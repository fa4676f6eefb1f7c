"""Worker pools for batch host work (metrics, renders, figure data).

Port of `ppsurf_tpu/utils/mp.py:17-60` (reference `source/base/mp.py:23-52`):
`start_process_pool` runs picklable work in a spawn-context process pool
with one task a child (`maxtasksperchild=1`), unpicklable work (closures)
in a thread pool, and everything serially for `num_processes <= 1`. Spawn
is the only start method: the parent may hold a CUDA context, which a
forked child must not inherit, and the workers here are host-only (they
never touch CUDA). `get_multi_device_params` (`ppsurf_tpu/utils/mp.py:63-74`)
sizes a data-parallel batch over the process group's ranks, or over the
local cards where there is no group.
"""
from __future__ import annotations

import pickle
import threading
import typing
from concurrent.futures import ThreadPoolExecutor


def _picklable(worker_function, parameters) -> bool:
    # every tuple is probed: one unpicklable parameter mid-batch would
    # break the pool's starmap instead of taking the thread pool
    try:
        pickle.dumps(worker_function)
        for p in parameters:
            pickle.dumps(p)
        return True
    except Exception:
        return False


def start_process_pool(
    worker_function: typing.Callable,
    parameters: typing.Sequence[typing.Sequence],
    num_processes: int = 1,
) -> typing.Optional[list]:
    """worker_function(*params) for each parameter tuple, results in order.

    num_processes <= 1 runs serially in this process; otherwise picklable
    work goes to a spawn-context process pool (one task a child) and the
    rest to a thread pool of that size.
    """
    if len(parameters) == 0:
        return []
    if num_processes <= 1:
        return [worker_function(*p) for p in parameters]
    if _picklable(worker_function, parameters):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes=num_processes, maxtasksperchild=1) as pool:
            return pool.starmap(worker_function, parameters)
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        futures = [pool.submit(worker_function, *p) for p in parameters]
        return [f.result() for f in futures]


def start_thread(func: typing.Callable, args: typing.Sequence = ()) -> threading.Thread:
    """Start `func(*args)` on a daemon thread."""
    t = threading.Thread(target=func, args=args, daemon=True)
    t.start()
    return t


def get_multi_device_params(batch_size_total: int = 50) -> dict:
    """Per-device batch sizing over the data axis (reference `mp.py:74-94`,
    which kept the global batch near 50): the world size of the process
    group, else the number of local cards (at least 1)."""
    import torch

    from ppsurf_tpu_torch.parallel.mesh import is_distributed

    if is_distributed():
        import torch.distributed as dist

        n = dist.get_world_size()
    else:
        n = max(1, torch.cuda.device_count())
    per_device = max(1, batch_size_total // n)
    return {
        "num_devices": n,
        "batch_size": per_device * n,
        "per_device_batch": per_device,
    }
