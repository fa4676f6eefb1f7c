"""Worker pools for batch host work (metrics, renders, figure data).

Port of `ppsurf_tpu/utils/mp.py:17-60` (reference `source/base/mp.py:23-52`):
`start_process_pool` runs picklable work in a spawn-context process pool
with one task a child (`maxtasksperchild=1`), unpicklable work (closures)
in a thread pool, and everything serially for `num_processes <= 1`. Spawn
is the only start method: the parent may hold a CUDA context, which a
forked child must not inherit, and the workers here are host-only (they
never touch CUDA). `get_multi_device_params` stays with the JAX package
until the port runs on several cards.
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
