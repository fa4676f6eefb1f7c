"""Profiling utilities.

Port of `ppsurf_tpu/utils/profiling.py` (reference
`source/base/profiling.py`): `init_profiling`, `print_duration`,
`print_memory`, `print_malloc_top` and `get_now_str` are copies;
`torch_trace` takes the place of `jax_trace` (the reference's
PyTorchProfiler preset, `configs/profiler.yaml`): a torch.profiler trace
of the enclosed work, CPU and, where a card is present, CUDA activity,
written as a Chrome trace (chrome://tracing, ui.perfetto.dev).
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import os
import time
import tracemalloc


def init_profiling() -> None:
    tracemalloc.start()


def print_duration(func, params: dict, name: str):
    """Time one call (reference `profiling.py:46-52`)."""
    start = time.time()
    result = func(**params)
    print(f"{name} took: {time.time() - start}")
    return result


def print_memory(min_size_mb: float = 0.1) -> None:
    """Largest live objects by size (reference `profiling.py:55-72`)."""
    import sys

    objects = gc.get_objects()
    sizes = [(sys.getsizeof(o) / 1024**2, type(o).__name__) for o in objects]
    big = sorted((s for s in sizes if s[0] > min_size_mb), reverse=True)[:20]
    for size_mb, name in big:
        print(f"{size_mb:8.2f} MB  {name}")


def print_malloc_top(count: int = 10) -> None:
    if not tracemalloc.is_tracing():
        return
    snapshot = tracemalloc.take_snapshot()
    for stat in snapshot.statistics("lineno")[:count]:
        print(stat)


def get_now_str() -> str:
    return str(datetime.datetime.now())


@contextlib.contextmanager
def torch_trace(log_dir: str = "profiles", enabled: bool = True,
                file_name: str = "trace.json"):
    """Trace the enclosed work with torch.profiler (CPU activity, and CUDA
    activity where a card is present) and write it to
    `log_dir/file_name` as a Chrome trace; yields the profiler (None when
    not `enabled`). The card is synchronised before the trace stops, so
    the enclosed kernels are in it."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, file_name))
