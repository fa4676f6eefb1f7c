"""Host allocator and garbage-collector tuning.

Port of `ppsurf_tpu/utils/alloc.py` (standard library and ctypes only),
with its environment switches. Its record for the JAX package's
containers: first-touch page faults at about 10 MB/s (a 142 MB `np.full`
15.8 s cold, 0.04 s warm), so a multi-MB numpy buffer that glibc returns
to the kernel and maps again costs seconds; and gen-2 collections over a
large graph of long-lived objects that fire inside numpy allocations as
2-16 s spikes. The reference has no counterpart.

`tune_host_allocator` runs at the start of `cli.main`; `freeze_gc` just
before `Predictor.reconstruct_shape` grows and meshes the field, where
the JAX package calls both.
"""
from __future__ import annotations

_done = False
_gc_done = False


def freeze_gc(debug: bool = False) -> None:
    """Move the live object graph out of GC tracking (`gc.freeze`) and
    raise the gen-2 threshold to 1000, once.

    Collection stays enabled: cycles made later are still reclaimed.
    Each call freezes what is live at that moment, so calling it once a
    shape keeps what the shape before left out of later collections.
    PPSURF_NO_GC_TUNE=1 turns it off; debug=True (or PPSURF_EVAL_DEBUG=1)
    prints every collection over 50 ms.
    """
    global _gc_done
    import gc
    import os
    import time

    if os.environ.get("PPSURF_NO_GC_TUNE") == "1":
        return
    if debug or os.environ.get("PPSURF_EVAL_DEBUG") == "1":
        state = {}

        def _cb(phase, info):
            if phase == "start":
                state["t"] = time.perf_counter()
            elif "t" in state:
                dt = time.perf_counter() - state.pop("t")
                if dt > 0.05:
                    print(f"#     gc[gen{info['generation']}]: {dt:6.2f}s", flush=True)

        if not any(getattr(c, "__name__", "") == "_cb" for c in gc.callbacks):
            gc.callbacks.append(_cb)
    gc.freeze()
    if not _gc_done:
        _gc_done = True
        g0, g1, _ = gc.get_threshold()
        gc.set_threshold(g0, g1, 1000)


def tune_host_allocator() -> None:
    """Tell glibc to keep freed memory: never trim, never mmap.

    Idempotent; a no-op where libc.so.6 or `mallopt` is missing. The
    heap's high-water mark (a few GB for the largest reconstruction) then
    stays with the process.
    """
    global _done
    if _done:
        return
    _done = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_MMAP_MAX, 0)
    except (OSError, AttributeError):
        pass
