"""K3's share of its roofline: the least time its work could take (the
benchmark's own count, `yardstick/opcount.py::decoder_tail_work`, over
every field query of the traced window) over the device time of the
kernels named below in the profiler's trace, in percent."""
from benchmark.yardstick import opcount

# the CUDA kernels of K3 (`csrc/decoder_tail.cu`): latent 256 and latent
# 32, bf16 and 3xTF32 builds
NAMES = ("decoder_tail_wgmma_kernel", "decoder_tail_narrow_wgmma_kernel",
         "decoder_tail_tf32_kernel", "decoder_tail_narrow_tf32_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds, calls = run.trace.sum_matching(NAMES)
    if calls == 0 or seconds <= 0:
        return None
    queries = sum(o["queries"] for o in run.objects)
    ops, nbytes = opcount.decoder_tail_work(run.config, queries, calls)
    return 100.0 * opcount.roofline_seconds(ops, nbytes, run.config) / seconds
