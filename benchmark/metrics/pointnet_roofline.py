"""K4's and K5's share of their roofline, as one piece of work: the least
time (the benchmark's own count, `yardstick/opcount.py::pointnet_work`,
over every field query of the traced window) over the summed device
time of the kernels named below, in percent."""
from benchmark.yardstick import opcount

# K4 and K5 (`csrc/pointnet.cu`): bf16, cluster (P > 64) and 3xTF32 builds
NAMES = ("trunk_wgmma_kernel", "trunk_tf32_kernel", "head_wgmma_kernel",
         "head_cluster_kernel", "head_tf32_kernel")
K4 = ("trunk_wgmma_kernel", "trunk_tf32_kernel")


def read(run):
    if run.trace is None or not opcount.is_ppsurf(run.config):
        return None
    seconds, calls = run.trace.sum_matching(NAMES)
    _, k4_calls = run.trace.sum_matching(K4)
    if k4_calls == 0 or seconds <= 0:
        return None
    queries = sum(o["queries"] for o in run.objects)
    ops, nbytes = opcount.pointnet_work(run.config, queries, k4_calls)
    return 100.0 * opcount.roofline_seconds(ops, nbytes, run.config) / seconds
