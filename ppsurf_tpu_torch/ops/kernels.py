"""Build, load and launch the port's CUDA kernels.

The sources under `csrc/` are compiled with nvcc for `sm_90a` into one
shared library with a plain C interface, bound with ctypes. The build
runs at first use (never at import), one nvcc process per source started
together, and the library lands in this package's ignored `_build/`
directory under a name that hashes the sources and flags, so an edited
source is rebuilt. A failed build or launch raises; nothing falls back.

Every launch goes through `launch`, which adds one to the kernel's entry
in `LAUNCHES`: the count a run reads to prove that its path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import typing

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
SOURCES = ("knn.cu", "decoder_tail.cu", "pointnet.cu", "select.cu", "winding.cu", "mesh.cu")
HEADERS = ("common.cuh", "gmma.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)

# the microbenchmark variants of `ppsurf_tpu_torch/tools/microbench_extract.py`
EXTRACT_VARIANTS = ("noop", "elementwise", "sum_only", "min_only", "min_argmin",
                    "min_mask", "full")

# kernel name -> launches since the last reset_launches(). K1 counts under
# "knn" for k <= 128 and "knn_k192" for 128 < k <= 256, the build the
# candidate refinement runs at kc=192; K3 under "decoder_tail" at latent
# 256 and "decoder_tail_l32" at latent 32 (POCO); K4 and K5 under
# "pointnet_trunk"/"pointnet_head" for patches of one 64-row tile and
# "..._wide" for P in (64, 256]; W1 (the metrics' winding number) under
# "winding"; the meshing kernels (`ops/mesh.py`) under "mesh_" and their C
# entry's name.
MESH_KERNELS = ("mesh_classify", "mesh_edges", "mesh_emit", "mesh_round_keys", "mesh_runs",
                "mesh_groups", "mesh_face_keys", "mesh_dedup", "mesh_components",
                "mesh_compact")
LAUNCHES: typing.Dict[str, int] = {
    "knn": 0, "knn_k192": 0, "decoder_tail": 0, "decoder_tail_l32": 0,
    "pointnet_trunk": 0, "pointnet_head": 0, "pointnet_trunk_wide": 0,
    "pointnet_head_wide": 0, "topk_rows": 0, "winding": 0,
    **{f"extract_{v}": 0 for v in EXTRACT_VARIANTS},
    **{k: 0 for k in MESH_KERNELS},
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry points: (argtypes); every one returns a cudaError_t as int
_SIGNATURES = {
    # pts4, boxes, queries, out ids, blocks, nq, k, points a block, stream
    "ppsurf_knn": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # latents, pts, queries, ids, w1, w2, b2, w3, b3, wq, bq, wv, bv,
    # wpack|NULL, out, c, k, latent, heads, is_bf16, stream
    "ppsurf_decoder_tail": [_P] * 15 + [_I] * 5 + [_P],
    # patches, w0a, w0b, ws1, ws2, ws3, aff, pack|NULL, b_out, pooled_out, c, p,
    # is_bf16, stream
    "ppsurf_pointnet_trunk": [_P] * 10 + [_I] * 3 + [_P],
    # x2, wc1, wc2, wc3, wq, wv, aff, bqv, pack|NULL, out, c, p, is_bf16, stream
    "ppsurf_pointnet_head": [_P] * 10 + [_I] * 3 + [_P],
    # d2, out positions, c, kc, k, stream
    "ppsurf_topk_rows": [_P, _P, _I, _I, _I, _P],
    # cand, out, q, ncand, k, variant (index in EXTRACT_VARIANTS), stream
    "ppsurf_extract": [_P, _P, _I, _I, _I, _I, _P],
    # queries, packed faces, partial sums, out, nq, face tiles, splits, stream
    "ppsurf_winding": [_P] * 4 + [_I] * 3 + [_P],
    # meshing (`csrc/mesh.cu`, arguments as its comments say)
    "ppsurf_mesh_classify": [_P, _I, _I, _I, _D, _P, _P, _P, _P, _P],
    "ppsurf_mesh_edges": [_P, _P, _I, _I, _I, _D, _P, _P, _P],
    "ppsurf_mesh_emit": [_P] * 6 + [_I, _I, _I, _D] + [_P] * 5,
    "ppsurf_mesh_round_keys": [_P, _L, _P, _P],
    "ppsurf_mesh_runs": [_P, _P, _I, _P, _P],
    "ppsurf_mesh_groups": [_P, _P, _P, _I, _P, _P, _P],
    "ppsurf_mesh_face_keys": [_P, _P, _I, _L, _I, _P, _P, _P, _P],
    "ppsurf_mesh_dedup": [_P] * 4 + [_I, _L] + [_P] * 3,
    "ppsurf_mesh_components": [_P] * 4 + [_I, _I] + [_P] * 5,
    "ppsurf_mesh_compact": [_P] * 4 + [_I] + [_P] * 3 + [_I] + [_P] * 3,
}
# launch shapes (`launch_info`): (int arguments) -> 4 long longs
_INFO = {
    # c, p (64 < p <= 256): CTAs a cluster, clusters at once, grid blocks,
    # weight bytes a launch streams by design
    "ppsurf_pointnet_head_info": 2,
    # c, is_bf16: 1, blocks an SM, grid blocks, weight bytes a launch streams
    # by design
    "ppsurf_decoder_tail_l32_info": 2,
}


class KernelLibrary:
    """The built shared library and what its build printed."""

    def __init__(self, path: str, log: str, seconds: float):
        self.path = path
        self.log = log
        self.build_seconds = seconds
        self.lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, ints in _INFO.items():
            fn = getattr(self.lib, name)
            fn.argtypes = [_I] * ints + [_P]
            fn.restype = ctypes.c_int
        self.lib.ppsurf_error_string.argtypes = [ctypes.c_int]
        self.lib.ppsurf_error_string.restype = ctypes.c_char_p


_LIBRARY: typing.Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fp:
            h.update(name.encode())
            h.update(fp.read())
    return h.hexdigest()[:12]


def build_library() -> typing.Tuple[str, str]:
    """Compile every source (in parallel) and link the library unless the
    build of these sources and flags is on disk; returns (library path,
    what nvcc printed).

    Processes that build at once (ranks at first use) each compile and
    link in a private temporary directory and move the finished log, then
    the finished library, into `_build/<hash>/` with `os.replace`: a
    reader that finds the library finds its log, and every library there
    is one build's whole output."""
    out_dir = os.path.join(BUILD_DIR, _digest())
    lib_path = os.path.join(out_dir, "libppsurf_kernels.so")
    log_path = os.path.join(out_dir, "build.log")  # what nvcc printed, kept with it
    if os.path.isfile(lib_path) and os.path.isfile(log_path):
        with open(log_path) as fp:
            return lib_path, fp.read()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(prefix="build.", dir=out_dir)
    try:
        procs = []
        for name in SOURCES:
            obj = os.path.join(work, name.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = ""
        objs = []
        failed = []
        for name, obj, proc in procs:
            text, _ = proc.communicate()
            log += f"== {name}\n{text}"
            if proc.returncode != 0:
                failed.append(name)
            objs.append(obj)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        lib_tmp = os.path.join(work, os.path.basename(lib_path))
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log += f"== link\n{link.stdout}"
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        with open(os.path.join(work, "build.log"), "w") as fp:
            fp.write(log)
        os.replace(os.path.join(work, "build.log"), log_path)
        os.replace(lib_tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path, log


def build() -> KernelLibrary:
    """The loaded kernel library (`build_library`), cached in-process."""
    global _LIBRARY
    if _LIBRARY is None:
        t0 = time.perf_counter()
        path, log = build_library()
        _LIBRARY = KernelLibrary(path, log, time.perf_counter() - t0)
    return _LIBRARY


def ptr(t: typing.Optional[torch.Tensor]) -> typing.Optional[int]:
    return None if t is None else t.data_ptr()


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Call C entry `symbol` with `device` (the card its tensors are on)
    current and on that card's current stream, raise on a launch error,
    and count one launch of `kernel`. The C entries read the current
    device (`cudaGetDevice`) for their per-card settings, so the device
    is entered here, whichever card the caller had current."""
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib.lib, symbol)(*args, stream)
    if rc != 0:
        msg = lib.lib.ppsurf_error_string(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} (cudaError {rc})")
    LAUNCHES[kernel] += 1


def launch_info(symbol: str, *args: int) -> typing.List[int]:
    """How C entry `symbol` (a key of `_INFO`) would launch for `args`:
    its CTAs a cluster, the clusters (or blocks an SM) the card holds at
    once, the grid's blocks and the weight bytes a launch streams by design
    (a count from the kernel's constants, not a measurement). Launches
    nothing."""
    lib = build()
    out = (ctypes.c_longlong * 4)()
    rc = getattr(lib.lib, symbol)(*args, out)
    if rc != 0:
        msg = lib.lib.ppsurf_error_string(rc).decode()
        raise RuntimeError(f"{symbol} failed: {msg} (cudaError {rc})")
    return list(out)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_cuda_args(name: str, tensors: typing.Dict[str, torch.Tensor],
                    dtypes: typing.Dict[str, torch.dtype]) -> None:
    """Raise unless every tensor is contiguous, on one CUDA device and of
    the stated dtype."""
    device = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in dtypes and t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")


def dtype_code(dt: torch.dtype) -> int:
    """1 for bf16, 0 for f32; other compute types are not built."""
    if dt == torch.bfloat16:
        return 1
    if dt == torch.float32:
        return 0
    raise ValueError(f"kernels are built for float32 and bfloat16, not {dt}")
