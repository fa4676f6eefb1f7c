"""ctypes bindings for the repository's C++ host library.

The source is the repository's `native/ppsurf_native.cpp`, read in place.
It is compiled with `g++` (the flags of `native/Makefile`) into this
package's ignored build directory on first use, under a name keyed by the
source and the host; the committed prebuilt library next to the source is
never loaded. Every entry point of reconstruction and scoring has a
numpy fallback in the calling module, so they still work where no host
compiler exists; the renderer (`render_mesh_native`,
`render_points_native`) has none, and raises without the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import typing

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_REPO, "native", "ppsurf_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lib: typing.Optional[ctypes.CDLL] = None
_lib_attempted = False


def _build() -> typing.Optional[str]:
    """Compile the source into BUILD_DIR; returns the library path."""
    if not os.path.isfile(_SOURCE):
        return None
    with open(_SOURCE, "rb") as fp:
        # -march=native ties the library to the host that built it
        digest = hashlib.sha1(fp.read() + platform.node().encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"libppsurf_native_{digest}.so")
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", *_CXXFLAGS, "-shared", "-o", tmp, _SOURCE],
            check=True, capture_output=True, timeout=300,
        )
    except (subprocess.SubprocessError, OSError):
        return None
    os.replace(tmp, path)
    return path


def _load() -> typing.Optional[ctypes.CDLL]:
    global _lib, _lib_attempted
    if _lib is not None or _lib_attempted:
        return _lib
    _lib_attempted = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [f32p, i64]
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_query.argtypes = [ctypes.c_void_p, f32p, i64, ctypes.c_int, f32p, i64p]
    lib.mc_extract.restype = i64
    lib.mc_extract.argtypes = [
        f64p, i64, i64, i64, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(i64), ctypes.POINTER(i64), i64, i64,
    ]
    lib.face_components.restype = i64
    lib.face_components.argtypes = [i64p, i64, i64p]
    lib.unique_rows_f64.restype = i64
    lib.unique_rows_f64.argtypes = [f64p, i64, i64p, i64p]
    lib.dedup_faces.restype = i64
    lib.dedup_faces.argtypes = [i64p, i64, i64p]
    lib.rg_dilate_unevaluated.restype = i64
    lib.rg_dilate_unevaluated.argtypes = [
        f64p, i64, i64, i64, i32p, i64, i64, u8p, ctypes.c_uint8, i32p, i64,
    ]
    lib.rg_next_frontier.restype = i64
    lib.rg_next_frontier.argtypes = [
        f64p, i64, i64, i64, i32p, i64, i64, u8p, u8p, ctypes.c_uint8, i32p, i64,
    ]
    lib.render_mesh.restype = None
    lib.render_mesh.argtypes = [
        f32p, i64, i32p, i64, ctypes.c_void_p, f64p, i64, i64, ctypes.c_double, u8p,
    ]
    lib.render_points.restype = None
    lib.render_points.argtypes = [
        f32p, i64, ctypes.c_void_p, f64p, i64, i64, ctypes.c_double, i64, u8p,
    ]
    _lib = lib
    return _lib


def _render_args(verts, colors, view, width, height, background):
    """The renderer's checked buffers: (vertices (V, 3) f32, colors (V, 3)
    uint8 or None, their address or None, view (4, 4) f64); the C++ side
    writes `background` as (height, width, 3) uint8 and reads V colors."""
    v = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    if background.shape != (height, width, 3) or background.dtype != np.uint8:
        raise ValueError(f"background must be ({height}, {width}, 3) uint8, got "
                         f"{background.dtype} {background.shape}")
    view = np.ascontiguousarray(view, np.float64)
    if view.shape != (4, 4):
        raise ValueError(f"view must be (4, 4), got {view.shape}")
    if colors is None:
        return v, None, None, view
    colors = np.ascontiguousarray(colors, np.uint8)
    if colors.shape != v.shape:
        raise ValueError(f"colors must be {v.shape} uint8, got {colors.shape}")
    return v, colors, colors.ctypes.data, view


def render_mesh_native(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: typing.Optional[np.ndarray],
    view: np.ndarray,
    width: int,
    height: int,
    fov_deg: float,
    background: np.ndarray,
) -> np.ndarray:
    """Z-buffer rasterize a mesh into `background` ((H, W, 3) uint8,
    written in place and returned): vertices (V, 3), faces (F, 3), colors
    (V, 3) uint8 or None (Lambert-shaded), `view` the row-major 4x4
    world-to-camera matrix, `fov_deg` the vertical field of view."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the host library native/ppsurf_native.cpp is not built")
    v, keep, col_p, view = _render_args(verts, colors, view, width, height, background)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)  # out-of-range ids are skipped
    lib.render_mesh(v, v.shape[0], f, f.shape[0], col_p, view, width, height, fov_deg,
                    background)
    del keep
    return background


def render_points_native(
    verts: np.ndarray,
    colors: typing.Optional[np.ndarray],
    view: np.ndarray,
    width: int,
    height: int,
    fov_deg: float,
    splat: int,
    background: np.ndarray,
) -> np.ndarray:
    """Splat a point cloud into `background` as squares of 2 * splat + 1
    pixels, nearest point on top (arguments as `render_mesh_native`)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the host library native/ppsurf_native.cpp is not built")
    v, keep, col_p, view = _render_args(verts, colors, view, width, height, background)
    lib.render_points(v, v.shape[0], col_p, view, width, height, fov_deg, splat, background)
    del keep
    return background


class RegionGrowState:
    """Native region-growing round helper (see recon/engine.py)."""

    def __init__(self, volume: np.ndarray, dilation: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.volume = volume  # (nx, ny, nz) f64, C-contiguous, shared
        self.dilation = dilation
        self._stamp = np.zeros(volume.shape, np.uint8)
        self._seen = np.zeros(volume.shape, np.uint8)
        self._epoch = 0

    def _next_epoch(self) -> int:
        self._epoch += 1
        if self._epoch == 256:
            self._stamp[:] = 0
            self._epoch = 1
        return self._epoch

    def dilate_unevaluated(self, frontier: np.ndarray) -> np.ndarray:
        nx, ny, nz = self.volume.shape
        cap = int(frontier.shape[0]) * (2 * self.dilation + 1) ** 3
        out = np.empty((cap, 3), np.int32)
        n = self._lib.rg_dilate_unevaluated(
            self.volume, nx, ny, nz,
            np.ascontiguousarray(frontier, np.int32), frontier.shape[0],
            self.dilation, self._stamp, self._next_epoch(), out, cap,
        )
        if n < 0:
            raise RuntimeError("rg_dilate_unevaluated overflow")
        return out[:n]

    def next_frontier(self, frontier: np.ndarray) -> np.ndarray:
        nx, ny, nz = self.volume.shape
        cap = max(1, int(frontier.shape[0])) * (2 * self.dilation + 1) ** 3
        out = np.empty((cap, 3), np.int32)
        n = self._lib.rg_next_frontier(
            self.volume, nx, ny, nz,
            np.ascontiguousarray(frontier, np.int32), frontier.shape[0],
            self.dilation, self._seen, self._stamp, self._next_epoch(), out, cap,
        )
        if n < 0:
            raise RuntimeError("rg_next_frontier overflow")
        return out[:n]


class NativeKdTree:
    """Exact k-nearest-neighbour queries on the host (the metrics' proximity
    layer): `query` returns (distances, ids), each (Q, k), nearest first."""

    def __init__(self, pts: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._pts = np.ascontiguousarray(pts, np.float32)
        self._handle = lib.kdtree_build(self._pts, self._pts.shape[0])

    def query(self, queries: np.ndarray, k: int = 1):
        q = np.ascontiguousarray(queries, np.float32)
        d2 = np.empty((q.shape[0], k), np.float32)
        ids = np.empty((q.shape[0], k), np.int64)
        self._lib.kdtree_query(self._handle, q, q.shape[0], k, d2, ids)
        return np.sqrt(d2), ids

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None


def available() -> bool:
    return _load() is not None


def marching_cubes_native(
    volume: np.ndarray, level: float = 0.0
) -> typing.Optional[typing.Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    vol = np.ascontiguousarray(volume, np.float64)
    nx, ny, nz = vol.shape
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mc_extract(vol, nx, ny, nz, float(level), None, None,
                        ctypes.byref(nv), ctypes.byref(nf), 0, 0)
    if rc != 0:
        return None
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int64)
    rc = lib.mc_extract(
        vol, nx, ny, nz, float(level),
        verts.ctypes.data_as(ctypes.c_void_p),
        faces.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(nv), ctypes.byref(nf), nv.value, nf.value,
    )
    if rc != 0:
        return None
    return verts, faces


def face_components_native(faces: np.ndarray) -> typing.Optional[typing.Tuple[int, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    f = np.ascontiguousarray(faces, np.int64)
    labels = np.empty((f.shape[0],), np.int64)
    n = lib.face_components(f, f.shape[0], labels)
    return int(n), labels


def unique_rows_native(
    keys: np.ndarray,
) -> typing.Optional[typing.Tuple[np.ndarray, np.ndarray]]:
    """(first, inverse) row-unique of (n, 3) float64 keys — see
    mesh_ops._unique_rows for the exact semantics."""
    lib = _load()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, np.float64)
    n = k.shape[0]
    first = np.empty((n,), np.int64)
    inverse = np.empty((n,), np.int64)
    nu = lib.unique_rows_f64(k, n, first, inverse)
    return first[:nu], inverse


def dedup_faces_native(faces: np.ndarray) -> typing.Optional[np.ndarray]:
    """Ascending original indices of kept faces (degenerate + duplicate
    removal) — see mesh_ops.remove_degenerate_faces."""
    lib = _load()
    if lib is None:
        return None
    f = np.ascontiguousarray(faces, np.int64)
    keep = np.empty((f.shape[0],), np.int64)
    m = lib.dedup_faces(f, f.shape[0], keep)
    return keep[:m]
