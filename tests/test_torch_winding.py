"""W1's arithmetic on the CPU: the arctangent, the face packing and a model
of the kernel's pair loop, against the plain version and the JAX package.

The CUDA kernel (`ppsurf_tpu_torch/csrc/winding.cu`) cannot run here, so
its arithmetic is mirrored in numpy float32 (FMAs as one rounding of the
exact product-sum, the reciprocal and square roots exactly rounded):
- the arctangent's coefficients: the kernel's marked array and the mirror
  `ops/winding.py::ATAN_COEFFS` agree as text;
- the arctangent (`add_atan2` at sum = -0) over a sweep of (num, den): all
  four quadrants, +-0, den = 0 and |num| / |den| from 1e-30 to 1e30, within
  the relative-error bound the source states, with an exact reciprocal and
  with it 1 ulp off either way; the signed zeros and +-pi exactly; the
  fast path's fused step equal to the general one to the bit;
- `pack_faces`: N = (B - A) x (C - A) rounded once from float64, the row
  layout, zero rows up to whole tiles; a padding face adds exactly 0
  through the plain formula on the packed form and through the kernel's
  arithmetic;
- the kernel's pair loop (packed faces, the numerator from the face
  vertex nearest the query, per-tile sums, the general path with its
  float64 repairs for every pair, whose bits the fast path gives where
  its vote passes) on a closed sphere mesh with
  queries on vertices and degenerate faces, within 1e-5 of `winding_plain`
  and of the JAX package's `_winding_tiled`, and no further from float64
  than twice the plain version (or 1e-5): the smoke's W1 limits, here on
  the model;
- a near-vertex probe under the same limits: queries 1e-2 to 1e-5 edges
  from a face's B or C, from every direction, on a closed icosphere and
  on small random triangles; the first design's a . N numerator fails it;
- the general path's float64 repairs (`repair_terms`): their two
  constants equal as text between the kernel and `ops/winding.py`; the
  numerator within its stated bound NUM_ERR_EPS eps |v*||N| over 200 000
  pairs within f32 rounding of a face's plane, where f32 gets many signs
  wrong; a near-plane probe (queries inside the faces of a closed
  icosphere and of large triangles, each off its plane in exact
  arithmetic) with the model within 1e-4 of float64 at every query, which
  the kernel's model before the repairs (`repaired=False`) fails by a
  whole turn on both shapes; and queries 1e-3 to 1e-6 edge lengths from
  an edge of large triangles, where the model is within 1e-5 of float64
  and errs by over 1e-3 without the near-edge float64 terms.
W1 itself against its plain version is in `tests/test_torch_package.py`
(marked `cuda`) and `chip_smoke.py` phase 13.
"""
from __future__ import annotations

import math
import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from ppsurf_tpu.metrics import winding as jwinding
from ppsurf_tpu_torch.ops import winding as pw
from ppsurf_tpu_torch.recon.marching_cubes import marching_cubes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join(ROOT, "ppsurf_tpu_torch", "csrc", "winding.cu")
MIRROR = os.path.join(ROOT, "ppsurf_tpu_torch", "ops", "winding.py")
MODEL_ATOL = 1e-5  # the kernel's model against the plain version and JAX

f32 = np.float32
FLT_MIN = f32(np.finfo(np.float32).tiny)
EPS = float(np.finfo(np.float32).eps)  # 2^-23
HALF_PI, PI = f32(math.pi / 2), f32(math.pi)


def _marked(path: str, comment: str, what: str = "ATAN COEFFS") -> str:
    with open(path) as fp:
        text = fp.read()
    return text[text.index(f"{comment} BEGIN W1 {what}"):
                text.index(f"{comment} END W1 {what}")]


def _stated_bounds():
    """(exact reciprocal, reciprocal 1 ulp off) relative-error bounds from
    the comment above `atan_poly` in the kernel's source."""
    with open(KERNEL) as fp:
        text = " ".join(line.strip().lstrip("/").strip() for line in fp)
    m = re.search(r"within ([0-9.e-]+) of atan\(r\) relative \(([0-9.e-]+) with the reciprocal",
                  text)
    return float(m.group(1)), float(m.group(2))


def fma(a, b, c):
    """One rounding of a * b + c (the f32 product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def atan_poly(s):
    c = np.asarray(pw.ATAN_COEFFS, f32)
    p = np.full_like(s, c[-1])
    for ci in c[-2::-1]:
        p = fma(p, s, ci)
    return p


def add_atan2(acc, n, d, rcp_ulps: int = 0):
    """The kernel's `add_atan2` (sum + atan2(n, d), general path), with the
    reciprocal moved `rcp_ulps` ulps away from the exactly rounded one."""
    n, d = np.asarray(n, f32), np.asarray(d, f32)
    an, ad = np.abs(n), np.abs(d)
    swap = an > ad
    hi = np.maximum(np.maximum(an, ad), FLT_MIN)
    rc = (f32(1) / hi).astype(f32)
    for _ in range(abs(rcp_ulps)):
        rc = np.nextafter(rc, f32(np.inf) if rcp_ulps > 0 else f32(0)).astype(f32)
    r = (np.minimum(an, ad) * rc).astype(f32)
    p = atan_poly((r * r).astype(f32))
    neg = np.signbit(d)
    sr = np.where(swap != neg, -r, r).astype(f32)
    base = np.where(swap, HALF_PI, np.where(neg, PI, f32(0))).astype(f32)
    sign = np.signbit(n)
    sr = np.where(sign, -sr, sr).astype(f32)
    base = np.where(sign, -base, base).astype(f32)
    return fma(sr, p, (np.asarray(acc, f32) + base).astype(f32))


def atan2_w1(n, d, rcp_ulps: int = 0):
    return add_atan2(np.full(np.shape(n), -0.0, f32), n, d, rcp_ulps)


def _sweep():
    """(num, den) over all quadrants: ratios 1e-30..1e30 at magnitudes
    1e-15..1e15, a dense circle, and the axes with +-0."""
    rng = np.random.default_rng(0)
    ratio = 10.0 ** rng.uniform(-30, 30, 400_000)
    mag = 10.0 ** rng.uniform(-15, 15, ratio.size)
    sn, sd = rng.choice([-1.0, 1.0], (2, ratio.size))
    n = sn * mag * ratio / (1 + ratio)
    d = sd * mag / (1 + ratio)
    t = np.linspace(-np.pi, np.pi, 400_001)
    axes = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0], [1e-30, 1.0],
                     [1.0, 1e-30], [-1.0, -1e-30], [3.0, 3.0], [-2.0, 2.0]])
    n = np.concatenate([n, np.sin(t), axes[:, 0]]).astype(f32)
    d = np.concatenate([d, np.cos(t), axes[:, 1]]).astype(f32)
    return n, d


def test_atan_coefficients_mirror_the_kernel_text():
    cu = [x[:-1] for x in re.findall(r"-?\d+\.\d*(?:e-?\d+)?f", _marked(KERNEL, "//"))]
    py = re.findall(r"-?\d+\.\d*(?:e-?\d+)?", _marked(MIRROR, "#"))
    assert len(cu) >= 6 and cu == py
    assert np.array_equal(np.asarray(cu, np.float64).astype(f32),
                          np.asarray(pw.ATAN_COEFFS, f32))


@pytest.mark.parametrize("rcp_ulps", [0, 1, -1])
def test_atan2_relative_error_within_the_stated_bound(rcp_ulps):
    exact_bound, off_bound = _stated_bounds()
    bound = exact_bound if rcp_ulps == 0 else off_bound
    n, d = _sweep()
    got = atan2_w1(n, d, rcp_ulps).astype(np.float64)
    ref = np.arctan2(n.astype(np.float64), d.astype(np.float64))
    nz = ref != 0
    rel = np.abs(got[nz] - ref[nz]) / np.abs(ref[nz])
    assert np.isfinite(got).all() and rel.max() <= bound, (rel.max(), bound)
    assert (got[~nz] == 0).all() and (np.signbit(got[~nz]) == np.signbit(n[~nz])).all()


def test_atan2_signed_zeros_and_axes():
    zeros = [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (0.0, -1.0), (-0.0, -1.0),
             (0.0, 2.0), (-0.0, 2.0)]
    n, d = (np.array(x, f32) for x in zip(*zeros))
    got = atan2_w1(n, d)
    want = np.arctan2(n, d).astype(f32)  # +-0 and +-pi (pi rounded to f32)
    assert np.array_equal(got, want) and np.array_equal(np.signbit(got), np.signbit(want))
    n, d = np.array([1.0, -1.0, 5.0, -5.0], f32), np.array([0.0, 0.0, -0.0, -0.0], f32)
    assert np.array_equal(atan2_w1(n, d), np.array([1, -1, 1, -1], f32) * HALF_PI)


def test_fast_path_matches_the_general_path_bitwise():
    """Where |n| < d the kernel takes fma(n / d, P, sum) for the whole
    warp; the general path must give the same bits."""
    rng = np.random.default_rng(1)
    d = (10.0 ** rng.uniform(-20, 3, 200_000)).astype(f32)
    n = (d * rng.uniform(-1, 1, d.size) * rng.choice([1.0, 1e-3, 1e-9], d.size)).astype(f32)
    n[:100] = 0.0
    n[100:200] = -0.0
    acc = rng.normal(0, 3, d.size).astype(f32)
    acc[:50] = 0.0
    inner = np.abs(n) < d
    assert inner.all()
    r = (n * (f32(1) / d).astype(f32)).astype(f32)
    fast = fma(r, atan_poly((r * r).astype(f32)), acc)
    assert np.array_equal(fast, add_atan2(acc, n, d))


def pack_model(a, b, c, tile=pw.W_TILE):
    return pw.pack_faces(*(torch.from_numpy(x) for x in (a, b, c)), tile=tile).numpy()


def test_pack_faces_layout_normal_and_padding():
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=(300, 3)).astype(f32) for _ in range(3))
    packed = pack_model(a, b, c)
    assert packed.dtype == np.float32 and packed.shape == (3 * pw.W_TILE, 12)
    assert pw.W_TILE == 128 and packed.shape[0] % pw.W_TILE == 0
    # the normal rounded once from float64 (the numerator bound needs it)
    a64 = a.astype(np.float64)
    n = np.cross(b.astype(np.float64) - a64, c.astype(np.float64) - a64).astype(f32)
    np.testing.assert_array_equal(packed[:300, 0:3], a)
    np.testing.assert_array_equal(packed[:300, 4:7], b)
    np.testing.assert_array_equal(packed[:300, 8:11], c)
    np.testing.assert_array_equal(packed[:300, [3, 7, 11]], n)
    np.testing.assert_allclose(packed[:300, [3, 7, 11]], np.cross(b - a, c - a), rtol=1e-5,
                               atol=1e-5)
    assert not packed[300:].any()
    assert pack_model(a[:128], b[:128], c[:128]).shape == (128, 12)
    assert pack_model(*(np.zeros((0, 3), f32),) * 3).shape == (0, 12)


def _pair_terms(q, pa, pb, pc, nearest: bool = True, repaired: bool = True):
    """The kernel's `pair_terms` on broadcast arrays: q (..., 3), the packed
    rows' (A, Nx), (B, Ny), (C, Nz) (..., 4) -> numerator, denominator and
    |a||b||c|; `repaired=False` sums the denominator as the kernel did
    before the repairs."""
    a = (pa[..., :3] - q).astype(f32)
    b = (pb[..., :3] - q).astype(f32)
    c = (pc[..., :3] - q).astype(f32)

    def dot(u, v):
        return fma(u[..., 2], v[..., 2], fma(u[..., 1], v[..., 1],
                                             (u[..., 0] * v[..., 0]).astype(f32)))

    la, lb, lc = (np.sqrt(dot(x, x)).astype(f32) for x in (a, b, c))
    nrm = np.stack(np.broadcast_arrays(pa[..., 3], pb[..., 3], pc[..., 3]), axis=-1)
    v = a
    if nearest:
        take_b = lb < la
        v = np.where(take_b[..., None], b, a)
        v = np.where((lc < np.where(take_b, lb, la))[..., None], c, v)
    num = dot(v, nrm)
    ab, bc, ca = dot(a, b), dot(b, c), dot(c, a)
    l3 = (la * lb * lc).astype(f32)
    if repaired:
        den = fma(ca, lb, fma(bc, la, fma(ab, lc, l3)))
    else:
        den = fma(ca, lb, fma(bc, la, fma(lc, fma(la, lb, ab), f32(0))))
    return num, den, l3


def pair_terms(q, faces, nearest: bool = True, repaired: bool = True):
    """The kernel's `pair_terms` for every (query, face) pair, (Q, F) each:
    the numerator v . N with v the difference vector of the face vertex
    nearest the query (ties to A, then B), the denominator and |a||b||c|;
    `nearest=False` is the first design's a . N, which the near-vertex
    probe must catch."""
    return _pair_terms(q[:, None, :], faces[None, :, 0:4], faces[None, :, 4:8],
                       faces[None, :, 8:12], nearest, repaired)


def num_f64(q, pa, pb, pc):
    """(A - q) . ((B - q) x (C - q)) in float64 (the smoke's float64
    reference formula) on broadcast arrays."""
    ax, ay, az = (pa[..., i] - np.asarray(q[..., i], np.float64) for i in range(3))
    bx, by, bz = (pb[..., i] - np.asarray(q[..., i], np.float64) for i in range(3))
    cx, cy, cz = (pc[..., i] - np.asarray(q[..., i], np.float64) for i in range(3))
    return ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz) + az * (bx * cy - by * cx)


def repair_terms(q, faces, num, den, l3):
    """The general path's float64 repairs (the kernel's `repair_terms`) on
    (Q, F) pairs: near an edge (max(|n|, |d|) <= EDGE |a||b||c|) n and d,
    elsewhere with d < 0 and |n| <= NUM_ERR_EPS eps |v*||N| the numerator,
    taken again in float64 as v* . ((B - A) x (C - A)), v* the exact
    difference vector of the nearest vertex."""
    edge = np.maximum(np.abs(num), np.abs(den)) <= f32(pw.EDGE) * l3
    p = [faces[None, :, i:i + 4].astype(np.float64) for i in (0, 4, 8)]
    x, y, z = (t[..., :3] - q.astype(np.float64)[:, None] for t in p)
    xx, yy, zz = ((t * t).sum(-1) for t in (x, y, z))
    nn = sum(t[..., 3] * t[..., 3] for t in p)
    lim = (pw.NUM_ERR_EPS * EPS) ** 2 * np.minimum(xx, np.minimum(yy, zz)) * nn
    sign = (den < 0) & (num.astype(np.float64) ** 2 <= lim)
    take_y = yy < xx
    v = np.where(take_y[..., None], y, x)
    v = np.where((zz < np.where(take_y, yy, xx))[..., None], z, v)
    exact = (v * np.cross(p[1][..., :3] - p[0][..., :3],
                          p[2][..., :3] - p[0][..., :3])).sum(-1).astype(f32)
    lx, ly, lz = (np.sqrt(t) for t in (xx, yy, zz))
    den64 = (lx * ly * lz + (x * y).sum(-1) * lz + (y * z).sum(-1) * lx
             + (z * x).sum(-1) * ly).astype(f32)
    return np.where(edge | sign, exact, num), np.where(edge, den64, den)


def pack_parent(a, b, c):
    """`pack_faces` before the repair: N as an f32 cross product of f32
    edges (torch's, as the parent's wrapper computed it)."""
    packed = pack_model(a, b, c)
    n = torch.linalg.cross(torch.from_numpy(b - a), torch.from_numpy(c - a)).numpy()
    packed[:len(a), [3, 7, 11]] = n
    return packed


def winding_model(q, a, b, c, nearest: bool = True, repaired: bool = True):
    """W1's arithmetic: packed faces, per-tile f32 sums of the fused
    arctangent steps added into a running total, divided by 2 pi. One
    split (the kernel adds the splits' totals in split order, in f64). A query on
    a vertex takes that vertex's zero difference vector as v, so its
    numerator is exactly +-0, as the plain version's is. `repaired=False`
    is the kernel before the repairs (an f32 normal, the old denominator
    sum, no float64 terms), which the near-plane probe must catch."""
    faces = pack_model(a, b, c) if repaired else pack_parent(a, b, c)
    total = np.zeros(q.shape[0], f32)
    for t in range(0, faces.shape[0], pw.W_TILE):
        tile = faces[t:t + pw.W_TILE]
        num, den, l3 = pair_terms(q, tile, nearest, repaired)
        if repaired:
            num, den = repair_terms(q, tile, num, den, l3)
        s = np.zeros(q.shape[0], f32)
        for f in range(num.shape[1]):
            s = add_atan2(s, num[:, f], den[:, f])
        total = (total + s).astype(f32)
    return (total / f32(2 * math.pi)).astype(f32)


def winding_f64(q, a, b, c):
    x, y, z = (t.astype(np.float64)[None] - q.astype(np.float64)[:, None] for t in (a, b, c))
    lx, ly, lz = (np.linalg.norm(t, axis=-1) for t in (x, y, z))
    num = (x * np.cross(y, z)).sum(-1)
    den = (lx * ly * lz + (x * y).sum(-1) * lz + (y * z).sum(-1) * lx
           + (z * x).sum(-1) * ly)
    return 2.0 * np.arctan2(num, den).sum(-1) / (4.0 * math.pi)


def test_padding_faces_add_exactly_zero():
    """A padding row (A = B = C = N = 0) adds exactly 0: through the plain
    formula on the packed form, atan2((A - q) . N, den) in torch, and
    through the kernel's arithmetic (the query at the origin is on the
    padding face's vertex)."""
    rng = np.random.default_rng(3)
    q = np.concatenate([(rng.random((200, 3)) - 0.5), np.zeros((1, 3))]).astype(f32)
    zero = np.zeros((5, 3), f32)
    packed = pack_model(zero, zero, zero)
    assert packed.shape == (pw.W_TILE, 12) and not packed.any()
    rows, qt = torch.from_numpy(packed), torch.from_numpy(q)[:, None]
    a, b, c = (rows[None, :, i:i + 3] - qt for i in (0, 4, 8))
    num = (a * rows[None, :, [3, 7, 11]]).sum(-1)
    la, lb, lc = (x.norm(dim=-1) for x in (a, b, c))
    den = (la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la
           + (c * a).sum(-1) * lb)
    plain = 2.0 * torch.atan2(num, den)
    assert (plain == 0).all() and (den[:-1] > 0).all() and (den[-1] == 0).all()
    assert (winding_model(q, zero, zero, zero) == 0).all()
    num, den, _ = pair_terms(q, packed)
    assert (num == 0).all() and (den[:-1] > 0).all() and (den[-1] == 0).all()


@pytest.fixture(scope="module")
def sphere():
    n = 33
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float64)
    vol = np.sqrt(((g - (n - 1) / 2) ** 2).sum(axis=0)) / ((n - 1) / 2) - 0.6
    verts, faces = marching_cubes(vol, 0.0)
    return (verts / (n - 1) - 0.5).astype(f32), faces.astype(np.int64)


def test_kernel_model_matches_plain_jax_and_float64(sphere):
    import jax.numpy as jnp

    verts, faces = sphere
    rng = np.random.default_rng(4)
    q = np.concatenate([(rng.random((300, 3)) - 0.5).astype(f32),
                        verts[rng.choice(verts.shape[0], 40, replace=False)],
                        np.zeros((1, 3), f32)])
    faces = np.concatenate([faces, faces[:30][:, [0, 0, 1]], faces[30:45][:, [0, 0, 0]]])
    a, b, c = (verts[faces[:, i]] for i in range(3))
    assert faces.shape[0] % pw.W_TILE  # a padded last tile
    model = winding_model(q, a, b, c)
    plain = pw.winding_plain(*(torch.from_numpy(x) for x in (q, a, b, c))).numpy()
    theirs = np.asarray(jwinding._winding_tiled(*(jnp.asarray(x) for x in (q, a, b, c))))
    ref = winding_f64(q, a, b, c)
    assert np.isfinite(model).all()
    np.testing.assert_allclose(model, plain, rtol=0, atol=MODEL_ATOL)
    np.testing.assert_allclose(model, theirs, rtol=0, atol=MODEL_ATOL)
    far = np.abs(plain - 0.5) > 1e-3
    assert np.array_equal((model > 0.5)[far], (plain > 0.5)[far])
    err, err_plain = np.abs(model - ref).max(), np.abs(plain - ref).max()
    assert err <= max(2 * err_plain, 1e-5), (err, err_plain)
    inside = np.linalg.norm(q[:300], axis=1) < 0.28
    assert inside.any() and np.abs(model[:300][inside] - 1).max() < 1e-3


def icosphere(level: int, radius: float):
    """A closed icosphere: the icosahedron split `level` times, 20 * 4^level
    faces, vertices on the sphere."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v.shape[0] + inv.reshape(3, -1).T  # midpoints of (01, 12, 20)
        v = np.concatenate([v, 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])])
        f = np.concatenate([np.stack([f[:, 0], mid[:, 0], mid[:, 2]], 1),
                            np.stack([mid[:, 0], f[:, 1], mid[:, 1]], 1),
                            np.stack([mid[:, 2], mid[:, 1], f[:, 2]], 1), mid])
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    return v.astype(f32), f


def near_vertex_queries(a, b, c, faces, rng):
    """Queries t edges from vertex B and from vertex C of the faces
    `faces`, t in 1e-2 ... 1e-5, from every direction of approach: along
    +-N, in the face's plane away from the face (the two edges at the
    vertex reversed, and the vertex minus the centroid), and from six
    random directions."""
    out = []
    for f in faces:
        p = np.stack([a[f], b[f], c[f]]).astype(np.float64)
        n = np.cross(p[1] - p[0], p[2] - p[0])
        n /= np.linalg.norm(n)
        edge = np.mean([np.linalg.norm(p[i] - p[i - 1]) for i in range(3)])
        for k in (1, 2):  # B, C
            vert = p[k]
            others = [p[j] for j in range(3) if j != k]
            dirs = [n, -n, vert - p.mean(0)] + [vert - o for o in others]
            dirs += list(rng.normal(size=(6, 3)))
            for d in dirs:
                d = d / np.linalg.norm(d)
                for t in (1e-2, 1e-3, 1e-4, 1e-5):
                    out.append(vert + t * edge * d)
    return np.asarray(out, f32)


def random_small_triangles(rng, n: int):
    """`n` triangles at random places in the unit cube, edges about 1/256."""
    centre = rng.uniform(-0.4, 0.4, (n, 1, 3))
    corners = centre + rng.normal(size=(n, 3, 3)) * (1 / 256 / 3 ** 0.5)
    return tuple(corners[:, i].astype(f32) for i in range(3))


@pytest.fixture(scope="module")
def near_vertex_cases():
    """(name, queries, a, b, c): a closed 5 120-face icosphere and 2 000
    random small triangles, each with queries near the B and C vertices of
    some faces."""
    rng = np.random.default_rng(5)
    verts, faces = icosphere(4, 0.3)
    a, b, c = (verts[faces[:, i]] for i in range(3))
    cases = [("icosphere", near_vertex_queries(a, b, c, rng.choice(len(faces), 6, False), rng),
              a, b, c)]
    a, b, c = random_small_triangles(rng, 2000)
    cases.append(("small triangles",
                  near_vertex_queries(a, b, c, rng.choice(len(a), 6, False), rng), a, b, c))
    return cases


def _near_vertex_errors(case, nearest: bool):
    """(|model - float64|, the limit max(2 |plain - float64|, 1e-5), inside
    masks differing where |plain - 0.5| > 1e-3) for one probe case."""
    _, q, a, b, c = case
    model = winding_model(q, a, b, c, nearest)
    plain = pw.winding_plain(*(torch.from_numpy(x) for x in (q, a, b, c))).numpy()
    ref = np.concatenate([winding_f64(q[i:i + 128], a, b, c) for i in range(0, len(q), 128)])
    far = np.abs(plain - 0.5) > 1e-3
    flips = int(((model > 0.5) != (plain > 0.5))[far].sum())
    err_plain = np.abs(plain - ref).max()
    return np.abs(model - ref).max(), max(2 * err_plain, 1e-5), flips


@pytest.mark.parametrize("which", [0, 1], ids=["icosphere", "small_triangles"])
def test_kernel_model_near_a_vertex(near_vertex_cases, which):
    """The near-vertex probe under the smoke's W1 limits: the numerator
    taken from the face vertex nearest the query stays within twice the
    plain version's distance from float64 (or 1e-5), and the inside masks
    agree wherever the plain version is clear of 0.5."""
    err, limit, flips = _near_vertex_errors(near_vertex_cases[which], nearest=True)
    assert err <= limit and flips == 0, (err, limit, flips)


def test_near_vertex_probe_catches_the_a_dot_n_numerator(near_vertex_cases):
    """The probe is sharp: the first design's a . N numerator breaks the
    float64 rule on both shapes."""
    for case in near_vertex_cases:
        err, limit, _ = _near_vertex_errors(case, nearest=False)
        assert err > limit, (case[0], err, limit)


def test_repair_bounds_mirror_the_kernel_text():
    cu = re.findall(r"(\w+) = (-?\d+\.\d*)f;", _marked(KERNEL, "//", "REPAIR BOUNDS"))
    py = re.findall(r"(\w+) = (-?\d+\.\d*)\n", _marked(MIRROR, "#", "REPAIR BOUNDS"))
    assert [(k.removeprefix("W1_"), v) for k, v in cu] == py and len(py) == 2
    assert [float(v) for _, v in py] == [pw.NUM_ERR_EPS, pw.EDGE]


def large_triangles(rng, n: int, radius: float = 0.3):
    """`n` triangles with vertices drawn uniformly on a sphere: faces across
    it, as smoke phase 13's soup."""
    pts = rng.normal(size=(3 * n, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * radius
    return tuple(pts[i::3].astype(f32) for i in range(3))


def inside_queries(a, b, c, faces, rng):
    """One f32 query inside each of the faces `faces`, at a random
    barycentric point: within f32 rounding of the face's plane."""
    w = rng.dirichlet([1.0, 1.0, 1.0], len(faces))
    return (w[:, :1] * a[faces].astype(np.float64) + w[:, 1:2] * b[faces]
            + w[:, 2:] * c[faces]).astype(f32)


def test_numerator_within_the_stated_bound():
    """|v . N - n*| <= NUM_ERR_EPS eps |v*||N| over 200 000 pairs with the
    query inside the face, within f32 rounding of its plane (n* the float64
    triple product of the f32 inputs, v* the exact difference vector of the
    nearest vertex): large faces across a sphere and small ones at random
    places. f32 gets the sign wrong at many of them, each within the bound,
    so the kernel's float64 step reaches every one."""
    rng = np.random.default_rng(8)
    tris = [np.concatenate(x) for x in zip(large_triangles(rng, 120_000),
                                           random_small_triangles(rng, 80_000))]
    q = inside_queries(*tris, np.arange(len(tris[0])), rng)
    faces = pack_model(*tris)[:len(q)]
    num, den, _ = _pair_terms(q, faces[:, 0:4], faces[:, 4:8], faces[:, 8:12])
    exact = num_f64(q, *(faces[:, i:i + 3].astype(np.float64) for i in (0, 4, 8)))
    near = np.min([np.linalg.norm(t.astype(np.float64) - q, axis=1) for t in tris], axis=0)
    scale = near * np.linalg.norm(faces[:, [3, 7, 11]].astype(np.float64), axis=1)
    err = np.abs(num.astype(np.float64) - exact) / (EPS * scale)
    wrong = np.sign(num) != np.sign(exact)
    assert wrong.sum() > 10_000 and (den[wrong] < 0).mean() > 0.99, (wrong.sum(),)
    assert err.max() <= pw.NUM_ERR_EPS, err.max()


def off_plane(q, a, b, c, faces) -> bool:
    """Whether every query lies off its face's plane in exact arithmetic:
    on the plane the winding number steps by one, and f32 and float64 may
    each take either side."""
    for qi, f in zip(q, faces):
        x, y, z = ([Fraction(float(t[f][i])) - Fraction(float(qi[i])) for i in range(3)]
                   for t in (a, b, c))
        if (x[0] * (y[1] * z[2] - y[2] * z[1]) + x[1] * (y[2] * z[0] - y[0] * z[2])
                + x[2] * (y[0] * z[1] - y[1] * z[0])) == 0:
            return False
    return True


@pytest.fixture(scope="module")
def near_plane_cases():
    """(name, queries, a, b, c): 300 f32 queries inside faces of a closed
    1 280-face icosphere, turned by a seeded rotation (the icosahedron's
    symmetric faces have planes that f32 points can lie on exactly), and
    of 1 000 large triangles across a sphere."""
    rng = np.random.default_rng(9)
    verts, faces = icosphere(3, 0.3)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    verts = (verts.astype(np.float64) @ rot).astype(f32)
    cases = []
    for name, (a, b, c) in (("icosphere", [verts[faces[:, i]] for i in range(3)]),
                            ("large triangles", large_triangles(rng, 1000))):
        picked = rng.choice(len(a), 300, False)
        q = inside_queries(a, b, c, picked, rng)
        assert off_plane(q, a, b, c, picked)
        cases.append((name, q, a, b, c))
    return cases


def _near_plane_errors(case, repaired: bool):
    _, q, a, b, c = case
    return np.abs(winding_model(q, a, b, c, repaired=repaired) - winding_f64(q, a, b, c))


@pytest.mark.parametrize("which", [0, 1], ids=["icosphere", "large_triangles"])
def test_kernel_model_near_a_plane(near_plane_cases, which):
    """The near-plane probe: at queries within f32 rounding of a face's
    plane, inside the face, the model is within W1_ATOL (1e-4) of float64
    at every query, with no whole turn lost (the plain version, an f32
    a . (b x c), is not held here: it loses turns as the JAX package does)."""
    err = _near_plane_errors(near_plane_cases[which], repaired=True)
    assert err.max() <= 1e-4, err.max()


def test_near_plane_probe_catches_the_parent_model(near_plane_cases):
    """The probe is sharp: the kernel before the repair (f32 normal, no
    float64 numerator) loses a whole turn on both shapes."""
    for case in near_plane_cases:
        err = _near_plane_errors(case, repaired=False)
        assert err.max() > 0.5, (case[0], err.max())


@pytest.fixture(scope="module")
def near_edge_case():
    """(queries, a, b, c): 1 000 large triangles across a sphere and 240 f32
    queries 1e-3 to 1e-6 edge lengths from a random point of an edge of one
    of them, in a random direction across the edge."""
    rng = np.random.default_rng(10)
    a, b, c = large_triangles(rng, 1000)
    out = []
    for f in rng.choice(len(a), 60, replace=False):
        p, r = (x[f].astype(np.float64) for x in rng.permutation([a, b, c])[:2])
        e = r - p
        side = np.cross(e, rng.normal(size=3))
        side /= np.linalg.norm(side)
        at = p + rng.uniform(0.1, 0.9) * e
        for t in (1e-3, 1e-4, 1e-5, 1e-6):
            out.append(at + t * np.linalg.norm(e) * side)
    return np.asarray(out, f32), a, b, c


def test_kernel_model_near_an_edge(near_edge_case, monkeypatch):
    """Near an edge n and d both cancel in f32: without the float64 terms
    (EDGE = 0) the model errs by over 1e-3 there; with them it is within
    1e-5 of float64 at every query."""
    q, a, b, c = near_edge_case
    ref = winding_f64(q, a, b, c)
    err = np.abs(winding_model(q, a, b, c) - ref).max()
    monkeypatch.setattr(pw, "EDGE", 0.0)
    err_f32 = np.abs(winding_model(q, a, b, c) - ref).max()
    assert err <= 1e-5 and err_f32 > 1e-3, (err, err_f32)
