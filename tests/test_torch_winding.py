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
- `pack_faces`: N = (B - A) x (C - A), the row layout, zero rows up to
  whole tiles; a padding face adds exactly 0 through the plain formula on
  the packed form and through the kernel's arithmetic;
- the kernel's pair loop (packed faces, the numerator from the face
  vertex nearest the query, per-tile sums, the general path for every
  pair, whose bits the fast path gives) on a closed sphere mesh with
  queries on vertices and degenerate faces, within 1e-5 of `winding_plain`
  and of the JAX package's `_winding_tiled`, and no further from float64
  than twice the plain version (or 1e-5): the smoke's W1 limits, here on
  the model;
- a near-vertex probe under the same limits: queries 1e-2 to 1e-5 edges
  from a face's B or C, from every direction, on a closed icosphere and
  on small random triangles; the first design's a . N numerator fails it.
W1 itself against its plain version is in `tests/test_torch_package.py`
(marked `cuda`) and `chip_smoke.py` phase 13.
"""
from __future__ import annotations

import math
import os
import re

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
HALF_PI, PI = f32(math.pi / 2), f32(math.pi)


def _marked(path: str, comment: str) -> str:
    with open(path) as fp:
        text = fp.read()
    return text[text.index(f"{comment} BEGIN W1 ATAN COEFFS"):
                text.index(f"{comment} END W1 ATAN COEFFS")]


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
    n = torch.linalg.cross(torch.from_numpy(b - a), torch.from_numpy(c - a)).numpy()
    np.testing.assert_array_equal(packed[:300, 0:3], a)
    np.testing.assert_array_equal(packed[:300, 4:7], b)
    np.testing.assert_array_equal(packed[:300, 8:11], c)
    np.testing.assert_array_equal(packed[:300, [3, 7, 11]], n)
    np.testing.assert_allclose(packed[:300, [3, 7, 11]], np.cross(b - a, c - a), rtol=1e-5,
                               atol=1e-5)
    assert not packed[300:].any()
    assert pack_model(a[:128], b[:128], c[:128]).shape == (128, 12)
    assert pack_model(*(np.zeros((0, 3), f32),) * 3).shape == (0, 12)


def pair_terms(q, faces, nearest: bool = True):
    """The kernel's `pair_terms`: numerator and denominator for every
    (query, face) pair, (Q, F) each. The numerator is v . N with v the
    difference vector of the face vertex nearest the query (ties to A, then
    B); `nearest=False` is the first design's a . N, which the near-vertex
    probe must catch."""
    q = q[:, None, :]
    pa, pb, pc = faces[None, :, 0:4], faces[None, :, 4:8], faces[None, :, 8:12]
    a = (pa[..., :3] - q).astype(f32)
    b = (pb[..., :3] - q).astype(f32)
    c = (pc[..., :3] - q).astype(f32)

    def dot(u, v):
        return fma(u[..., 2], v[..., 2], fma(u[..., 1], v[..., 1],
                                             (u[..., 0] * v[..., 0]).astype(f32)))

    la, lb, lc = (np.sqrt(dot(x, x)).astype(f32) for x in (a, b, c))
    nrm = np.stack([pa[..., 3], pb[..., 3], pc[..., 3]], axis=-1)
    v = a
    if nearest:
        take_b = lb < la
        v = np.where(take_b[..., None], b, a)
        v = np.where((lc < np.where(take_b, lb, la))[..., None], c, v)
    num = dot(v, nrm)
    ab, bc, ca = dot(a, b), dot(b, c), dot(c, a)
    den = fma(ca, lb, fma(bc, la, fma(lc, fma(la, lb, ab), f32(0))))
    return num, den


def winding_model(q, a, b, c, nearest: bool = True):
    """W1's arithmetic: packed faces, per-tile f32 sums of the fused
    arctangent steps added into a running total, divided by 2 pi. One
    split (the kernel adds the splits' totals in split order, in f64). A query on
    a vertex takes that vertex's zero difference vector as v, so its
    numerator is exactly +-0, as the plain version's is."""
    faces = pack_model(a, b, c)
    total = np.zeros(q.shape[0], f32)
    for t in range(0, faces.shape[0], pw.W_TILE):
        num, den = pair_terms(q, faces[t:t + pw.W_TILE], nearest)
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
    num, den = pair_terms(q, packed)
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
