"""Host side of the f32 K3, K4 and K5 on the tensor cores as 3xTF32
(`csrc/gmma.cuh`, `ops/wgmma_layout.py`, `ops/decoder_tail.py`,
`ops/pointnet_att.py`).

- The tf32 rounding model (`tf32_round`: round to nearest, ties away from
  zero, 10 mantissa bits, the low 13 bits cleared, as the kernels'
  `cvt.rna.tf32.f32` and mask) equals an independent float64 rounding on
  seeded data, rounds exact ties away from zero and keeps +-0; the split
  hi + lo equals x within 2^-22 |x|, and is exact for +-0.
- The f32 weight packs hold each weight's hi and lo exactly, slice by
  slice, in the swizzled K-major layout with the inputs of each group of
  8 in `TF32_K_ORDER`, in the order the kernels multiply them (K3 at
  latent 32: each weight's hi tile and lo tile at the kernel's offsets);
  an f32 call without its pack is refused before any launch.
- A numpy model of the latent-32 K3's register-fed products: thread t's
  accumulator fragment of one layer, taken as the next layer's A fragment
  of each k8 step ({v[4g], v[4g+2], v[4g+1], v[4g+3]}) against the
  pack's tiles, gives the product in true input order.
- A model of the kernels' products (the three terms hi x hi, hi x lo,
  lo x hi of each k8 step, each accumulated in f32) run through the
  plain versions at full width (K3 at L=256, 64 rows, and at L=32, k in
  {50, 64}; K4 and K5 at P in {50, 200}) on seeded queries meets the
  smoke's f32 limits against the
  plain f32 versions (max |diff| 1e-4, mean 2e-6, x max(1, max |plain|));
  the same model with one term (plain TF32) and with hi x lo dropped
  misses them, so the limits bite. The committed weights are f16 values,
  exact in tf32 (their lo is zero), so the model runs on them times (1 +
  1e-3 seeded noise), full f32 mantissas, as the smoke's f32 kernel
  checks do. K=3 products (K4's conv0a, K3's rel rows) stay f32 on the
  CUDA cores in the kernels and in the model.
"""
from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch

from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.models.norm import dense
from ppsurf_tpu_torch.ops import decoder_tail as dt_mod
from ppsurf_tpu_torch.ops import pointnet_att as pn
from ppsurf_tpu_torch.ops.patches import patch_space
from ppsurf_tpu_torch.ops.wgmma_layout import (
    TF32_K_ORDER, tf32_round, tf32_split, unswizzle_tile,
)
from ppsurf_tpu_torch.train.model import poco_spec, ppsurf_spec

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models_pretrained", "ppsurf_mini_infer.npz")
F32 = torch.float32
SLICE = 4096  # f32 values of one slice: the hi and the lo (64 x 32) tile
LIMITS = (1e-4, 2e-6)  # the smoke's f32 K3-K5 limits, x scale
TERMS = {"3xTF32": ("hl", "lh", "hh"), "1xTF32": ("hh",), "hi x lo dropped": ("lh", "hh")}


def _rna_f64(x: np.ndarray) -> np.ndarray:
    """Round f32 to 11 significant bits, ties away from zero, in float64."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    s = m * 2.0 ** 11
    return (np.sign(s) * np.floor(np.abs(s) + 0.5) * 2.0 ** (e - 11)).astype(np.float32)


def _seeded(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 10.0 ** rng.uniform(-30, 30, n)).astype(np.float32)


def test_tf32_round_matches_float64_rounding():
    x = _seeded(200000, 0)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_f64(x))
    assert not (got.view(np.uint32) & 0x1FFF).any()


def test_tf32_round_ties_away_and_zeros():
    rng = np.random.RandomState(1)
    bits = (rng.randint(0x00800000, 0x7F000000, 10000).astype(np.uint32) & ~np.uint32(0x1FFF)
            ) | np.uint32(0x1000)
    bits[::2] |= np.uint32(0x80000000)  # negative ties too
    x = bits.view(np.float32)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_f64(x))
    assert (np.abs(got) > np.abs(x)).all()  # away from zero
    zeros = np.array([0.0, -0.0], np.float32)
    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(zeros)))
    for v in (tf32_round(torch.from_numpy(zeros)).numpy(), hi):
        np.testing.assert_array_equal(v, zeros)
        np.testing.assert_array_equal(np.signbit(v), np.signbit(zeros))
    np.testing.assert_array_equal(lo, 0.0)  # -0 - (-0) is +0: the split is exact


def test_split_recovers_x_within_2_pow_minus_22():
    x = _seeded(200000, 2)
    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(x)))
    np.testing.assert_array_equal(hi, _rna_f64(x))
    np.testing.assert_array_equal(lo, _rna_f64(x - hi))  # x - hi is exact in f32
    assert not ((hi.view(np.uint32) | lo.view(np.uint32)) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x.astype(np.float64))
    assert err.max() <= 2.0 ** -22


# ---- the packs ----

def _net():
    return load_network(ppsurf_spec(dtype=F32), load_infer_npz(WEIGHTS), torch.device("cpu"))


def _unpack(pack: torch.Tensor, shapes, quarters):
    """(hi, lo) of each weight (in, out) of a 3xTF32 stream rebuilt from
    its slices: its column quarters in the order `quarters` gives, each
    over its K-chunks of 32 inputs in order; a slice's hi tile, then its
    lo tile."""
    weights, at = [], 0
    for (n_in, n_out), order in zip(shapes, quarters):
        assert sorted(order) == list(range(n_out // 64))
        hi, lo = torch.zeros(n_in, n_out), torch.zeros(n_in, n_out)
        for q in order:
            for kc in range(n_in // 32):
                inputs = [32 * kc + 8 * g + o for g in range(4) for o in TF32_K_ORDER]
                for part, out in ((0, hi), (1, lo)):
                    image = pack[at + part * SLICE // 2:at + (part + 1) * SLICE // 2]
                    out[inputs, 64 * q:64 * (q + 1)] = unswizzle_tile(image, 64).t()
                at += SLICE
        weights.append((hi, lo))
    assert at == pack.numel()
    return weights


def _check_split(w: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    x = w.numpy()
    np.testing.assert_array_equal(hi.numpy(), _rna_f64(x))
    np.testing.assert_array_equal(lo.numpy(), _rna_f64(x - hi.numpy()))
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())


def test_decoder_tail_pack_holds_hi_and_lo_of_each_weight():
    t = dt_mod.decoder_tables(_net().projection, F32)
    assert t.wpack.dtype == F32 and t.wpack.numel() * 4 == 104 * 16384
    assert torch.equal(t.wpack, dt_mod.pack_tf32x3_weights(t.w2, t.w3, t.wq, t.wv))
    ws = (t.w2, t.w3, t.wq, t.wv)
    quarters = ((0, 1, 2, 3), (0, 1, 2, 3), (0,), (0, 1, 2, 3))
    for w, (hi, lo) in zip(ws, _unpack(t.wpack, [tuple(w.shape) for w in ws], quarters)):
        _check_split(w, hi, lo)


def test_head_pack_holds_hi_and_lo_of_each_weight():
    t = pn.pointnet_tables(_net().point_net)
    assert t.head_pack.numel() * 4 == 54 * 16384
    ws = (*t.head_w[:3], t.head_w[4])
    # a layer's quarters beyond its input width first: conv2 (64 inputs)
    # quarter 1, conv3 (128 inputs) quarters 2 and 3
    quarters = ((0,), (1, 0), (2, 3, 0, 1), (0, 1, 2, 3))
    assert pn.HEAD_QUARTERS == quarters
    for w, (hi, lo) in zip(ws, _unpack(t.head_pack, [tuple(w.shape) for w in ws], quarters)):
        _check_split(w, hi, lo)


def test_trunk_pack_holds_hi_and_lo_of_each_weight():
    t = pn.pointnet_tables(_net().point_net)
    assert t.trunk_pack.dtype == F32 and t.trunk_pack.numel() * 4 == 24 * 16384
    assert torch.equal(t.trunk_pack, pn.pack_trunk_tf32x3(*t.trunk_w[1:]))
    ws = t.trunk_w[1:]  # conv0b, stn conv1-3; conv0a (K=3) stays on the CUDA cores
    # stn conv2 (64 inputs) writes its quarter 1 first; stn conv3's output
    # is never stored, so its quarters come in order
    quarters = ((0,), (0,), (1, 0), (0, 1, 2, 3))
    assert pn.TRUNK_QUARTERS == quarters
    for w, (hi, lo) in zip(ws, _unpack(t.trunk_pack, [tuple(w.shape) for w in ws], quarters)):
        _check_split(w, hi, lo)


def _poco_tables():
    """POCO's latent-32 decoder tables in f32 from seeded weights (full
    f32 mantissas) with seeded nonzero biases."""
    proj = load_network(poco_spec(dtype=F32), init_variables(poco_spec(), seed=0),
                        torch.device("cpu")).projection
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for layer in (proj.fc2, proj.fc3, proj.fc_query, proj.fc_value):
            layer.bias.copy_(torch.from_numpy(0.1 * rng.randn(*layer.bias.shape)))
    return dt_mod.decoder_tables(proj, F32)


def test_l32_pack_holds_hi_and_lo_of_each_weight():
    t = _poco_tables()
    assert t.wpack.dtype == F32 and t.wpack.numel() * 4 == 40960
    assert torch.equal(t.wpack, dt_mod.pack_l32_tf32x3(t.w2, t.w3, t.wq, t.wv))
    inputs = [8 * g + o for g in range(4) for o in TF32_K_ORDER]
    # the kernel's offsets (bytes) of each weight's hi tile; its lo tile
    # follows, (out columns x 128 bytes) later
    for at, w in ((0, t.w2), (8192, t.w3), (16384, t.wq), (32768, t.wv)):
        n_out = w.shape[1]
        hi, lo = torch.zeros(32, n_out), torch.zeros(32, n_out)
        for part, out in ((0, hi), (1, lo)):
            start = at // 4 + part * n_out * 32
            out[inputs] = unswizzle_tile(t.wpack[start:start + n_out * 32], n_out).t()
        _check_split(w, hi, lo)
    assert not tf32_split(t.w2)[1].eq(0).all()  # the seeded weights have full mantissas


def test_register_fed_a_fragments_give_the_product_in_input_order():
    """The kernel's m64nNk8 products, modelled lane by lane: thread t
    (warp w = t / 32, lane l) holds v[4g + e] = V[r0 + 8 (e / 2), 8g + cl
    + e % 2] of the previous layer's (64 x 32) output V, r0 = 16w + l / 4,
    cl = 2 (l % 4); its A fragment of step g is {v[4g], v[4g + 2], v[4g +
    1], v[4g + 3]}, a[i] at row r0 + 8 (i % 2), logical column l % 4 + 4
    (i / 2), and logical column j multiplies the tile's K row j."""
    t = _poco_tables()
    rng = np.random.RandomState(11)
    v_mat = rng.randn(64, 32)
    for at, w in ((0, t.w2), (16384, t.wq)):
        n_out = w.shape[1]
        tiles = [unswizzle_tile(t.wpack[at // 4 + p * n_out * 32:
                                        at // 4 + (p + 1) * n_out * 32], n_out).double()
                 for p in (0, 1)]
        b = (tiles[0] + tiles[1]).numpy()  # (n_out, 32): hi + lo, K in tile order
        d = np.zeros((64, n_out))
        for thread in range(128):
            warp, lane = divmod(thread, 32)
            r0, cl = 16 * warp + lane // 4, 2 * (lane % 4)
            v = [v_mat[r0 + 8 * (e // 2), 8 * g + cl + e % 2] for g in range(4) for e in range(4)]
            for g in range(4):
                a = (v[4 * g], v[4 * g + 2], v[4 * g + 1], v[4 * g + 3])
                for i in range(4):
                    row, col = r0 + 8 * (i % 2), lane % 4 + 4 * (i // 2)
                    d[row] += a[i] * b[:, 8 * g + col]
        # each (row, k step) is fed by the 4 lanes of its quad once each
        hi, lo = tf32_split(w)
        want = v_mat @ (hi.double() + lo.double()).numpy()
        np.testing.assert_allclose(d, want, rtol=1e-12, atol=1e-12)


def test_f32_calls_without_their_pack_are_refused():
    net = _net()
    t = dt_mod.decoder_tables(net.projection, F32)
    with pytest.raises(ValueError, match="wpack"):
        dt_mod._check(t, 256, 64)  # its pack, but on the CPU
    t.wpack = types.SimpleNamespace(is_cuda=True)  # stands for the pack on the card
    dt_mod._check(t, 256, 64)
    t.wpack = None
    with pytest.raises(ValueError, match="wpack"):
        dt_mod._check(t, 256, 64)
    t32 = _poco_tables()
    with pytest.raises(ValueError, match="wpack"):
        dt_mod._check(t32, 32, 64)  # its pack, but on the CPU
    t32.wpack = types.SimpleNamespace(is_cuda=True)
    dt_mod._check(t32, 32, 64)
    t32.wpack = None
    for k in (1, 50, 64):
        with pytest.raises(ValueError, match="wpack"):
            dt_mod._check(t32, 32, k)
    tabs = pn.pointnet_tables(net.point_net)
    tabs.head_pack = None
    with pytest.raises(ValueError, match="weight pack"):
        pn._check(tabs, 50, "pointnet_head", {}, tabs.head_pack)
    tabs.trunk_pack = None
    for p in (50, 200):
        with pytest.raises(ValueError, match="weight pack"):
            pn._check(tabs, p, "pointnet_trunk", {}, tabs.trunk_pack)


# ---- the products' model against the plain versions ----

def tf32x3_matmul(x: torch.Tensor, w: torch.Tensor, terms) -> torch.Tensor:
    """x (..., K) @ w (K, N) as the kernels multiply: each k8 step's
    `terms` ("hl": hi_x lo_w, "lh": lo_x hi_w, "hh": hi_x hi_w), each
    exact product added to an f32 accumulator."""
    parts = {"x": tf32_split(x.float()), "w": tf32_split(w.float())}
    k = w.shape[0]
    rows = x.reshape(-1, k)
    xs = [p.reshape(rows.shape) for p in parts["x"]]
    acc = torch.zeros(rows.shape[0], w.shape[1])
    for g in range(0, k, 8):
        for term in terms:
            a = xs[0 if term[0] == "h" else 1][:, g:g + 8].double()
            b = parts["w"][0 if term[1] == "h" else 1][g:g + 8].double()
            acc = (acc.double() + a @ b).float()
    return acc.reshape(*x.shape[:-1], w.shape[1])


def _model_dense(terms):
    def model(x, kernel, bias, dt):
        # K5's fc_query (an f32 dot product) and K4's conv0a (K=3) run on
        # the CUDA cores
        if kernel.shape[1] == 1 or kernel.shape[0] == 3:
            return dense(x, kernel, bias, dt)
        y = tf32x3_matmul(x, kernel, terms)
        return y if bias is None else y + bias.float()
    return model


def _errors(out: torch.Tensor, ref: torch.Tensor):
    scale = max(1.0, float(ref.abs().max()))
    d = (out - ref).abs()
    return float(d.max()) / scale, float(d.mean()) / scale


def _full_mantissas(w: torch.Tensor, rng) -> torch.Tensor:
    return (w * torch.from_numpy(1 + 1e-3 * rng.randn(*w.shape).astype(np.float32)))


def test_committed_weights_are_exact_in_tf32():
    t = dt_mod.decoder_tables(_net().projection, F32)
    for w in (t.w2, t.w3, t.wq, t.wv):
        assert torch.equal(tf32_round(w), w)


@pytest.fixture(scope="module")
def k3_case():
    net = _net()
    rng = np.random.RandomState(3)
    t = dt_mod.decoder_tables(net.projection, F32)
    t.w2, t.w3, t.wq, t.wv = (_full_mantissas(w, rng) for w in (t.w2, t.w3, t.wq, t.wv))
    n, c = 2000, 200
    latents = torch.from_numpy(rng.randn(n, 256).astype(np.float32))
    pts = torch.from_numpy(rng.rand(n, 3).astype(np.float32) - 0.5)
    queries = torch.from_numpy(rng.rand(c, 3).astype(np.float32) - 0.5)
    ids = torch.from_numpy(rng.randint(0, n, (c, 64)))
    args = (latents, pts, queries, ids, t)
    return args, dt_mod.decoder_tail_plain(*args)


@pytest.fixture(scope="module")
def k5_cases():
    net = _net()
    rng = np.random.RandomState(4)
    t = pn.pointnet_tables(net.point_net)
    t.head_w = tuple(_full_mantissas(w, rng) for w in t.head_w)
    cases = {}
    for p in (50, 200):
        c = 200
        cloud = torch.from_numpy(rng.rand(4000, 3).astype(np.float32) - 0.5)
        q = torch.from_numpy(rng.rand(c, 3).astype(np.float32) - 0.5)
        near = torch.cdist(q, cloud).topk(p, largest=False).indices
        b, pooled = pn.pointnet_trunk_plain(patch_space(cloud[near], q), t)
        x2 = pn.stn_apply(pooled, b, t)
        cases[p] = (x2, t), pn.pointnet_head_plain(x2, t)
    return cases


@pytest.mark.parametrize("variant", list(TERMS))
def test_k3_product_model_against_the_limits(k3_case, variant, monkeypatch):
    args, ref = k3_case
    monkeypatch.setattr(dt_mod, "dense", _model_dense(TERMS[variant]))
    err = _errors(dt_mod.decoder_tail_plain(*args), ref)
    within = err[0] <= LIMITS[0] and err[1] <= LIMITS[1]
    assert within == (variant == "3xTF32"), (variant, err)


@pytest.mark.parametrize("p", (50, 200))
@pytest.mark.parametrize("variant", list(TERMS))
def test_k5_product_model_against_the_limits(k5_cases, p, variant, monkeypatch):
    args, ref = k5_cases[p]
    monkeypatch.setattr(pn, "dense", _model_dense(TERMS[variant]))
    err = _errors(pn.pointnet_head_plain(*args), ref)
    within = err[0] <= LIMITS[0] and err[1] <= LIMITS[1]
    assert within == (variant == "3xTF32"), (variant, err)


@pytest.fixture(scope="module")
def k4_cases():
    net = _net()
    rng = np.random.RandomState(5)
    t = pn.pointnet_tables(net.point_net)
    t.trunk_w = tuple(_full_mantissas(w, rng) for w in t.trunk_w)
    cases = {}
    for p in (50, 200):
        c = 200
        cloud = torch.from_numpy(rng.rand(4000, 3).astype(np.float32) - 0.5)
        q = torch.from_numpy(rng.rand(c, 3).astype(np.float32) - 0.5)
        near = torch.cdist(q, cloud).topk(p, largest=False).indices
        patches = patch_space(cloud[near], q)
        cases[p] = (patches, t), pn.pointnet_trunk_plain(patches, t)
    return cases


@pytest.mark.parametrize("p", (50, 200))
@pytest.mark.parametrize("variant", list(TERMS))
def test_k4_product_model_against_the_limits(k4_cases, p, variant, monkeypatch):
    args, (b_ref, pooled_ref) = k4_cases[p]
    monkeypatch.setattr(pn, "dense", _model_dense(TERMS[variant]))
    b, pooled = pn.pointnet_trunk_plain(*args)
    out, ref = torch.cat([b.flatten(), pooled.flatten()]), torch.cat([b_ref.flatten(),
                                                                      pooled_ref.flatten()])
    err = _errors(out, ref)
    within = err[0] <= LIMITS[0] and err[1] <= LIMITS[1]
    assert within == (variant == "3xTF32"), (variant, err)


@pytest.fixture(scope="module")
def k3_l32_cases():
    t = _poco_tables()
    rng = np.random.RandomState(6)
    n, c = 2000, 200
    latents = torch.from_numpy(rng.randn(n, 32).astype(np.float32))
    pts = torch.from_numpy(rng.rand(n, 3).astype(np.float32) - 0.5)
    queries = torch.from_numpy(rng.rand(c, 3).astype(np.float32) - 0.5)
    ids = torch.from_numpy(rng.randint(0, n, (c, 64)))
    cases = {}
    for k in (50, 64):
        args = (latents, pts, queries, ids[:, :k].contiguous(), t)
        cases[k] = args, dt_mod.decoder_tail_plain(*args)
    return cases


@pytest.mark.parametrize("k", (50, 64))
@pytest.mark.parametrize("variant", list(TERMS))
def test_k3_l32_product_model_against_the_limits(k3_l32_cases, k, variant, monkeypatch):
    args, ref = k3_l32_cases[k]
    monkeypatch.setattr(dt_mod, "dense", _model_dense(TERMS[variant]))
    err = _errors(dt_mod.decoder_tail_plain(*args), ref)
    within = err[0] <= LIMITS[0] and err[1] <= LIMITS[1]
    assert within == (variant == "3xTF32"), (variant, err)
