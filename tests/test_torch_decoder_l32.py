"""Host side of the latent-32 bf16 K3 (`ppsurf_tpu_torch/ops/decoder_tail.py`,
`decoder_tail_narrow_wgmma_kernel` in `csrc/decoder_tail.cu`), POCO's
decoder tail on the tensor cores.

- The 20 KB weight pack holds W2, W3, Wq and Wv exactly, each as one
  swizzled K-major tile whose K of 32 is padded with zeros, at the offsets
  the kernel reads; `decoder_tables` makes it in bf16 (in f32 the 3xTF32
  pack, `tests/test_torch_tf32x3.py`).
- A bf16 call at latent 32 without its pack is refused before any launch.
- A model of the kernel's arithmetic and reduction order over the `wgmma`
  accumulator fragments (thread t of a warpgroup holds rows
  16 (t / 32) + (t % 32) / 4 and 8 more, columns 8j + 2 (t % 4) + e), its
  reduce-scatter over the 8 row lanes and its sums over the 4 warps, equals
  `decoder_tail_plain` within the smoke's bf16 limits at k in {1, 33, 64}:
  rows past k repeat neighbour 0, get -inf logits and weight 0.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from ppsurf_tpu_torch.convert.infer_npz import load_network
from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.ops import decoder_tail as dt_mod
from ppsurf_tpu_torch.ops.wgmma_layout import unswizzle_tile
from ppsurf_tpu_torch.train.model import poco_spec

BF16 = torch.bfloat16
LAT, HEADS, ROWS = 32, 64, 64


def _tables(dt):
    """POCO's decoder tables from seeded weights, with seeded nonzero
    biases (flax initialises them to zero, which would hide the rounding
    of a dense output before its bias)."""
    net = load_network(poco_spec(dtype=dt), init_variables(poco_spec(), seed=0),
                       torch.device("cpu"))
    proj = net.projection
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for layer in (proj.fc2, proj.fc3, proj.fc_query, proj.fc_value):
            layer.bias.copy_(torch.from_numpy(0.1 * rng.randn(*layer.bias.shape)))
    return dt_mod.decoder_tables(proj, dt)


def _rnd(x):
    return x.to(BF16).float()


def test_l32_pack_holds_the_weights_exactly():
    rng = np.random.RandomState(0)
    w2, w3, wv = (torch.from_numpy(rng.randn(LAT, LAT).astype(np.float32)).to(BF16)
                  for _ in range(3))
    wq = torch.from_numpy(rng.randn(LAT, HEADS).astype(np.float32)).to(BF16)
    pack = dt_mod.pack_l32_weights(w2, w3, wq, wv)
    assert pack.dtype == BF16 and pack.numel() * 2 == 20480
    # the kernel's offsets (bytes): W2 0, W3 4096, Wq 8192, Wv 16384
    for at, w, rows in ((0, w2, LAT), (4096, w3, LAT), (8192, wq, HEADS), (16384, wv, LAT)):
        tile = unswizzle_tile(pack[at // 2:at // 2 + rows * 64], rows)
        assert torch.equal(tile[:, :LAT], w.t())
        assert not tile[:, LAT:].float().abs().sum()  # the padded inputs are zero
    # the 128-byte swizzle: row r's 16-byte unit u at unit u ^ (r % 8)
    units = pack[2048:4096].view(LAT, 8, 8)  # W3, from byte 4096
    for r, u in ((0, 0), (5, 3), (13, 1), (31, 2)):
        assert torch.equal(units[r, u ^ (r % 8)], w3[8 * u:8 * u + 8, r])


@pytest.mark.parametrize("dt", [BF16, torch.float32])
def test_tables_make_the_l32_pack_in_bf16_only(dt):
    t = _tables(dt)
    assert (t.w2.shape, t.wq.shape) == ((LAT, LAT), (LAT, HEADS))
    if dt == torch.float32:  # the f32 build's 3xTF32 pack (tests/test_torch_tf32x3.py)
        assert torch.equal(t.wpack, dt_mod.pack_l32_tf32x3(t.w2, t.w3, t.wq, t.wv))
        return
    assert torch.equal(t.wpack, dt_mod.pack_l32_weights(t.w2, t.w3, t.wq, t.wv))


def test_bf16_l32_call_without_its_pack_is_refused():
    t = _tables(BF16)
    with pytest.raises(ValueError, match="wpack"):
        dt_mod._check(t, LAT, 64)  # its pack, but on the CPU
    pack = t.wpack
    t.wpack = types.SimpleNamespace(is_cuda=True)  # stands for the pack on the card
    dt_mod._check(t, LAT, 64)  # accepted
    t.wpack = None
    with pytest.raises(ValueError, match="wpack"):
        dt_mod._check(t, LAT, 64)
    t.wpack = pack
    with pytest.raises(ValueError, match="1 <= k <= 64"):
        dt_mod._check(_tables(BF16), LAT, 65)


# ---- the kernel's arithmetic in its order ----

WARP = torch.arange(4)[:, None]  # (4, 1)
GROUP = torch.arange(8)[None, :]  # (1, 8): lane / 4, the row within a warp's 8


def _rows_then_warps(x):
    """The kernel's column sum of x (C, 64 rows, N) in f32: each thread's
    rows r0 + 8 rs summed, the reduce-scatter over the 8 row lanes (lane
    bits 4, 3, 2: partners g ^ 4, then g ^ 2, then g ^ 1), then the 4
    warps in order."""
    r0 = 16 * WARP + GROUP  # (4, 8)
    t = x[:, r0] + x[:, r0 + 8]  # (C, 4, 8, N)
    b = t[:, :, :4] + t[:, :, 4:]  # partners g ^ 4
    a = b[:, :, :2] + b[:, :, 2:]  # g ^ 2
    w = a[:, :, 0] + a[:, :, 1]  # g ^ 1 -> (C, 4, N)
    return ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]


def l32_model(latents, pts, queries, ids, t: dt_mod.DecoderTables):
    """`decoder_tail_narrow_wgmma_kernel` in torch: (C, 32) bf16."""
    c, k = ids.shape
    rows = torch.tensor(list(range(k)) + [0] * (ROWS - k))
    nid = ids[:, rows]  # (C, 64): rows past k repeat neighbour 0
    real = torch.arange(ROWS) < k
    rel = _rnd(queries[:, None, :] - pts[nid])
    w1 = t.w1.float()
    # rnd(fma(rel2, wc, fma(rel1, wb, rel0 * wa))), in f64 to stand for the
    # fused multiply-adds, then rounded
    rw = _rnd((rel[..., 2:3].double() * w1[2].double()
               + (rel[..., 1:2].double() * w1[1].double()
                  + (rel[..., 0:1] * w1[0]).double())).float())
    h = torch.relu(_rnd(latents[nid].float() + rw))

    def dense(x, w, b):  # bf16 operands, f32 product, the dense epilogue
        return _rnd(_rnd(torch.matmul(x, w.float())) + b)

    h = torch.relu(dense(h, t.w2, t.b2))
    h = torch.relu(dense(h, t.w3, t.b3))
    logit = dense(h, t.wq, t.bq).masked_fill(~real[None, :, None], -torch.inf)  # (C, 64, 64)
    value = dense(h, t.wv, t.bv)  # (C, 64, 32)
    m = logit.amax(dim=1, keepdim=True)
    e = torch.where(real[None, :, None], _rnd(torch.exp(_rnd(logit - m))),
                    torch.zeros(()))
    s = _rnd(_rows_then_warps(e))  # (C, 64 heads)
    att = _rnd(e / s[:, None, :])
    # a row's mean: each quad lane over its 16 heads (columns 8j + 2c, +1
    # for j in order), then lanes c ^ 1, then c ^ 2
    heads = torch.tensor([[8 * j + 2 * cq + e_ for j in range(8) for e_ in range(2)]
                          for cq in range(4)])  # (4, 16)
    part = torch.zeros(c, ROWS, 4)
    for cq in range(4):
        for hd in heads[cq]:
            part[:, :, cq] = part[:, :, cq] + att[:, :, hd]
    mean = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    a = torch.where(real[None, :], _rnd(mean / HEADS), torch.zeros(()))  # (C, 64)
    weighted = a[..., None] * value  # each product rounded to f32, then the rows' sums
    return _rows_then_warps(weighted).to(BF16)


@pytest.mark.parametrize("k", [1, 33, 64])
def test_l32_model_equals_the_plain_version(k):
    t = _tables(BF16)
    rng = np.random.RandomState(k)
    n, c = 300, 40
    pts = torch.from_numpy(rng.rand(n, 3).astype(np.float32))
    queries = torch.from_numpy(rng.rand(c, 3).astype(np.float32))
    latents = torch.from_numpy(rng.randn(n, LAT).astype(np.float32)).to(BF16)
    ids = torch.from_numpy(np.stack([rng.choice(n, k, replace=False) for _ in range(c)]))
    plain = dt_mod.decoder_tail_plain(latents, pts, queries, ids, t).float()
    model = l32_model(latents, pts, queries, ids, t).float()
    assert torch.isfinite(model).all()
    # the smoke's bf16 limits: max and mean |model - plain| within 1.6e-2
    # and 2e-6 of scale = max(1, max |plain|)
    scale = max(1.0, float(plain.abs().max()))
    diff = (model - plain).abs()
    assert float(diff.max()) <= 1.6e-2 * scale
    assert float(diff.mean()) <= 2e-6 * scale
