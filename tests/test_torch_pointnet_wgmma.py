"""Host side of the tensor-core K4 and K5 (`ppsurf_tpu_torch/ops/pointnet_att.py`,
`csrc/pointnet.cu`) and of the weight layout they share with K3.

- The bf16 weight packs hold every weight exactly, tile by tile, in the
  swizzled K-major operand layout of `csrc/gmma.cuh`, at the offsets the
  kernels read; `pointnet_tables` makes them in bf16 (in f32 the 3xTF32
  packs of K4 and K5, `tests/test_torch_tf32x3.py`).
- K3's pack (`ops/decoder_tail.py`) is byte for byte what it was before
  the swizzle helpers moved to `ops/wgmma_layout.py`.
- A model of the kernels' reductions over the `wgmma` accumulator
  fragments (thread t of a warpgroup holds rows 16 (t / 32) + (t % 32) / 4
  and 8 more, columns 8j + 2 (t % 4) + e) equals the plain version exactly:
  K4's max over 64 rows whose rows >= P repeat row 0, and K5's
  row-masked softmax with its f32 attention-weighted sum over lane
  shuffles and per-warp partials. For K5 the inputs are bf16 values whose
  f32 sums are exact in any order (logits within 4 of each other, values
  small integers), so the comparison sees the model's masking, row
  mapping and rounding, not the order of the sums.
- A bf16 call without its pack is refused before any launch.
- A model of the cluster K5 (P > 64: a patch's tiles on the CTAs of a
  thread-block cluster) equals `pointnet_head_plain` within the smoke's
  bf16 limits at every cluster size and with last tiles of 1 to 64 rows:
  each tile's logits, one max and sum over all tiles' rows in every warp
  (lane l: rows l + 32i), each tile's weighted values summed over its
  fragments and warps, the tiles' sums added in tile order.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
from ppsurf_tpu_torch.ops import pointnet_att as pn
from ppsurf_tpu_torch.ops.decoder_tail import pack_wgmma_weights
from ppsurf_tpu_torch.ops.wgmma_layout import unswizzle_tile
from ppsurf_tpu_torch.train.model import ppsurf_spec

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models_pretrained", "ppsurf_mini_infer.npz")
BF16 = torch.bfloat16
TILE = 4096  # bf16 elements of one (64 x 64) tile


def _weights(rng, shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(BF16) for s in shapes]


def _tables(dt):
    net = load_network(ppsurf_spec(dtype=dt), load_infer_npz(WEIGHTS), torch.device("cpu"))
    return pn.pointnet_tables(net.point_net)


def _rnd(x):
    return x.to(BF16).float()


def test_trunk_pack_holds_the_weights_exactly():
    w0b, ws1, ws2, ws3 = _weights(np.random.RandomState(0),
                                  [(64, 64), (64, 64), (64, 128), (128, 256)])
    pack = pn.pack_trunk_weights(w0b, ws1, ws2, ws3)
    assert pack.dtype == BF16 and pack.numel() * 2 == 96 * 1024
    assert torch.equal(unswizzle_tile(pack[:TILE], 64), w0b.t())
    assert torch.equal(unswizzle_tile(pack[TILE:2 * TILE], 64), ws1.t())
    assert torch.equal(unswizzle_tile(pack[2 * TILE:4 * TILE], 128), ws2.t())
    for h in range(2):
        for k in range(2):  # the kernel's tile 4 + 2 (2h + k), 16 KB each
            at = (4 + 2 * (2 * h + k)) * TILE
            assert torch.equal(unswizzle_tile(pack[at:at + 2 * TILE], 128),
                               ws3[64 * k:64 * (k + 1), 128 * h:128 * (h + 1)].t())


def test_head_pack_holds_the_weights_exactly():
    wc1, wc2, wc3, wv = _weights(np.random.RandomState(1),
                                 [(64, 64), (64, 128), (128, 256), (256, 256)])
    pack = pn.pack_head_weights(wc1, wc2, wc3, wv)
    assert pack.dtype == BF16 and pack.numel() * 2 == 8192 + 13 * 16384

    def slice_(i):  # slice i of the stream: 8 KB first, then 16 KB each
        at = 0 if i == 0 else TILE + (i - 1) * 2 * TILE
        return pack[at:at + (TILE if i == 0 else 2 * TILE)]

    assert torch.equal(unswizzle_tile(slice_(0), 64), wc1.t())
    assert torch.equal(unswizzle_tile(slice_(1), 128), wc2.t())
    for first, w, ktiles in ((2, wc3, 2), (6, wv, 4)):
        for h in range(2):
            for k in range(ktiles):
                assert torch.equal(unswizzle_tile(slice_(first + ktiles * h + k), 128),
                                   w[64 * k:64 * (k + 1), 128 * h:128 * (h + 1)].t())
    # the layout `csrc/gmma.cuh::swizzle_offset` describes: row r's 16-byte
    # unit u at unit u ^ (r % 8)
    units = slice_(1).view(128, 8, 8)
    for r, u in ((0, 0), (5, 3), (77, 6), (127, 7)):
        assert torch.equal(units[r, u ^ (r % 8)], wc2[8 * u:8 * u + 8, r])


@pytest.mark.parametrize("dt", [BF16, torch.float32])
def test_tables_make_the_packs_in_bf16_only(dt):
    t = _tables(dt)
    if dt == torch.float32:  # the f32 K4 and K5 stream their 3xTF32 packs
        assert torch.equal(t.trunk_pack, pn.pack_trunk_tf32x3(*t.trunk_w[1:]))
        assert torch.equal(t.head_pack, pn.pack_head_tf32x3(*t.head_w[:3], t.head_w[4]))
        return
    assert torch.equal(t.trunk_pack, pn.pack_trunk_weights(*t.trunk_w[1:]))
    assert torch.equal(t.head_pack, pn.pack_head_weights(*t.head_w[:3], t.head_w[4]))


def test_decoder_tail_pack_is_byte_identical():
    rng = np.random.RandomState(0)
    w2, w3, wv = _weights(rng, [(256, 256)] * 3)
    (wq,) = _weights(rng, [(256, 64)])
    pack = pack_wgmma_weights(w2, w3, wq, wv)
    # the sha256 of this pack as the K3 kernel was first built with it
    digest = hashlib.sha256(pack.view(torch.int16).numpy().tobytes()).hexdigest()
    assert digest == "088ce2f6d985977cf262235da7c0da085a9e805df284560775e8207d1814bdd6"
    # and the same bytes from the layout's definition, element by element
    want = []
    for w, blocks in ((w2, 128), (w3, 128)):
        want += [(w, h, k, blocks) for h in range(2) for k in range(4)]
    want += [(wq, 0, k, 64) for k in range(4)]
    want += [(wv, h, k, 128) for h in range(2) for k in range(4)]
    out = np.empty(pack.numel(), np.int16)
    at = 0
    for w, h, k, rows in want:
        wt = w.t()[rows * h:rows * (h + 1), 64 * k:64 * (k + 1)].contiguous()
        src = wt.view(torch.int16).numpy()
        for r in range(rows):
            for u in range(8):
                dst = at + r * 64 + 8 * (u ^ (r % 8))
                out[dst:dst + 8] = src[r, 8 * u:8 * u + 8]
        at += rows * 64
    assert at == pack.numel()
    np.testing.assert_array_equal(out, pack.view(torch.int16).numpy())


def test_bf16_call_without_its_pack_is_refused():
    t = _tables(BF16)
    t.head_pack = None
    with pytest.raises(ValueError, match="weight pack"):
        pn._check(t, 50, "pointnet_head", {}, t.head_pack)
    with pytest.raises(ValueError, match="P <= 256"):
        pn._check(t, 257, "pointnet_trunk", {}, t.trunk_pack)


# ---- the kernels' reductions over the accumulator fragments ----

WARP = torch.arange(4)[:, None]  # (4, 1)
LANE = torch.arange(32)[None, :]  # (1, 32)
R0 = 16 * WARP + LANE // 4  # fragment rows r0 and r0 + 8 of thread (w, l)


def _butterfly(x, offsets, op):
    """x (..., 32) over the lanes: x[l] = op(x[l], x[l ^ off]) per offset."""
    lane = torch.arange(32)
    for off in offsets:
        x = op(x, x[..., lane ^ off])
    return x


def _fragment_reduce(rows_r0, rows_r8, op):
    """The column reduction of a (C, 64, 256) function of the rows: per
    thread over its rows r0 and r0 + 8 (`rows_r0(col)`, `rows_r8(col)` give
    (C, 4, 32) values of column col), over the 8 lanes of a column by
    shuffles (lanes l ^ 4, then l ^ 8, then l ^ 16), stored per warp by
    lanes 0-3 -> (C, 4 warps, 256)."""
    per_warp = None
    for half in range(2):
        for j in range(16):
            for e in range(2):
                col = 128 * half + 8 * j + 2 * (LANE % 4) + e  # (1, 32)
                v = _butterfly(op(rows_r0(col), rows_r8(col)), (4, 8, 16), op)
                if per_warp is None:
                    per_warp = torch.zeros(v.shape[0], 4, 256)
                per_warp[:, :, col[0, :4]] = v[:, :, :4]
    return per_warp


def trunk_max_model(y64: torch.Tensor) -> torch.Tensor:
    """K4's pooled from stn conv3's (C, 64, 256) output (rows >= P repeat
    row 0): fmaxf over the fragments, then over the 4 warps."""
    per_warp = _fragment_reduce(lambda col: y64[:, R0, col], lambda col: y64[:, R0 + 8, col],
                                torch.maximum)
    return torch.maximum(torch.maximum(per_warp[:, 0], per_warp[:, 1]),
                         torch.maximum(per_warp[:, 2], per_warp[:, 3]))


def head_pool_model(logit: torch.Tensor, value: torch.Tensor, p: int) -> torch.Tensor:
    """K5's pooling from the (C, 64) rounded logits and the (C, 64, 256)
    rounded fc_value outputs (rows >= p repeat row 0): every warp's
    softmax with lane l holding rows l and l + 32, then each thread's
    weighted rows r0, r0 + 8, the lane butterfly and the 4-warp sum."""
    lane = torch.arange(32)
    real_a, real_b = lane < p, lane + 32 < p
    la = torch.where(real_a, logit[:, :32], -torch.inf)
    lb = torch.where(real_b, logit[:, 32:], -torch.inf)
    m = _butterfly(torch.maximum(la, lb), (16, 8, 4, 2, 1), torch.maximum)
    ea = torch.where(real_a, _rnd(torch.exp(_rnd(la - m))), 0.0)
    eb = torch.where(real_b, _rnd(torch.exp(_rnd(lb - m))), 0.0)
    s = _rnd(_butterfly(ea + eb, (16, 8, 4, 2, 1), torch.add))
    att = torch.cat([_rnd(ea / s), _rnd(eb / s)], dim=1)  # (C, 64) by row
    a0, a1 = att[:, R0], att[:, R0 + 8]  # (C, 4, 32)
    per_warp = _fragment_reduce(lambda col: a0 * value[:, R0, col],
                                lambda col: a1 * value[:, R0 + 8, col], torch.add)
    return _rnd(per_warp[:, 0] + per_warp[:, 1] + per_warp[:, 2] + per_warp[:, 3])


def _pad_rows(p):
    """Row index of the kernels' 64 rows: 0..p-1, then row 0."""
    return torch.tensor(list(range(p)) + [0] * (64 - p))


@pytest.mark.parametrize("p", [1, 17, 50, 64])
def test_trunk_fragment_max_equals_the_plain_version(p):
    t = _tables(BF16)
    rng = np.random.RandomState(p)
    patches = torch.from_numpy(rng.randn(24, p, 3).astype(np.float32) * 0.05).to(BF16)
    x = patches
    for layer in range(5):  # the layers of pointnet_trunk_plain
        x = pn._dense_bn(x, t.trunk_w[layer], t.trunk_aff, layer, t.dt)
    _, pooled = pn.pointnet_trunk_plain(patches, t)
    model = trunk_max_model(x[:, _pad_rows(p)].float())
    assert torch.equal(model.to(BF16), pooled)


@pytest.mark.parametrize("p", [1, 17, 50, 64])
def test_head_fragment_pooling_equals_the_plain_version(p):
    rng = np.random.RandomState(100 + p)
    c = 24
    logit = torch.from_numpy(rng.uniform(-2, 2, (c, p)).astype(np.float32)).to(BF16)
    value = torch.from_numpy(rng.randint(-8, 9, (c, p, 256)).astype(np.float32)).to(BF16)
    plain = pn.attention_pool_plain(logit[..., None], value, BF16)
    rows = _pad_rows(p)
    lpad, vpad = logit[:, rows].float(), value[:, rows].float()
    assert torch.equal(head_pool_model(lpad, vpad, p).to(BF16), plain)
    # the rows past p are masked out: other logits and values there change nothing
    lpad[:, p:], vpad[:, p:] = 30.0, 1e4
    assert torch.equal(head_pool_model(lpad, vpad, p).to(BF16), plain)


def head_cluster_model(logit: torch.Tensor, value: torch.Tensor, p: int) -> torch.Tensor:
    """The cluster K5's pooling from the (C, 64T) rounded logits and the
    (C, 64T, 256) rounded fc_value outputs of a patch's T tiles (a tile's
    rows >= p repeat its first): in every warp of every CTA, lane l holds
    rows l + 32i (i < 8, rows >= p masked): the max, the exps, their sum
    over i in order, the lane butterflies; tile t's rows take their
    lane's weight; each tile's weighted rows are summed over the
    fragments, the lanes and the 4 warps, and the tiles' sums in order."""
    c, rows_t = logit.shape
    tiles = rows_t // 64
    lanes = torch.arange(32)
    lg = torch.full((c, 256), -torch.inf)
    lg[:, :rows_t] = logit
    rows = lanes[None, :] + 32 * torch.arange(8)[:, None]  # (8, 32): lane l's rows
    real = rows < p
    x = torch.where(real, lg[:, rows], -torch.inf)  # (C, 8, 32)
    m = _butterfly(x.amax(dim=1), (16, 8, 4, 2, 1), torch.maximum)  # (C, 32)
    e = torch.where(real, _rnd(torch.exp(_rnd(x - m[:, None]))), 0.0)
    s = torch.zeros(c, 32)
    for i in range(8):
        s = s + e[:, i]
    s = _rnd(_butterfly(s, (16, 8, 4, 2, 1), torch.add))
    weight = _rnd(e / s[:, None])  # (C, 8, 32): row l + 32i
    total = None
    for t in range(tiles):
        att = weight[:, 2 * t:2 * t + 2].reshape(c, 64)  # the tile's rows in order
        v = value[:, 64 * t:64 * (t + 1)]
        a0, a1 = att[:, R0], att[:, R0 + 8]
        per_warp = _fragment_reduce(lambda col: a0 * v[:, R0, col],
                                    lambda col: a1 * v[:, R0 + 8, col], torch.add)
        tile_sum = per_warp[:, 0] + per_warp[:, 1] + per_warp[:, 2] + per_warp[:, 3]
        total = tile_sum if total is None else total + tile_sum
    return _rnd(total)


@pytest.mark.parametrize("p", [65, 100, 128, 129, 192, 200, 256])
def test_head_cluster_model_equals_the_plain_version(p):
    t = _tables(BF16)
    rng = np.random.RandomState(200 + p)
    c = 12
    x2 = torch.from_numpy(rng.randn(c, p, 64).astype(np.float32)).to(BF16)
    x = x2
    for layer in range(3):  # the layers of pointnet_head_plain
        x = pn._dense_bn(x, t.head_w[layer], t.head_aff, layer, t.dt, relu=layer < 2)
    logit = pn.dense(x, t.head_w[3], t.bqv[0, :1], t.dt)[..., 0].float()
    value = pn.dense(x, t.head_w[4], t.bqv[1], t.dt).float()
    tiles = -(-p // 64)
    # the kernel's rows: tile t holds rows 64t.. of the patch, past p its first
    rows = torch.tensor([r if r < p else 64 * (r // 64) for r in range(64 * tiles)])
    lpad, vpad = logit[:, rows], value[:, rows]
    plain = pn.pointnet_head_plain(x2, t).float()
    model = head_cluster_model(lpad, vpad, p).float()
    scale = max(1.0, float(plain.abs().max()))
    diff = (model - plain).abs()
    assert float(diff.max()) <= 1.6e-2 * scale  # the smoke's bf16 limits
    assert float(diff.mean()) <= 2e-6 * scale
    # the rows past p are masked out: other logits and values there change nothing
    pad = torch.arange(64 * tiles) >= p
    lpad[:, pad], vpad[:, pad] = 30.0, 1e4
    assert torch.equal(head_cluster_model(lpad, vpad, p), model.to(BF16))
