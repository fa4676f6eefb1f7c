"""Host side of the port's tensor-layout contracts with its CUDA kernels.

K1 (`ppsurf_tpu_torch/ops/knn.py`): the Morton blocking keeps every
point's original id, each block's box contains its valid points, and the
box lower bound (the query clamped into the box, in the kernel's rounded
arithmetic) never exceeds a contained point's `dist2`, bit for bit,
including clouds with coordinates at float edge values. A model of the
kernel's selection (seed, threshold, cut, rank) on these blocks returns
the plain version's ids on ties, duplicates and masks.

K3 (`ppsurf_tpu_torch/ops/decoder_tail.py`): the bf16 weight stream holds
W2, W3, Wq and Wv exactly, in the swizzled K-major operand layout of
`csrc/gmma.cuh`.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ppsurf_tpu_torch.ops import knn, morton
from ppsurf_tpu_torch.ops.decoder_tail import pack_wgmma_weights
from ppsurf_tpu_torch.ops.wgmma_layout import unswizzle_tile

B = knn.KNN_BLOCK


def _cloud(kind: str, seed: int):
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        pts = rng.rand(1000, 3)
    elif kind == "duplicates":  # hundreds of copies of a few points
        pts = np.concatenate([np.repeat(rng.rand(3, 3), 250, axis=0), rng.rand(150, 3)])
    elif kind == "cluster":  # a dense cluster and sparse far outliers
        pts = np.concatenate([rng.randn(900, 3) * 1e-3, rng.randn(40, 3) * 1e3])
    else:  # float edge values: huge, tiny, subnormal, signed zeros
        edge = np.array([3.0e38, -3.0e38, 1e-38, -1e-45, 1e-45, 0.0, -0.0, 1.0,
                         np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                        np.float32)
        pts = rng.choice(edge, size=(300, 3))
        pts = np.concatenate([pts, rng.rand(100, 3) * 1e-30, rng.rand(100, 3)])
    pts = pts.astype(np.float32)
    rng.shuffle(pts)
    return pts


CLOUDS = ("uniform", "duplicates", "cluster", "edge")


def _blocks(pts, valid=None):
    pts4, boxes = knn.knn_blocks(torch.from_numpy(pts),
                                 None if valid is None else torch.from_numpy(valid))
    return pts4.numpy(), boxes.numpy()


@pytest.mark.parametrize("kind", CLOUDS)
@pytest.mark.parametrize("masked", [False, True])
def test_blocking_keeps_original_ids(kind, masked):
    pts = _cloud(kind, 0)
    valid = np.random.RandomState(1).rand(len(pts)) < 0.7 if masked else None
    pts4, boxes = _blocks(pts, valid)
    n = len(pts)
    assert pts4.shape == (boxes.shape[0] * B, 4) and boxes.shape[0] == -(-n // B)
    ids = pts4[:, 3].view(np.int32)
    assert sorted(ids[:n]) == list(range(n)) and (ids[n:] == -1).all()
    ok = ~np.isnan(pts4[:, 0])
    want = np.ones(n, bool) if valid is None else valid
    assert sorted(ids[ok]) == list(np.flatnonzero(want))
    np.testing.assert_array_equal(pts4[ok, :3].view(np.uint32), pts[ids[ok]].view(np.uint32))
    assert np.isnan(pts4[~ok, :3]).all()


@pytest.mark.parametrize("kind", CLOUDS)
def test_boxes_contain_their_points_and_bound_their_distances(kind):
    pts = _cloud(kind, 2)
    valid = np.random.RandomState(3).rand(len(pts)) < 0.8
    pts4, boxes = _blocks(pts, valid)
    block = np.arange(len(pts4)) // B
    ok = ~np.isnan(pts4[:, 0])
    lo, hi = boxes[block, 0:3], boxes[block, 4:7]
    assert ((lo <= pts4[:, :3]) & (pts4[:, :3] <= hi))[ok].all()
    empty = np.array([not ok[b * B:(b + 1) * B].any() for b in range(len(boxes))])
    assert (boxes[empty, 0:3] == np.inf).all() and (boxes[empty, 4:7] == -np.inf).all()

    rng = np.random.RandomState(4)
    queries = np.concatenate([pts[rng.randint(0, len(pts), 30)],
                              rng.rand(30, 3).astype(np.float32) * 2 - 0.5,
                              np.array([[1e30, -1e30, 0.0], [0.0, 0.0, 0.0]], np.float32)])
    qt = torch.from_numpy(queries)
    lb = knn.box_lower_bound(qt, torch.from_numpy(boxes)).numpy()
    d2 = knn.dist2(qt, torch.from_numpy(pts4[:, :3])).numpy()
    assert (lb[:, block[ok]] <= d2[:, ok]).all()
    assert (lb[:, empty] == np.inf).all()
    # d >= 0 orders like its bits: the kernel compares keys as unsigned
    both = np.isfinite(d2[:, ok])
    assert (lb[:, block[ok]].view(np.uint32)[both] <= d2[:, ok].view(np.uint32)[both]).all()


def test_morton_codes_on_the_device_equal_the_host_codes():
    pts = _cloud("uniform", 5) * np.float32(3.0) - np.float32(1.0)
    ours = knn.morton_codes(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(ours, morton.morton_codes(pts).astype(np.int64))


def _kernel_model(pts, queries, k, valid=None):
    """The kernel's selection on `knn_blocks` (one query at a time): seed
    tau from the blocks nearest by lower bound until they hold k keys,
    visit the blocks whose bound is not above tau outward from the first
    seed block, cut a full buffer to its k smallest, rank the rest."""
    kmax = 32 if k <= 32 else 64 if k <= 64 else 128 if k <= 128 else 256
    cap = 2 * kmax + B
    pts4, boxes = _blocks(pts, valid)
    ids = pts4[:, 3].view(np.int32).astype(np.int64)
    lbs = knn.box_lower_bound(torch.from_numpy(queries), torch.from_numpy(boxes)).numpy()
    d2s = knn.dist2(torch.from_numpy(queries), torch.from_numpy(pts4[:, :3])).numpy()
    inf_key = 0x7F800000 << 32
    out = np.full((len(queries), k), -1, np.int64)
    for qi in range(len(queries)):
        dbits = d2s[qi].view(np.uint32).astype(np.int64)
        keys = np.where(np.isnan(d2s[qi]), (1 << 63) - 1, (dbits << 32) | (ids & 0xFFFFFFFF))
        bkeys = (lbs[qi].view(np.uint32).astype(np.int64) << 32) | np.arange(len(boxes))
        buf, tau = [], inf_key

        def append(b):
            nonlocal buf, tau
            if len(buf) + B > cap:
                buf = sorted(buf)[:k]
                tau = buf[-1]
            buf += [int(x) for x in keys[b * B:(b + 1) * B] if x < tau]

        seeds = [int(b) for b in np.argsort(bkeys) if np.isfinite(lbs[qi, b])]
        picked = 0
        while len(buf) < k and picked < len(seeds):
            append(seeds[picked])
            picked += 1
        if len(buf) >= k:
            buf = sorted(buf)[:k]
            tau = buf[-1]
        done = set(seeds[:picked])
        first, nb = (seeds[0] if seeds else 0), len(boxes)
        order = []  # groups of 32 outward from the first seed block
        for j in range(nb // 32 + 2):
            order += list(range(first + 32 * j, first + 32 * j + 32))
            order += list(range(first - 32 * j - 1, first - 32 * j - 33, -1))
        for b in order:
            tau_d = np.uint32(tau >> 32).view(np.float32)
            if 0 <= b < nb and b not in done and np.isfinite(lbs[qi, b]) \
                    and lbs[qi, b] <= tau_d:
                append(b)
        for r, key in enumerate(sorted(buf)[:k]):
            out[qi, r] = key & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("kind,k", [("duplicates", 16), ("duplicates", 192),
                                    ("cluster", 64), ("uniform", 256)])
def test_kernel_selection_model_returns_the_plain_ids(kind, k):
    pts = _cloud(kind, 6)
    rng = np.random.RandomState(7)
    queries = np.concatenate([pts[rng.randint(0, len(pts), 8)],
                              np.array([[5e3, 5e3, 5e3]], np.float32)])
    ref = knn.knn_plain(torch.from_numpy(pts), torch.from_numpy(queries), k).numpy()
    np.testing.assert_array_equal(_kernel_model(pts, queries, k), ref)
    valid = np.zeros(len(pts), bool)
    valid[rng.choice(len(pts), k // 2 + 1, replace=False)] = True
    ref = knn.knn_plain(torch.from_numpy(pts), torch.from_numpy(queries), k,
                        torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(_kernel_model(pts, queries, k, valid), ref)


def test_wgmma_weight_stream_holds_the_weights_exactly():
    g = torch.Generator().manual_seed(0)
    w2, w3, wv = (torch.randn(256, 256, generator=g).to(torch.bfloat16) for _ in range(3))
    wq = torch.randn(256, 64, generator=g).to(torch.bfloat16)
    pack = pack_wgmma_weights(w2, w3, wq, wv)
    assert pack.dtype == torch.bfloat16 and pack.numel() * 2 == 26 * 16384
    slices = pack.view(26, -1)
    for first, w in ((0, w2), (8, w3), (18, wv)):
        for h in range(2):
            for k in range(4):
                tile = unswizzle_tile(slices[first + 4 * h + k], 128)  # (out, 64 inputs)
                assert torch.equal(tile, w[64 * k:64 * (k + 1), 128 * h:128 * (h + 1)].t())
    for k in range(4):
        tile = unswizzle_tile(slices[16 + k // 2].view(2, -1)[k % 2], 64)
        assert torch.equal(tile, wq[64 * k:64 * (k + 1)].t())
    # the layout `csrc/gmma.cuh::swizzle_offset` describes: row r's 16-byte
    # unit u at unit u ^ (r % 8)
    flat = slices[0].view(128, 8, 8)
    for r, u in ((0, 0), (3, 5), (13, 2), (127, 7)):
        assert torch.equal(flat[r, u ^ (r % 8)], w2[8 * u:8 * u + 8, r])
