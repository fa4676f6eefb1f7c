"""Exact k-nearest-neighbour ids, nearest first (kernel K1).

Replaces the TPU kernel `_knn_kernel` (`ppsurf_tpu/ops/knn_pallas.py:48`,
launched at `:489` through `knn_pallas_single`, reached from
`ppsurf_tpu/ops/knn.py:124-173`). The TPU kernel keeps per-block minima,
selects blocks and extracts from them; the CUDA kernel (`csrc/knn.cu`)
culls blocks by their boxes instead:

- the wrapper sorts the cloud into Morton blocks of KNN_BLOCK points on
  the card (`knn_blocks`), each point carrying its original id, and takes
  each block's box over its valid points with `amin`/`amax`;
- one warp per query seeds a threshold tau from the blocks nearest by box
  lower bound that hold k points (the k-th smallest (distance, id) key
  among them: an exact upper bound), visits only the blocks whose lower
  bound is not above tau's distance, appends keys below tau to a buffer in
  shared memory, cuts a full buffer to its k smallest (tau tightens) and
  ranks the final buffer into the output;
- distances are direct differences `(p-q)^2` summed x, y, z with rounded
  (non-fused) f32 operations, the same arithmetic as the plain version
  below; the box lower bound clamps the query into the box in the same
  arithmetic (`box_lower_bound`), so it never exceeds a contained point's
  distance; ties go to the lower original id. Kernel and plain version
  therefore return identical ids, whatever the order of the points.

What bounds it on an H100: the distances the data needs. Brute force is
Q*N distance evaluations (8 f32 operations each, no tensor-core form):
2.4e10 operations at the field chunk's 50 048 x 60 031, 0.36 ms at the
card's 67 TFLOP/s f32 peak. The culled kernel needs only the points of
the blocks whose box lower bound is not above the query's true k-th
distance (`chip_smoke.py` counts them from the plain result); the bytes
(points, queries, ids) are a few tens of MB.

Ids of points with `valid` False never appear; where fewer than k valid
points lie at a finite distance, the trailing ids are -1.
"""
from __future__ import annotations

import typing

import torch

from ppsurf_tpu_torch.ops import kernels

KMAX = 256  # largest k the kernel is built for (the JAX dispatch bound)
KNN_BLOCK = 64  # points per Morton block (`B` in csrc/knn.cu)
_PLAIN_BLOCK = 1 << 25  # distance entries per plain-version query chunk

# spread 10 bits two apart (`morton.py`'s 3-D bit split)
_SPREAD = ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249))

Blocks = typing.Tuple[torch.Tensor, torch.Tensor]


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit Z-order codes (int64) of (N, 3) f32 points in their own box,
    on the points' device: `morton.morton_codes` in torch."""
    bmin = points.amin(dim=0)
    bmax = points.amax(dim=0)
    top = float(2 ** 10 - 1)
    # a tensor numerator: `scalar / tensor` would multiply by a reciprocal
    scale = torch.where(bmax > bmin, torch.full_like(bmax, top) / (bmax - bmin),
                        torch.zeros_like(bmin))
    # NaN (an infinite coordinate times a zero scale) goes to cell 0
    cells = ((points - bmin) * scale).nan_to_num_(0.0).clamp_(0.0, top).to(torch.int64)
    for sh, mask in _SPREAD:  # all three axes at once
        cells = (cells | (cells << sh)) & mask
    return cells[:, 0] | (cells[:, 1] << 1) | (cells[:, 2] << 2)


def knn_blocks(points: torch.Tensor, valid: typing.Optional[torch.Tensor] = None
               ) -> Blocks:
    """The cloud as K1 reads it: `pts4` (nb*KNN_BLOCK, 4) f32 rows (x, y, z,
    original id as int32 bits) in Morton order, padded to whole blocks,
    with NaN coordinates for invalid and padding rows; `boxes` (nb, 8) f32
    rows (lo x, y, z, 0, hi x, y, z, 0) over each block's valid points,
    (+inf, -inf) where it has none. The order only sets how tight the
    boxes are: ties break by the original id either way."""
    n = points.shape[0]
    points = points.float()
    perm = torch.argsort(morton_codes(points), stable=True)
    nb = max(1, -(-n // KNN_BLOCK))
    pad = nb * KNN_BLOCK - n
    xyz = points[perm]
    ok = torch.ones(n, dtype=torch.bool, device=points.device) if valid is None \
        else valid.to(torch.bool)[perm]
    ids = perm.to(torch.int32)
    if pad:
        xyz = torch.cat([xyz, xyz.new_zeros((pad, 3))])
        ok = torch.cat([ok, ok.new_zeros(pad)])
        ids = torch.cat([ids, ids.new_full((pad,), -1)])
    inf = float("inf")
    lo = torch.where(ok[:, None], xyz, inf).view(nb, KNN_BLOCK, 3).amin(dim=1)
    hi = torch.where(ok[:, None], xyz, -inf).view(nb, KNN_BLOCK, 3).amax(dim=1)
    zero = lo.new_zeros((nb, 1))
    boxes = torch.cat([lo, zero, hi, zero], dim=1).contiguous()
    pts4 = torch.cat([torch.where(ok[:, None], xyz, float("nan")),
                      ids.view(torch.float32)[:, None]], dim=1).contiguous()
    return pts4, boxes


def box_lower_bound(queries: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(Q, nb) least squared distance from each query to each box of
    `knn_blocks`, in the kernel's arithmetic: the query clamped into the
    box, then `dist2`. Never above the dist2 of a point in the box."""
    lo = boxes[None, :, 0:3]
    hi = boxes[None, :, 4:7]
    qq = queries[:, None, :]
    d = torch.minimum(torch.maximum(qq, lo), hi) - qq
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def dist2(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances by direct differences, summed x, y, z in
    that order — the kernel's arithmetic."""
    dx = points[None, :, 0] - queries[:, None, 0]
    dy = points[None, :, 1] - queries[:, None, 1]
    dz = points[None, :, 2] - queries[:, None, 2]
    return dx * dx + dy * dy + dz * dz


def dist2_rows(queries: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(C, kc) squared distances of each query (C, 3) to its own row of
    candidate points (C, kc, 3), in `dist2`'s arithmetic: the same bits
    as the kernel's distance of that query and point."""
    d = cand - queries[:, None, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def knn_plain(points: torch.Tensor, queries: torch.Tensor, k: int,
              valid: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: full distances and a stable sort."""
    n = points.shape[0]
    out = torch.empty((queries.shape[0], k), dtype=torch.int64, device=points.device)
    step = max(1, _PLAIN_BLOCK // max(n, 1))
    for s in range(0, queries.shape[0], step):
        d2 = dist2(queries[s:s + step], points)
        if valid is not None:
            d2 = d2.masked_fill(~valid[None, :], float("inf"))
        d_sorted, ids = torch.sort(d2, dim=1, stable=True)
        ids = ids[:, :k]
        ids[torch.isinf(d_sorted[:, :k])] = -1
        out[s:s + step] = ids
    return out


def knn(points: torch.Tensor, queries: torch.Tensor, k: int,
        valid: typing.Optional[torch.Tensor] = None,
        blocks: typing.Optional[Blocks] = None) -> torch.Tensor:
    """Ids (Q, k) int64 of the k nearest `points` (N, 3) to each of
    `queries` (Q, 3), nearest first; `valid` (N,) bool masks points out.
    `blocks`, `knn_blocks(points, valid)` made once by a caller that
    queries the same cloud again, saves the kernel's blocking per call.

    CPU tensors take the plain version; CUDA tensors launch K1, counted
    as "knn" for k <= 128 and "knn_k192" above.
    """
    n = points.shape[0]
    if not 1 <= k <= min(n, KMAX):
        raise ValueError(f"k={k} must lie in [1, min(N={n}, {KMAX})]")
    if points.device.type == "cpu":
        return knn_plain(points.float(), queries.float(), k, valid)
    queries = queries.float().contiguous()
    pts4, boxes = knn_blocks(points, valid) if blocks is None else blocks
    nb = -(-n // KNN_BLOCK)
    if tuple(pts4.shape) != (nb * KNN_BLOCK, 4) or tuple(boxes.shape) != (nb, 8) \
            or queries.shape[1:] != (3,):
        raise ValueError(f"knn: blocks {tuple(pts4.shape)}, boxes {tuple(boxes.shape)} "
                         f"and queries {tuple(queries.shape)} do not fit {n} points")
    kernels.check_cuda_args(
        "knn", {"points": pts4, "boxes": boxes, "queries": queries},
        {"points": torch.float32, "boxes": torch.float32},
    )
    out = torch.empty((queries.shape[0], k), dtype=torch.int64, device=queries.device)
    if queries.shape[0]:
        kernels.launch(
            "knn" if k <= 128 else "knn_k192", "ppsurf_knn", queries.device, kernels.ptr(pts4),
            kernels.ptr(boxes), kernels.ptr(queries), kernels.ptr(out),
            boxes.shape[0], queries.shape[0], k, KNN_BLOCK,
        )
    return out
