"""Exact k-nearest-neighbour ids, nearest first (kernel K1).

Replaces the TPU kernel `_knn_kernel` (`ppsurf_tpu/ops/knn_pallas.py:48`,
launched at `:489` through `knn_pallas_single`, reached from
`ppsurf_tpu/ops/knn.py:124-173`). The TPU design — block minima, block
selection and a banded one-hot gather certified per tile — existed to
avoid XLA's full sort and Mosaic's layout limits; the CUDA kernel
(`csrc/knn.cu`) is a brute-force scan instead:

- one thread per query keeps a sorted list of its k best (distance, id)
  pairs; points stream through shared memory in tiles, and a point costs
  one distance and one compare unless it beats the list's worst entry;
- before the scan, each thread seeds its list from a window of 4k points
  around the nearest point of a strided sample. On Morton-sorted clouds
  (the field evaluator sorts both sides) the window already holds nearly
  the true k nearest, so the scan inserts rarely;
- distances are direct differences `(p-q)^2` summed x, y, z with rounded
  (non-fused) f32 operations, the same arithmetic as the plain version
  below, and ties go to the lower point index. Kernel and plain version
  therefore return identical ids.

What bounds it on an H100: the Q*N distance evaluations (8 f32 operations
each, no tensor-core form) — 2.4e10 operations at the field chunk's
50 048 x 60 031, about 0.36 ms at the card's 67 TFLOP/s f32 peak; the
bytes (points, queries, ids) are a few tens of MB. The insertion work
depends on the data and is small once the seed window is good.

Ids of points with `valid` False never appear; where fewer than k valid
points exist, the trailing ids are -1.
"""
from __future__ import annotations

import typing

import torch

from ppsurf_tpu_torch.ops import kernels

KMAX = 256  # largest k the kernel is built for (the JAX dispatch bound)
_PLAIN_BLOCK = 1 << 25  # distance entries per plain-version query chunk


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
        valid: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ids (Q, k) int64 of the k nearest `points` (N, 3) to each of
    `queries` (Q, 3), nearest first; `valid` (N,) bool masks points out.

    CPU tensors take the plain version; CUDA tensors launch K1, counted
    as "knn" for k <= 128 and "knn_k192" above.
    """
    n = points.shape[0]
    if not 1 <= k <= min(n, KMAX):
        raise ValueError(f"k={k} must lie in [1, min(N={n}, {KMAX})]")
    if points.device.type == "cpu":
        return knn_plain(points.float(), queries.float(), k, valid)
    points = points.float().contiguous()
    queries = queries.float().contiguous()
    if valid is not None:
        valid = valid.to(torch.uint8).contiguous()
    kernels.check_cuda_args(
        "knn", {"points": points, "queries": queries,
                **({"valid": valid} if valid is not None else {})}, {},
    )
    out = torch.empty((queries.shape[0], k), dtype=torch.int64, device=points.device)
    if queries.shape[0]:
        kernels.launch(
            "knn" if k <= 128 else "knn_k192", "ppsurf_knn", kernels.ptr(points),
            kernels.ptr(valid), kernels.ptr(queries), kernels.ptr(out), n,
            queries.shape[0], k,
        )
    return out
