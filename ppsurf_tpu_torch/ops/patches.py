"""Local-patch extraction for the PPSurf PointNet branch.

Port of `ppsurf_tpu/ops/patches.py` (reference `source/ppsurf_data_loader.py:83-123`).
"""
from __future__ import annotations

import typing

import torch

from ppsurf_tpu_torch.ops.knn import knn


def patch_space(pts_local_ms: torch.Tensor, pts_query_ms: torch.Tensor) -> torch.Tensor:
    """Center patches on queries and scale each to unit max-radius.

    pts_local_ms (..., Q, P, 3), pts_query_ms (..., Q, 3); the radius has a
    1e-30 floor, as in the JAX package.
    """
    centered = pts_local_ms - pts_query_ms[..., None, :]
    radius = torch.linalg.vector_norm(centered, dim=-1).amax(dim=-1)
    return centered / torch.clamp(radius[..., None, None], min=1e-30)


def extract_local_patches(pts_raw: torch.Tensor, pts_query: torch.Tensor,
                          num_pts_local: int,
                          valid_raw: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """kNN patches of a raw cloud around each query, in patch space.

    pts_raw (Nraw, 3), pts_query (Q, 3), valid_raw (Nraw,) bool ->
    (Q, num_pts_local, 3).
    """
    ids = knn(pts_raw, pts_query, num_pts_local, valid=valid_raw)
    return patch_space(pts_raw[ids], pts_query)


def extract_local_patches_batch(pts_raw: torch.Tensor, valid_raw: torch.Tensor,
                                pts_query: torch.Tensor, num_pts_local: int) -> torch.Tensor:
    """The patches of B padded raw clouds (`ppsurf_tpu/ops/patches.py:34-56`):
    pts_raw (B, R, 3), valid_raw (B, R) bool, pts_query (B, Q, 3) ->
    (B, Q, num_pts_local, 3), one masked K1 call an item."""
    return torch.stack([
        extract_local_patches(pts_raw[b], pts_query[b], num_pts_local, valid_raw[b])
        for b in range(pts_raw.shape[0])])
