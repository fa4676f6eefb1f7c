"""Fixed-count support-point subsampling with explicit draws.

Port of `ppsurf_tpu/ops/subsample.py` (replacing the reference's
`sampling_quantized`, `source/poco_data_loader.py:59-134`). Points that
represent a voxel at the coarsest of four halving levels rank highest,
then representatives of each finer level, then uniform random fill; one
top-k over the combined score selects the subset. Each level rotates the
cloud by a random rotation first.

Its random numbers are inputs, not internal draws: `tie` (N,) uniforms
break ties and fill, `rot_u` (4, 3) uniforms give the Shoemake rotation of
each level. `draw_subsample` makes them from a torch.Generator; the tests
hand both packages the same numbers.
"""
from __future__ import annotations

import math
import typing

import torch

NUM_HALVINGS = 4  # voxel-size halving levels mirrored from the reference loop


def random_rotation(u: torch.Tensor) -> torch.Tensor:
    """Uniform SO(3) rotation from three uniforms (Shoemake quaternion)."""
    r1, r2, r3 = u[0], u[1], u[2]
    two_pi = 2.0 * math.pi
    x = torch.sqrt(1.0 - r1) * torch.sin(two_pi * r2)
    y = torch.sqrt(1.0 - r1) * torch.cos(two_pi * r2)
    z = torch.sqrt(r1) * torch.sin(two_pi * r3)
    w = torch.sqrt(r1) * torch.cos(two_pi * r3)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
    ])


def _first_in_voxel_flags(pts_rot: torch.Tensor, vox: torch.Tensor,
                          tie: torch.Tensor) -> torch.Tensor:
    """Bool flag per point: is it the (random) representative of its voxel?"""
    mini = pts_rot.amin(dim=0)
    cell = torch.floor((pts_rot - mini[None, :]) / vox).to(torch.int64)
    dim = cell.max() + 2
    vox_id = (cell[:, 0] * dim + cell[:, 1]) * dim + cell[:, 2]
    # order by (vox_id, tie): a stable sort by tie, then by vox_id
    by_tie = torch.argsort(tie, stable=True)
    order = by_tie[torch.argsort(vox_id[by_tie], stable=True)]
    vox_sorted = vox_id[order]
    first_sorted = torch.ones_like(vox_sorted, dtype=torch.bool)
    first_sorted[1:] = vox_sorted[1:] != vox_sorted[:-1]
    flags = torch.zeros_like(first_sorted)
    flags[order] = first_sorted
    return flags


def voxel_subsample(pts: torch.Tensor, n_support: int, tie: torch.Tensor,
                    rot_u: torch.Tensor) -> torch.Tensor:
    """Indices (n_support,) of a spatially uniform subsample of pts (N, 3)."""
    mini = pts.amin(dim=0)
    maxi = pts.amax(dim=0)
    # reference voxel size: bbox-diagonal norm / sqrt(n_support); the count
    # is a device fill, not a host copy, so a CUDA graph can capture it
    vox0 = torch.linalg.vector_norm(maxi - mini) / torch.sqrt(
        torch.full((), float(n_support), device=pts.device))
    vox0 = torch.clamp(vox0, min=1e-12)
    score = tie.clone()
    for lvl in range(NUM_HALVINGS):
        rot = random_rotation(rot_u[lvl])
        flags = _first_in_voxel_flags(pts @ rot.T, vox0 / (2.0 ** lvl), tie)
        # coarse-level flags dominate all finer levels combined
        score = score + torch.where(flags, 2.0 * 2.0 ** (NUM_HALVINGS - lvl), 0.0)
    return torch.topk(score, n_support).indices


def draw_subsample(n: int, generator: torch.Generator,
                   device: torch.device) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """(tie (n,), rot_u (4, 3)) uniforms for one `voxel_subsample` call."""
    tie = torch.rand(n, generator=generator, device=device)
    rot_u = torch.rand(NUM_HALVINGS, 3, generator=generator, device=device)
    return tie, rot_u
