"""Point-encoding utilities.

Port of `ppsurf_tpu/ops/encoding.py` (reference `source/base/nn.py:9-69`):
the optional network-input transforms `cartesian_to_polar` and
`pos_encoding`, channels-last. Plain PyTorch: elementwise work that no
TPU kernel of the JAX package covers.
"""
from __future__ import annotations

import math

import torch


def cartesian_to_polar(pts_cart: torch.Tensor) -> torch.Tensor:
    """(B, N, 2|3) cartesian -> polar/spherical (reference `nn.py:9-37`).

    3-D returns (azimuth, elevation, radius); 2-D returns (radius, phi).
    """
    if pts_cart.shape[-1] == 2:
        x, y = pts_cart[..., 0], pts_cart[..., 1]
        return torch.stack([torch.sqrt(x ** 2 + y ** 2), torch.atan2(y, x)], dim=-1)
    x, y, z = pts_cart[..., 0], pts_cart[..., 1], pts_cart[..., 2]
    hxy = torch.hypot(x, y)
    return torch.stack([torch.atan2(y, x), torch.atan2(z, hxy), torch.hypot(hxy, z)], dim=-1)


def pos_encoding(pts: torch.Tensor, pos_encoding_levels: int,
                 skip_last_dim: bool = False) -> torch.Tensor:
    """Sin/cos positional encoding of point coordinates (reference
    `nn.py:40-69`): per dim and level l, cos(x * l * pi * 2^l) and
    sin(x * l * pi * 2^l), all cosines first; with skip_last_dim the last
    input dim (e.g. polar radius) passes through unencoded."""
    if pos_encoding_levels <= 0:
        return pts
    num_dim = pts.shape[-1]
    cos_parts, sin_parts = [], []
    for dim in range(num_dim):
        x = pts[..., dim]
        for lvl in range(pos_encoding_levels):
            if skip_last_dim and dim == num_dim - 1:
                cos_parts.append(x)
                sin_parts.append(x)
            else:
                scale = lvl * math.pi * (2.0 ** lvl)
                cos_parts.append(torch.cos(x * scale))
                sin_parts.append(torch.sin(x * scale))
    return torch.stack(cos_parts + sin_parts, dim=-1)
