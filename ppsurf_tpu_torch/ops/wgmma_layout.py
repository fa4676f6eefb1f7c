"""Weight operands of the tensor-core kernels, in the layout `wgmma` reads.

A weight (in, out) is stored transposed (K-major) in tiles of 64 inputs:
a tile holds `rows` output columns x 64 inputs, 128 bytes of bf16 a row,
with row r's 16-byte unit u stored at unit u ^ (r % 8) (128-byte
swizzling, `csrc/gmma.cuh`). The kernels copy such tiles to shared memory
as they are and point `wgmma` descriptors at them. K3
(`ops/decoder_tail.py`) and K4/K5 (`ops/pointnet_att.py`) lay out their
weights with these helpers, once per table.
"""
from __future__ import annotations

import typing

import torch


def swizzle_tile(wt: torch.Tensor) -> torch.Tensor:
    """A (rows, 64) bf16 K-major tile in the 128-byte-swizzled layout that
    `wgmma` reads (`csrc/gmma.cuh`): row r's 16-byte unit u is stored at
    unit u ^ (r % 8). Returns the (rows * 64,) image."""
    rows = wt.shape[0]
    units = wt.reshape(rows, 8, 8)
    r = torch.arange(rows, device=wt.device)[:, None]
    src = torch.arange(8, device=wt.device)[None, :] ^ (r % 8)
    return units.gather(1, src[..., None].expand(rows, 8, 8)).reshape(-1)


def unswizzle_tile(image: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of `swizzle_tile` (the swizzle is its own inverse)."""
    return swizzle_tile(image.reshape(rows, 64)).reshape(rows, 64)


def weight_tile(w: torch.Tensor, cols: slice, k: int) -> torch.Tensor:
    """Output columns `cols` of weight w (in, out) against its inputs
    64k..64k+63, as one swizzled K-major tile image."""
    return swizzle_tile(w.t()[cols, 64 * k:64 * (k + 1)].contiguous())


def column_halves(w: torch.Tensor) -> typing.List[torch.Tensor]:
    """The (128 x 64) tiles of a weight (in, 256) in the order a kernel
    that runs it as two 128-column halves multiplies them: output columns
    0-127 then 128-255, each over its K-tiles of 64 inputs in order."""
    return [weight_tile(w, slice(128 * h, 128 * (h + 1)), k)
            for h in range(2) for k in range(w.shape[0] // 64)]
