"""Weight operands of the tensor-core kernels, in the layout `wgmma` reads.

A weight (in, out) is stored transposed (K-major) in tiles of 128 bytes
a row: a bf16 tile holds `rows` output columns x 64 inputs, an f32 tile
64 output columns x 32 inputs, with row r's 16-byte unit u stored at unit
u ^ (r % 8) (128-byte swizzling, `csrc/gmma.cuh`). The kernels copy such
tiles to shared memory as they are and point `wgmma` descriptors at them.
K3 (`ops/decoder_tail.py`) and K4/K5 (`ops/pointnet_att.py`) lay out
their weights with these helpers, once per table.

The f32 builds of K3-K5 multiply as 3xTF32 (`csrc/gmma.cuh`): each
weight is split into tf32 hi = tf32(w) (round to nearest, ties away from
zero, 10 mantissa bits) and lo = tf32(w - hi), and a slice of their
stream holds the hi tile and then the lo tile of the same 64 columns x 32
inputs. Within each group of 8 inputs a tile row holds them in the order
`TF32_K_ORDER`, the order the kernels' A fragments take them in.
"""
from __future__ import annotations

import typing

import torch


# the inputs of a group of 8 in the order of a tf32 tile row: A's logical
# column i (i < 4) is input 2i, column i + 4 input 2i + 1
TF32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def swizzle_tile(wt: torch.Tensor) -> torch.Tensor:
    """A (rows, 128 bytes) K-major tile (64 bf16 or 32 f32 a row) in the
    128-byte-swizzled layout that `wgmma` reads (`csrc/gmma.cuh`): row r's
    16-byte unit u is stored at unit u ^ (r % 8). Returns the flat image."""
    rows = wt.shape[0]
    units = wt.reshape(rows, 8, -1)
    r = torch.arange(rows, device=wt.device)[:, None]
    src = torch.arange(8, device=wt.device)[None, :] ^ (r % 8)
    return units.gather(1, src[..., None].expand(*units.shape)).reshape(-1)


def unswizzle_tile(image: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of `swizzle_tile` (the swizzle is its own inverse)."""
    return swizzle_tile(image.reshape(rows, -1)).reshape(rows, -1)


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 (10 mantissa bits) rounded to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` with the low 13 bits cleared (`gmma.cuh`)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """w (f32) -> (hi, lo): hi = tf32(w), lo = tf32(w - hi); hi + lo = w
    within 2^-22 |w|."""
    hi = tf32_round(w)
    return hi, tf32_round(w.float() - hi)


def tf32_slice(hi: torch.Tensor, lo: torch.Tensor, cols: slice, kc: int) -> torch.Tensor:
    """One slice of a 3xTF32 weight stream: the hi tile, then the lo tile,
    of output columns `cols` of a split weight (in, out) against its inputs
    32kc..32kc+31, each group of 8 in `TF32_K_ORDER` (2 x 8 KB of f32 for
    64 columns, 2 x 4 KB for 32)."""
    order = [32 * kc + 8 * g + o for g in range(4) for o in TF32_K_ORDER]
    return torch.cat([swizzle_tile(x.t()[cols][:, order].contiguous()) for x in (hi, lo)])


def tf32_stream(w: torch.Tensor,
                quarters: typing.Optional[typing.Sequence[int]] = None) -> typing.List[torch.Tensor]:
    """The slices of weight w (in, out) in the order the f32 kernels
    multiply them (`gmma.cuh::mma_quarter_tf32x3`): its column quarters (64
    columns) in the order `quarters` (default ascending), each over its
    K-chunks of 32 inputs in order."""
    hi, lo = tf32_split(w)
    n_in, n_out = w.shape
    return [tf32_slice(hi, lo, slice(64 * q, 64 * (q + 1)), kc)
            for q in (quarters or range(n_out // 64)) for kc in range(n_in // 32)]
