"""Generalized winding numbers of query points against a triangle soup (W1).

The metrics' inside/outside test (IoU, F1: `metrics/winding.py`). The JAX
package computes it as one jitted XLA reduction on the accelerator
(`_winding_tiled`, `ppsurf_tpu/metrics/winding.py:23-80`); it has no
Pallas kernel. Each triangle (A, B, C) adds its solid angle seen from the
query q (Van Oosterom-Strackee), with a = A - q, b = B - q, c = C - q:

    omega = 2 atan2(a . (b x c), |a||b||c| + (a.b)|c| + (b.c)|a| + (c.a)|b|)

and the winding number is the sum over the triangles divided by 4 pi.

Contract: `queries` (Q, 3), `tri_a`, `tri_b`, `tri_c` (F, 3) f32 ->
(Q,) f32. `winding_plain` tiles as the JAX function does: query tiles of
1024, face tiles of F_TILE = 8192 padded with all-zero triangles (which
add 0 up to the rounding of b x c, where torch fuses a product into its
difference), each tile's sum added into an f32 accumulator. The CUDA
kernel (`csrc/winding.cu`) takes the faces packed by `pack_faces` (A, B,
C and the normal N = (B - A) x (C - A), so that a . (b x c) = v . N is
three FMAs, with v the difference vector of the face vertex nearest the
query: its rounding shrinks near that vertex as the true value does),
four queries a thread, face tiles staged by bulk copies,
the face axis split over blocks whose sums are added in a fixed order,
approximate square roots and an arctangent of bounded relative error
(`ATAN_COEFFS`); it agrees with the plain version to rounding, not bit
for bit. Next to a face the kernel takes two kinds of pair in float64: within
f32 rounding of the face's plane, inside it, where the solid angle is
near +-2 pi and the numerator's sign alone picks the turn (where |n| is
within the numerator's stated rounding bound, `NUM_ERR_EPS`), and near an
edge, where numerator and denominator both cancel (`EDGE`). The plain
version keeps the JAX package's f32 a . (b x c) and, like it, can lose a
whole turn near a plane: there W1 is held to float64, not to its plain
version.

What bounds it on an H100: issued instructions. The formula is 64 f32
additions and multiplications, three square roots and an arctangent for
each (query, face) pair; 100 000 queries against a 647 000-face mesh are
6.5e10 pairs, about 4.2e12 operations. The bytes are a few MB.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ppsurf_tpu_torch.ops import kernels

F_TILE = 8192  # faces a step of the plain version: (1024, F_TILE, 3) temporaries
Q_TILE = 1024
W_TILE = 128  # faces a ring stage of the kernel (csrc/winding.cu); pack_faces pads to it
W_BLOCK_QUERIES = 128 * 4  # queries a block of the kernel: 128 threads, 4 queries each
# blocks the kernel aims for per SM: the face axis is split until the grid
# fills the card about 16 times over (about 6 blocks an SM at once)
BLOCKS_PER_SM = 16 * 6
# The kernel's arctangent polynomial, atan(r) / r = P(r^2) for |r| <= 1,
# lowest power first: the text of `csrc/winding.cu`'s `atan_poly` (the CPU
# tests hold the two equal and the f32 evaluation to its error bound).
# BEGIN W1 ATAN COEFFS
ATAN_COEFFS = (
    1.0, -0.33332393, 0.19974214, -0.14041328, 0.09968473, -0.06020313,
    0.024734065,
    -0.004822535,
)
# END W1 ATAN COEFFS
# The general path's float64 repairs (`repair_terms` in `csrc/winding.cu`,
# where both constants are derived; the CPU tests hold this text to it):
# the numerator v . N errs by at most NUM_ERR_EPS eps |v*||N| (eps = 2^-23,
# v* the exact difference vector of the nearest vertex), so where d < 0 and
# |n| is within that its sign is taken in float64; and a pair with
# max(|n|, |d|) <= EDGE |a||b||c| lies so near an edge that both are.
# BEGIN W1 REPAIR BOUNDS
NUM_ERR_EPS = 3.0
EDGE = 0.015625
# END W1 REPAIR BOUNDS


def winding_plain(queries: torch.Tensor, tri_a: torch.Tensor, tri_b: torch.Tensor,
                  tri_c: torch.Tensor, q_tile: int = Q_TILE) -> torch.Tensor:
    """Plain PyTorch version of W1, tiled as `_winding_tiled`.

    It keeps the JAX package's f32 numerator a . (b x c), so at a query
    within f32 rounding of a face's plane, inside the face, it can take
    the wrong sign of a solid angle near 2 pi and lose a whole turn, as
    `_winding_tiled` does. W1 decides that sign in float64, so near a plane
    W1 is held to float64, not to this version."""
    queries = queries.float()
    num_f = tri_a.shape[0]
    pad_f = (-num_f) % F_TILE
    tris = [F.pad(t.float(), (0, 0, 0, pad_f)).reshape(-1, F_TILE, 3)
            for t in (tri_a, tri_b, tri_c)]
    out = []
    for q in queries.split(q_tile):
        acc = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
        for ta, tb, tc in zip(*tris):
            a = ta[None] - q[:, None]  # (t, F_TILE, 3)
            b = tb[None] - q[:, None]
            c = tc[None] - q[:, None]
            la = torch.linalg.norm(a, dim=-1)
            lb = torch.linalg.norm(b, dim=-1)
            lc = torch.linalg.norm(c, dim=-1)
            num = (a * torch.linalg.cross(b, c)).sum(-1)
            den = (la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la
                   + (c * a).sum(-1) * lb)
            omega = 2.0 * torch.atan2(num, den)  # solid angle per triangle
            acc = acc + omega.sum(-1)
        out.append(acc / (4.0 * math.pi))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=queries.device)
    return torch.cat(out)


def pack_faces(tri_a: torch.Tensor, tri_b: torch.Tensor, tri_c: torch.Tensor,
               tile: int = W_TILE) -> torch.Tensor:
    """The kernel's face layout: (ceil(F / tile) * tile, 12) f32 rows
    (A, Nx, B, Ny, C, Nz) with N = (B - A) x (C - A) computed in float64
    and rounded once to f32 (so |N_i - N*_i| <= eps / 2 |N*_i| for the
    exact normal N* of the f32 vertices, which the kernel's numerator
    bound `NUM_ERR_EPS` needs; an f32 cross product errs by eps |B - A||C - A|,
    far more than that on thin faces), then all-zero rows up to whole
    tiles. A zero row is a triangle at the origin with N = 0: its
    numerator is +-0 over a positive denominator (or 0 over 0 for a query
    at the origin), so it adds exactly 0."""
    a, b, c = (t.float() for t in (tri_a, tri_b, tri_c))
    a64 = a.double()
    n = torch.linalg.cross(b.double() - a64, c.double() - a64).float()
    packed = torch.cat([a, n[:, :1], b, n[:, 1:2], c, n[:, 2:]], dim=1)
    return F.pad(packed, (0, 0, 0, (-a.shape[0]) % tile))


def winding(queries: torch.Tensor, tri_a: torch.Tensor, tri_b: torch.Tensor,
            tri_c: torch.Tensor) -> torch.Tensor:
    """Winding numbers (Q,) f32 of `queries` (Q, 3) against the triangles
    `tri_a`, `tri_b`, `tri_c` (F, 3).

    CPU tensors take the plain version; CUDA tensors launch W1. The two
    agree to rounding, but for queries within f32 rounding of a face's
    plane, where the plain version can lose a whole turn and W1, which
    takes the numerator's sign in float64 there, is held to float64.
    """
    for name, t in (("queries", queries), ("tri_a", tri_a), ("tri_b", tri_b),
                    ("tri_c", tri_c)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (n, 3), got {tuple(t.shape)}")
    if not tri_a.shape == tri_b.shape == tri_c.shape:
        raise ValueError("tri_a, tri_b and tri_c must have one shape")
    if queries.device.type == "cpu":
        return winding_plain(queries, tri_a, tri_b, tri_c)
    args = {k: t.float().contiguous() for k, t in
            (("queries", queries), ("tri_a", tri_a), ("tri_b", tri_b), ("tri_c", tri_c))}
    kernels.check_cuda_args("winding", args, {})
    nq = queries.shape[0]
    out = torch.empty(nq, dtype=torch.float32, device=queries.device)
    if nq == 0:
        return out
    faces = pack_faces(args["tri_a"], args["tri_b"], args["tri_c"])
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    tiles = faces.shape[0] // W_TILE
    splits = max(1, min(tiles, -(-sms * BLOCKS_PER_SM // -(-nq // W_BLOCK_QUERIES))))
    partial = torch.empty((splits, nq), dtype=torch.float32, device=queries.device)
    kernels.launch("winding", "ppsurf_winding", queries.device, kernels.ptr(args["queries"]),
                   kernels.ptr(faces), kernels.ptr(partial), kernels.ptr(out), nq, tiles,
                   splits)
    return out
