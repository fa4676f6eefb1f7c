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
add exactly 0), each tile's sum added into an f32 accumulator. The CUDA
kernel (`csrc/winding.cu`) runs one thread per query over faces staged in
shared memory and splits the face axis over blocks, adding the splits in
a fixed order; its sums round in another order than torch's, so the two
agree to rounding, not bit for bit.

What bounds it on an H100: operations. 64 f32 additions and
multiplications, three square roots and an arctangent for each (query,
face) pair; 100 000 queries against a 647 000-face mesh are 6.5e10 pairs,
about 4.2e12 operations. The bytes are a few MB.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ppsurf_tpu_torch.ops import kernels

F_TILE = 8192  # faces a step of the plain version: (1024, F_TILE, 3) temporaries
Q_TILE = 1024
W_TILE = 256  # faces a step of the kernel (csrc/winding.cu)
W_THREADS = 128  # queries a block of the kernel
# blocks the kernel aims for per SM: the face axis is split until the grid
# fills the card about 8 times over (16 blocks an SM at once)
BLOCKS_PER_SM = 8 * 16


def winding_plain(queries: torch.Tensor, tri_a: torch.Tensor, tri_b: torch.Tensor,
                  tri_c: torch.Tensor, q_tile: int = Q_TILE) -> torch.Tensor:
    """Plain PyTorch version of W1, tiled as `_winding_tiled`."""
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


def winding(queries: torch.Tensor, tri_a: torch.Tensor, tri_b: torch.Tensor,
            tri_c: torch.Tensor) -> torch.Tensor:
    """Winding numbers (Q,) f32 of `queries` (Q, 3) against the triangles
    `tri_a`, `tri_b`, `tri_c` (F, 3).

    CPU tensors take the plain version; CUDA tensors launch W1.
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
    nq, nf = queries.shape[0], tri_a.shape[0]
    out = torch.empty(nq, dtype=torch.float32, device=queries.device)
    if nq == 0:
        return out
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    tiles = max(1, -(-nf // W_TILE))
    splits = max(1, min(tiles, -(-sms * BLOCKS_PER_SM // -(-nq // W_THREADS))))
    partial = torch.empty((splits, nq), dtype=torch.float32, device=queries.device)
    kernels.launch("winding", "ppsurf_winding", *(kernels.ptr(t) for t in args.values()),
                   kernels.ptr(partial), kernels.ptr(out), nq, nf, splits)
    return out
