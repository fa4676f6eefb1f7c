"""Positions of the k smallest of kc candidate distances per query (kernel K2).

Replaces the TPU kernel `_topk_rows_kernel` (`ppsurf_tpu/ops/knn_pallas.py:269`,
launched at `:315` through `topk_rows_pallas`), which the candidate
refinement calls once per bisection iteration (`ppsurf_tpu/recon/field.py:341-352`)
to pick each iterate's exact k nearest from its kc certified candidates.

Contract: `d2` (C, kc) f32, one row of candidate distances per query,
kc <= 256 and k <= kc -> (C, k) int64 positions in [0, kc), ascending by
(value, position): `torch.sort(d2, dim=1, stable=True)[1][:, :k]`, which is
the plain version. Rows are per query (the TPU kernel's (kc, C) layout
served its sublane reductions), so the result feeds `ids.gather(1, pos)`.

The TPU kernel masks each chosen entry with a large constant and so needs
inputs below 2e12. The CUDA kernel (`csrc/select.cu`) reserves no value and
runs no rounds: one warp per row, lane l holding the order-preserving 32-bit
words of positions l, l+32, ... (torch.sort's order: NaN last, -0 == +0).
A warp binary search between the row's least and greatest word finds W, the
word of the k-th key (one `redux.sync` count a step, stopping where exactly
k words lie at or below the midpoint); the words below W and the first
(k - #below) words at W in position order are compacted into a shared
buffer by ballot, and each kept position is written at its rank among them.

What bounds it on an H100: bytes. It reads C*kc*4 and writes C*k*8 bytes,
64 MB at the refinement's C=50 048, kc=192, k=64: 0.019 ms at 3.35 TB/s.
A selection needs about kc*log2(k) compares a row (6e7 in all), 0.001 ms
at the 67 TFLOP/s f32 rate. What the kernel adds is instructions: about 25
search steps of kc/32 compares and a reduction each, and k ranks of k
compares each.
"""
from __future__ import annotations

import torch

from ppsurf_tpu_torch.ops import kernels

KC_MAX = 256  # the widest row the kernel holds in registers (8 words a lane)


def topk_rows_plain(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of K2: a stable sort of each row."""
    return torch.sort(d2, dim=1, stable=True)[1][:, :k]


def topk_rows(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (C, k) int64 of the k smallest entries of each row of
    `d2` (C, kc), ascending, ties to the lower position.

    CPU tensors take the plain version; CUDA tensors launch K2.
    """
    if d2.dim() != 2:
        raise ValueError(f"d2 must be (C, kc), got {tuple(d2.shape)}")
    c, kc = d2.shape
    if not 1 <= k <= kc <= KC_MAX:
        raise ValueError(f"need 1 <= k={k} <= kc={kc} <= {KC_MAX}")
    if d2.device.type == "cpu":
        return topk_rows_plain(d2.float(), k)
    d2 = d2.float().contiguous()
    kernels.check_cuda_args("topk_rows", {"d2": d2}, {})
    out = torch.empty((c, k), dtype=torch.int64, device=d2.device)
    if c:
        kernels.launch("topk_rows", "ppsurf_topk_rows", d2.device, kernels.ptr(d2),
                       kernels.ptr(out), c, kc, k)
    return out
