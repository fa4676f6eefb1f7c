"""Microbenchmark of the selection pass that K2 runs (T1).

    python -m ppsurf_tpu_torch.tools.microbench_extract

Replaces the TPU diagnostic `tools/microbench_extract.py` (`make_kernel`,
`:30-75`, launched at `:87`): k passes over a resident slab of candidate
distances, in seven variants that each keep part of the real pass body, so
the time of a pass can be attributed to its primitives. The shapes are the
TPU tool's (49 152 queries x 1536 candidates, k=64), with rows per query
instead of its (ncand, Q) layout.

On the card, one warp holds a query's row in registers, 48 entries a lane
(K2's layout, `csrc/select.cu`), and lane 0 writes out[row, i] at pass i:

- `noop`: zeros (the slab is loaded and the loop runs empty);
- `elementwise`: the row's first entry, and +1 over the whole slab per
  pass, so out[:, i] is cand[:, 0] with i rounded increments;
- `sum_only`: the row sum (lane sums in position order, then the warp
  butterfly);
- `min_only`: the row minimum (lane minimum and warp butterfly);
- `min_argmin`: the lowest position of the row minimum;
- `min_mask`: the row minimum, after which every entry equal to it is
  masked to 4e12: the i-th smallest distinct value;
- `full`: K2's pass, the positions of the k smallest entries.

Each pass works on registers the compiler must treat as changed, so no
variant's work is hoisted out of the loop, and a store that no data can
trigger reads every entry at the end, so no load or update is dropped
where the output does not read it (`noop`, `elementwise`). Inputs are
finite. What bounds every variant is its bytes: the slab is read once
(302 MB at the default shape, 0.090 ms at 3.35 TB/s).

Each variant has a plain PyTorch version here that computes the same
numbers (the sum in the kernel's order); the script holds every variant
against it before timing it.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from ppsurf_tpu_torch.ops import kernels
from ppsurf_tpu_torch.ops.topk_rows import topk_rows_plain

VARIANTS = kernels.EXTRACT_VARIANTS
NCAND_MAX = 1536  # 48 entries a lane
BIG = 4e12  # the mask value of `min_mask`
QUERIES, NCAND, K = 49152, 1536, 64  # the TPU tool's shapes


def _lane_order_sum(cand: torch.Tensor) -> torch.Tensor:
    """Row sums in the kernel's order: lane l sums positions l, l+32, ...
    in turn, then lanes pair up at distance 16, 8, 4, 2, 1."""
    q, n = cand.shape
    per = -(-n // 32)
    x = torch.nn.functional.pad(cand, (0, per * 32 - n)).view(q, per, 32)
    s = x[:, 0]
    for j in range(1, per):
        s = s + x[:, j]
    for half in (16, 8, 4, 2, 1):
        s = s[:, :half] + s[:, half:2 * half]
    return s[:, 0]


def extract_plain(cand: torch.Tensor, variant: str, k: int) -> torch.Tensor:
    """Plain PyTorch version of each variant: cand (Q, ncand) f32 ->
    (Q, k) f32."""
    q, n = cand.shape
    if variant == "noop":
        return torch.zeros((q, k), dtype=torch.float32, device=cand.device)
    if variant == "elementwise":
        col, cols = cand[:, 0], []
        for _ in range(k):
            cols.append(col)
            col = col + 1.0
        return torch.stack(cols, dim=1)
    if variant == "full":
        return topk_rows_plain(cand, k).float()
    if variant == "min_mask":
        x, cols = cand, []
        for _ in range(k):
            m = x.amin(dim=1, keepdim=True)
            cols.append(m[:, 0])
            x = torch.where(x <= m, torch.full_like(x, BIG), x)
        return torch.stack(cols, dim=1)
    if variant == "sum_only":
        row = _lane_order_sum(cand)
    elif variant == "min_only":
        row = cand.amin(dim=1)
    elif variant == "min_argmin":
        m = cand.amin(dim=1, keepdim=True)
        pos = torch.arange(n, device=cand.device).expand(q, n)
        row = torch.where(cand <= m, pos, n).amin(dim=1).float()
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return row[:, None].expand(q, k).contiguous()


def extract(cand: torch.Tensor, variant: str, k: int) -> torch.Tensor:
    """k passes of `variant` over cand (Q, ncand) f32, ncand <= 1536 ->
    (Q, k) f32. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    q, n = cand.shape
    if not (1 <= n <= NCAND_MAX and k >= 1 and (variant != "full" or k <= n)):
        raise ValueError(f"need 1 <= ncand={n} <= {NCAND_MAX}, k={k} >= 1"
                         " (and k <= ncand for 'full')")
    if cand.device.type == "cpu":
        return extract_plain(cand.float(), variant, k)
    cand = cand.float().contiguous()
    kernels.check_cuda_args("extract", {"cand": cand}, {})
    out = torch.empty((q, k), dtype=torch.float32, device=cand.device)
    if q:
        kernels.launch(f"extract_{variant}", "ppsurf_extract", kernels.ptr(cand),
                       kernels.ptr(out), q, n, k, VARIANTS.index(variant))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_extract: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"# card: {smi}; slab {QUERIES} x {NCAND} f32, k={K}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cand = torch.rand((QUERIES, NCAND), generator=gen, device="cuda")
    for variant in VARIANTS:
        if not torch.equal(extract(cand, variant, K), extract_plain(cand, variant, K)):
            print(f"{variant:12s} FAILED: differs from its plain version", flush=True)
            return 1
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            extract(cand, variant, K)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        print(f"{variant:12s} {ms:9.4f} ms  {ms * 1e3 / K:8.3f} us/pass", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
