"""Microbenchmark of the selection pass that K2 runs (T1).

    python -m ppsurf_tpu_torch.tools.microbench_extract

Replaces the TPU diagnostic `tools/microbench_extract.py` (`make_kernel`,
`:30-75`, launched at `:87`): k passes over a resident slab of candidate
distances, in seven variants that each keep part of the real pass body, so
the time of a pass can be attributed to its primitives. The shapes are the
TPU tool's (49 152 queries x 1536 candidates, k=64), with rows per query
instead of its (ncand, Q) layout.

On the card (`csrc/select.cu`), persistent warps each hold a query's row in
registers, 48 entries a lane at positions lane + 32 j, while one lane's
1-D bulk copy brings the warp's next row into its shared buffer. The min
variants work on order-preserving 32-bit words (`redux.sync` takes the
warp minimum). Lane 0 writes out[row, i] at pass i:

- `noop`: zeros (the slab is loaded and the loop runs empty);
- `elementwise`: the row's first entry, and +1 over the whole slab per
  pass, so out[:, i] is cand[:, 0] with i rounded increments;
- `sum_only`: the row sum (four lane sums over j = 0..3 mod 4 of all 48
  entries, zeros past the row, added in pairs, then the warp butterfly);
- `min_only`: the row minimum;
- `min_argmin`: the lowest position of the row minimum (one lane scan and
  one warp reduction);
- `min_mask`: the row minimum, after which every entry equal to it is
  masked to 4e12: the i-th smallest distinct value;
- `full`: K2's function, the positions of the k smallest entries, by K2's
  selection (a binary search for the k-th word, no rounds); it runs once
  a row, so its time reads per selection, not per pass, and its k is at
  most 256 (the keys a warp buffers).

No pass's work may be hoisted out of the pass loop: `elementwise` and
`min_mask` change their entries every pass, and the first operations of
the other passes take a zero the compiler cannot prove (pass index AND
ncand >> 16; an empty `asm` that claims to change a register does not
survive into the assembler, which then hoisted the lane sums and minima
out of the loop). A store that no data can trigger reads every entry at
the end, so no load or update is dropped where the output does not read
it (`noop`, `elementwise`). Inputs are finite. What bounds every variant
is its bytes: the slab is read once (302 MB at the default shape, 0.090 ms
at 3.35 TB/s). `pass_loop_sizes` counts the SASS instructions of each
variant's pass loop, which with the times says what a pass costs. Times
are CUDA-event medians over 20 back-to-back launches, so the host's
enqueue between launches is hidden.

Each variant has a plain PyTorch version here that computes the same
numbers (the sum in the kernel's order); the script holds every variant
against it before timing it.
"""
from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import typing

import torch

from ppsurf_tpu_torch.ops import kernels
from ppsurf_tpu_torch.ops.topk_rows import topk_rows_plain

VARIANTS = kernels.EXTRACT_VARIANTS
NCAND_MAX = 1536  # 48 entries a lane
FULL_K_MAX = 256  # the kept keys a warp buffers for `full`
BIG = 4e12  # the mask value of `min_mask`
QUERIES, NCAND, K = 49152, 1536, 64  # the TPU tool's shapes


def _lane_order_sum(cand: torch.Tensor) -> torch.Tensor:
    """Row sums in the kernel's order: lane l holds positions l + 32 j for
    j < 48 (zeros past the row); sum e takes j = e, e + 4, ... in turn, the
    lane adds (s0 + s1) + (s2 + s3), then lanes pair up at distance 16, 8,
    4, 2, 1."""
    q, n = cand.shape
    x = torch.nn.functional.pad(cand, (0, NCAND_MAX - n)).view(q, NCAND_MAX // 32, 32)
    s = [x[:, e] for e in range(4)]
    for j in range(4, NCAND_MAX // 32):
        s[j % 4] = s[j % 4] + x[:, j]
    s = (s[0] + s[1]) + (s[2] + s[3])
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
    (Q, k) f32; for `full`, k <= min(ncand, 256) (the kernel's key buffer;
    `extract_plain` takes any k <= ncand). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    q, n = cand.shape
    if not (1 <= n <= NCAND_MAX and k >= 1
            and (variant != "full" or k <= min(n, FULL_K_MAX))):
        raise ValueError(f"need 1 <= ncand={n} <= {NCAND_MAX}, k={k} >= 1"
                         f" (and k <= min(ncand, {FULL_K_MAX}) for 'full')")
    if cand.device.type == "cpu":
        return extract_plain(cand.float(), variant, k)
    cand = cand.float().contiguous()
    kernels.check_cuda_args("extract", {"cand": cand}, {})
    ld = -(-n // 4) * 4
    if ld != n or cand.data_ptr() % 16:
        # the bulk copy moves rows that start 16-byte aligned and are a
        # multiple of 16 bytes long; the kernel never reads the padding
        padded = cand.new_zeros((q, ld))
        padded[:, :n] = cand
        cand = padded
    out = torch.empty((q, k), dtype=torch.float32, device=cand.device)
    if q:
        kernels.launch(f"extract_{variant}", "ppsurf_extract", cand.device, kernels.ptr(cand),
                       kernels.ptr(out), q, n, k, VARIANTS.index(variant))
    return out


def sass_loops(sass: str) -> typing.Dict[str, typing.List[int]]:
    """Variant -> the instruction counts of the innermost loops of its
    `extract_kernel` in `cuobjdump -sass` output: a loop is a branch back
    to a lower address and the instructions from there to it; loops that
    work an mbarrier (SYNCS) or issue a bulk copy (UBLKCP) are left out.
    For every variant but `full` the one innermost loop is the pass loop."""
    loops: typing.Dict[str, typing.List[int]] = {}
    for part in sass.split("Function : ")[1:]:
        head, body = part.split("\n", 1)
        m = re.search(r"extract_kernelILi(\d+)E", head)
        if m is None:
            continue
        code = {}  # address -> instruction
        for line in body.splitlines():
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                code[int(ins.group(1), 16)] = ins.group(2)
        spans = []
        for a, ins in code.items():
            br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if br and int(br.group(1), 16) < a:
                t = int(br.group(1), 16)
                inside = [i for x, i in code.items() if t <= x <= a]
                if not any(re.search(r"\b(SYNCS|UBLKCP)", i) for i in inside):
                    spans.append((t, a, len(inside)))
        inner = [n for t, a, n in spans
                 if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a for t2, a2, _ in spans)]
        loops[VARIANTS[int(m.group(1))]] = sorted(inner)
    return loops


def pass_loop_sizes(lib_path: str) -> typing.Dict[str, typing.List[int]]:
    """`sass_loops` of the built kernel library (needs the CUDA toolkit's
    cuobjdump beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True,
                          text=True).stdout
    return sass_loops(sass)


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_extract: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"# card: {smi}; slab {QUERIES} x {NCAND} f32, k={K}")
    loops = pass_loop_sizes(kernels.build().path)
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
            for _ in range(20):
                extract(cand, variant, K)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 20)
        ms = statistics.median(times)
        if variant == "full":
            print(f"{variant:12s} {ms:9.4f} ms  {ms * 1e6 / QUERIES:8.3f} ns per selection "
                  f"(one row's {K} smallest); innermost SASS loops {loops.get(variant)} "
                  "instructions", flush=True)
        else:
            print(f"{variant:12s} {ms:9.4f} ms  {ms * 1e3 / K:8.3f} us/pass; pass loop "
                  f"{loops.get(variant)} SASS instructions", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
