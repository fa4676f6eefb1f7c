#!/usr/bin/env python3
"""Control for the limits that `chip_smoke.py` holds K3, K4, K5 (bf16 and
f32) and W1 (the metrics' winding number) to.

    python3 chip_rounding_control.py [--only TEXT]

Runs `chip_smoke.py` (with a short reconstruction, without the campaign
phase) on this checkout and on
copies of it in which one step of a kernel is removed: a rounding step of
the bf16 K3-K5 epilogues, a term or rounding of the f32 K3-K5's 3xTF32
products, or a term, guard, choice or float64 repair of W1's arithmetic.
It prints each run's kernel check lines and exit code. The limits are
sound where the unchanged run passes and each copy fails the checks of the
kernel it changes (for the 3xTF32 copies of `mma_steps_tf32x3`, whose
products the f32 K3 at latent 256, K4 and K5 share, the f32 checks of
each must fail; for those of `mma_regs_tf32x3`, the f32 latent-32 K3's;
for W1's near-plane repair and its bound, a line of the near-plane probe;
for its near-edge repair, a seeded soup's float64 check). `--only`
runs the mutants whose name holds TEXT. Needs one CUDA card; the copies
live in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_ARGS = ["--resolution", "33", "--passes", "1", "--refine", "1", "--no-campaign"]

# the f32 checks of the kernels whose products go through
# `gmma.cuh::mma_steps_tf32x3` (K3 at latent 256, K4, K5) and of the
# latent-32 K3, whose register-fed products are `mma_regs_tf32x3`'s
F32_CHECKS = ("# K3 decoder_tail f32 ", "# K4 pointnet_trunk f32 ", "# K5 pointnet_head f32 ")
L32_F32_CHECKS = ("# K3 decoder_tail L=32 k=64 f32 ",)
# W1's near-plane probe (every line of it) and its seeded soups (any seed)
W1_PLANE_CHECKS = ("# W1 winding 2048 queries within f32 rounding of the planes of ",)
W1_SOUP_CHECKS = ("# W1 winding 2048 cube samples x 200000 large triangles, seed ",)
THREE_TERMS = (
    "#pragma unroll\n"
    "  for (int kk = 0; kk < 2; ++kk) {\n"
    "    wgmma_m64n64k8_tf32_rs(d, ah[kk], desc_sw128(b + TF32_TILE + 32 * kk), accumulate | kk);"
    "  // hi x lo\n"
    "    wgmma_m64n64k8_tf32_rs(d, al[kk], desc_sw128(b + 32 * kk), 1);  // lo x hi\n"
    "  }\n"
    "#pragma unroll\n"
    "  for (int kk = 0; kk < 2; ++kk)\n"
    "    wgmma_m64n64k8_tf32_rs(d, ah[kk], desc_sw128(b + 32 * kk), 1);  // hi x hi\n")

# name -> (source, text, the text with one step removed[, the check lines
# that must each fail])
MUTANTS = {
    "K3-K5 f32 3xTF32: one TF32 term (hi x hi) only": (
        "ppsurf_tpu_torch/csrc/gmma.cuh", THREE_TERMS,
        "#pragma unroll\n"
        "  for (int kk = 0; kk < 2; ++kk)\n"
        "    wgmma_m64n64k8_tf32_rs(d, ah[kk], desc_sw128(b + 32 * kk), accumulate | kk);"
        "  // hi x hi\n",
        F32_CHECKS),
    "K3-K5 f32 3xTF32: lo x hi dropped": (
        "ppsurf_tpu_torch/csrc/gmma.cuh",
        "    wgmma_m64n64k8_tf32_rs(d, al[kk], desc_sw128(b + 32 * kk), 1);  // lo x hi\n",
        "", F32_CHECKS),
    "K3-K5 f32 3xTF32: hi by truncation, not cvt.rna": (
        "ppsurf_tpu_torch/csrc/gmma.cuh",
        "  hi = tf32_rna(x);\n",
        "  hi = __float_as_uint(x) & 0xffffe000u;\n", F32_CHECKS),
    "K3 latent 32 f32 3xTF32 (register-fed): one TF32 term (hi x hi) only": (
        "ppsurf_tpu_torch/csrc/gmma.cuh",
        "#pragma unroll\n"
        "  for (int g = 0; g < 4; ++g) {\n"
        "    mma(ah[g], b + N * 128 + 32 * g, g);  // hi x lo\n"
        "    mma(al[g], b + 32 * g, 1);  // lo x hi\n"
        "  }\n"
        "#pragma unroll\n"
        "  for (int g = 0; g < 4; ++g)\n"
        "    mma(ah[g], b + 32 * g, 1);  // hi x hi\n",
        "#pragma unroll\n"
        "  for (int g = 0; g < 4; ++g)\n"
        "    mma(ah[g], b + 32 * g, g);  // hi x hi\n",
        L32_F32_CHECKS),
    "K3 latent 32 f32 3xTF32 (register-fed): lo x hi dropped": (
        "ppsurf_tpu_torch/csrc/gmma.cuh",
        "    mma(al[g], b + 32 * g, 1);  // lo x hi\n",
        "", L32_F32_CHECKS),
    "K4/K5 bf16 epilogue: dense output not rounded before its bias": (
        "ppsurf_tpu_torch/csrc/pointnet.cu",
        "float2 y = rnd2(acc0, acc1);",
        "float2 y = make_float2(acc0, acc1);"),
    "K4/K5 bf16 epilogue: bias sum not rounded before the BN affine": (
        "ppsurf_tpu_torch/csrc/pointnet.cu",
        "y = rnd2(y.x + b.x, y.y + b.y);",
        "y = make_float2(y.x + b.x, y.y + b.y);"),
    "K5 bf16 softmax weight not rounded": (
        "ppsurf_tpu_torch/csrc/pointnet.cu",
        "const float att = rnd<bf16>(e / s);",
        "const float att = e / s;"),
    "K5 bf16 softmax weight not rounded, a patch's tiles on a cluster": (
        "ppsurf_tpu_torch/csrc/pointnet.cu",
        "const float weight = rnd<bf16>(mine_e / s);",
        "const float weight = mine_e / s;"),
    "K5 bf16 fc_value epilogue: product not rounded before its bias": (
        "ppsurf_tpu_torch/csrc/pointnet.cu",
        "const float2 v = rnd2(acc0, acc1);",
        "const float2 v = make_float2(acc0, acc1);"),
    "K3 wgmma epilogue: product not rounded before its bias (fc2, fc3, fc_query, fc_value)": (
        "ppsurf_tpu_torch/csrc/decoder_tail.cu",
        "return rnd<bf16>(rnd<bf16>(acc) + b);",
        "return rnd<bf16>(acc + b);"),
    "K3 latent 32 epilogue: product not rounded before its bias (fc2, fc3, fc_query, fc_value)": (
        "ppsurf_tpu_torch/csrc/decoder_tail.cu",
        "return rnd<T>(rnd<T>(x) + bias);",
        "return rnd<T>(x + bias);"),
    "K3 latent 32 head-mean attention not rounded": (
        "ppsurf_tpu_torch/csrc/decoder_tail.cu",
        "return real ? rnd<T>(sum / HEADS) : 0.f;",
        "return real ? sum / HEADS : 0.f;"),
    "K3 head-mean attention not rounded": (
        "ppsurf_tpu_torch/csrc/decoder_tail.cu",
        "att[tid] = tid < kn ? rnd<T>(a / HEADS) : 0.f;",
        "att[tid] = tid < kn ? a / HEADS : 0.f;"),
    "W1 arctangent: the polynomial's highest term dropped": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "      -0.004822535f,\n",
        ""),
    "W1 vertex guard removed (0 / 0 for a query on a vertex)": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "const float hi = fmaxf(fmaxf(an, ad), W_FLT_MIN);",
        "const float hi = fmaxf(an, ad);"),
    "W1 numerator of a query on or near C not taken from C (a . N rounds there)": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "  n = lc < fminf(la, lb) ? nc : n;\n",
        ""),
    "W1 numerator a . N for every query (the first design's, near B and C)": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "  n = lb < la ? nb : na;\n"
        "  n = lc < fminf(la, lb) ? nc : n;\n",
        "  n = na;\n"),
    "W1 near-plane numerator not taken again in float64 (its f32 sign kept)": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "          if (edge || d[j] < 0.f) t = repair_terms(",
        "          if (edge) t = repair_terms(", W1_PLANE_CHECKS),
    "W1 numerator bound shrunk 16x (3 eps to 3/16 eps)": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "constexpr float W1_NUM_ERR_EPS = 3.0f;",
        "constexpr float W1_NUM_ERR_EPS = 0.1875f;", W1_PLANE_CHECKS),
    "W1 near-edge terms not taken in float64": (
        "ppsurf_tpu_torch/csrc/winding.cu",
        "          const bool edge = fmaxf(fabsf(n[j]), fabsf(d[j])) <= W1_EDGE * l3[j];",
        "          const bool edge = false;", W1_SOUP_CHECKS),
}
# what chip_smoke.py needs of the checkout
NEEDED = ("chip_smoke.py", "bench_torch.py", "ppsurf_tpu_torch", "native", "models_pretrained", "configs")
SKIP = shutil.ignore_patterns("_build", "__pycache__")


def run_smoke(root: str, must_fail=()) -> bool:
    """Whether the smoke fails on the checkout at `root`, and each check
    line that starts with one of `must_fail` says FAILED."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", *SMOKE_ARGS], cwd=root,
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith(("# K3", "# K4", "# K5", "# W1")):
            print(f"  {line}")
    if proc.returncode != 0 and proc.stderr.strip():
        print(f"  {proc.stderr.strip().splitlines()[-1]}")
    print(f"  exit code {proc.returncode}", flush=True)
    return proc.returncode != 0 and all(
        any(line.startswith(check) and line.endswith("FAILED") for line in lines)
        for check in must_fail)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="", help="run the mutants whose name holds this text")
    args = ap.parse_args()
    print("== unchanged", flush=True)
    if run_smoke(HERE):
        print("chip_rounding_control: the unchanged checkout fails", file=sys.stderr)
        return 1
    missed = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (source, text, mutated, *must_fail)) in enumerate(MUTANTS.items()):
            if args.only not in name:
                continue
            copy = os.path.join(tmp, f"m{i}")
            for item in NEEDED:
                src_path = os.path.join(HERE, item)
                if os.path.isdir(src_path):
                    shutil.copytree(src_path, os.path.join(copy, item), ignore=SKIP)
                else:
                    os.makedirs(copy, exist_ok=True)
                    shutil.copy2(src_path, copy)
            path = os.path.join(copy, source)
            with open(path) as fp:
                src = fp.read()
            if src.count(text) != 1:
                print(f"chip_rounding_control: `{text}` is not once in {source}",
                      file=sys.stderr)
                return 1
            with open(path, "w") as fp:
                fp.write(src.replace(text, mutated))
            print(f"== {name}", flush=True)
            if not run_smoke(copy, *must_fail):
                missed.append(name)
    print(f"mutants the limits miss: {missed or 'none'}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
