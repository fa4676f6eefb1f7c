"""End-to-end reconstruction benchmark of the port: the twin of `bench.py`.

    python3 bench_torch.py [--resolution 257] [--reps 3] [--weights committed|random|PATH]
                           [--prefill 0] [--precision 16|32] [--cloud PLY]
                           [--passes 10] [--refine 10] [--device cuda|cpu]

Times what `bench.py:168-196` times, on the port: the latent encoding on
a seeded device generator, the `FieldEvaluator`, `freeze_gc()`, then
`reconstruct_mesh` (region growing, marching cubes, the evaluator's
bisection refinement, cleanup), ending in `torch.cuda.synchronize()`.
With prefill 0 this is `Predictor.reconstruct_shape`'s path, so a pass
gives its mesh. One untimed pass first builds the kernels (nvcc at first
use into `ppsurf_tpu_torch/_build/`); then `--reps` timed passes.

Workload: PPSurf 50NN (latent 256, k=64, P=50), bf16 on the card (f32
with `--precision 32` or on the CPU, as `cli` chooses), 10 encoder
passes, refine 10, res 257 (`configs/poco.yaml:47-53`). Weights: the
committed `models_pretrained/ppsurf_mini_infer.npz`; `random`: seeded
initial weights with `bench.py`'s analytic sphere blended into the field
(`bench.py:122-130`), so growth and refinement see a surface; or a port
`last.pt` or an inference `.npz`. Cloud: `data/synthetic.torus_cloud(60031,
seed=0)`, or a PLY's vertices.

Prints every pass's seconds on stderr, then a `# detail:` line there
(weights, dtype, resolution, the card and its power limit, phase
seconds, field queries, vertices and faces, kernel launches of one
pass, prefill bands, the field's achieved TFLOP/s), and as the last
stdout line `bench.py`'s four keys: `value` is the median of the passes'
seconds, `vs_baseline` 60 s (the reference's time an object on one
NVIDIA A40, `BASELINE.md`) over it. A failed run prints `bench.py`'s
error line (`"value": null`) and exits 1. It writes no file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
import typing

import numpy as np
import torch

BASELINE_S = 60.0  # the reference: about 1 min an object on one A40 (BASELINE.md)
N_POINTS = 60031
SEED = 0  # the encoder's generator; chip_smoke.py phase 4 reconstructs with seed 0


def metric_name(resolution: int) -> str:
    return f"ppsurf50nn_e2e_reconstruction_res{resolution}"


def parse_args(argv: typing.Optional[typing.Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="PPSurf 50NN end-to-end reconstruction "
                                             "benchmark of the PyTorch/CUDA port")
    ap.add_argument("--resolution", type=int, default=257)
    ap.add_argument("--reps", type=int, default=3, help="timed passes (the median is the value)")
    ap.add_argument("--weights", default="committed",
                    help="'committed' (models_pretrained/ppsurf_mini_infer.npz), 'random' "
                         "(seeded initial weights plus bench.py's sphere), or a last.pt or "
                         "inference .npz")
    ap.add_argument("--prefill", type=int, default=0,
                    help="the region grower's speculative prefill radius (0: off)")
    ap.add_argument("--precision", choices=("16", "32"), default="16",
                    help="16: bf16 on the card; 32: f32")
    ap.add_argument("--cloud", default=None, help="a PLY whose vertices are the cloud")
    ap.add_argument("--passes", type=int, default=10, help="the encoder's passes")
    ap.add_argument("--refine", type=int, default=10, help="bisection iterations")
    ap.add_argument("--device", default=None, help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def load_cloud(path: typing.Optional[str]) -> np.ndarray:
    from ppsurf_tpu_torch.data.synthetic import torus_cloud
    from ppsurf_tpu_torch.io.ply import load_ply

    pts = torus_cloud(N_POINTS, seed=0) if path is None else load_ply(path).vertices
    return np.ascontiguousarray(pts, np.float32)


def sphere_blend(pts: np.ndarray):
    """`bench.py:122-130`: 0.01 x the field plus the signed distance to the
    sphere of radius max |pts|, as `FieldEvaluator`'s transform."""
    radius = float(np.max(np.abs(pts)))

    def blend(vals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return 0.01 * vals + (torch.sqrt((q.float() ** 2).sum(-1)) - radius)

    return blend


def make_predictor(args: argparse.Namespace, device: torch.device):
    """(Predictor, weights label): the 50NN network on `device`."""
    from ppsurf_tpu_torch.convert.checkpoint import load_checkpoint_variables
    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS, Predictor
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    half = args.precision == "16" and device.type == "cuda"
    spec = ppsurf_spec(dtype=torch.bfloat16 if half else torch.float32,
                       gen_subsample_manifold_iter=args.passes, gen_refine_iter=args.refine)
    if args.weights == "random":
        variables = init_variables(spec, seed=0)
    else:
        path = DEFAULT_WEIGHTS if args.weights == "committed" else args.weights
        variables = load_checkpoint_variables(path)
    return Predictor(spec, variables=variables, device=device, verbose=False), args.weights


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def reconstruct(predictor, cloud: np.ndarray, resolution: int, prefill: int = 0,
                transform=None) -> typing.Tuple[typing.Any, dict]:
    """One pass of the timed path: (mesh or None, its record: seconds,
    phase seconds, field queries, grower counts)."""
    from ppsurf_tpu_torch.recon.engine import reconstruct_mesh
    from ppsurf_tpu_torch.recon.field import FieldEvaluator
    from ppsurf_tpu_torch.utils.alloc import freeze_gc

    spec, device = predictor.spec, predictor.device
    timings, stats = {}, {}
    t0 = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(SEED)
    latents = predictor.encoder(torch.from_numpy(cloud).to(device), generator=generator)
    _sync(device)
    timings["encode"] = time.perf_counter() - t0
    evaluator = FieldEvaluator(predictor.net, spec, cloud, latents, transform=transform)
    freeze_gc()
    mesh = reconstruct_mesh(evaluator, input_points=cloud, resolution=resolution, padding=1,
                            mc_value=0.0, refine_iter=spec.gen_refine_iter, out_value=1.0,
                            refine_device=evaluator.refine_bisection, timings=timings,
                            prefill_radius=prefill, stats=stats, device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    # every query the field evaluated: the grid, the refinement's
    # iterates, and the iterates of vertices refined again on the plain path
    queries = evaluator.stat_queries + evaluator.stat_cert_failed * spec.gen_refine_iter
    return mesh, dict(seconds=seconds, timings=timings, queries=queries, **stats)


def card_line(device: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def run_bench(args: argparse.Namespace) -> typing.Tuple[dict, dict]:
    """(result line, detail) of one benchmark run."""
    from ppsurf_tpu_torch.device import resolve_device
    from ppsurf_tpu_torch.ops import kernels
    from ppsurf_tpu_torch.ops.opcount import PEAK_OPS, field_flops
    from ppsurf_tpu_torch.utils.alloc import tune_host_allocator

    tune_host_allocator()
    device = resolve_device(args.device)
    predictor, weights = make_predictor(args, device)
    cloud = load_cloud(args.cloud)
    transform = sphere_blend(cloud) if args.weights == "random" else None

    t0 = time.perf_counter()
    reconstruct(predictor, cloud, args.resolution, args.prefill, transform)
    print(f"# warm-up pass (builds the kernels at first use): "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    passes = []
    for rep in range(args.reps):
        kernels.reset_launches()
        mesh, rec = reconstruct(predictor, cloud, args.resolution, args.prefill, transform)
        rec["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        passes.append(rec)
        print(f"# pass {rep}: {rec['seconds']:.3f} s; "
              + " ".join(f"{k}={v:.3f}s" for k, v in rec["timings"].items()),
              file=sys.stderr, flush=True)
    if mesh is None:
        raise RuntimeError("the field never crossed zero: no mesh")
    value = round(statistics.median(r["seconds"] for r in passes), 3)
    result = {"metric": metric_name(args.resolution), "value": value,
              "unit": "s/object", "vs_baseline": round(BASELINE_S / value, 3)}

    last = passes[-1]
    dtype = predictor.spec.dtype
    peak = PEAK_OPS["bf16"] if dtype == torch.bfloat16 else PEAK_OPS["tf32"] / 3
    field_s = last["timings"]["grow"] + last["timings"]["refine"]
    tflops = last["queries"] * field_flops(predictor.spec) / field_s / 1e12
    detail = {
        "weights": weights, "dtype": str(dtype).replace("torch.", ""),
        "resolution": args.resolution, "card": card_line(device), "device": str(device),
        "points": int(cloud.shape[0]), "prefill": args.prefill,
        "passes_s": [r["seconds"] for r in passes],
        "phases_s": {k: round(v, 3) for k, v in last["timings"].items()},
        "field_queries": last["queries"], "rounds": last["rounds"],
        "prefill_bands": last["prefill_bands"], "prefill_voxels": last["prefill_voxels"],
        "vertices": int(mesh.vertices.shape[0]), "faces": int(mesh.faces.shape[0]),
        "launches": last["launches"],
        "mflop_per_query": round(field_flops(predictor.spec) / 1e6, 3),
        "field_tflops": round(tflops, 3),
        # bf16: the dense bf16 peak; f32: 3xTF32, three TF32 products a product
        "field_share_of_peak": round(tflops * 1e12 / peak, 5),
    }
    return result, detail


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    args = parse_args(argv)
    try:
        result, detail = run_bench(args)
    except Exception as exc:  # the run's boundary: the error line, never a stale value
        traceback.print_exc()
        print(json.dumps({"metric": metric_name(args.resolution), "value": None,
                          "unit": "s/object", "vs_baseline": None,
                          "error": f"{type(exc).__name__}: {exc}"}), flush=True)
        return 1
    print(f"# detail: {json.dumps(detail)}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
