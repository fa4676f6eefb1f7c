"""Time K3-K5 of this checkout against another checkout's, in turns on one card.

    python -m ppsurf_tpu_torch.tools.ab_kernels --baseline DIR [--rounds N]

DIR is another checkout of the repository (for example the parent commit,
`git archive <commit> | tar -x -C DIR`). Each side runs in a subprocess of
its own (both packages are `ppsurf_tpu_torch`: this file is run by path
with the side's root first on the path), in the order baseline,
this checkout, this checkout, baseline (N times over), and builds its own
kernels at first use. A side times, with CUDA events (median of 5 calls
after a warm-up), the f32 and bf16 builds of K3 (latent 256, k=64), K4
and K5 (P=50), the f32 K4 and K5 at P=200 (the committed weights) and K3
at latent 32 (k=64, POCO's seeded weights) in both dtypes, on the same
seeded inputs at the field's production shapes (60 031 points, 50 048
queries), and prints one JSON line; the script prints each run and the
medians of each side. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_POINTS, N_QUERIES = 60031, 50048


def _cuda_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def worker() -> dict:
    """Times of this process's `ppsurf_tpu_torch` (the checkout it runs in)."""
    import torch

    from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
    from ppsurf_tpu_torch.convert.init import init_variables
    from ppsurf_tpu_torch.ops.decoder_tail import decoder_tables, decoder_tail
    from ppsurf_tpu_torch.ops.knn import knn
    from ppsurf_tpu_torch.ops.patches import patch_space
    from ppsurf_tpu_torch.ops.pointnet_att import (
        pointnet_head, pointnet_tables, pointnet_trunk, pointnet_trunk_plain, stn_apply,
    )
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS
    from ppsurf_tpu_torch.train.model import poco_spec, ppsurf_spec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand(N_POINTS, 3, generator=gen, device=dev) - 0.5
    q = pts[torch.randint(0, N_POINTS, (N_QUERIES,), generator=gen, device=dev)]
    q = q + 0.02 * torch.randn(q.shape, generator=gen, device=dev)
    lat = torch.randn(N_POINTS, 256, generator=gen, device=dev)
    lat32 = torch.randn(N_POINTS, 32, generator=gen, device=dev)
    variables = load_infer_npz(DEFAULT_WEIGHTS)
    poco_vars = init_variables(poco_spec(), seed=0)
    out = {}
    with torch.inference_mode():
        ids = knn(pts, q, 200)
        k64 = ids[:, :64].contiguous()
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            net = load_network(ppsurf_spec(dtype=dt), variables, dev)
            tabs = decoder_tables(net.projection, dt)
            lat_dt = lat.to(dt)
            out[f"K3 {tag}"] = _cuda_ms(lambda: decoder_tail(lat_dt, pts, q, k64, tabs))
            tabs32 = decoder_tables(load_network(poco_spec(dtype=dt), poco_vars, dev).projection, dt)
            lat32_dt = lat32.to(dt)
            out[f"K3 L=32 {tag}"] = _cuda_ms(lambda: decoder_tail(lat32_dt, pts, q, k64, tabs32))
            pt = pointnet_tables(net.point_net)
            for p in (50, 200) if tag == "f32" else (50,):
                pp = patch_space(pts[ids[:, :p]], q).to(dt).contiguous()
                b, pooled = pointnet_trunk_plain(pp, pt)
                x2 = stn_apply(pooled, b, pt).contiguous()
                out[f"K4 {tag} P={p}"] = _cuda_ms(lambda: pointnet_trunk(pp, pt))
                out[f"K5 {tag} P={p}"] = _cuda_ms(lambda: pointnet_head(x2, pt))
                del pp, b, pooled, x2
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return 0
    roots = {"baseline": os.path.abspath(args.baseline), "this": HERE}
    runs = {"baseline": [], "this": []}
    for side in ("baseline", "this", "this", "baseline") * args.rounds:
        # this file run by path, its `ppsurf_tpu_torch` the side's
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                              cwd=roots[side], capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=roots[side]))
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"# {side}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in runs[side][-1].items()),
              flush=True)
    for side, rs in runs.items():
        print(f"# {side} medians: " + ", ".join(
            f"{k} {statistics.median(r[k] for r in rs):.3f} ms" for k in rs[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
