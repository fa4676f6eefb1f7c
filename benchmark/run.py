"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: set up (torch and the card, the program's
kernel library from its cache in the checkout, the weights, the cell's
inputs from the seed, one warm object or step at the cell's own shapes),
run the cell's traffic back to back for `--seconds`, then, with the
window closed and its numbers read, compare a sample of what the timed
path produced with the plain reference. The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and last `checks` (each number
compared, with its limit). The checks are also the last lines of standard
error. Without a card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402  (set-up runs from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, cell=None, device=None) -> int:
    """One run. `cell` and `device` serve the tests only: a cell built in
    place of one of BENCHMARK.json's, on a device that is not a card."""
    args = parse_args(argv)
    from benchmark.harness import common

    common.set_cache_env()
    try:
        chips = 1
        if cell is None:
            bench = common.load_json(os.path.join(ROOT, "BENCHMARK.json"))
            cell = common.find_cell(args.workload, bench)
            chips = {w["name"]: w for w in bench["workloads"]}[args.workload]["chips"]
        import torch

        if device is None:
            if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
                log(f"no result: the cell needs {chips} card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
                return 2
            device = torch.device("cuda", 0)
        on_card = device.type == "cuda"
        kind, card = common.card_info(torch) if on_card else ("cpu", "cpu")
        log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        gen = common.generator(cell.mix["kind"])
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        run, check = gen.run(cell, args.seed, args.seconds, bool(args.trace), device,
                             T_START, log)
        memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
        metrics = {}
        for m in (cell.per_layer if args.trace else cell.end_to_end):
            value = common.reader(m["name"])(run)
            if common.finite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = time.perf_counter()
        numbers = check()
        log(f"# reference compared in {time.perf_counter() - t:.3f} s")
    except Exception:  # the run's boundary: no result line, a non-zero exit
        traceback.print_exc()
        return 1
    bad = common.forbidden_modules()
    if bad:
        log(f"no result: modules of JAX or the JAX package are loaded: {bad}")
        return 3
    checks = {k: [numbers.get(k, float("inf")), lim] for k, lim in cell.limits.items()}
    correct = run.failed == 0 and all(common.finite(v) and v <= lim
                                      for v, lim in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": memory_peak}
    line = {"correct": correct, "attempted": len(run.objects), "failed": run.failed,
            "metrics": metrics, "device": device_info}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        top = sorted(run.trace.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        line["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in top],
                             "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} (limit {lim!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
