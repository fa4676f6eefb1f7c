"""The control of a reconstruction cell's limits, on the card at the
cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--seconds 0]

For each seed one process-wide set-up of the cell (its weights from the
seed), a window of `--seconds` (0: one object), then for the window's last
object three sides on the same cloud, weights and generator seed: the
program's recorded outputs, the plain reference in float32 (TF32 off),
and the control, the reference with every product's operands rounded to
float8 e4m3 (`reference/plain.py::fp8_e4m3`, the precision below the
configuration's bf16), whose field and bisection also run the program's
engine in the program's place for a mesh of its own
(`harness/reconstruct.py::control_mesh`). It prints the program's and the control's
numbers (`reference/compare.py::gaps`) a seed, one JSON line each, and
the smallest control reading beside the largest program reading of each
number. `--control 0` reads the program alone (the set-up is made once for
all seeds); `--fault NAME` plants one of the faults of
`tests/drive_tiny.py` in the program first. The benchmark's own runs
never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import typing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def control_readings(cell, seed: int, seconds: float, device, control: bool = True,
                     prepared=None) -> dict:
    """{'program': numbers, 'control': numbers} of one seed; `prepared`,
    the generator's `prepare` of the cell, is the set-up shared by seeds."""
    import torch

    from benchmark.harness import common
    from benchmark.reference import compare, plain

    gen = common.generator(cell.mix["kind"])
    if cell.mix["kind"] == "train":
        return train_readings(cell, gen, seed, seconds, device, control)
    run, _ = gen.run(cell, seed, seconds, False, device, time.perf_counter(), log,
                     prepared=prepared)
    obj = run.objects[-1]
    for o in run.objects[:-1]:
        o.pop("latents", None)
    out = {}
    with torch.no_grad():
        ref = compare.reference_side(cell.config, cell.mix, run.weights, obj, device)
        out["program"] = compare.gaps(compare.program_candidate(obj, cell.config, device),
                                      ref, obj, device)
        if control:
            ctl = compare.reference_side(cell.config, cell.mix, run.weights, obj, device,
                                         q=plain.fp8_e4m3)
            ctl.block = 8192
            t = time.perf_counter()
            mesh = gen.control_mesh(ctl, obj, cell.mix, cell.config["gen_refine_iter"], seed)
            log(f"# control mesh in {time.perf_counter() - t:.3f} s")
            out["control"] = compare.gaps(compare.control_candidate(ctl, obj, cell.config,
                                                                    device, mesh),
                                          ref, obj, device)
    obj.pop("latents", None)
    return out


def train_readings(cell, gen, seed: int, seconds: float, device, control: bool) -> dict:
    """The program's numbers of a training cell, and with `control` the
    control's (the reference in float8 e4m3 in the program's place) and
    those of the half-batch fault planted in the reference (the loss's
    mean over the first half of the batch)."""
    from benchmark.reference import compare_train, plain

    run, check = gen.run(cell, seed, seconds, False, device, time.perf_counter(), log)
    out = {"program": check()}
    if control:
        i = run.inputs
        ref = compare_train.reference_steps(cell.config, cell.mix, i["flat"], i["shapes"],
                                            i["seeds"], device)
        for name, kw in (("control", dict(q=plain.fp8_e4m3)),
                         ("half_batch", dict(half_batch=True))):
            c = compare_train.reference_steps(cell.config, cell.mix, i["flat"], i["shapes"],
                                              i["seeds"], device, **kw)
            out[name] = compare_train.gaps(dict(losses=c["losses"], first_grad=c["first_grad"],
                                                p_end=c["params"]), ref, i["p0"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1,
                    help="0: the program's readings alone")
    ap.add_argument("--fault", default="none",
                    help="a fault of benchmark/tests/drive_tiny.py planted in the program")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import common

    common.set_cache_env()
    if not torch.cuda.is_available():
        log("the control runs on a card")
        return 2
    from benchmark.tests.drive_tiny import plant

    cell = common.find_cell(args.workload)
    plant(args.fault, cell.mix["kind"] == "train")
    device = torch.device("cuda", 0)
    readings = []
    prepared = None
    if cell.mix["kind"] != "train":  # the weights do not hang on the seed
        prepared = common.generator(cell.mix["kind"]).prepare(cell, args.seeds[0], device)
    for seed in args.seeds:
        r = control_readings(cell, seed, args.seconds, device, bool(args.control), prepared)
        readings.append(r)
        print(json.dumps({"seed": seed, "fault": args.fault, **r}), flush=True)
    summary = {k: {"program_max": max(r["program"][k] for r in readings)}
               for k, v in readings[0]["program"].items() if isinstance(v, float)}
    for k in summary:
        for side in readings[0]:
            if side != "program":
                summary[k][side + "_min"] = min(r[side][k] for r in readings)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
