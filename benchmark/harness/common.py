"""What every cell shares: finding a cell's files by name, the run's
environment, the card, the result line, and the profiler's trace.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`,
the file its entry gives), a traffic mix (`traffic/<name>.json`, whose
`kind` names the generator `harness/<kind>.py` that reads it) and, through
the metrics' entries, its metric readers (`metrics/<name>.py`, each with
`read(run) -> float | None`). Adding a configuration, a mix or a metric is
adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import typing

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ppsurf_tpu")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")  # fixed, inside the checkout


def load_json(path: str) -> typing.Any:
    with open(path) as fp:
        return json.load(fp)


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    name: str
    config: dict
    mix: dict
    end_to_end: typing.List[dict]
    per_layer: typing.List[dict]
    limits: typing.Dict[str, float]  # each compared number's limit (`limits/<name>.json`)


def find_cell(name: str, bench: typing.Optional[dict] = None) -> Cell:
    """The workload `name`, its configuration and mix files, and the
    metrics it reports: an end-to-end metric in the cells its `workloads`
    lists, or in every cell without the key; a per-layer metric in the
    cells its `workloads` lists (the key is required)."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    return Cell(name, config, mix, e2e, layer, limits)


def reader(metric: str) -> typing.Callable[[typing.Any], typing.Optional[float]]:
    """`read` of `metrics/<metric>.py`, loaded by its file path (a name
    may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def generator(kind: str):
    """The module `harness/<kind>.py` that runs a mix of this kind."""
    return importlib.import_module(f"benchmark.harness.{kind}")


def set_cache_env() -> None:
    """Every build and kernel cache the run could write, at fixed paths
    inside the checkout (the program's CUDA library builds into its own
    `ppsurf_tpu_torch/_build/`)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> typing.List[str]:
    """Loaded modules whose top-level name (before the first dot) is in
    FORBIDDEN, compared whole: `ppsurf_tpu_torch` is not `ppsurf_tpu`."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_info(torch) -> typing.Tuple[str, str]:
    """(torch's device name, nvidia-smi's name and power limit)."""
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unavailable"
    return name, smi


def finite(x: typing.Optional[float]) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


# --- the profiler's trace -------------------------------------------------

@dataclasses.dataclass
class Trace:
    """Device activity of a traced window: per kernel name its seconds
    and launches, the union of busy intervals, the window's length, and
    the longest idle gaps named by the harness's phase they fell in."""

    kernels: typing.Dict[str, typing.List[float]]  # name -> [seconds, count]
    busy_s: float
    window_s: float
    gaps: typing.List[typing.Tuple[str, float]]

    def sum_matching(self, parts: typing.Sequence[str]) -> typing.Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds any of parts."""
        sec, cnt = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if any(p in name for p in parts):
                sec += s
                cnt += int(c)
        return sec, cnt


def reduce_trace(prof, phases: typing.Sequence[typing.Tuple[str, int, int]],
                 window_ns: typing.Tuple[int, int]) -> Trace:
    """Reduce a `torch.profiler.profile` to a Trace. `phases` are (name,
    start, end) of the harness's spans and `window_ns` the window, both in
    `time.monotonic_ns()`'s clock; the device events are moved onto that
    clock by the offset of the profiler's own clock (read at the trace's
    start) where they differ."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = []
    kernels: typing.Dict[str, typing.List[float]] = {}
    for e in events:
        if e.device_type() != cuda:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        spans.append((start, start + dur))
        k = kernels.setdefault(e.name(), [0.0, 0])
        k[0] += dur * 1e-9
        k[1] += 1
    spans.sort()
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    w0, w1 = window_ns
    # the device clock against the host's monotonic clock: the first
    # device event follows the window's start closely, never precedes it
    offset = 0
    if spans and not (w0 - 10**9 <= spans[0][0] <= w1 + 10**9):
        offset = spans[0][0] - w0
    window_s = (w1 - w0) * 1e-9
    if spans:  # the window as the device saw it, from the first to the last event
        window_s = max(window_s, (cur_e - spans[0][0]) * 1e-9)

    def phase_of(t: int) -> str:
        t -= offset
        for name, a, b in phases:
            if a <= t <= b:
                return name
        return "between phases"

    named = sorted(((phase_of((a + b) // 2), (b - a) * 1e-9) for a, b in gaps),
                   key=lambda g: -g[1])
    return Trace(kernels, busy * 1e-9, window_s, named[:10])
