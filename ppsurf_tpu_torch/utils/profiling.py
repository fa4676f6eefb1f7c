"""The profiler preset and the device's time by the program's spans.

`torch_trace` takes the place of the JAX package's `jax_trace` (the
reference's PyTorchProfiler preset, `configs/profiler.yaml`): a
torch.profiler trace of the enclosed work, CPU and, where a card is
present, CUDA activity, written as a Chrome trace (chrome://tracing,
ui.perfetto.dev), and beside it the table `attribute` makes of the
trace's events and the spans `utils/spans.py` recorded in it: for each
span name its count, host seconds, self seconds, the device seconds of
the kernels launched inside it, the device's idle seconds inside it and
its counts summed.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import typing

from ppsurf_tpu_torch.utils import spans as spans_mod

OUTSIDE = "(outside spans)"  # the row of work launched, and idle time, outside every span
TOP_KERNELS = 5  # device events named in a row, longest first


def is_launch(e) -> bool:
    """A host event of the CUDA runtime or driver (`cudaLaunchKernel`,
    `cuLaunchKernel`, `cudaMemcpyAsync`, ...): the call that enqueued the
    device event of the same correlation id. torch 2.11's `_KinetoEvent`
    has no activity type, so the name tells: no operator, annotation or
    span of the program starts with "cu"."""
    return e.name().startswith("cu")


def _innermost_timeline(spans: typing.Sequence[spans_mod.Span]
                        ) -> typing.Tuple[typing.List[int], typing.List[int]]:
    """(times, span index) at every span boundary: from each time on, the
    innermost open span (-1: none) until the next."""
    depth = {}
    for i, s in enumerate(spans):
        d, p = 0, s.parent
        while p is not None:
            d, p = d + 1, p.parent
        depth[i] = d
    bounds = sorted([(s.start_ns, 0, depth[i], i) for i, s in enumerate(spans)]
                    + [(s.end_ns, 1, -depth[i], i) for i, s in enumerate(spans)])
    stack: typing.List[int] = []
    times, owners = [], []
    for t, end, _, i in bounds:
        if end:
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == i:
                    del stack[j]
                    break
        else:
            stack.append(i)
        times.append(t)
        owners.append(stack[-1] if stack else -1)
    return times, owners


def _gaps(intervals: typing.List[typing.Tuple[int, int]]
          ) -> typing.Tuple[int, typing.List[typing.Tuple[int, int]]]:
    """(busy ns, idle gaps) of the union of device intervals."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def attribute(events, spans: typing.Sequence[spans_mod.Span]) -> dict:
    """The device's time and idle gaps by span, from profiler events
    (`_KinetoEvent`s, or objects with their methods) and recorded spans.

    A device event (a kernel, copy or fill; not an annotation) belongs to
    the innermost span open when the host call that enqueued it (the
    runtime or driver event of the same correlation id) started, or, with
    no such call in the trace, when it started itself; an idle instant
    (between the union of device intervals) to the innermost span open
    then. Per span name: `count`, `host_s` (summed durations), `self_s`
    (less what its child spans cover), `device_s` and `device_self_s`
    (the device events inside it and its children, and directly),
    `idle_s` and `idle_self_s` (alike), `top_kernels` ([name, seconds] of
    its own device events, the TOP_KERNELS longest), `counts` (the spans'
    counts summed by name). The row OUTSIDE holds the
    device events and idle time outside every span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    launches: typing.Dict[int, int] = {}
    device = []  # (correlation id, start ns, duration ns, name)
    intervals = []
    unmatched = 0
    for e in events:
        if e.device_type() == cuda:
            dur = e.duration_ns()
            if dur <= 0 or e.is_user_annotation():  # gpu_user_annotation: not work
                continue
            intervals.append((e.start_ns(), e.start_ns() + dur))
            device.append((e.correlation_id(), e.start_ns(), dur, e.name()))
        elif is_launch(e):
            launches.setdefault(e.correlation_id(), e.start_ns())

    spans = list(spans)
    index = {id(s): i for i, s in enumerate(spans)}
    parent = [index.get(id(s.parent), -1) if s.parent is not None else -1 for s in spans]
    times, owners = _innermost_timeline(spans)

    def owner_at(t: int) -> int:
        k = bisect.bisect_right(times, t) - 1
        return owners[k] if k >= 0 else -1

    names = [s.name for s in spans]
    rows: typing.Dict[str, dict] = {}

    def row(name: str) -> dict:
        if name not in rows:
            rows[name] = dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0,
                              device_self_s=0.0, idle_s=0.0, idle_self_s=0.0,
                              top_kernels=collections.Counter(), counts=collections.Counter())
        return rows[name]

    for i, s in enumerate(spans):
        r = row(s.name)
        r["count"] += 1
        r["counts"].update(s.counts)
        r["host_s"] += s.seconds
        r["self_s"] += s.seconds
        if parent[i] >= 0:
            row(names[parent[i]])["self_s"] -= s.seconds

    def chain(i: int) -> typing.Set[str]:
        """The names of span i and its ancestors, each once."""
        out = set()
        while i >= 0:
            out.add(names[i])
            i = parent[i]
        return out

    for corr, start, dur, kname in device:
        t = launches.get(corr)
        if t is None:
            unmatched += 1
            t = start
        i = owner_at(t)
        own = row(names[i] if i >= 0 else OUTSIDE)
        own["device_self_s"] += dur * 1e-9
        own["top_kernels"][kname] += dur * 1e-9
        for name in (chain(i) if i >= 0 else {OUTSIDE}):
            rows[name]["device_s"] += dur * 1e-9

    busy, gaps = _gaps(intervals)
    starts = [a for a, _ in gaps]
    cum = [0]
    for a, b in gaps:
        cum.append(cum[-1] + b - a)

    def idle_before(t: int) -> int:
        j = bisect.bisect_right(starts, t)
        if j == 0:
            return 0
        a, b = gaps[j - 1]
        return cum[j - 1] + min(t, b) - a

    for i, s in enumerate(spans):
        rows[s.name]["idle_s"] += (idle_before(s.end_ns) - idle_before(s.start_ns)) * 1e-9
    edges = [-(2 ** 63)] + times + [2 ** 63 - 1]
    seg_owner = [-1] + owners
    for k, i in enumerate(seg_owner):
        idle = idle_before(edges[k + 1]) - idle_before(edges[k])
        if idle:
            r = row(names[i] if i >= 0 else OUTSIDE)
            r["idle_self_s"] += idle * 1e-9
            if i < 0:
                r["idle_s"] += idle * 1e-9
    for r in rows.values():
        r["top_kernels"] = [[n, s] for n, s in r["top_kernels"].most_common(TOP_KERNELS)]
        r["counts"] = dict(r["counts"])
    window = (min(a for a, _ in intervals), max(b for _, b in intervals)) if intervals else (0, 0)
    return dict(device_window_s=(window[1] - window[0]) * 1e-9, busy_s=busy * 1e-9,
                idle_s=cum[-1] * 1e-9, device_events=len(device), launch_unmatched=unmatched,
                spans=rows)


@contextlib.contextmanager
def torch_trace(log_dir: str = "profiles", enabled: bool = True,
                file_name: str = "trace.json"):
    """Trace the enclosed work with torch.profiler (CPU activity, and CUDA
    activity where a card is present) and write it to
    `log_dir/file_name` as a Chrome trace, with `attribute` of it as
    `<file_name without .json>.spans.json` beside; yields the profiler
    (None when not `enabled`). The spans recorded inside form the
    recorder's window. The card is synchronised before the trace stops,
    so the enclosed kernels are in it."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        spans_mod.RECORDER.start_window()
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, file_name))
    stem = file_name[:-5] if file_name.endswith(".json") else file_name
    with open(os.path.join(log_dir, stem + ".spans.json"), "w") as fp:
        json.dump(attribute(prof.profiler.kineto_results.events(), spans_mod.RECORDER.spans),
                  fp, indent=1)
