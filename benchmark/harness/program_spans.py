"""The program's own spans over a traced window, for the per-layer
metrics that read them (`metrics/encode_graph_s.py` and the others that
say so).

The program records its spans (`ppsurf_tpu_torch/utils/spans.py`) while
a torch.profiler trace runs, so in a `--trace 1` run they are the
window's: the harness starts its profiler after the warm object or the
set-up steps, whose spans ran untraced. A run with no trace, or a
program without the recorder, gives nothing.
"""
from __future__ import annotations

import typing


def recorded(run) -> typing.Optional[list]:
    """The spans of the run's traced window, or None."""
    if run.trace is None:
        return None
    try:
        from ppsurf_tpu_torch.utils import spans
    except ImportError:
        return None
    return list(spans.RECORDER.spans) or None


def ancestor(span, names: typing.Collection[str]):
    """The nearest enclosing span of `span` named in `names`, or None."""
    p = span.parent
    while p is not None and p.name not in names:
        p = p.parent
    return p


def seconds_per(run, units: int, name: str,
                inside: typing.Optional[typing.Collection[str]] = None) -> typing.Optional[float]:
    """The seconds of the window's spans called `name` (only those inside
    a span named in `inside`, where given) over `units` objects or steps;
    None where there are none."""
    found = recorded(run)
    if not found or units <= 0:
        return None
    found = [s for s in found if s.name == name
             and (inside is None or ancestor(s, inside) is not None)]
    if not found:
        return None
    return sum(s.seconds for s in found) / units
