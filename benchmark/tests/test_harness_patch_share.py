"""`metrics/patch_search_share.py`: 100 x the `queries` of the traced
window's `field.patch` spans over the window's field queries; nothing
where no `field.patch` span was recorded (a patch within the decoder's
ids, or a program from before the span), the run is untraced, or no span
was recorded. A traced tiny PPSurf 200NN cell on the CPU searches a
patch for every query it evaluates."""
from __future__ import annotations

import types

import pytest

from benchmark.harness import common
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.test_harness_spans import drive
from ppsurf_tpu_torch.utils import spans

READ = common.reader("patch_search_share")


def span(name, **counts):
    s = spans.Span(name, None)
    s.counts.update(counts)
    return s


def run_of(trace, *queries):
    return types.SimpleNamespace(trace=trace, objects=[{"queries": q} for q in queries])


@pytest.mark.parametrize("found, share", [
    ([span("field.chunk"), span("field.patch", queries=600), span("field.patch", queries=400),
      span("field", queries=1000)], 100.0),
    ([span("field.patch", queries=500), span("field.refine", queries=500)], 50.0),
    ([span("field", queries=1000), span("field.chunk"), span("field.refine", queries=200)],
     None),
    ([span("field.patch")], None),
    ([], None),
])
def test_share_of_the_windows_queries(monkeypatch, found, share):
    monkeypatch.setattr(spans.RECORDER, "spans", found)
    assert READ(run_of(object(), 700, 300)) == share
    assert READ(run_of(None, 700, 300)) is None


def test_tiny_pps200nn_cell_searches_every_query():
    assert READ(drive(tiny_cell("pps200nn"), True)) == 100.0


def test_tiny_pps50nn_cell_has_no_patch_search():
    assert READ(drive(tiny_cell("pps50nn"), True)) is None
