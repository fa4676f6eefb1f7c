"""`metrics/encode_replay_share.py`: 100 x replays / chunks over the
traced window's `encode` spans; nothing where the encoder counts no
chunks (a program from before the counts), the run is untraced, or no
span was recorded. On the CPU the encoder runs its chunks op by op, so a
traced tiny cell reads 0."""
from __future__ import annotations

import types

import pytest

from benchmark.harness import common
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.test_harness_spans import drive
from ppsurf_tpu_torch.utils import spans

READ = common.reader("encode_replay_share")


def encode(**counts):
    s = spans.Span("encode", None)
    s.counts.update(counts)
    return s


@pytest.mark.parametrize("found, share", [
    ([encode(chunks=70, replays=70, captures=1), encode(chunks=70, replays=70, captures=0)],
     100.0),
    ([encode(chunks=70, replays=70, captures=0), encode(chunks=10, replays=0, captures=0),
      spans.Span("encode.graph", None)], 87.5),
    ([encode(), spans.Span("encode.net", None)], None),
    ([], None),
])
def test_share_of_the_windows_chunks(monkeypatch, found, share):
    monkeypatch.setattr(spans.RECORDER, "spans", found)
    assert READ(types.SimpleNamespace(trace=object())) == share
    assert READ(types.SimpleNamespace(trace=None)) is None


def test_cpu_cell_runs_no_replay():
    cell = tiny_cell("pps50nn")
    assert READ(drive(cell, True)) == 0.0
    assert READ(drive(cell, False)) is None
