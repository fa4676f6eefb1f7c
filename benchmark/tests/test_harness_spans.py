"""The per-layer metrics that read the program's own spans
(`harness/program_spans.py`), on tiny cells run in this process on the
CPU with the harness's profiler given CPU activity (the CPU build of
torch has no CUDA activity to trace):

- each returns a finite value in a traced run and None in an untraced
  one, and None where the program has no span recorder;
- they fit inside the harness's own spans: `encode_graph_s +
  encode_net_s <= encode_s`, `grow_self_s <= grow_s`, and the step's
  three phases sum to at most `train_step_s`.
"""
from __future__ import annotations

import sys
import time
import types

import pytest
import torch

from benchmark.harness import common
from benchmark.tests.conftest import tiny_cell, tiny_train_cell

REC = ("encode_graph_s", "encode_net_s", "grow_self_s", "readback_wait_s")
TRAIN = ("forward_s.train", "backward_s.train", "optimizer_s.train")


def drive(cell, trace: bool):
    """One run of the tiny cell's window (no comparison with the reference)."""
    from torch.profiler import ProfilerActivity

    real = torch.profiler.profile
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "profile",
                   lambda activities: real(activities=[ProfilerActivity.CPU]))
        gen = common.generator(cell.mix["kind"])
        run, _ = gen.run(cell, 2**31 + 41, 0.0, trace, torch.device("cpu"),
                         time.perf_counter(), lambda msg: None)
    return run


def values(run, names):
    return {n: common.reader(n)(run) for n in names}


@pytest.fixture(scope="module")
def rec_values():
    """The readers' values of a traced and an untraced run, each read
    right after its run (the recorder holds the last window only), and
    the harness's own per-object seconds of the traced run."""
    cell = tiny_cell("pps50nn")
    traced = drive(cell, True)
    got = values(traced, REC + ("encode_s", "grow_s", "refine_s"))
    return got, values(drive(cell, False), REC)


@pytest.fixture(scope="module")
def train_values():
    cell = tiny_train_cell()
    traced = drive(cell, True)
    got = values(traced, TRAIN + ("train_step_s",))
    return got, values(drive(cell, False), TRAIN)


def test_reconstruction_readers(rec_values):
    got, plain = rec_values
    assert all(common.finite(got[n]) and got[n] >= 0 for n in REC), got
    assert all(v is None for v in plain.values())
    assert got["encode_graph_s"] + got["encode_net_s"] <= got["encode_s"]
    assert 0 < got["grow_self_s"] <= got["grow_s"]
    assert got["readback_wait_s"] < got["encode_s"] + got["grow_s"] + got["refine_s"]


def test_training_readers(train_values):
    got, plain = train_values
    assert all(common.finite(got[n]) and got[n] > 0 for n in TRAIN), got
    assert all(v is None for v in plain.values())
    assert sum(got[n] for n in TRAIN) <= got["train_step_s"]


def test_readers_give_nothing_without_the_recorder(monkeypatch):
    import ppsurf_tpu_torch.utils

    # a program older than the recorder: its module does not import
    monkeypatch.delattr(ppsurf_tpu_torch.utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "ppsurf_tpu_torch.utils.spans", None)
    run = types.SimpleNamespace(trace=object(), objects=[{}], steps=[{}])
    assert all(v is None for v in values(run, REC + TRAIN).values())
