"""Whole runs of a tiny cell on the CPU, each in its own process (the
run's own check that no module of JAX or the JAX package is loaded needs
a process that never imported them): the last line's keys, `correct`
true on a sound run and false with each fault the reconstruction cells
can have planted under the timed path."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.common import FORBIDDEN, ROOT
from benchmark.tests.conftest import TINY_LIMITS

TINY_RUN = os.path.join(ROOT, "benchmark", "tests", "drive_tiny.py")


def drive(config: str, fault: str, seed: int) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, TINY_RUN, config, fault, str(seed)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("config", ["poco", "pps50nn"])
def test_sound_run_last_line(config):
    line = drive(config, "none", 2**31 + 11)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"s_per_object", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(TINY_LIMITS)


@pytest.mark.parametrize("fault", ["refine_unchanged", "half_batch", "altered_answer",
                                   "grow_shift"])
def test_fault_makes_run_incorrect(fault):
    line = drive("poco", fault, 2**31 + 13)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_training_run_last_line():
    line = drive("train", "none", 2**31 + 31)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_step_s", "setup_s"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_fault_makes_run_incorrect(fault):
    line = drive("train", fault, 2**31 + 37)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_no_jax_in_harness_and_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.control, benchmark.harness.reconstruct\n"
            "import benchmark.reference.compare\n"
            "import ppsurf_tpu_torch.recon.predict, ppsurf_tpu_torch.recon.engine\n"
            "from benchmark.harness.common import forbidden_modules\n"
            "print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.compare, benchmark.reference.plain\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not top & (set(FORBIDDEN) | {"ppsurf_tpu_torch"})


def test_forbidden_names_compared_whole(monkeypatch):
    from benchmark.harness import common

    monkeypatch.setitem(sys.modules, "ppsurf_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_other", sys)
    assert "ppsurf_tpu_torch_fake" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ppsurf_tpu.models", sys)
    assert "ppsurf_tpu.models" in common.forbidden_modules()
