"""The control: the reference with every product in float8 e4m3, put in
the program's place, has to come out incorrect. On the CPU at the tiny
size against the tiny limits; on a card at the cell's own size against
the cell's limits (`benchmark/control.py` runs the readings that set
them)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import common
from benchmark.reference import compare, plain
from benchmark.tests.conftest import tiny_cell, tiny_train_cell


def readings(cell, seed, device):
    gen = common.generator(cell.mix["kind"])
    run, _ = gen.run(cell, seed, 0, False, device, time.perf_counter(), lambda m: None)
    obj = run.objects[-1]
    ref = compare.reference_side(cell.config, cell.mix, run.weights, obj, device)
    ctl = compare.reference_side(cell.config, cell.mix, run.weights, obj, device,
                                 q=plain.fp8_e4m3)
    mesh = gen.control_mesh(ctl, obj, cell.mix, cell.config["gen_refine_iter"], seed)
    prog = compare.gaps(compare.program_candidate(obj, cell.config, device), ref, obj, device)
    cont = compare.gaps(compare.control_candidate(ctl, obj, cell.config, device, mesh), ref,
                        obj, device)
    return prog, cont


@pytest.mark.parametrize("config", ["pps50nn", "poco"])
def test_control_fails_tiny_limits(config):
    cell = tiny_cell(config)
    prog, cont = readings(cell, 2**31 + 17, torch.device("cpu"))
    assert all(prog[k] <= lim for k, lim in cell.limits.items())
    assert any(cont[k] > 3 * lim for k, lim in cell.limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pps50nn.rec257.torus60k", "poco.rec257.torus60k"])
def test_control_fails_cell_limits(workload, cuda_card):
    cell = common.find_cell(workload)
    for seed in (2**31 + 19, 2**31 + 23, 2**31 + 29):
        prog, cont = readings(cell, seed, cuda_card)
        assert all(prog[k] <= lim for k, lim in cell.limits.items())
        assert any(cont[k] > lim for k, lim in cell.limits.items())


def test_training_control_fails_tiny_limits():
    from benchmark import control

    cell = tiny_train_cell()
    r = control.control_readings(cell, 2**31 + 41, 0, torch.device("cpu"), True)
    assert all(r["program"][k] <= lim for k, lim in cell.limits.items())
    for side in ("control", "half_batch"):
        assert any(r[side][k] > 3 * lim for k, lim in cell.limits.items()), side


@pytest.mark.cuda
def test_training_control_fails_cell_limits(cuda_card):
    from benchmark import control

    cell = common.find_cell("pps50nn.train.b10")
    for seed in (2**31 + 43, 2**31 + 47, 2**31 + 53):
        r = control.control_readings(cell, seed, 0, cuda_card, True)
        assert all(r["program"][k] <= lim for k, lim in cell.limits.items())
        assert any(r["control"][k] > lim for k, lim in cell.limits.items())
