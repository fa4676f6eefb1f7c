"""POCO's data-parallel step on two gloo ranks against the JAX package's
2-device `shard_map` step, on the CPU: the cases and limits of
`tests/test_torch_parallel.py` (its docstring), with POCO at latent 16,
k=8 and 6144 points a cloud, each rank fed its JAX device's assembled
inputs. A file of its own, so that the two models' references are built
by two test workers.
"""
from __future__ import annotations

import pytest

from test_torch_parallel import (SYNCS, check_buffers, check_eval, check_gradients, check_loss,
                                 check_updates, run_parity)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return run_parity("poco", str(tmp_path_factory.mktemp("dp_poco")))


@pytest.mark.parametrize("sync", SYNCS)
def test_dp_step_loss_matches_jax(parity, sync):
    check_loss(parity, sync)


@pytest.mark.parametrize("sync", SYNCS)
def test_dp_step_gradients_match_jax(parity, sync):
    check_gradients(parity, sync)


@pytest.mark.parametrize("sync", SYNCS)
def test_dp_step_updates_match_jax(parity, sync):
    check_updates(parity, sync)


@pytest.mark.parametrize("sync", SYNCS)
def test_dp_step_buffers_match_jax(parity, sync):
    check_buffers(parity, sync)


def test_dp_eval_step_reduces_over_ranks(parity):
    check_eval(parity)
