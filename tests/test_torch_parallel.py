"""Data parallelism of the port (`ppsurf_tpu_torch/parallel/mesh.py`,
`train/loop.py`) against the JAX package's `shard_map` step, on the CPU.

Two gloo ranks (processes of `ppsurf_tpu_torch.tools.dryrun_multihost`,
joined within a timeout) each take one cloud of a global batch of two and
run the port's `train_step` in a process group; the JAX package's
`make_train_step` runs the same batch on a 2-device mesh of the conftest's
virtual CPU devices. Both start from the same variables
(`convert.init.init_variables`); each rank is fed the JAX draws of its own
device: `fold_in(step_key, d)` split into the graph key, whose uniforms
the rank builds its graphs from (PPSurf), and the dropout key, whose masks
are captured from the JAX forward (PPSurf); POCO's ranks take the JAX
device's assembled inputs (as `tests/test_torch_train.py` does for one
device, and for its reasons). Held, for sync_batch_stats False and True,
within `tests/test_torch_train.py`'s limits:

- the loss averaged over the ranks, to 1e-5 relative;
- the averaged gradients against the mean of the JAX devices' gradients;
- the AdamW-updated parameters (each package's update is AdamW's first
  step on its own gradients, so they agree to lr / eps times the
  gradients' bound), bit-identical on both ranks;
- the buffers: rank 0's (sync False) or the ranks' mean (sync True),
  against JAX's, and bit-identical on both ranks.

Also: the averaged gradients equal the mean of the ranks' gradients
without the group; rank 0's buffers equal a one-rank step on rank 0's
half; `eval_step` averages the loss and sums the confusion counts;
`process_batch_slice` equals the JAX package's over a grid; `shard_batch`
raises on a batch that does not divide; `cli fit --trainer.devices 2
--device cpu` spawns two gloo ranks of which rank 0 alone writes the run.
POCO's cases are in `tests/test_torch_parallel_poco.py`.
"""
from __future__ import annotations

import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import ppsurf_tpu.parallel.mesh as jmesh
from ppsurf_tpu.train import loop as jloop
from ppsurf_tpu.train import model as jmodel
from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.parallel import mesh
from ppsurf_tpu_torch.tools.dryrun_multihost import run_job
from ppsurf_tpu_torch.train import loop
from ppsurf_tpu_torch.train import model as tmodel

from test_torch_train import (EPS, GRAD_ATOL, GRAD_RTOL, LR, N_POINTS, TINY, Q, _batch, _flat,
                              jax_step_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLD = 2
EXTRA = {"ppsurf": dict(pointnet_latent_size=16, num_pts_local=8), "poco": {}}


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def jax_reference(kind: str) -> dict:
    """The JAX package's 2-device step (sync_batch_stats False and True)
    and, per device, the inputs it built, its dropout masks and gradients."""
    import jax.numpy as jnp

    jspec = (jmodel.ppsurf_spec if kind == "ppsurf" else jmodel.poco_spec)(
        **TINY, **EXTRA[kind])
    tspec = (tmodel.ppsurf_spec if kind == "ppsurf" else tmodel.poco_spec)(
        **TINY, **EXTRA[kind])
    net = jspec.make_network()
    batch_np = _batch(N_POINTS[kind])  # 2 clouds: one a device
    variables = init_variables(tspec, seed=2)
    params = _tree(jnp.asarray, variables["params"])
    stats = _tree(jnp.asarray, variables["batch_stats"])
    step_key = jax.random.key(3)

    @jax.jit
    def local(p, batch, key):  # `_loss_and_aux` of one device, data and masks kept
        graph_key, dropout_key = jax.random.split(key)
        data = jspec.assemble_step_data(batch, graph_key, knn_tile=64)
        masks = []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout) and context.module.rate > 0:
                masks.append(out != 0)
            return out

        def loss_fn(p_):
            with fnn.intercept_methods(capture):
                logits, mutated = net.apply({"params": p_, "batch_stats": stats}, data, True,
                                            mutable=["batch_stats"],
                                            rngs={"dropout": dropout_key})
            return jloop.cross_entropy_loss(logits, batch["occ"]), (data, masks, mutated)

        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    devices = []
    for d in range(WORLD):
        local_key = jax.random.fold_in(step_key, d)  # shard_map's device d
        half = {k: jnp.asarray(v[d:d + 1]) for k, v in batch_np.items()}
        (loss, (data, masks, _)), grads = local(params, half, local_key)
        devices.append({
            "loss": float(loss),
            "grads": _flat(jax.tree_util.tree_map(np.asarray, grads)),
            "masks": [torch.from_numpy(np.array(m)) for m in masks],
            "data": {k: torch.from_numpy(np.array(v)) for k, v in data.items()},
            "draws": jax_step_draws(jax.random.split(local_key)[0], 1, N_POINTS[kind]),
        })

    cfg = jloop.TrainConfig(batch_size=WORLD, num_devices=WORLD, knn_tile=64)
    jm = jmesh.get_data_mesh(WORLD)
    tx, _ = jloop.make_optimizer(cfg, steps_per_epoch=1)
    steps = {}
    for sync in (False, True):
        fresh = jax.tree_util.tree_map(jnp.copy, (params, stats))  # the step donates them
        state = jmesh.replicate(jloop.TrainState(
            step=jnp.zeros((), jnp.int32), params=fresh[0], batch_stats=fresh[1],
            opt_state=tx.init(fresh[0])), jm)
        step = jloop.make_train_step(net, jspec, tx, jm, knn_tile=64, sync_batch_stats=sync)
        new_state, loss, conf = step(state, jmesh.shard_batch(
            {k: jnp.asarray(v) for k, v in batch_np.items()}, jm), step_key)
        steps[sync] = {
            "loss": float(loss),
            "conf": {k: float(v) for k, v in conf.items()},
            "params": _flat(jax.tree_util.tree_map(np.asarray, new_state.params)),
            "stats": _flat(jax.tree_util.tree_map(np.asarray, new_state.batch_stats)),
        }
    return {"batch": batch_np, "variables": variables, "devices": devices, "steps": steps,
            "mean_grads": {n: (devices[0]["grads"][n] + devices[1]["grads"][n]) / 2
                           for n in devices[0]["grads"]}}


def port_cases(kind: str, ref: dict) -> list:
    """The job's cases: the port's step on the JAX draws, both sync settings."""
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()
             if kind == "ppsurf" or k not in ("pts_raw_ms", "raw_valid")}
    case = {"spec": dict(kind=kind, **TINY, **EXTRA[kind]), "seed": 0, "lr": LR,
            "variables": _tree(lambda a: torch.from_numpy(np.array(a)), ref["variables"]),
            "batch": batch}
    if kind == "ppsurf":
        case["draws"] = [d["draws"] for d in ref["devices"]]
        case["masks"] = [d["masks"] for d in ref["devices"]]
    else:
        case["data"] = [{k: v.long() if k.startswith(("ids", "proj")) else v
                         for k, v in d["data"].items()} for d in ref["devices"]]
    return [dict(case, name=f"{kind}_sync{int(sync)}", sync_batch_stats=sync, eval=not sync)
            for sync in (False, True)]


def run_parity(kind: str, tmp_dir: str) -> dict:
    ref = jax_reference(kind)
    results = run_job({"device": "cpu", "cases": port_cases(kind, ref)}, WORLD, tmp_dir,
                      backend="gloo", timeout=240, env={"OMP_NUM_THREADS": "2"})
    ranks = [{c["name"].rsplit("_", 1)[1]: c for c in r["cases"]} for r in results]
    return {"kind": kind, "ref": ref, "ranks": ranks}


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return run_parity("ppsurf", str(tmp_path_factory.mktemp("dp_ppsurf")))


def _grad_bounds(kind, grads):
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    return {name: GRAD_RTOL[kind] * float(np.abs(g).max()) + GRAD_ATOL * gmax
            for name, g in grads.items()}


def check_loss(p, sync):
    for r in p["ranks"]:
        np.testing.assert_allclose(r[sync]["loss"], p["ref"]["steps"][sync == "sync1"]["loss"],
                                   rtol=1e-5)


def check_gradients(p, sync):
    want = p["ref"]["mean_grads"]
    bounds = _grad_bounds(p["kind"], want)
    for r in p["ranks"]:
        got = {n: g.numpy() for n, g in r[sync]["grads"].items()}
        assert set(got) == set(want)
        bad = {n: (float(np.abs(got[n] - g).max()), bounds[n]) for n, g in want.items()
               if np.abs(got[n] - g).max() > bounds[n]}
        assert not bad, bad
        # the all-reduced mean is the mean of the ranks' own gradients, up
        # to the sums of a second backward in another order (the CPU's
        # threaded reductions): the same bounds
        locals_ = [rk[sync]["local_grads"] for rk in p["ranks"]]
        for n, g in r[sync]["grads"].items():
            mean = ((locals_[0][n] + locals_[1][n]) / 2).numpy()
            np.testing.assert_allclose(g.numpy(), mean, rtol=0, atol=bounds[n], err_msg=n)


def _adamw_first_step(p, g, wd=1e-2):
    return p - LR * (g / (np.abs(g) + EPS) + wd * p)


def check_updates(p, sync):
    jstep = p["ref"]["steps"][sync == "sync1"]
    init = _flat(p["ref"]["variables"]["params"])
    bounds = _grad_bounds(p["kind"], p["ref"]["mean_grads"])
    r0, r1 = (r[sync] for r in p["ranks"])
    for name, want in jstep["params"].items():
        # JAX's step reduces gradients of its own program, which agree with
        # the separately compiled per-device ones to the gradients' bound
        np.testing.assert_allclose(
            want, _adamw_first_step(init[name], p["ref"]["mean_grads"][name]),
            rtol=0, atol=LR / EPS * bounds[name] + 1e-6, err_msg=name)
        mine = r0["params"][name].numpy()
        np.testing.assert_allclose(mine, _adamw_first_step(init[name], r0["grads"][name].numpy()),
                                   rtol=0, atol=1e-6, err_msg=name)
        # so the two agree to twice lr / eps times the gradients' bound
        np.testing.assert_allclose(mine, want, rtol=0, atol=2 * LR / EPS * bounds[name] + 1e-6,
                                   err_msg=name)
        assert torch.equal(r0["params"][name], r1["params"][name]), name


def check_buffers(p, sync):
    jstats = p["ref"]["steps"][sync == "sync1"]["stats"]
    r0, r1 = (r[sync] for r in p["ranks"])
    assert set(r0["buffers"]) == set(jstats)
    for name, s in jstats.items():
        tol = 1e-4 * float(np.abs(s).max()) + 1e-7
        np.testing.assert_allclose(r0["buffers"][name].numpy(), s, rtol=0, atol=tol,
                                   err_msg=name)
        assert torch.equal(r0["buffers"][name], r1["buffers"][name]), name
        # rank 0's: a one-rank step on rank 0's half; or the ranks' mean
        want = r0["local_buffers"][name] if sync == "sync0" else \
            (r0["local_buffers"][name] + r1["local_buffers"][name]) / 2
        np.testing.assert_allclose(r0["buffers"][name].numpy(), want.numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def check_eval(p):
    r0, r1 = (r["sync0"] for r in p["ranks"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["eval_loss"],
                                   (r0["local_eval_loss"] + r1["local_eval_loss"]) / 2,
                                   rtol=1e-6)
        for k, v in r["eval_conf"].items():
            assert v == r0["local_eval_conf"][k] + r1["local_eval_conf"][k], k
    assert r0["eval_conf"]["predictions"] == WORLD * Q


SYNCS = ["sync0", "sync1"]


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


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4])
def test_process_batch_slice_matches_jax(monkeypatch, n_proc):
    for global_batch in (1, 2, 5, 8, 10, 13):
        for i in range(n_proc):
            monkeypatch.setattr(jax, "process_count", lambda: n_proc)
            monkeypatch.setattr(jax, "process_index", lambda: i)
            m = mesh.DataMesh(i, n_proc, (torch.device("cpu"),), True)
            assert mesh.process_batch_slice(global_batch, m) == \
                jmesh.process_batch_slice(global_batch), (global_batch, n_proc, i)


def test_shard_batch_slices_and_raises_on_an_indivisible_batch():
    batch = {"a": np.arange(10).reshape(5, 2), "b": np.arange(5)}
    m = mesh.DataMesh(1, 2, (torch.device("cpu"),), True)
    with pytest.raises(ValueError, match="not divisible by the mesh's 2 devices"):
        mesh.shard_batch(batch, m)
    out = mesh.shard_batch({"b": np.arange(6)}, m)
    np.testing.assert_array_equal(out["b"], [3, 4, 5])
    one = mesh.DataMesh(0, 1, (torch.device("cpu"),), False)
    assert mesh.shard_batch(batch, one) is batch


def test_trainer_without_a_group_refuses_several_devices(tmp_path):
    spec = tmodel.ppsurf_spec(**TINY, **EXTRA["ppsurf"])
    with pytest.raises(ValueError, match="one process drives one device"):
        loop.Trainer(spec, loop.TrainConfig(num_devices=2, default_root_dir=str(tmp_path)),
                     device="cpu")


def test_maybe_init_distributed_needs_its_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "PPSURF_DIST"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_init_distributed("gloo") is False
    assert not mesh.is_distributed()


def test_cli_fit_spawns_ranks_and_rank0_writes_the_run(tmp_path, monkeypatch):
    from ppsurf_tpu_torch import cli
    from ppsurf_tpu_torch.convert.checkpoint import load_checkpoint

    from test_torch_data import write_training_dataset

    in_file = write_training_dataset(str(tmp_path / "ds"), n_train=4, n_val=2, n_test=1,
                                     n_pts=200, n_query=32)
    root = tmp_path / "models"
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # two ranks beside the other test workers
    configs = [a for c in ("poco", "ppsurf")
               for a in ("-c", os.path.join(REPO, "configs", f"{c}.yaml"))]
    rc = cli.main(["fit", *configs, "--device", "cpu", "--trainer.devices", "2", "--trainer.max_epochs", "1",
                   "--trainer.default_root_dir", str(root),
                   "--data.init_args.in_file", in_file, "--data.init_args.batch_size", "2",
                   "--data.init_args.manifold_points", "64",
                   "--data.init_args.patches_per_shape", "16",
                   "--data.init_args.workers", "1",
                   "--model.init_args.network_latent_size", "16",
                   "--model.init_args.pointnet_latent_size", "16",
                   "--model.init_args.num_pts_local", "8", "--model.init_args.k", "8"])
    assert rc == 0
    # one run dir: rank 1 took rank 0's version, and only rank 0 wrote
    assert sorted(os.listdir(root)) == ["version_0"]
    assert "config.yaml" in os.listdir(root / "version_0")
    payload = load_checkpoint(str(root / "version_0" / "checkpoints" / "last.pt"))
    assert payload["step"] == 2  # 4 shapes, global batch 2


@pytest.mark.parametrize("cards", [0, 1, 3, 4, 8])
def test_multi_device_params_match_jax(monkeypatch, cards):
    from ppsurf_tpu.utils import mp as jmp
    from ppsurf_tpu_torch.utils import mp

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(jax, "devices", lambda: list(range(cards)))
    for total in (1, 10, 50):
        assert mp.get_multi_device_params(total) == jmp.get_multi_device_params(total)
