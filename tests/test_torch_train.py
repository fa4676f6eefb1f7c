"""One training step of the port against the JAX package's, on the CPU.

For PPSurf and for POCO at a tiny width (latent 16, P=8, k=8, two clouds
of 96 (PPSurf) or 6144 (POCO) points, 16 queries, a padded raw cloud of 128 points whose first
item has 100 valid), `ppsurf_tpu.train.loop.make_train_step` on one
device and the port's `train_step` take the same initial variables, the
same batch, the same inputs (for PPSurf the port builds them from JAX's
subsampling draws, split as the step splits its key, and must match
JAX's; for POCO, at 6144 points, it takes JAX's) and the same dropout
masks (JAX's, captured with `flax.linen.intercept_methods`), and must
agree on:

- the loss, to 1e-5 relative (f32 sums in another order);
- every gradient leaf, to GRAD_RTOL of the leaf's largest |g| plus
  GRAD_ATOL of the model's (reasons beside the constants);
- the updated parameters: each package's update is AdamW's first step on
  its own gradients, p - lr * (g / (|g| + eps) + wd * p), to 1e-6; its
  slope in g is at most lr / eps = 100, so two gradients that agree
  within d move their parameter to within 100 * d: the bound of the
  direct comparison is that, from the gradients' bound, plus 1e-6;
- the running statistics and FKAConv radii, to 1e-4 of a leaf's largest
  value (they see the forward pass only).

Also: the port's own dropout keeps 70% and scales by 1/0.7; the
learning rate of the step count equals optax's schedule at and around
the milestone steps; `Trainer.fit` counts its steps, writes `last.pt`,
restores it exactly and resumes at the restored epoch.
"""
from __future__ import annotations

import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.ops import graph as jgraph
from ppsurf_tpu.ops import subsample as jsub
from ppsurf_tpu.parallel.mesh import get_data_mesh, replicate, shard_batch
from ppsurf_tpu.train import loop as jloop
from ppsurf_tpu.train import model as jmodel
from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables, to_jax_variables
from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
from ppsurf_tpu_torch.models.pointnet import MLP
from ppsurf_tpu_torch.train import loop
from ppsurf_tpu_torch.train import model as tmodel

from test_torch_data import write_training_dataset

B, Q, RAW = 2, 16, 128
# points a cloud: POCO's kernel net uses ReLU, whose kink is met exactly
# where a level's kNN graph is complete (a level of at most 16 points):
# its offsets then come in +- pairs, InstanceNorm's mean is 0 up to
# rounding and the self-neighbour's normalized 0 lands on the kink, so
# the two packages' subgradients differ; 6144 points keep every level
# above 16 (24 at the coarsest). PPSurf's SiLU has no kink.
N_POINTS = {"ppsurf": 96, "poco": 6144}
TINY = dict(network_latent_size=16, k=8)
LR, EPS = 1e-3, 1e-5
# gradients, of a leaf's largest |g|: f32 sums in another order through
# the whole backward pass stay within 1e-4 (PPSurf); POCO's ReLU kernel
# nets at 6144 points meet pre-activations within rounding of 0, where the
# two packages take different sides of the kink: 2e-2 (measured 7e-3)
GRAD_RTOL = {"ppsurf": 1e-4, "poco": 2e-2}
# a gradient that is 0 in exact arithmetic (the bias of a Dense before a
# train-mode BatchNorm, whose mean removes it) is rounding noise, measured
# below 4e-7 of the model's largest |g|
GRAD_ATOL = 2e-6

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _batch(n: int):
    rng = np.random.RandomState(0)
    valid = np.ones((B, RAW), bool)
    valid[0, 100:] = False
    return {
        "pts_ms": rng.rand(B, n, 3).astype(np.float32) - 0.5,
        "pts_query_ms": rng.rand(B, Q, 3).astype(np.float32) - 0.5,
        "occ": (rng.rand(B, Q) > 0.5).astype(np.int32),
        "pts_raw_ms": rng.rand(B, RAW, 3).astype(np.float32) - 0.5,
        "raw_valid": valid,
    }


def jax_step_draws(graph_key, batch_size: int, n: int):
    """The uniforms `build_fkaconv_graph` draws for each item of a batch
    from its key (`graph.py:64-69`, `subsample.py:84-98, 114`)."""
    sizes = [n] + jgraph.level_sizes(n)
    level_keys = jax.random.split(graph_key, 4)
    draws = [[] for _ in range(batch_size)]
    for lvl in range(4):
        for b, k_item in enumerate(jax.random.split(level_keys[lvl], batch_size)):
            k_tie, *k_levels = jax.random.split(k_item, 1 + jsub._NUM_HALVINGS)
            tie = np.asarray(jax.random.uniform(k_tie, (sizes[lvl],)))
            rot = np.stack([np.asarray(jax.random.uniform(k, (3,))) for k in k_levels])
            draws[b].append((torch.from_numpy(tie.copy()), torch.from_numpy(rot)))
    return draws


def _jax_step(kind: str):
    spec_fn = jmodel.ppsurf_spec if kind == "ppsurf" else jmodel.poco_spec
    extra = dict(pointnet_latent_size=16, num_pts_local=8) if kind == "ppsurf" else {}
    jspec = spec_fn(**TINY, **extra)
    net = jspec.make_network()
    batch = {k: jnp.asarray(v) for k, v in _batch(N_POINTS[kind]).items()}
    data0 = jspec.assemble_step_data(batch, jax.random.key(1), knn_tile=64)
    variables = jax.jit(net.init)(jax.random.key(2), data0)
    params = variables["params"]
    stats = variables["batch_stats"]
    init = {"params": jax.tree_util.tree_map(np.asarray, params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}

    step_key = jax.random.key(3)
    local_key = jax.random.fold_in(step_key, 0)  # shard_map's device 0

    def loss_fn(p):  # `_loss_and_aux` (`loop.py:79-95`), its data and masks kept
        graph_key, dropout_key = jax.random.split(local_key)
        data = jspec.assemble_step_data(batch, graph_key, knn_tile=64)
        masks = []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout) and context.module.rate > 0:
                masks.append(out != 0)
            return out

        with fnn.intercept_methods(capture):
            logits, _ = net.apply({"params": p, "batch_stats": stats}, data, True,
                                  mutable=["batch_stats"], rngs={"dropout": dropout_key})
        return jloop.cross_entropy_loss(logits, batch["occ"]), (data, masks)

    (loss_g, (data, masks)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)

    cfg = jloop.TrainConfig(batch_size=B, num_devices=1, knn_tile=64)
    mesh = get_data_mesh(1)
    tx, _ = jloop.make_optimizer(cfg, steps_per_epoch=1)
    state = replicate(jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                       batch_stats=stats, opt_state=tx.init(params)), mesh)
    step = jloop.make_train_step(net, jspec, tx, mesh, knn_tile=64)
    new_state, loss, _ = step(state, shard_batch(batch, mesh), step_key)
    graph_key, _ = jax.random.split(local_key)
    return {
        "init": init,
        "loss": float(loss),
        "loss_grad_fn": float(loss_g),
        "grads": _flat(jax.tree_util.tree_map(np.asarray, grads)),
        "masks": [torch.from_numpy(np.array(m)) for m in masks],
        "data": {k: torch.from_numpy(np.array(v)) for k, v in data.items()},
        "params": _flat(jax.tree_util.tree_map(np.asarray, new_state.params)),
        "stats": _flat(jax.tree_util.tree_map(np.asarray, new_state.batch_stats)),
        "draws": jax_step_draws(graph_key, B, N_POINTS[kind]),
    }


def _step_pair(kind: str):
    ref = _jax_step(kind)
    spec_fn = tmodel.ppsurf_spec if kind == "ppsurf" else tmodel.poco_spec
    extra = dict(pointnet_latent_size=16, num_pts_local=8) if kind == "ppsurf" else {}
    spec = spec_fn(**TINY, **extra)
    net = spec.make_network()
    net.load_state_dict(from_jax_variables(ref["init"], net), strict=True)
    opt = loop.make_optimizer(net, loop.TrainConfig())
    batch = {k: torch.from_numpy(v) for k, v in _batch(N_POINTS[kind]).items()
             if kind == "ppsurf" or k not in ("pts_raw_ms", "raw_valid")}
    jdata = {k: v.long() if k.startswith(("ids", "proj")) else v
             for k, v in ref["data"].items()}
    if kind == "ppsurf":
        # the port's batched builds from JAX's draws give JAX's inputs
        ours_data = spec.assemble_step_data(batch, ref["draws"])
        for k, v in jdata.items():
            np.testing.assert_allclose(ours_data[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        step_spec = spec
    else:
        # at 6144 points JAX's kNN (|p|^2 + |q|^2 - 2 p.q) and subsampling
        # (floors of rotated coordinates) round some near-ties differently
        # from the port's exact arithmetic: the step takes JAX's inputs
        step_spec = types.SimpleNamespace(assemble_step_data=lambda *_: jdata)
    loss, _ = loop.train_step(net, step_spec, opt, batch, ref["draws"], LR,
                              masks=ref["masks"] if kind == "ppsurf" else None)
    grads = {name: p.grad.numpy().copy() for name, p in net.named_parameters()}
    ours = {"loss": float(loss), "grads": grads, "net": net,
            "vars": to_jax_variables(net)}
    return kind, ref, ours


@pytest.fixture(scope="module", params=["ppsurf", "poco"])
def step_pair(request):
    return _step_pair(request.param)


def test_train_step_loss_matches_jax(step_pair):
    kind, ref, ours = step_pair
    np.testing.assert_allclose(ref["loss_grad_fn"], ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
    if kind == "ppsurf":  # the MLP's two dropout layers were captured
        assert len(ref["masks"]) == 2 and ref["masks"][0].shape == (B * Q, 16)


def _grad_bounds(kind, grads):
    """Per leaf, the allowed |difference| of a gradient entry."""
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    return {name: GRAD_RTOL[kind] * float(np.abs(g).max()) + GRAD_ATOL * gmax
            for name, g in grads.items()}


def test_train_step_gradients_match_jax(step_pair):
    kind, ref, ours = step_pair
    jg = ref["grads"]
    assert set(jg) == set(ours["grads"])
    bounds = _grad_bounds(kind, jg)
    bad = {name: (float(np.abs(ours["grads"][name] - g).max()), bounds[name])
           for name, g in jg.items()
           if np.abs(ours["grads"][name] - g).max() > bounds[name]}
    assert not bad, bad


def _adamw_first_step(p, g, wd=1e-2):
    """optax.adamw's first update: m_hat = g, v_hat = g^2."""
    return p - LR * (g / (np.abs(g) + EPS) + wd * p)


def test_train_step_updates_match_jax(step_pair):
    kind, ref, ours = step_pair
    init = _flat(ref["init"]["params"])
    mine = _flat(ours["vars"]["params"])
    bounds = _grad_bounds(kind, ref["grads"])
    for name, p in ref["params"].items():
        # each package's update is AdamW's first step on its own gradients
        np.testing.assert_allclose(p, _adamw_first_step(init[name], ref["grads"][name]),
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(mine[name],
                                   _adamw_first_step(init[name], ours["grads"][name]),
                                   rtol=0, atol=1e-6, err_msg=name)
        # so the two agree to lr / eps times the gradients' bound
        np.testing.assert_allclose(mine[name], p, rtol=0, atol=LR / EPS * bounds[name] + 1e-6,
                                   err_msg=name)
    mine_stats = _flat(ours["vars"]["batch_stats"])
    assert set(mine_stats) == set(ref["stats"])
    for name, s in ref["stats"].items():
        np.testing.assert_allclose(mine_stats[name], s, rtol=0,
                                   atol=1e-4 * float(np.abs(s).max()) + 1e-7, err_msg=name)


def test_port_dropout_rate_and_scaling():
    """With bn0 made constant 1 (scale 0, bias 1), fc1 sees the first
    dropout's output: 1/0.7 where the generator's draw keeps, 0 elsewhere,
    about 70% kept; eval mode drops nothing."""
    mlp = MLP(64, 2, num_layers=3, dropout=0.3)
    with torch.no_grad():
        mlp.fc0.kernel.copy_(torch.eye(64))
        mlp.bn0.bias.fill_(1.0)
    seen = []
    mlp.fc1.register_forward_pre_hook(lambda m, args: seen.append(args[0].clone()))
    x = torch.rand(2048, 64)
    with torch.no_grad():
        mlp(x, train=True, generator=torch.Generator().manual_seed(5))
        mlp(x, train=False)
    want = torch.rand((2048, 64), generator=torch.Generator().manual_seed(5)) < 0.7
    np.testing.assert_array_equal(seen[0].numpy(),
                                  np.where(want.numpy(), np.float32(1.0) / np.float32(0.7), 0))
    assert abs(float((seen[0] > 0).float().mean()) - 0.7) < 0.01  # 131072 draws: sd 0.0013
    assert bool((seen[1] > 0).all())


@pytest.mark.parametrize("milestones", [(2, 4), (75, 125)])
def test_lr_schedule_matches_optax(milestones):
    cfg_j = jloop.TrainConfig(lr_milestones=milestones)
    cfg_t = loop.TrainConfig(lr_milestones=milestones)
    spe = 3
    _, schedule = jloop.make_optimizer(cfg_j, steps_per_epoch=spe)
    counts = sorted({c for m in milestones for c in (m * spe - 1, m * spe, m * spe + 1)}
                    | {0, 1})
    for count in counts:
        np.testing.assert_allclose(loop.lr_at(cfg_t, spe, count), float(schedule(count)),
                                   rtol=1e-6, err_msg=str(count))


def _tiny_fit(root, in_file, max_epochs, ckpt_path=None):
    spec = tmodel.ppsurf_spec(name="ppsurf_test", network_latent_size=16,
                              pointnet_latent_size=16, num_pts_local=8, k=8)
    cfg = loop.TrainConfig(max_epochs=max_epochs, batch_size=2, default_root_dir=root)
    dm = OccupancyDataModule(in_file=in_file, batch_size=2, manifold_points=64,
                             patches_per_shape=16, seed=42, workers=1)
    trainer = loop.Trainer(spec, cfg, device="cpu")
    return trainer, trainer.fit(dm, ckpt_path=ckpt_path)


def test_fit_steps_checkpoint_and_resume(tmp_path):
    in_file = write_training_dataset(str(tmp_path / "ds"), n_train=3, n_val=1, n_test=1,
                                     n_pts=200, n_query=32)
    root = str(tmp_path / "models")
    t1, s1 = _tiny_fit(root, in_file, 1)
    assert s1.step == 2  # ceil(3 shapes / batch 2)
    ckpt = os.path.join(t1.ckpt_dir, "last.pt")
    assert t1.ckpt_dir == os.path.join(root, "version_0", "checkpoints") and os.path.isfile(ckpt)
    assert [s for s, _ in t1.history] == [1, 2]
    assert all(np.isfinite(loss) for _, loss in t1.history)
    # the checkpoint restores the network and the optimizer exactly
    restored = t1.restore_checkpoint(t1.init_state(), ckpt)
    assert restored.step == 2
    for (name, a), b in zip(s1.net.state_dict().items(), restored.net.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    assert restored.optimizer.state_dict()["state"][0]["step"] == 2

    # resume with max_epochs=2: one more epoch, in a new version dir
    t2, s2 = _tiny_fit(root, in_file, 2, ckpt_path=ckpt)
    assert s2.step == 4 and t2.version_dir.endswith("version_1")
    # resuming a finished run takes no step
    t3, s3 = _tiny_fit(root, in_file, 1, ckpt_path=ckpt)
    assert s3.step == 2 and t3.history == []
