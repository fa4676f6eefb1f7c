"""The port's reference-checkpoint converter against the JAX package's.

- A synthetic Lightning state dict under the reference's key names and
  shapes (`network.encoder.cv0.cv.weight` (out, in, 1, K), Conv1d weights
  (out, in, 1), Linear weights (out, in), BatchNorm running statistics
  with `num_batches_tracked`, (1,) alpha/beta/norm_radius), made from a
  flax-initialised PPSurf or POCO at narrow widths with random BatchNorm
  statistics: `convert_state_dict` of the port and of the JAX package give
  the same trees, equal to the flax variables the state dict was made from,
  and the port network loaded from them gives the flax network's logits
  within 2e-5 of their scale on the same inputs.
- `convert_torch_checkpoint` on a full Lightning checkpoint writes a
  `last.pt` (step = `global_step`, no optimizer state) that loads with
  `weights_only=True`, and `cli predict --ckpt_path` reconstructs from it
  on the CPU; the module's command line does the same.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.convert.torch_ckpt import convert_state_dict as jconvert
from ppsurf_tpu.train import model as jmodel
from ppsurf_tpu_torch import cli
from ppsurf_tpu_torch.convert import torch_ckpt
from ppsurf_tpu_torch.convert.checkpoint import load_checkpoint
from ppsurf_tpu_torch.convert.infer_npz import load_network
from ppsurf_tpu_torch.train import model as tmodel

from test_torch_cli import _dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32, products summed in another order by XLA and by PyTorch: 2e-5 of the
# logits' scale, max(1, max |logit|) (an untrained FKAConv encoder grows its
# activations by orders of magnitude over its layers, as tests/test_torch_poco.py)
LOGIT_TOL = 2e-5
N, Q = 96, 24
NARROW = {"ppsurf": dict(network_latent_size=16, k=8, pointnet_latent_size=16,
                         num_pts_local=8),
          "poco": dict(network_latent_size=16, k=8)}


def _flat(tree, prefix=()):
    out = {}
    for name, node in tree.items():
        out.update(_flat(node, prefix + (name,)) if isinstance(node, dict)
                   else {prefix + (name,): np.asarray(node)})
    return out


def reference_state_dict(variables: dict) -> dict:
    """The flax tree as the reference's Lightning `state_dict`: torch names
    and layouts under `network.`."""
    params, stats = _flat(variables["params"]), _flat(variables["batch_stats"])
    n_mlp = sum(1 for p in params if p[0] == "mlp" and p[1].startswith("fc") and p[-1] == "kernel"
                and p[1] != "fc_final")

    def module(path):
        if path[0] == "mlp":
            layer = path[1]
            if layer == "fc_final":
                return ("mlp", "layers", str(n_mlp), "0")
            return ("mlp", "layers", layer[2:], "0" if layer.startswith("fc") else "1")
        return path

    def kernel_layout(path, w):
        fka_layer = path[:-1] + ("cv",) in params
        if path[0] == "mlp" or ("stn1" in path or "stn2" in path) and path[-1].startswith("fc"):
            return w.T  # Linear (out, in)
        if fka_layer and path[-1] in ("fc1", "fc2", "fc3"):
            return w.T[:, :, None, None]  # Conv2d 1x1
        return w.T[:, :, None]  # Conv1d

    sd = {}
    for path, v in params.items():
        *mod, leaf = path
        mod = tuple(mod)
        key = "network." + ".".join(module(mod))
        if leaf == "kernel":
            sd[key + ".weight"] = kernel_layout(mod, v)
        elif leaf == "cv":  # (in, K, out) -> Conv2d (out, in, 1, K)
            sd[key + ".cv.weight"] = np.transpose(v, (2, 0, 1))[:, :, None, :]
        elif leaf in ("alpha", "beta"):
            sd[f"{key}.{leaf}"] = v.reshape(1)
        elif leaf == "scale":
            sd[key + ".weight"] = v
        else:
            sd[f"{key}.{leaf}"] = v
    for path, v in stats.items():
        *mod, leaf = path
        key = "network." + ".".join(module(tuple(mod)))
        if leaf == "norm_radius":
            sd[key + ".norm_radius"] = v.reshape(1)
        else:
            sd[f"{key}.running_{leaf}"] = v
            sd[key + ".num_batches_tracked"] = np.asarray(17, np.int64)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sorted(sd.items())}


def _batch(kind):
    rng = np.random.RandomState(4)
    batch = {"pts_ms": rng.rand(1, N, 3).astype(np.float32) - 0.5,
             "pts_query_ms": rng.rand(1, Q, 3).astype(np.float32) - 0.5}
    if kind == "ppsurf":
        batch["pts_raw_ms"] = rng.rand(1, 120, 3).astype(np.float32) - 0.5
        batch["raw_valid"] = np.ones((1, 120), bool)
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _flax(kind):
    """Flax network of `kind` at narrow widths: init, random BatchNorm
    statistics, its inputs and its eval logits."""
    jspec = (jmodel.ppsurf_spec if kind == "ppsurf" else jmodel.poco_spec)(**NARROW[kind])
    net = jspec.make_network()
    data = jspec.assemble_step_data(_batch(kind), jax.random.key(1), knn_tile=64)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(net.init)(jax.random.key(2), data))
    rng = np.random.RandomState(5)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.rand(*x.shape) * 0.5 + 0.5, np.float32), variables["batch_stats"])
    logits = np.asarray(jax.jit(lambda v, d: net.apply(v, d, False))(variables, data))
    return variables, {k: np.asarray(v) for k, v in data.items()}, logits


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


@pytest.mark.parametrize("kind", ["ppsurf", "poco"])
def test_convert_state_dict_matches_jax(kind):
    variables, data, logits = _flax(kind)
    sd = reference_state_dict(variables)
    assert "network.encoder.cv0.cv.weight" in sd and sd["network.encoder.cv0.alpha"].shape == (1,)
    params, stats = torch_ckpt.convert_state_dict(sd)
    jparams, jstats = jconvert(sd)
    _assert_trees_equal({"params": params, "batch_stats": stats},
                        {"params": jparams, "batch_stats": jstats})
    _assert_trees_equal({"params": params, "batch_stats": stats}, variables)

    spec = (tmodel.ppsurf_spec if kind == "ppsurf" else tmodel.poco_spec)(**NARROW[kind])
    net = load_network(spec, {"params": params, "batch_stats": stats}, torch.device("cpu"))
    tdata = {k: torch.from_numpy(v.copy()).long() if k.startswith(("ids", "proj"))
             else torch.from_numpy(v.copy()) for k, v in data.items()}
    with torch.no_grad():
        ours = net(tdata, train=False).numpy()
    assert ours.shape == logits.shape
    scale = max(1.0, float(np.abs(logits).max()))
    np.testing.assert_allclose(ours, logits, rtol=0, atol=LOGIT_TOL * scale)


def _lightning_checkpoint(path, sd):
    """A full Lightning checkpoint dict around `sd`, written with torch.save."""
    torch.save({
        "epoch": 149, "global_step": 55350, "pytorch-lightning_version": "2.1.0",
        "state_dict": sd, "loops": {"fit_loop": {}}, "callbacks": {"ModelCheckpoint": {}},
        "optimizer_states": [{"state": {}, "param_groups": []}], "lr_schedulers": [{}],
        "hparams_name": "kwargs", "hyper_parameters": {"name": "ppsurf_50nn", "workers": 1},
    }, path)


def test_convert_torch_checkpoint_then_cli_predict(tmp_path, capsys):
    variables, _, _ = _flax("ppsurf")
    ckpt = str(tmp_path / "last.ckpt")
    _lightning_checkpoint(ckpt, reference_state_dict(variables))
    out = str(tmp_path / "models" / "version_0" / "checkpoints" / "last.pt")
    assert torch_ckpt.convert_torch_checkpoint(ckpt, out) == out
    payload = load_checkpoint(out)  # weights_only=True
    assert payload["step"] == 55350 and payload["optimizer"] is None
    _assert_trees_equal(payload["variables"], variables)

    # the module's command line writes the same file
    out2 = str(tmp_path / "cli" / "last.pt")
    assert torch_ckpt.main([ckpt, out2]) == 0
    _assert_trees_equal(load_checkpoint(out2)["variables"], variables)

    testset = _dataset(str(tmp_path / "tiny"), ["shape_a"], n=300)
    results = str(tmp_path / "results")
    widths = [a for k, v in NARROW["ppsurf"].items()
              for a in (f"--model.init_args.{k}", str(v))]
    rc = cli.main(["predict", "-c", os.path.join(REPO, "configs", "poco.yaml"),
                   "-c", os.path.join(REPO, "configs", "ppsurf.yaml"),
                   "--ckpt_path", out, "--device", "cpu",
                   "--data.init_args.in_file", testset,
                   "--model.init_args.results_dir", results, *widths,
                   "--model.init_args.gen_resolution_global", "9",
                   "--model.init_args.gen_subsample_manifold_iter", "1",
                   "--model.init_args.gen_refine_iter", "1"])
    text = capsys.readouterr().out
    # random weights need not put a surface in the unit cube: 0 or 1 meshes
    assert rc in (0, 1) and f"weights {out}" in text
    assert os.path.isfile(str(tmp_path / "models" / "version_0" / "config_predict.yaml"))
