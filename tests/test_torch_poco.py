"""POCO in the port against the JAX package on the CPU, in f32.

- `PocoNetwork.get_latent` and `from_latent` (plain and projected-latent
  decoder) with flax-initialised JAX weights (randomised BatchNorm
  statistics) passed through `from_jax_variables`: 2e-5 of the output's
  scale. An untrained FKAConv encoder grows its activations by orders of
  magnitude over its ~40 layers (latents of order 1e4 here), so the
  encoder is held relative to its largest latent;
- `convert.init.init_variables` makes the tree `PocoNetwork.init` and
  `PPSurfNetwork.init` make, name for name and shape for shape;
- the POCO field of `FieldEvaluator` and a small POCO reconstruction
  against the JAX `FieldEvaluator` and `Predictor` (1e-4), the port fed
  the JAX encoder's draws (`EncoderDraws`). The weights are the seeded
  `init_variables` with fc1's latent rows divided by the latents' standard
  deviation and fc8's biases shifted to centre the field, so that it is
  not saturated at -1 and crosses zero;
- `ops/encoding.py` against `ppsurf_tpu/ops/encoding.py`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.ops.encoding import cartesian_to_polar as jpolar
from ppsurf_tpu.ops.encoding import pos_encoding as jpos
from ppsurf_tpu.recon import engine as jax_engine
from ppsurf_tpu.recon.field import FieldEvaluator as JFieldEvaluator
from ppsurf_tpu.recon.predict import Predictor as JPredictor
from ppsurf_tpu.train.model import poco_spec as jax_poco_spec
from ppsurf_tpu.train.model import ppsurf_spec as jax_ppsurf_spec
from ppsurf_tpu_torch.convert.infer_npz import load_network
from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.ops.encoding import cartesian_to_polar, pos_encoding
from ppsurf_tpu_torch.ops.graph import build_fkaconv_graph, draw_graph
from ppsurf_tpu_torch.recon import engine
from ppsurf_tpu_torch.recon.field import FieldEvaluator
from ppsurf_tpu_torch.recon.predict import Predictor
from ppsurf_tpu_torch.train.model import poco_spec, ppsurf_spec

from test_torch_recon import _exact_tie, jax_encoder_draws, sphere_cloud

SEED = 7
RES = 17
SPEC = dict(gen_subsample_manifold_iter=2, gen_refine_iter=3, rec_batch_size=1024)
_G = np.linspace(-0.5, 0.5, 9, dtype=np.float32)
GRID = np.stack(np.meshgrid(_G, _G, _G, indexing="ij"), -1).reshape(-1, 3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    for name, node in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(node, dict):
            out.update(_flat(node, path))
        else:
            out[path] = tuple(np.shape(node))
    return out


@functools.lru_cache(maxsize=None)
def _flax_init(kind: str):
    """`init` of the JAX package's network of `kind` on a 600-point cloud."""
    spec = {"poco": jax_poco_spec, "ppsurf": jax_ppsurf_spec}[kind]()
    rng = np.random.RandomState(0)
    pts = (rng.rand(1, 600, 3) - 0.5).astype(np.float32)
    batch = {"pts_ms": jnp.asarray(pts), "pts_query_ms": jnp.asarray(pts[:, :40]),
             "pts_raw_ms": jnp.asarray(pts), "raw_valid": jnp.ones((1, 600), bool)}
    key = jax.random.key(1)
    net = spec.make_network()
    variables = jax.jit(net.init)(key, spec.assemble_step_data(batch, key, knn_tile=256))
    return net, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def poco_flax():
    net, variables = _flax_init("poco")
    rng = np.random.RandomState(2)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.rand(*x.shape) * 0.5 + 0.5, np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    ours = load_network(poco_spec(), variables, torch.device("cpu"))
    return net, variables, ours


def _close(ours, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * scale)


def test_poco_get_latent_matches_flax(poco_flax):
    net, variables, ours = poco_flax
    rng = np.random.RandomState(3)
    pts = (rng.rand(500, 3) - 0.5).astype(np.float32)
    graph = build_fkaconv_graph(torch.from_numpy(pts),
                                draw_graph(500, torch.Generator().manual_seed(4),
                                           torch.device("cpu")))
    jg = {name: jnp.asarray(t.numpy().astype(np.int32 if name.startswith("ids") else np.float32))
          for name, t in graph.items()}
    ref = np.asarray(jax.jit(lambda v, d: net.apply(v, d, False, method=net.get_latent))(
        variables, {"pts": jnp.asarray(pts)[None], **jg}))
    with torch.inference_mode():
        lat = ours.get_latent({"pts": torch.from_numpy(pts)[None], **graph}).numpy()
    assert lat.shape == ref.shape == (1, 500, 32)
    _close(lat, ref, 2e-5)


@pytest.mark.parametrize("projected", [False, True])
def test_poco_from_latent_matches_flax(poco_flax, projected):
    """The decoder to two logits (fc8 with last_layer), on plain latents
    and on latents with fc1's latent rows folded in (as `FieldEvaluator`
    folds them); a given `feat_proj` is returned as it is."""
    net, variables, ours = poco_flax
    rng = np.random.RandomState(5)
    data = {
        "latents": rng.randn(1, 300, 32).astype(np.float32),
        "pts": (rng.rand(1, 300, 3) - 0.5).astype(np.float32),
        "pts_query": (rng.rand(1, 40, 3) - 0.5).astype(np.float32),
        "proj_ids": rng.randint(0, 300, size=(1, 40, 64)),
    }
    jvars = variables
    if projected:
        p = variables["params"]["projection"]
        k1 = np.asarray(p["fc1"]["kernel"])
        data["latents"] = data["latents"] @ k1[:32] + np.asarray(p["fc1"]["bias"])
        proj = dict(p, fc1={"kernel": k1[32:]})
        jvars = {"params": dict(variables["params"], projection=proj),
                 "batch_stats": variables["batch_stats"]}
        data["latents_projected"] = True
    ref = np.asarray(net.apply(jvars, {k: jnp.asarray(v) for k, v in data.items()},
                               method=net.from_latent))
    with torch.inference_mode():
        out = ours.from_latent({k: v if isinstance(v, bool) else _t(v)
                                for k, v in data.items()}).numpy()
        given = torch.randn(1, 40, 2)
        assert ours.from_latent({"feat_proj": given}) is given
    assert out.shape == ref.shape == (1, 40, 2)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("kind", ["poco", "ppsurf"])
def test_init_variables_match_the_flax_tree(kind):
    """Names and shapes of `init_variables` equal those of the flax
    network's `init`; the values are seeded and load into the port."""
    spec = {"poco": poco_spec, "ppsurf": ppsurf_spec}[kind]()
    _, flax_vars = _flax_init(kind)
    ours = init_variables(spec, seed=5)
    assert set(ours) == set(flax_vars) == {"params", "batch_stats"}
    for coll in ours:
        assert _flat(ours[coll]) == _flat(flax_vars[coll]), coll
    again = init_variables(spec, seed=5)
    leaves = zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(again))
    assert all(np.array_equal(a, b) for a, b in leaves)
    assert all(np.isfinite(x).all() for x in jax.tree_util.tree_leaves(ours))
    load_network(spec, ours, torch.device("cpu"))


@pytest.fixture(scope="module")
def poco_runs():
    """Both packages reconstruct a 1500-point ellipsoid with POCO on the
    same seeded weights, the port on the JAX encoder's draws."""
    pts = sphere_cloud() * np.float32([1.0, 1.0, 0.3])
    variables = init_variables(poco_spec(), seed=3)
    jp = JPredictor(jax_poco_spec(**SPEC), variables, verbose=False)
    lat = np.asarray(jp.encoder(variables, pts, jax.random.key(SEED)))
    # untrained latents are of order 1e4: scale fc1's latent rows so the
    # decoder's pre-activations are of order 1 and the field is not
    # saturated at -1
    proj = variables["params"]["projection"]
    proj["fc1"]["kernel"][:32] /= float(lat.std())
    # and shift fc8's biases so the field's median over the grid is 0
    field = JFieldEvaluator(jp.net, jp.spec, variables, pts, lat)(GRID)
    shift = float(np.arctanh(np.median(field)))  # half the logits' difference
    proj["fc8"]["bias"] += np.float32([-shift, shift])
    jp = JPredictor(jax_poco_spec(**SPEC), variables, verbose=False)
    tp = Predictor(poco_spec(**SPEC), variables=variables, device="cpu", verbose=False)
    volumes = {}

    def capture_volume(original, tag):
        def wrapped(*a, **kw):
            out = original(*a, **kw)
            volumes[tag] = out[0].copy()
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for module, tag in ((jax_engine, "jax"), (engine, "torch")):
            mp.setattr(module, "create_volume_region_growing",
                       capture_volume(module.create_volume_region_growing, tag))
        mesh_j = jp.reconstruct_shape(pts, seed=SEED, resolution=RES)
        draws = jax_encoder_draws(jax.random.key(SEED), pts.shape[0], tp.encoder)
        mesh_t = tp.reconstruct_shape(pts, resolution=RES, draws=draws)
        lat_t = tp.encoder(torch.from_numpy(pts), draws=draws).numpy()
    return dict(pts=pts, jp=jp, tp=tp, variables=variables, lat=lat, lat_t=lat_t,
                mesh_j=mesh_j, mesh_t=mesh_t, volumes=volumes)


def test_poco_latent_encoder_matches_jax(poco_runs):
    _close(poco_runs["lat_t"], poco_runs["lat"], 2e-5)


def test_poco_field_matches_jax(poco_runs):
    """The field on the JAX latents at a 9^3 grid: not saturated, crossing
    zero, equal to 1e-4 but where a query's 64-NN set has a near-tie."""
    r = poco_runs
    je = JFieldEvaluator(r["jp"].net, r["jp"].spec, r["variables"], r["pts"], r["lat"])
    te = FieldEvaluator(r["tp"].net, r["tp"].spec, r["pts"], torch.from_numpy(r["lat"].copy()))
    assert te.point_net is None and te.patch_k == 0
    with torch.inference_mode():
        ours = te(GRID)
    theirs = je(GRID)
    assert (theirs > 0).any() and (theirs < 0).any() and np.abs(theirs).max() < 0.9
    ok = ~_exact_tie(r["pts"], GRID, ks=(64,))
    assert ok.sum() > 0.98 * GRID.shape[0]
    np.testing.assert_allclose(ours[ok], theirs[ok], rtol=0, atol=1e-4)


def test_poco_reconstruction_matches_jax(poco_runs):
    """The evaluated voxels, the volume's signs and values, the faces and
    the refined vertices of the two reconstructions (1e-4)."""
    vj, vt = poco_runs["volumes"]["jax"], poco_runs["volumes"]["torch"]
    np.testing.assert_array_equal(np.isfinite(vt), np.isfinite(vj))
    fin = np.isfinite(vj)
    assert fin.sum() > 500
    np.testing.assert_array_equal(np.sign(vt[fin]), np.sign(vj[fin]))
    np.testing.assert_allclose(vt[fin], vj[fin], rtol=0, atol=1e-4)
    mj, mt = poco_runs["mesh_j"], poco_runs["mesh_t"]
    assert mj is not None and mt is not None and mt.faces.shape[0] > 500
    np.testing.assert_array_equal(mt.faces, mj.faces)
    np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_cartesian_to_polar_matches_jax(dim):
    rng = np.random.RandomState(dim)
    pts = (rng.randn(2, 50, dim) * 2).astype(np.float32)
    pts[0, 0] = 0.0
    np.testing.assert_allclose(cartesian_to_polar(_t(pts)).numpy(),
                               np.asarray(jpolar(jnp.asarray(pts))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("levels,skip", [(0, False), (1, False), (4, False), (4, True)])
def test_pos_encoding_matches_jax(levels, skip):
    rng = np.random.RandomState(levels)
    pts = (rng.rand(2, 30, 3) - 0.5).astype(np.float32)
    ours = pos_encoding(_t(pts), levels, skip_last_dim=skip).numpy()
    ref = np.asarray(jpos(jnp.asarray(pts), levels, skip_last_dim=skip))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
