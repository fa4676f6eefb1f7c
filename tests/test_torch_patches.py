"""Patch sizes and cloud sizes beyond PPSurf 50NN's, in the port against
the JAX package on the CPU (f32, committed weights).

- `ppsurf_100nn` / `ppsurf_200nn`: the patch (P=100, 200) is wider than
  the decoder's k=64. The JAX package takes the patch from its own kNN
  (`ppsurf_tpu/recon/field.py:118-122`, `ops/patches.py:34`); the port
  makes one kNN at k=P and takes its first 64 ids for the decoder. The
  field on a grid and near the cloud equals the JAX field to 1e-4 but
  where a query's 64- or P-NN set holds a near-tie (the JAX CPU kNN ranks
  by matmul distances), and the candidate refinement equals the plain one
  exactly;
- clouds of 40 and 60 points, fewer than the decoder's 64 neighbours: k
  becomes N and the patch min(50, N), as in the JAX package
  (`field.py:113-132`); both packages reconstruct them, the port on the
  JAX encoder's draws, to the same faces and vertices within 1e-4.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ppsurf_tpu.convert.infer_npz import load_infer_npz as jax_load_infer_npz
from ppsurf_tpu.recon.field import FieldEvaluator as JFieldEvaluator
from ppsurf_tpu.recon.predict import Predictor as JPredictor
from ppsurf_tpu.train.model import ppsurf_spec as jax_spec
from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
from ppsurf_tpu_torch.recon.field import FieldEvaluator
from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS, Predictor
from ppsurf_tpu_torch.train.model import ppsurf_spec

from test_torch_recon import _exact_tie, jax_encoder_draws, sphere_cloud

SPEC = dict(gen_subsample_manifold_iter=2, gen_refine_iter=3, rec_batch_size=1024)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(4)
    pts = sphere_cloud() * np.float32([1.0, 1.0, 0.3])
    latents = (rng.randn(pts.shape[0], 256) * 0.5).astype(np.float32)
    g = np.linspace(-0.5, 0.5, 7, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    near = pts[rng.randint(0, pts.shape[0], 300)] + rng.randn(300, 3).astype(np.float32) * 0.03
    return pts, latents, np.concatenate([grid, near]).astype(np.float32)


def _port_evaluator(p: int, pts, latents):
    spec = ppsurf_spec(num_pts_local=p, **SPEC)
    net = load_network(spec, load_infer_npz(DEFAULT_WEIGHTS), torch.device("cpu"))
    return FieldEvaluator(net, spec, pts, torch.from_numpy(latents.copy()))


@pytest.mark.parametrize("p", [100, 200])
def test_wide_patch_field_matches_jax(cloud, p):
    pts, latents, queries = cloud
    spec = jax_spec(num_pts_local=p, **SPEC)
    je = JFieldEvaluator(spec.make_network(), spec, jax_load_infer_npz(DEFAULT_WEIGHTS), pts,
                         latents, pts_raw=pts)
    assert not je.shared_cloud
    te = _port_evaluator(p, pts, latents)
    assert (te.k, te.patch_k) == (64, p)
    with torch.inference_mode():
        ours = te(queries)
    theirs = je(queries)
    ok = ~_exact_tie(pts, queries, ks=(64, p))
    assert ok.sum() > 0.97 * queries.shape[0]
    np.testing.assert_allclose(ours[ok], theirs[ok], rtol=0, atol=1e-4)


def test_wide_patch_candidate_refinement_equals_plain(cloud):
    """At P=100 each bisection step of the candidate path gets its 64 ids
    from the candidates and its patch from its own kNN at k=P, as the
    JAX package does: exactly the plain path's result on the CPU."""
    pts, latents, _ = cloud
    te = _port_evaluator(100, pts, latents)
    rng = np.random.RandomState(6)
    v1 = pts[rng.randint(0, pts.shape[0], 200)] * 1.1
    v2 = v1 * 0.8
    with torch.inference_mode():
        p1, p2 = te(v1), te(v2)
        args = (0.5 * (v1 + v2), v1, v2, p1, p2, 3)
        plain = te.refine_bisection(*args, force_full=True)
        cand = te.refine_bisection(*args)
    assert te.stat_cert_failed < 100
    np.testing.assert_array_equal(cand, plain)


@pytest.mark.parametrize("n", [40, 60])
def test_small_cloud_reconstructs_as_jax(n):
    pts = sphere_cloud(n, seed=1)
    variables = jax_load_infer_npz(DEFAULT_WEIGHTS)
    mesh_j = JPredictor(jax_spec(**SPEC), variables, verbose=False).reconstruct_shape(
        pts, seed=7, resolution=17)
    tp = Predictor(ppsurf_spec(**SPEC), variables=variables, device="cpu", verbose=False)
    draws = jax_encoder_draws(jax.random.key(7), n, tp.encoder)
    mesh_t = tp.reconstruct_shape(pts, resolution=17, draws=draws)
    ev = tp.last_evaluator
    assert (ev.k, ev.patch_k) == (n, min(50, n))
    assert mesh_j is not None and mesh_t is not None and mesh_t.faces.shape[0] > 500
    np.testing.assert_array_equal(mesh_t.faces, mesh_j.faces)
    np.testing.assert_allclose(mesh_t.vertices, mesh_j.vertices, rtol=0, atol=1e-4)
