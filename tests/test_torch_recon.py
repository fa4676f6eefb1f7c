"""The port's reconstruction slice against the JAX package on the CPU.

One module fixture reconstructs a 1500-point ellipsoid (a bumpy sphere
flattened to 0.3 in z) with the committed weights in both packages (2
encoder passes, res 17, refine 3, both refining on their default
candidate path), the port with the JAX draws injected. The tests then
hold, in f32:

- one FKAConv graph's latents (`get_latent`) and the accumulated latents
  of `LatentEncoder` to 1e-4: the encoder is ~40 layers deep and XLA and
  PyTorch sum their products in other orders;
- field values of `FieldEvaluator` on shared latents to 1e-4 (a
  difference of softmax probabilities, same reason), apart from queries
  whose 64- or 50-NN set holds a near-tie (the JAX CPU kNN ranks by
  matmul distances);
- `refine_bisection` on half of the vertices that refinement took in the
  JAX reconstruction, with the inputs the JAX run captured: the plain
  path (`force_full=True`) against the JAX plain path and the candidate
  path against the JAX candidate path, to 1e-4 (bisection steps are
  halvings of one grid edge, so any flipped branch would show as a step
  of at least edge/2^iters); and the port's candidate path against its
  own plain path exactly, also with REFINE_CAND_K cut to k+1, where
  nearly every certificate fails and the plain path re-refines;
- `Predictor.reconstruct_shape`: the evaluated-voxel set, the volume's
  signs, the faces and the refined vertices (1e-4). A refined vertex may
  differ where one bisection step took the other branch; each such vertex
  is replayed and must trace back to a near-tie of its query's 50/64-NN
  set or a field within 1e-4 of zero.
"""
from __future__ import annotations

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.convert.infer_npz import load_infer_npz as jax_load_infer_npz
from ppsurf_tpu.recon import engine as jax_engine
from ppsurf_tpu.recon import field as jax_field
from ppsurf_tpu.recon.field import FieldEvaluator as JFieldEvaluator
from ppsurf_tpu.recon.field import LatentEncoder as JLatentEncoder
from ppsurf_tpu.recon.predict import Predictor as JPredictor
from ppsurf_tpu.train.model import ppsurf_spec as jax_spec
from ppsurf_tpu_torch.ops.graph import build_fkaconv_graph, draw_graph
from ppsurf_tpu_torch.recon import engine, field
from ppsurf_tpu_torch.recon.field import EncoderDraws, FieldEvaluator
from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS, Predictor
from ppsurf_tpu_torch.train.model import ppsurf_spec

from test_torch_ops import jax_graph_draws

SEED = 7
RES = 17
SPEC = dict(gen_subsample_manifold_iter=2, gen_refine_iter=3, rec_batch_size=1024)


def sphere_cloud(n: int = 1500, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bumps = 1.0 + 0.1 * np.sin(3 * d[:, 0]) * np.cos(2 * d[:, 1])
    return (d * 0.4 * bumps[:, None]).astype(np.float32)


def jax_encoder_draws(key, n: int, encoder) -> EncoderDraws:
    """The permutations and graph draws of `ppsurf_tpu`'s
    `LatentEncoder._make_encode_all` (`field.py:407-418`) for key."""
    s = min(encoder.spec.gen_subsample_manifold, n)
    nb = -(-n // encoder.BUCKET) * encoder.BUCKET if n > s else n
    num_chunks = -(-nb // s)
    iters = encoder.spec.gen_subsample_manifold_iter
    pass_keys = jax.random.split(key, iters * (1 + num_chunks))
    perms = np.stack([np.asarray(jax.random.permutation(pass_keys[i], nb))
                      for i in range(iters)])
    graphs = [jax_graph_draws(pass_keys[iters + j], s) for j in range(iters * num_chunks)]
    return EncoderDraws(torch.from_numpy(perms.astype(np.int64)), graphs)


def _exact_tie(pts, queries, ks=(50, 64), rel=1e-5):
    d2 = np.sort(((queries[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1), axis=1)
    tie = np.zeros(queries.shape[0], bool)
    for k in ks:
        if k < d2.shape[1]:
            tie |= (d2[:, k] - d2[:, k - 1]) <= rel * d2[:, k]
    return tie


@pytest.fixture(scope="module")
def runs():
    # flattened to an ellipsoid: in the cubic grid over its extent it
    # crosses half the voxels a sphere would, which halves the field work
    pts = sphere_cloud() * np.float32([1.0, 1.0, 0.3])
    variables = jax_load_infer_npz(DEFAULT_WEIGHTS)
    volumes, refines = {}, {}

    def capture_volume(original, tag):
        def wrapped(*a, **kw):
            out = original(*a, **kw)
            volumes[tag] = out[0].copy()
            return out
        return wrapped

    def capture_refine(original, tag):
        def wrapped(self, v, v1, v2, p1, p2, iters, *a, **kw):
            out = original(self, v, v1, v2, p1, p2, iters, *a, **kw)
            refines[tag] = dict(v=v, v1=v1, v2=v2, p1=p1, p2=p2, iters=iters,
                                out=np.asarray(out))
            return out
        return wrapped

    jax_field._reset_cand_broken()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PPSURF_REFINE_CAND", raising=False)
        for module, tag in ((jax_engine, "jax"), (engine, "torch")):
            mp.setattr(module, "create_volume_region_growing",
                       capture_volume(module.create_volume_region_growing, tag))
        for cls, tag in ((JFieldEvaluator, "jax"), (FieldEvaluator, "torch")):
            mp.setattr(cls, "refine_bisection", capture_refine(cls.refine_bisection, tag))
        jp = JPredictor(jax_spec(**SPEC), variables, verbose=False)
        tp = Predictor(ppsurf_spec(**SPEC), variables=variables, device="cpu", verbose=False)

        def port_run():
            draws = jax_encoder_draws(jax.random.key(SEED), pts.shape[0], tp.encoder)
            mesh = tp.reconstruct_shape(pts, resolution=RES, draws=draws)
            return mesh, tp.encoder(torch.from_numpy(pts), draws=draws).numpy()

        # the port computes while XLA compiles the JAX programs
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(port_run)
            mesh_j = jp.reconstruct_shape(pts, seed=SEED, resolution=RES)
            lat_j = np.asarray(jp.encoder(variables, pts, jax.random.key(SEED)))
            mesh_t, lat_t = port.result()
    # the JAX run stayed on its candidate path (no downgrade to the plain one)
    assert not jax_field._CAND_BROKEN
    return dict(pts=pts, variables=variables, jp=jp, tp=tp, mesh_j=mesh_j,
                mesh_t=mesh_t, lat_j=lat_j, lat_t=lat_t, volumes=volumes,
                refines=refines)


def test_get_latent_on_one_graph_matches_jax(runs):
    """Both networks on one graph, the port's (graph parity is
    `test_torch_ops.py::test_fkaconv_graph_matches_jax`)."""
    pts = runs["pts"][:600]
    graph = build_fkaconv_graph(torch.from_numpy(pts),
                                draw_graph(600, torch.Generator().manual_seed(3), torch.device("cpu")))
    jg = {name: jnp.asarray(t.numpy().astype(np.int32 if name.startswith("ids") else np.float32))
          for name, t in graph.items()}
    net = runs["jp"].net
    ref = np.asarray(jax.jit(
        lambda v, d: net.apply(v, d, False, method=net.get_latent)
    )(runs["variables"], {"pts": jnp.asarray(pts)[None], **jg}))
    with torch.inference_mode():
        ours = runs["tp"].net.get_latent({"pts": torch.from_numpy(pts)[None], **graph})
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_latent_encoder_matches_jax(runs):
    np.testing.assert_allclose(runs["lat_t"], runs["lat_j"], rtol=1e-4, atol=1e-4)


def _evaluators(runs, own_latents: bool = False):
    """JAX and port evaluators on the JAX latents, or each on its own
    package's latents (as in the two reconstructions)."""
    lat_j = runs["lat_j"]
    lat_t = runs["lat_t"] if own_latents else lat_j.copy()
    je = JFieldEvaluator(runs["jp"].net, runs["jp"].spec, runs["variables"], runs["pts"],
                         lat_j, pts_raw=runs["pts"])
    te = FieldEvaluator(runs["tp"].net, runs["tp"].spec, runs["pts"], torch.from_numpy(lat_t))
    return je, te


def test_field_matches_jax_on_a_grid(runs):
    je, te = _evaluators(runs)
    g = np.linspace(-0.5, 0.5, 9, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    with torch.inference_mode():
        ours = te(grid)
    theirs = je(grid)
    ok = ~_exact_tie(runs["pts"], grid)
    assert ok.sum() > 0.98 * grid.shape[0]
    np.testing.assert_allclose(ours[ok], theirs[ok], rtol=0, atol=1e-4)


def _refine_inputs(runs):
    """Every second vertex of the JAX reconstruction's refinement, with its
    inputs as the JAX run captured them."""
    rj = runs["refines"]["jax"]
    rows = np.arange(0, rj["v"].shape[0], 2)
    v, v1, v2 = (rj[n][rows].astype(np.float32) for n in ("v", "v1", "v2"))
    return rows, (v, v1, v2, rj["p1"][rows], rj["p2"][rows], rj["iters"])


@pytest.fixture(scope="module")
def port_refines(runs):
    """The port's refinement of those vertices on the JAX latents: plain
    path, candidate path, and candidate path with REFINE_CAND_K = k+1."""
    _, te = _evaluators(runs)
    _, args = _refine_inputs(runs)
    out = {}
    with torch.inference_mode():
        out["plain"] = te.refine_bisection(*args, force_full=True)
        out["cand"] = te.refine_bisection(*args)
        out["cand_failed"] = te.stat_cert_failed
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(field, "REFINE_CAND_K", te.k + 1)
            out["narrow"] = te.refine_bisection(*args)
        out["narrow_failed"] = te.stat_cert_failed - out["cand_failed"]
    return out


def _far_from_ties(runs, v, v1, v2):
    ok = ~_exact_tie(runs["pts"], np.concatenate([v1, v2, v]))
    return ok.reshape(3, -1).all(axis=0)


def test_refine_bisection_matches_jax_plain_path(runs, port_refines):
    je, _ = _evaluators(runs)
    rows, args = _refine_inputs(runs)
    theirs = je.refine_bisection(*args, force_full=True)
    ok = _far_from_ties(runs, *args[:3])
    assert rows.size > 300 and ok.mean() > 0.95
    np.testing.assert_allclose(port_refines["plain"][ok], theirs[ok], rtol=0, atol=1e-4)


def test_refine_bisection_matches_jax_candidate_path(runs, port_refines):
    """The JAX reconstruction's own candidate-path results for those
    vertices."""
    rows, args = _refine_inputs(runs)
    ok = _far_from_ties(runs, *args[:3])
    assert rows.size > 300 and ok.mean() > 0.95
    theirs = runs["refines"]["jax"]["out"][rows]
    np.testing.assert_allclose(port_refines["cand"][ok], theirs[ok], rtol=0, atol=1e-4)


def test_candidate_refinement_equals_the_plain_path(runs, port_refines):
    """Exact on the CPU: the candidates hold each iterate's 64 nearest and
    K2's plain version orders them as K1's does, so every field evaluation
    sees the same ids. With kc = k+1 almost every certificate fails and
    the plain path's result comes back for those vertices."""
    n = port_refines["plain"].shape[0]
    assert port_refines["cand_failed"] < n // 2
    assert port_refines["narrow_failed"] > 0.9 * n
    np.testing.assert_array_equal(port_refines["cand"], port_refines["plain"])
    np.testing.assert_array_equal(port_refines["narrow"], port_refines["plain"])


def test_reconstruct_shape_matches_jax_predictor(runs):
    vj, vt = runs["volumes"]["jax"], runs["volumes"]["torch"]
    np.testing.assert_array_equal(np.isfinite(vt), np.isfinite(vj))  # evaluated voxels
    fin = np.isfinite(vj)
    assert fin.sum() > 1000
    np.testing.assert_array_equal(np.sign(vt[fin]), np.sign(vj[fin]))
    np.testing.assert_allclose(vt[fin], vj[fin], rtol=0, atol=1e-4)
    mj, mt = runs["mesh_j"], runs["mesh_t"]
    assert mj is not None and mt is not None
    assert mt.faces.shape == mj.faces.shape and mt.faces.shape[0] > 1000
    np.testing.assert_array_equal(mt.faces, mj.faces)

    # refinement got the same grid edges and, to the field's tolerance, the
    # same start points (marching cubes interpolates the volume) and end values
    rj, rt = runs["refines"]["jax"], runs["refines"]["torch"]
    for name in ("v1", "v2"):
        np.testing.assert_array_equal(rt[name], rj[name])
    np.testing.assert_allclose(rt["v"], rj["v"], rtol=0, atol=1e-4)
    for name in ("p1", "p2"):
        np.testing.assert_array_equal(np.sign(rt[name]), np.sign(rj[name]))
        np.testing.assert_allclose(rt[name], rj[name], rtol=0, atol=1e-4)
    # refined vertices agree to 1e-4 except where a bisection step took the
    # other branch; each such vertex must be explained by its first
    # diverging query
    bad = np.abs(rt["out"] - rj["out"]).max(axis=1) > 1e-4
    assert bad.sum() <= max(3, bad.size // 1000), f"{bad.sum()} of {bad.size}"
    for cause in _diverging_steps(runs, rj, np.flatnonzero(bad)):
        assert cause in ("near-tie", "near-zero"), cause
    vd = np.abs(mt.vertices - mj.vertices).max(axis=1) > 1e-4
    assert vd.sum() <= bad.sum()
    np.testing.assert_allclose(mt.vertices[~vd], mj.vertices[~vd], rtol=0, atol=1e-4)


def _diverging_steps(runs, rec, rows):
    """Replay the bisection of `rows` with each package's evaluator on its
    own latents and name, per row, why the first step whose branch differs
    differs: a near-tie in the query's 50/64-NN set, or a field within 1e-4
    of zero on both sides; 'none' where no branch differs."""
    if rows.size == 0:
        return []
    je, te = _evaluators(runs, own_latents=True)
    v, v1, v2 = (rec[n][rows].astype(np.float32) for n in ("v", "v1", "v2"))
    p1, p2 = rec["p1"][rows].copy(), rec["p2"][rows].copy()
    cause = np.array(["none"] * rows.size, dtype=object)
    for _ in range(rec["iters"]):
        pj = je(v)
        with torch.inference_mode():
            pt = te(v)
        split = (((pj * p1) > 0) != ((pt * p1) > 0)) | (((pj * p2) > 0) != ((pt * p2) > 0))
        new = split & (cause == "none")
        tie = _exact_tie(runs["pts"], v)
        small = np.minimum(np.abs(pj), np.abs(pt)) <= 1e-4
        cause[new & tie] = "near-tie"
        cause[new & ~tie & small] = "near-zero"
        cause[new & ~tie & ~small] = "unexplained"
        m1, m2 = (pj * p1) > 0, (pj * p2) > 0
        v1[m1], p1[m1] = v[m1], pj[m1]
        v2[m2], p2[m2] = v[m2], pj[m2]
        v = (0.5 * (v1 + v2)).astype(np.float32)
    return list(cause)


def test_rec_entry_writes_the_mesh_in_input_coordinates(tmp_path):
    """`python -m ppsurf_tpu_torch.rec` on a shifted, scaled sphere (one
    encoder pass and one refinement step to keep it short): the PLY it
    writes, at `<out_dir>/<base>/<base>.ply` as the JAX package names it,
    lies on the input sphere, not in the unit cube."""
    from ppsurf_tpu_torch import rec
    from ppsurf_tpu_torch.io.ply import load_ply

    center = np.array([5.0, -3.0, 2.0], np.float32)
    cloud = sphere_cloud() * 10.0 + center
    np.save(tmp_path / "ball.npy", cloud)
    rc = rec.main([str(tmp_path / "ball.npy"), str(tmp_path / "out"), "--device", "cpu",
                   "--model.init_args.gen_resolution_global", "11",
                   "--model.init_args.gen_subsample_manifold_iter", "1",
                   "--model.init_args.gen_refine_iter", "1"])
    assert rc == 0
    mesh = load_ply(str(tmp_path / "out" / "ball.npy" / "ball.npy.ply"))
    radius = np.linalg.norm(mesh.vertices - center, axis=1)
    assert mesh.faces.shape[0] > 200
    assert radius.max() < 5.0 and 3.6 < np.median(radius) < 4.4
