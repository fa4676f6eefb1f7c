"""The port's mesh metrics against the JAX package's on the CPU.

- `sample_surface` / `sample_mesh`: the same samples bit for bit (seed 42
  and a given generator, with face indices, empty meshes);
- `nn_query` (native kd-tree and scipy paths), `get_closest_point_on_mesh`
  and the exact `normal_error`: equal arrays and values;
- `winding_plain` against `_winding_tiled` within 2e-5 absolute, on a
  sphere of 3 512 faces and one of 13 832 (across a face tile of 8 192),
  with queries on vertices and degenerate faces added; `points_inside`
  masks equal;
- Chamfer, Hausdorff and normal error within 1e-12 relative (host paths),
  IoU and F1 equal, on the same mesh files; the dispatcher's NaN for a
  missing mesh and its error for a missing ground truth;
- `points_inside` of an empty mesh is all False.

W1 against its plain version on a card is in `tests/test_torch_package.py`
(marked `cuda`), which runs where JAX is not installed.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from ppsurf_tpu.io.ply import Mesh as JMesh
from ppsurf_tpu.metrics import mesh_metrics as jmm
from ppsurf_tpu.metrics import proximity as jprox
from ppsurf_tpu.metrics import sampling as jsampling
from ppsurf_tpu.metrics import winding as jwinding
from ppsurf_tpu_torch.io.ply import Mesh
from ppsurf_tpu_torch.metrics import mesh_metrics as mm
from ppsurf_tpu_torch.metrics import proximity as prox
from ppsurf_tpu_torch.metrics import sampling
from ppsurf_tpu_torch.metrics import winding as pwinding
from ppsurf_tpu_torch.ops.winding import winding, winding_plain
from ppsurf_tpu_torch.recon.marching_cubes import marching_cubes

WINDING_ATOL = 2e-5  # plain version vs the JAX reduction: f32 sums in another order
METRIC_RTOL = 1e-12  # host paths (numpy, the same kd-tree): equal up to the last bits
IOU_SAMPLES = 4096


def sphere_mesh(radius: float, n: int, center=(0.0, 0.0, 0.0)) -> Mesh:
    """Marching cubes of a sphere's distance on an n^3 grid over the unit cube."""
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float64)
    mid = (n - 1) / 2
    vol = np.sqrt(((g - mid) ** 2).sum(axis=0)) * (1.0 / mid) - radius / 0.5
    verts, faces = marching_cubes(vol, 0.0)
    world = (verts / mid - 1.0) * 0.5 + np.asarray(center)
    return Mesh(vertices=world.astype(np.float32), faces=faces.astype(np.int64))


def jmesh(m: Mesh) -> JMesh:
    return JMesh(vertices=m.vertices, faces=m.faces)


@pytest.fixture(scope="module")
def meshes():
    return {"small": sphere_mesh(0.3, 33), "big": sphere_mesh(0.3, 65, (0.05, 0.0, 0.02))}


@pytest.fixture(scope="module")
def mesh_files(tmp_path_factory, meshes):
    tmp = tmp_path_factory.mktemp("meshes")
    files = {"a": str(tmp / "a.ply"), "c": str(tmp / "c.ply"), "bad": str(tmp / "bad.ply")}
    meshes["small"].export(files["a"])
    sphere_mesh(0.24, 33, (0.02, -0.01, 0.0)).export(files["c"])
    with open(files["bad"], "w") as fp:
        fp.write("not a ply\n")
    return files


def test_sampling_is_bit_identical(meshes, mesh_files):
    m = meshes["small"]
    np.testing.assert_array_equal(sampling.sample_surface(m, 5000),
                                  jsampling.sample_surface(jmesh(m), 5000))
    ours = sampling.sample_surface(m, 3000, np.random.default_rng(7), return_face_index=True)
    theirs = jsampling.sample_surface(jmesh(m), 3000, np.random.default_rng(7),
                                      return_face_index=True)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for f in mesh_files.values():
        np.testing.assert_array_equal(sampling.sample_mesh(f, 2000),
                                      jsampling.sample_mesh(f, 2000))
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    assert sampling.sample_surface(empty, 10).shape == (0, 3)
    assert sampling.sample_surface(empty, 10, return_face_index=True)[1].shape == (0,)


@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
def test_proximity_matches_jax(meshes, mesh_files, monkeypatch, native):
    from ppsurf_tpu import native as jnative
    from ppsurf_tpu_torch import native as pnative

    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(pnative, "available", lambda: False)
    elif not pnative.available():
        pytest.skip("the host library did not build")
    rng = np.random.default_rng(3)
    pts = rng.random((4000, 3)) - 0.5
    queries = rng.random((1000, 3)) - 0.5
    for k in (1, 8):
        for a, b in zip(prox.nn_query(pts, queries, k), jprox.nn_query(pts, queries, k)):
            np.testing.assert_array_equal(a, b)
    m = meshes["small"]
    for a, b in zip(prox.get_closest_point_on_mesh(m, queries),
                    jprox.get_closest_point_on_mesh(jmesh(m), queries)):
        np.testing.assert_array_equal(a, b)
    assert (prox.normal_error(mesh_files["c"], mesh_files["a"], 3000)
            == jprox.normal_error(mesh_files["c"], mesh_files["a"], 3000))


def _winding_inputs(mesh: Mesh, seed: int):
    """Cube queries, 64 queries exactly on vertices, and the mesh's faces
    with degenerate ones added (a repeated vertex, all three the same)."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices
    queries = np.concatenate([
        (rng.random((1500, 3)) - 0.5).astype(np.float32),
        v[rng.choice(v.shape[0], 64, replace=False)],
    ])
    f = mesh.faces
    degenerate = np.stack([f[:40, 0], f[:40, 0], f[:40, 1]], axis=1)
    point = np.repeat(f[40:60, :1], 3, axis=1)
    faces = np.concatenate([f, degenerate, point])
    return queries, v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]


@pytest.mark.parametrize("which", ["small", "big"])
def test_winding_plain_matches_jax(meshes, which):
    import jax.numpy as jnp

    queries, a, b, c = _winding_inputs(meshes[which], seed=1)
    ours = winding_plain(*(torch.from_numpy(x) for x in (queries, a, b, c))).numpy()
    theirs = np.asarray(jwinding._winding_tiled(*(jnp.asarray(x) for x in (queries, a, b, c))))
    assert ours.dtype == np.float32 and ours.shape == (queries.shape[0],)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=WINDING_ATOL)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        winding(*(torch.from_numpy(x) for x in (queries, a, b, c))).numpy(), ours)
    # inside / outside of the closed mesh, away from its surface
    cube = queries[:1500]
    mesh = meshes[which]
    np.testing.assert_array_equal(pwinding.points_inside(mesh, cube, device="cpu"),
                                  jwinding.points_inside(jmesh(mesh), cube))
    inside = np.linalg.norm(cube - mesh.vertices.mean(0), axis=1) < 0.29
    outside = np.linalg.norm(cube - mesh.vertices.mean(0), axis=1) > 0.31
    w = ours[:1500]
    assert np.abs(w[inside] - 1).max() < 1e-3 and np.abs(w[outside]).max() < 1e-3


def test_points_inside_edges(meshes):
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    q = np.zeros((5, 3))
    assert not pwinding.points_inside(empty, q, device="cpu").any()
    np.testing.assert_allclose(
        pwinding.winding_number(meshes["small"], q, device="cpu"),
        np.asarray(jwinding.winding_number(jmesh(meshes["small"]), q)), rtol=0,
        atol=WINDING_ATOL)


METRICS = {
    "chamfer": (lambda m, a, b, **kw: m.chamfer_distance(a, b, 5000), METRIC_RTOL),
    "hausdorff": (lambda m, a, b, **kw: m.hausdorff_distance(a, b, 3000), METRIC_RTOL),
    "normals": (lambda m, a, b, **kw: m.normal_error_approx(a, b, 5000), METRIC_RTOL),
    "iou": (lambda m, a, b, **kw: m.intersection_over_union(a, b, IOU_SAMPLES, **kw), 0.0),
    "f1": (lambda m, a, b, **kw: m.f1_approx(a, b, IOU_SAMPLES, **kw), 0.0),
}


@pytest.mark.parametrize("metric", list(METRICS))
def test_metric_matches_jax(mesh_files, metric):
    fn, rtol = METRICS[metric]
    ours = fn(mm, mesh_files["c"], mesh_files["a"], device="cpu")
    theirs = fn(jmm, mesh_files["c"], mesh_files["a"])
    assert ours[:2] == theirs[:2]
    np.testing.assert_allclose(ours[2:], theirs[2:], rtol=rtol, atol=0)
    value = ours[2]
    assert np.isfinite(value)
    if metric == "iou":  # spheres of radius 0.24 and 0.3: IoU about 0.51
        assert 0.4 < value < 0.6
    # an unreadable mesh
    bad = fn(mm, mesh_files["bad"], mesh_files["a"], device="cpu")
    jbad = fn(jmm, mesh_files["bad"], mesh_files["a"])
    np.testing.assert_array_equal(np.asarray(bad[2:], float), np.asarray(jbad[2:], float))


def test_dispatcher_matches_jax(mesh_files, tmp_path):
    missing = str(tmp_path / "missing_{}.ply")
    template = os.path.join(os.path.dirname(mesh_files["c"]), "{}.ply")
    for metric in ("chamfer", "normals", "iou"):
        got = mm.get_metric_meshes([template, missing], ["c"], [mesh_files["a"]],
                                   num_samples=2048, metric=metric, device="cpu")
        want = jmm.get_metric_meshes([template, missing], ["c"], [mesh_files["a"]],
                                     num_samples=2048, metric=metric)
        assert len(got) == 2 and np.isnan(got[1][0]) and np.isnan(want[1][0])
        np.testing.assert_allclose(got[0], want[0], rtol=METRIC_RTOL)
    with pytest.raises(FileExistsError, match="GT mesh missing"):
        mm.get_metric_mesh_single_file(missing.format("gt"), mesh_files["c"], 100, device="cpu")
