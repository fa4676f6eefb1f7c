"""The port's figure tooling against the JAX package's on the CPU: the
colour map, Chamfer-coloured meshes, renders and their PNGs, the merged
comparison tables, the figure data, the IMLS re-alignment, the figure
renders, the `comp_*` configurations, and the container and pool helpers.

Inputs are made from a seed with numpy; outputs are compared byte for
byte (PLY, CSV, LaTeX), as arrays (`.npz`) or as decoded pixels (PNG: the
JAX package's read with PIL, here in the test only).
"""
from __future__ import annotations

import importlib
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from ppsurf_tpu.io.ply import Mesh, save_ply
from ppsurf_tpu_torch.utils.png import read_png, write_png
from tests.test_mesh_metrics import make_sphere_mesh

COMP_MODULES = ("comp_ablation_abc_maxnoise", "comp_ablation_abc_varnoise", "comp_ablation_all",
                "comp_ablation_dense", "comp_ablation_nn", "comp_ablation_noisefree",
                "comp_ablation_noisy", "comp_ablation_original", "comp_ablation_sparse",
                "comp_all", "comp_dense", "comp_noisefree", "comp_noisy", "comp_original",
                "comp_sparse")


def _cube() -> Mesh:
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int64)
    return Mesh(vertices=v - 0.5, faces=f)


def _pixels(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def test_colormap_equal():
    from ppsurf_tpu.utils.visualization import _colormap as theirs
    from ppsurf_tpu_torch.utils.visualization import _colormap as ours

    t = np.concatenate([np.linspace(-0.5, 1.5, 4001), np.random.default_rng(0).random(1000)])
    np.testing.assert_array_equal(ours(t), theirs(t))


def test_png_writer_round_trip_and_layout(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    assert struct.unpack(">IIBBBBB", data[16:29]) == (53, 37, 8, 2, 0, 0, 0)
    # the IDAT payload inflates with zlib to filter-0 rows of the pixels
    (n,) = struct.unpack(">I", data[33:37])
    assert data[37:41] == b"IDAT"
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(37, 53 * 3 + 1)
    assert not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(37, 53, 3), img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(_pixels(path), img)  # PIL reads the same pixels
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_visualize_chamfer_distance_bytes_and_distances(tmp_path):
    from ppsurf_tpu.utils.visualization import visualize_chamfer_distance as theirs
    from ppsurf_tpu_torch.utils.visualization import visualize_chamfer_distance as ours

    rec, gt = str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply")
    make_sphere_mesh(0.27, n=21).export(rec)
    make_sphere_mesh(0.3).export(gt)
    a, b = str(tmp_path / "jax" / "cd.ply"), str(tmp_path / "port" / "cd.ply")
    assert theirs(rec, gt, a) == a and ours(rec, gt, b) == b
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(np.load(a[:-4] + ".npz")["distances"],
                                  np.load(b[:-4] + ".npz")["distances"])
    assert ours(str(tmp_path / "missing.ply"), gt, b) is None


@pytest.mark.parametrize("kind", ["mesh", "coloured_mesh", "points_npy", "points_ply"])
def test_render_scene_pixels_equal(tmp_path, kind):
    from ppsurf_tpu.utils.visualization import render_scene as theirs
    from ppsurf_tpu_torch.utils.visualization import render_scene as ours

    rng = np.random.default_rng(2)
    path = str(tmp_path / ("in.npy" if kind == "points_npy" else "in.ply"))
    if kind == "mesh":
        make_sphere_mesh(0.3, n=17).export(path)
    elif kind == "coloured_mesh":
        m = _cube()
        Mesh(m.vertices, m.faces, rng.integers(0, 256, (8, 3), dtype=np.uint8)).export(path)
    elif kind == "points_npy":
        np.save(path, rng.random((500, 3)).astype(np.float32))
    else:
        save_ply(path, rng.random((700, 3)).astype(np.float32),
                 vertex_colors=rng.integers(0, 256, (700, 3), dtype=np.uint8))
    a, b = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    theirs(path, a, resolution=(96, 80))
    ours(path, b, resolution=(96, 80))
    want = _pixels(a)
    assert want.shape == (80, 96, 3) and (want < 250).any()
    np.testing.assert_array_equal(read_png(b), want)


def test_render_without_the_host_library(monkeypatch):
    """A mesh raises where the native renderer is missing (the JAX
    package's PIL painter is not ported); points fall back to numpy."""
    from ppsurf_tpu_torch import native
    from ppsurf_tpu_torch.utils import visualization as vz

    monkeypatch.setattr(native, "available", lambda: False)
    cube = _cube()
    with pytest.raises(RuntimeError, match="host library"):
        vz._render_arrays(cube.vertices, cube.faces, None, (32, 32), 45.0)
    img = vz._render_arrays(cube.vertices, None, None, (32, 32), 45.0)
    assert img.shape == (32, 32, 3) and (img != 255).any()


def test_native_renderer_checks_its_buffers():
    from ppsurf_tpu_torch import native
    from ppsurf_tpu_torch.utils.visualization import camera_view_matrix

    cube = _cube()
    view = camera_view_matrix(cube.vertices)
    img = np.full((20, 30, 3), 255, np.uint8)
    with pytest.raises(ValueError, match="background"):
        native.render_mesh_native(cube.vertices, cube.faces, None, view, 20, 30, 45.0, img)
    with pytest.raises(ValueError, match="colors"):
        native.render_points_native(cube.vertices, np.zeros((7, 3), np.uint8), view, 30, 20,
                                    45.0, 1, img)
    out = native.render_mesh_native(cube.vertices, cube.faces, None, view, 30, 20, 45.0, img)
    assert out is img and (img != 255).any()


def test_merge_comps_csv_and_tex_equal(tmp_path):
    import pandas as pd

    from ppsurf_tpu.eval.reports import export_table
    from ppsurf_tpu.figures.comp_base import merge_comps as theirs
    from ppsurf_tpu_torch.figures.comp_base import merge_comps as ours

    for comp in ("jax", "port"):
        for d, cols in (("abc_noisy", ["Mean chamfer_distance", "Median f1"]),
                        ("famous_dense", ["Mean chamfer_distance", "Count", "Median f1"])):
            vals = np.random.default_rng(len(cols)).normal(size=(2, len(cols)))
            vals[1, 0] = np.nan
            df = pd.DataFrame(vals, columns=cols, index=["ppsurf_50nn", "poco_mini"])
            df.index.name = "Model"
            export_table(df, str(tmp_path / comp / d / "comp_mean.xlsx"), add_stats=False)
    a = theirs("comp_x", ["abc_noisy", "missing", "famous_dense"], str(tmp_path / "jax"))
    b = ours("comp_x", ["abc_noisy", "missing", "famous_dense"], str(tmp_path / "port"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a[:-4] + ".tex").read() == open(b[:-4] + ".tex").read()
    assert ours("comp_y", ["missing"], str(tmp_path / "port")) is None


def _figure_inputs(root):
    rng = np.random.default_rng(4)
    cube = _cube()
    for d in ("datasets/dset/03_meshes", "datasets/dset/04_pts_vis", "results/meth/dset/meshes"):
        os.makedirs(os.path.join(root, d))
    cube.export(os.path.join(root, "datasets/dset/03_meshes/shapeA.ply"))
    save_ply(os.path.join(root, "datasets/dset/04_pts_vis/shapeA.xyz.ply"),
             rng.random((100, 3)).astype(np.float32) - 0.5)
    Mesh(cube.vertices + 0.01, cube.faces).export(
        os.path.join(root, "results/meth/dset/meshes/shapeA.xyz.ply"))


def test_assemble_figure_data_equal(tmp_path):
    from ppsurf_tpu.figures.prepare_figures import assemble_figure_data as theirs
    from ppsurf_tpu_torch.figures.prepare_figures import assemble_figure_data as ours

    for tag, fn in (("jax", theirs), ("port", ours)):
        root = str(tmp_path / tag)
        _figure_inputs(root)
        fn(os.path.join(root, "figs"), [("dset", "shapeA")],
           datasets_path=os.path.join(root, "datasets"),
           results_path=os.path.join(root, "results"), methods=["meth"], workers=0,
           min_vertex_count=100)
    base = ("figs", "dset", "shapeA")
    for name in ("gt.ply", "pc.ply", "meth.ply", "meth_dist_col.ply"):
        assert (open(os.path.join(tmp_path, "jax", *base, name), "rb").read()
                == open(os.path.join(tmp_path, "port", *base, name), "rb").read()), name
    za = np.load(os.path.join(tmp_path, "jax", *base, "meth_dist.npz"))
    zb = np.load(os.path.join(tmp_path, "port", *base, "meth_dist.npz"))
    for k in ("vertices", "faces", "distances"):
        np.testing.assert_array_equal(za[k], zb[k])
    assert zb["vertices"].shape[0] >= 100 and 0 < zb["distances"].mean() < 0.05


def test_fix_imls_equal(tmp_path):
    from ppsurf_tpu.figures import fix_imls as theirs
    from ppsurf_tpu_torch.figures import fix_imls as ours

    cube = _cube()
    for tag, mod in (("jax", theirs), ("port", ours)):
        root = tmp_path / tag
        os.makedirs(root / "datasets" / "abc" / "03_meshes")
        (root / "datasets" / "abc" / "testset.txt").write_text("s1\ns2\n")
        for i, s in enumerate(("s1", "s2")):
            Mesh(cube.vertices * (2.0 + i) + np.float32(i), cube.faces).export(
                str(root / "datasets" / "abc" / "03_meshes" / f"{s}.ply"))
        misaligned = root / "results" / "neural_imls misaligned" / "abc" / "meshes"
        os.makedirs(misaligned)
        Mesh(cube.vertices * 0.9, cube.faces).export(str(misaligned / "s1.ply"))
        mod.main(str(root / "datasets"), str(root / "results"), workers=0)
    out = os.path.join("results", "neural_imls", "abc", "meshes", "s1.ply")
    assert open(tmp_path / "jax" / out, "rb").read() == open(tmp_path / "port" / out, "rb").read()
    assert not os.path.exists(tmp_path / "port" / out.replace("s1", "s2"))
    assert ours.DATASETS == theirs.DATASETS


def test_render_figures_main_pixels_equal(tmp_path):
    from ppsurf_tpu.figures.render_figures import main as theirs
    from ppsurf_tpu_torch.figures.render_figures import main as ours

    for tag in ("jax", "port"):
        base = tmp_path / tag / "figs" / "d" / "s"
        os.makedirs(base)
        _cube().export(str(base / "gt.ply"))
        v = make_sphere_mesh(0.3, n=13)
        np.savez(str(base / "meth_dist.npz"), vertices=v.vertices, faces=v.faces,
                 distances=np.random.default_rng(6).random(v.vertices.shape[0]) * 0.03)
        _cube().export(str(base / "meth_dist_col.ply"))  # skipped by both
    for tag, main in (("jax", theirs), ("port", ours)):
        assert main(["--figures_dir", str(tmp_path / tag / "figs"), "--workers", "0",
                     "--resolution", "64"]) == 0
    for name in ("gt.png", "meth_dist.png"):
        want = _pixels(str(tmp_path / "jax" / "figs" / "d" / "s" / name))
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / "figs" / "d" / "s" / name)),
                                      want)
    assert not os.path.exists(tmp_path / "port" / "figs" / "d" / "s" / "meth_dist_col.png")


@pytest.mark.parametrize("name", COMP_MODULES)
def test_comp_configuration_equal(name):
    theirs = importlib.import_module(f"ppsurf_tpu.figures.{name}")
    ours = importlib.import_module(f"ppsurf_tpu_torch.figures.{name}")
    assert ours.DATASETS == theirs.DATASETS and ours.METHODS == theirs.METHODS
    assert ours.run_comparison.__module__ == "ppsurf_tpu_torch.figures.comp_base"


def test_container_helpers_equal():
    from ppsurf_tpu.utils import container as theirs
    from ppsurf_tpu_torch.utils import container as ours

    dicts = [{"a": 1.0, "b": {"c": 2.0, "d": 3.0}, "l": [1, 2], "s": "x"},
             {"a": np.nan, "b": {"c": 4.0, "d": 5.0}, "l": [3, 4], "s": "y"}]
    for fl in (False, True):
        assert ours.flatten_dicts(dicts, fl) == theirs.flatten_dicts(dicts, fl)
    flat = ours.flatten_dicts(dicts)
    assert ours.aggregate_dicts_np(flat, "mean") == theirs.aggregate_dicts_np(flat, "mean")
    for method in ("concat", "stack"):
        got, want = ours.aggregate_dicts_np(flat, method), theirs.aggregate_dicts_np(flat, method)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        ours.aggregate_dicts_np(flat, "max")
    parts = [np.arange(3.0), np.arange(2.0)]
    np.testing.assert_array_equal(ours.tensor_list_to_array([torch.arange(3.0), parts[1]]),
                                  theirs.tensor_list_to_array(parts))


def _square(x):
    return x * x


def test_start_process_pool_paths():
    from ppsurf_tpu_torch.utils.mp import start_process_pool, start_thread

    params = [(i,) for i in range(5)]
    want = [i * i for i in range(5)]
    assert start_process_pool(_square, params, 0) == want  # serial
    assert start_process_pool(_square, params, 2) == want  # spawn pool
    assert start_process_pool(lambda x: x * x, params, 2) == want  # threads: unpicklable
    assert start_process_pool(_square, [], 4) == []
    out = []
    start_thread(out.append, (7,)).join()
    assert out == [7]
