"""The port's command line, datasets and output naming against the JAX
package on the CPU.

- Config stacking (`-c a.yaml -c b.yaml`, dotted overrides) resolves
  every stack of `configs/*.yaml` to the dict `ppsurf_tpu.cli.
  resolve_config` makes, and the model spec to the JAX spec's fields;
  `rec in out` rewrites to the same predict overrides.
- `Predictor.predict_dataset` writes each mesh where the JAX package's
  writes it, for a dataset `.txt` (`<results>/<name>/<dataset>/meshes/
  <shape>.xyz.ply`) and for a single cloud file
  (`<out_dir>/<base>/<base>.ply`, the base name keeping its extension):
  both predictors run on a tiny dataset made under tmp_path, with
  `reconstruct_shape` replaced by one fixed mesh.
- End to end on the CPU: `cli predict` on a two-shape dataset and `cli rec`
  on a `.ply` cloud; `rec` into the cloud's own directory, which the old
  `<out_dir>/<stem>.ply` naming overwrote, is refused and keeps the cloud.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from ppsurf_tpu import cli as jax_cli
from ppsurf_tpu.data.datasets import ShapeDataset as JShapeDataset
from ppsurf_tpu.recon.predict import Predictor as JPredictor
from ppsurf_tpu_torch import cli
from ppsurf_tpu_torch.data.datasets import ShapeDataset
from ppsurf_tpu_torch.io.ply import Mesh, load_ply, save_ply
from ppsurf_tpu_torch.recon.predict import Predictor

from test_torch_recon import sphere_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACKS = [
    ["poco"],
    ["poco", "poco_mini"],
    ["poco", "ppsurf"],
    ["poco", "ppsurf", "ppsurf_50nn"],
    ["poco", "ppsurf", "ppsurf_100nn"],
    ["poco", "ppsurf", "ppsurf_200nn"],
    ["poco", "ppsurf", "ppsurf_10nn", "device_server"],
    ["poco", "ppsurf", "ppsurf_25nn", "ppsurf_mini", "profiler"],
]
OVERRIDES = [("model.init_args.gen_resolution_global", "65"),
             ("data.init_args.padding_factor", "0.1"), ("ckpt_path", "w.npz")]
SPEC_FIELDS = ("name", "kind", "in_channels", "out_channels", "k", "network_latent_size",
               "pointnet_latent_size", "num_pts_local", "gen_subsample_manifold",
               "gen_subsample_manifold_iter", "gen_resolution_global", "rec_batch_size",
               "gen_refine_iter", "results_dir", "padding_factor")


def _configs(names):
    return [os.path.join(REPO, "configs", f"{n}.yaml") for n in names]


@pytest.mark.parametrize("names", STACKS, ids=["+".join(s) for s in STACKS])
def test_config_stack_resolves_as_jax(names):
    for overrides in ([], OVERRIDES):
        ours = cli.resolve_config(_configs(names), overrides, "predict")
        assert ours == jax_cli.resolve_config(_configs(names), overrides, "predict")
        spec = cli.build_spec(ours, cli.torch.device("cpu"))
        jspec = jax_cli.build_components(ours)[0]
        assert {f: getattr(spec, f) for f in SPEC_FIELDS} == \
               {f: getattr(jspec, f) for f in SPEC_FIELDS}


def test_rec_rewrite_matches_jax():
    args = (["in.xyz.ply", "out"], [("model.init_args.k", "32")])
    assert cli.rewrite_rec_args(*args) == jax_cli.rewrite_rec_args(*args)
    with pytest.raises(SystemExit):
        cli.rewrite_rec_args(["in.ply"], [])


def _dataset(root, names, n=1500):
    """A dataset dir: 04_pts_vis/<name>.xyz.ply clouds and set files."""
    os.makedirs(os.path.join(root, "04_pts_vis"))
    for i, name in enumerate(names):
        pts = sphere_cloud(n, seed=i) * np.float32([1.0, 1.0, 0.5 + 0.2 * i])
        save_ply(os.path.join(root, "04_pts_vis", name + ".xyz.ply"), pts)
    for split in ("trainset", "valset", "testset"):
        with open(os.path.join(root, f"{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return os.path.join(root, "testset.txt")


def test_predict_dataset_writes_where_jax_writes(tmp_path, monkeypatch):
    from ppsurf_tpu.convert.infer_npz import load_infer_npz as jax_load
    from ppsurf_tpu.train.model import ppsurf_spec as jax_spec
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS
    from ppsurf_tpu_torch.train.model import ppsurf_spec

    tetra = Mesh(vertices=np.eye(4, 3, dtype=np.float32),
                 faces=np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]))
    testset = _dataset(str(tmp_path / "tiny"), ["shape_a", "shape_b"], n=200)
    single = str(tmp_path / "tiny" / "04_pts_vis" / "shape_a.xyz.ply")
    outs = {}
    for tag, pred, ds_cls in (
            ("jax", JPredictor(jax_spec(name="nn50", results_dir=str(tmp_path / "jax")),
                               jax_load(DEFAULT_WEIGHTS), verbose=False), JShapeDataset),
            ("torch", Predictor(ppsurf_spec(name="nn50", results_dir=str(tmp_path / "torch")),
                                device="cpu", verbose=False), ShapeDataset)):
        monkeypatch.setattr(type(pred), "reconstruct_shape", lambda self, *a, **kw: tetra)
        files = [f for _, f, _ in pred.predict_dataset(ds_cls(testset))]
        files += [f for _, f, _ in pred.predict_dataset(ds_cls(single))]
        files += [f for _, f, _ in pred.predict_dataset(
            ds_cls(single), results_dir=str(tmp_path / tag / "given"))]
        assert all(os.path.isfile(f) for f in files)
        outs[tag] = [os.path.relpath(f, str(tmp_path / tag)) for f in files]
    assert outs["torch"] == outs["jax"] == [
        os.path.join("nn50", "tiny", "meshes", "shape_a.xyz.ply"),
        os.path.join("nn50", "tiny", "meshes", "shape_b.xyz.ply"),
        os.path.join("shape_a.xyz.ply", "shape_a.xyz.ply.ply"),
        os.path.join("given", "shape_a.xyz.ply", "shape_a.xyz.ply.ply"),
    ]


FAST = ["--device", "cpu", "--model.init_args.gen_resolution_global", "11",
        "--model.init_args.gen_subsample_manifold_iter", "1",
        "--model.init_args.gen_refine_iter", "1"]


def test_cli_predict_and_rec_end_to_end(tmp_path, capsys):
    testset = _dataset(str(tmp_path / "tiny"), ["shape_a", "shape_b"])
    results = str(tmp_path / "results")
    rc = cli.main(["predict", "-c", _configs(["poco"])[0], "-c", _configs(["ppsurf"])[0],
                   "-c", _configs(["ppsurf_50nn"])[0],
                   "--data.init_args.in_file", testset,
                   "--model.init_args.results_dir", results, *FAST])
    assert rc == 0
    meshes = sorted(glob.glob(os.path.join(results, "**", "*.ply"), recursive=True))
    assert meshes == [os.path.join(results, "ppsurf_50nn", "tiny", "meshes", f"{s}.xyz.ply")
                      for s in ("shape_a", "shape_b")]
    assert "2 of 2 shapes reconstructed" in capsys.readouterr().out
    for path in meshes:
        assert load_ply(path).faces.shape[0] > 100

    # rec writes <out_dir>/<base>/<base>.ply in the input's coordinates; an
    # out_dir that holds the cloud itself is refused before any work, and
    # the cloud is kept
    cloud = os.path.join(str(tmp_path / "tiny"), "04_pts_vis", "shape_a.xyz.ply")
    before = load_ply(cloud).vertices.copy()
    assert cli.main(["rec", cloud, str(tmp_path / "rec"), *FAST]) == 0
    mesh = load_ply(str(tmp_path / "rec" / "shape_a.xyz.ply" / "shape_a.xyz.ply.ply"))
    assert mesh.faces.shape[0] > 100
    assert np.abs(mesh.vertices).max() < 1.2 * np.abs(before).max()
    with pytest.raises(FileExistsError, match="shape_a.xyz.ply"):
        cli.main(["rec", cloud, os.path.dirname(cloud), *FAST])
    np.testing.assert_array_equal(load_ply(cloud).vertices, before)


def test_cli_refuses_what_it_cannot_load(tmp_path, monkeypatch):
    cloud = str(tmp_path / "c.xyz")
    np.savetxt(cloud, sphere_cloud(100))
    with pytest.raises(SystemExit, match="orbax"):
        cli.main(["rec", cloud, str(tmp_path), "--device", "cpu",
                  "--ckpt_path", str(tmp_path / "version_0" / "checkpoints" / "last")])
    with pytest.raises(SystemExit, match="no weights"):
        cli.main(["rec", cloud, str(tmp_path), "--device", "cpu", "-c", _configs(["poco"])[0]])
    # fit defaults to the card and does not fall back to the CPU
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(["fit", "-c", _configs(["poco"])[0]])
    assert cli.main(["predict", "-c", _configs(["poco"])[0], "--print_config"]) == 0
