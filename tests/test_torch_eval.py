"""The port's scoring of reconstructions against the JAX package's, on the CPU.

- `make_quantitative_comparison`: the four tables (Chamfer, F1, IoU,
  normal error) of two methods over three shapes, one mesh missing (NaN),
  byte for byte the JAX package's CSVs, and an `.xlsx` beside each;
- `evaluate_reconstructions` on a dataset with `03_meshes` and
  `make_evaluation.main` on the same layout: the JAX package's CSVs byte
  for byte; a second `make_evaluation` run skips the up-to-date tables;
  a dataset without `03_meshes` and a single cloud are skipped;
- `cli predict --device cpu` on a two-shape dataset with `03_meshes`
  scores its meshes on the CPU: four tables with one finite row per shape
  (the scoring at 2 048 samples, so that the plain winding number stays
  quick here; the card's smoke scores at the default 100 000).

That the scoring entry points default to CUDA and raise without it is
held in `tests/test_torch_package.py`.

The inside/outside tests run at 1 024 to 2 048 cube samples (one or two
query tiles of the plain winding number).
"""
from __future__ import annotations

import csv
import os
import shutil

import numpy as np

from ppsurf_tpu.eval import make_evaluation as jmake_evaluation
from ppsurf_tpu.eval.reports import make_quantitative_comparison as jquant
from ppsurf_tpu.train.evaluate import evaluate_reconstructions as jevaluate
from ppsurf_tpu.train.model import ppsurf_spec as jax_spec
from ppsurf_tpu_torch import cli
from ppsurf_tpu_torch.eval import make_evaluation
from ppsurf_tpu_torch.eval.reports import make_quantitative_comparison
from ppsurf_tpu_torch.train import evaluate
from ppsurf_tpu_torch.train.model import ppsurf_spec

from test_torch_cli import FAST, _configs, _dataset
from test_torch_metrics import sphere_mesh

TABLES = ("chamfer_distance", "f1", "iou", "normal_error")
SAMPLES = 1024


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _assert_same_tables(ours_dir, jax_dir):
    for name in TABLES:
        assert _read(os.path.join(ours_dir, name + ".csv")) == \
            _read(os.path.join(jax_dir, name + ".csv")), name
        assert os.path.isfile(os.path.join(ours_dir, name + ".xlsx"))


def _write_gt(dataset_dir, names):
    """03_meshes/<name>.ply: spheres of radius 0.3 to 0.38."""
    os.makedirs(os.path.join(dataset_dir, "03_meshes"), exist_ok=True)
    for i, name in enumerate(names):
        sphere_mesh(0.3 + 0.04 * i, 25).export(os.path.join(dataset_dir, "03_meshes",
                                                            name + ".ply"))


def _write_results(meshes_dir, names):
    """Reconstructions: spheres a little off their ground truth."""
    os.makedirs(meshes_dir, exist_ok=True)
    for i, name in enumerate(names):
        sphere_mesh(0.28 + 0.04 * i, 21, (0.01 * i, 0.0, 0.02)).export(
            os.path.join(meshes_dir, name + ".xyz.ply"))


def test_quantitative_comparison_matches_jax_byte_for_byte(tmp_path):
    names = ["s0", "s1", "s_missing"]
    gt_dir = str(tmp_path / "ds")
    _write_gt(gt_dir, names)
    gt = [os.path.join(gt_dir, "03_meshes", n + ".ply") for n in names]
    templates = []
    for m in ("m1", "m2"):
        _write_results(str(tmp_path / m), names[:2] if m == "m1" else names[:1])
        templates.append(str(tmp_path / m / "{}.xyz.ply"))
    ours = make_quantitative_comparison(names, gt, ["m1", "m2"], templates,
                                        str(tmp_path / "ours"), num_samples=SAMPLES,
                                        device="cpu")
    theirs = jquant(names, gt, ["m1", "m2"], templates, str(tmp_path / "jax"),
                    num_samples=SAMPLES)
    assert sorted(ours) == sorted(theirs) == ["chamfer", "f1", "iou", "normals"]
    _assert_same_tables(str(tmp_path / "ours"), str(tmp_path / "jax"))
    rows = list(csv.reader(open(ours["iou"])))
    assert rows[0] == ["Shape", "m1", "m2"]
    assert [r[0] for r in rows[1:]] == names + ["AVERAGE", "MEDIAN", "STDEV"]
    assert 0.5 < float(rows[1][1]) < 1.0 and rows[3][1] == "" and rows[2][2] == ""


def _dataset_with_results(root, names, name="ppsurf_50nn"):
    in_file = _dataset(os.path.join(root, "ds"), names, n=100)
    _write_gt(os.path.join(root, "ds"), names)
    for tag in ("ours", "jax"):
        _write_results(os.path.join(root, tag, name, "ds", "meshes"), names)
    return in_file


def test_evaluate_reconstructions_and_make_evaluation_match_jax(tmp_path, capsys):
    names = ["shape_a", "shape_b"]
    root = str(tmp_path)
    in_file = _dataset_with_results(root, names)
    ours_dir = os.path.join(root, "ours", "ppsurf_50nn", "ds")
    jax_dir = os.path.join(root, "jax", "ppsurf_50nn", "ds")
    got = evaluate.evaluate_reconstructions(ppsurf_spec(), in_file, ours_dir,
                                            num_samples=SAMPLES, device="cpu")
    jevaluate(jax_spec(), in_file, jax_dir, num_samples=SAMPLES)
    assert sorted(got) == ["chamfer", "f1", "iou", "normals"]
    _assert_same_tables(ours_dir, jax_dir)
    # the default results dir: <results_dir>/<name>/<dataset>
    spec = ppsurf_spec(results_dir=os.path.join(root, "ours"))
    assert evaluate.evaluate_reconstructions(spec, in_file, num_samples=SAMPLES,
                                             device="cpu")["iou"] == \
        os.path.join(ours_dir, "iou.csv")

    for tag in ("ours", "jax"):
        for name in TABLES:
            os.remove(os.path.join(root, tag, "ppsurf_50nn", "ds", name + ".csv"))
    args = ["--model_names", "ppsurf_50nn", "--dataset_names", "ds",
            "--data_dir", root, "--num_samples", str(SAMPLES)]
    assert make_evaluation.main([*args, "--results_dir", os.path.join(root, "ours"),
                                 "--device", "cpu"]) == 0
    assert jmake_evaluation.main([*args, "--results_dir", os.path.join(root, "jax")]) == 0
    _assert_same_tables(ours_dir, jax_dir)
    capsys.readouterr()
    assert make_evaluation.evaluate_method_on_dataset(
        "ppsurf_50nn", "ds", os.path.join(root, "ours"), root, SAMPLES, device="cpu") is None
    assert "up to date" in capsys.readouterr().out
    assert make_evaluation.evaluate_method_on_dataset(
        "ppsurf_50nn", "none", os.path.join(root, "ours"), root, device="cpu") is None

    # no ground truth, or a single cloud: nothing to score
    shutil.rmtree(os.path.join(root, "ds", "03_meshes"))
    assert evaluate.evaluate_reconstructions(spec, in_file, device="cpu") is None
    assert "Skipping evaluation" in capsys.readouterr().out
    cloud = os.path.join(root, "ds", "04_pts_vis", "shape_a.xyz.ply")
    assert evaluate.evaluate_reconstructions(spec, cloud, device="cpu") is None


def test_cli_predict_scores_the_dataset_on_the_cpu(tmp_path, monkeypatch, capsys):
    names = ["shape_a", "shape_b"]
    testset = _dataset(str(tmp_path / "tiny"), names)
    _write_gt(str(tmp_path / "tiny"), names)
    calls = []
    full = evaluate.evaluate_reconstructions

    def scored(spec, in_file, results_dir=None, num_samples=100000, device=None):
        calls.append((in_file, num_samples, str(device)))
        return full(spec, in_file, results_dir, num_samples=2048, device=device)

    monkeypatch.setattr(evaluate, "evaluate_reconstructions", scored)
    results = str(tmp_path / "results")
    rc = cli.main(["predict", "-c", _configs(["poco"])[0], "-c", _configs(["ppsurf"])[0],
                   "-c", _configs(["ppsurf_50nn"])[0],
                   "--data.init_args.in_file", testset,
                   "--model.init_args.results_dir", results, *FAST])
    assert rc == 0 and calls == [(testset, 100000, "cpu")]
    assert "2 of 2 shapes reconstructed" in capsys.readouterr().out
    rdir = os.path.join(results, "ppsurf_50nn", "tiny")
    for name in TABLES:
        rows = list(csv.reader(open(os.path.join(rdir, name + ".csv"))))
        assert rows[0] == ["Shape", "ppsurf_50nn"]
        assert [r[0] for r in rows[1:3]] == names
        assert all(np.isfinite(float(r[1])) for r in rows[1:3]), (name, rows)
        assert os.path.isfile(os.path.join(rdir, name + ".xlsx"))
