"""The port's training data, metrics, report and command line against the
JAX package, on the CPU.

- `OccupancyDataModule.epoch_batches` of the port yields batches
  bit-identical to the JAX package's on a dataset written under tmp_path
  (clouds, query points, signed distances, set files): shuffled with
  augmentation and `patches_per_shape`, all queries, and unshuffled with
  a wrapped last batch, over one and several prefetch workers.
- `build_fkaconv_graph_batch`, `build_proj_ids_batch` and
  `extract_local_patches_batch` match the JAX package's batched builds
  from the same draws (`jax.random.split` of each level's key over the
  batch), ids exactly and patches to 1e-6.
- Confusion counts and metrics match `ppsurf_tpu.metrics.classification`.
- `make_test_report` writes the same CSV, byte for byte, as the JAX
  package's pandas writer, and an `.xlsx` that reads back to it.
- `cli fit` then `cli test` with `--device cpu` end to end: a checkpoint
  `last.pt` with `config.yaml` beside it, the report of every test
  shape, and `predict` from the port checkpoint.
"""
from __future__ import annotations

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppsurf_tpu.data.datasets import OccupancyDataModule as JDataModule
from ppsurf_tpu.eval.reports import make_test_report as jax_make_test_report
from ppsurf_tpu.metrics import classification as jcls
from ppsurf_tpu.ops.graph import build_fkaconv_graph as jbuild_graph
from ppsurf_tpu.ops.graph import build_proj_ids as jbuild_proj_ids
from ppsurf_tpu.ops.patches import extract_local_patches as jextract
from ppsurf_tpu_torch import cli
from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
from ppsurf_tpu_torch.eval.reports import make_test_report
from ppsurf_tpu_torch.eval.xlsx import read_xlsx
from ppsurf_tpu_torch.io.ply import save_ply
from ppsurf_tpu_torch.metrics import classification as cls
from ppsurf_tpu_torch.ops.graph import build_fkaconv_graph_batch, build_proj_ids_batch
from ppsurf_tpu_torch.ops.patches import extract_local_patches_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_training_dataset(root: str, n_train: int = 5, n_val: int = 2, n_test: int = 2,
                           n_pts: int = 300, n_query: int = 64, seed: int = 0) -> str:
    """A dataset in the reference layout: spheres of random centre and
    radius, `04_pts_vis/<name>.xyz.ply` clouds (sizes vary by shape),
    `05_query_pts`/`05_query_dist/<name>.ply.npy` queries in the unit cube
    with their signed distances, and the three set files; returns the
    test set's path."""
    rng = np.random.RandomState(seed)
    for d in ("04_pts_vis", "05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    splits = {"trainset": [f"train_{i}" for i in range(n_train)],
              "valset": [f"val_{i}" for i in range(n_val)],
              "testset": [f"test_{i}" for i in range(n_test)]}
    for names in splits.values():
        for name in names:
            radius = 0.2 + 0.15 * rng.rand()
            centre = (rng.rand(3) - 0.5) * 0.2
            d = rng.randn(n_pts + rng.randint(0, n_pts // 2), 3)
            pts = d / np.linalg.norm(d, axis=1, keepdims=True) * radius + centre
            save_ply(os.path.join(root, "04_pts_vis", name + ".xyz.ply"), pts.astype(np.float32))
            q = (rng.rand(n_query, 3) - 0.5).astype(np.float32)
            dist = (np.linalg.norm(q - centre, axis=1) - radius).astype(np.float32)
            np.save(os.path.join(root, "05_query_pts", name + ".ply.npy"), q)
            np.save(os.path.join(root, "05_query_dist", name + ".ply.npy"), dist)
    for split, names in splits.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return os.path.join(root, "testset.txt")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_training_dataset(str(tmp_path_factory.mktemp("ds")))


@pytest.mark.parametrize("patches,aug,shuffle,workers", [
    (24, True, True, 1), (None, True, True, 3), (None, False, False, 1)])
def test_epoch_batches_bit_identical_to_jax(dataset, patches, aug, shuffle, workers):
    kw = dict(in_file=dataset, batch_size=2, manifold_points=100, seed=7,
              do_data_augmentation=aug, patches_per_shape=patches, workers=workers)
    ours_dm, jax_dm = OccupancyDataModule(**kw), JDataModule(**kw)
    for epoch in range(2):  # the seed streams carry over between epochs
        if epoch == 0:
            ours_ds, jax_ds = ours_dm.train_dataset(), jax_dm.train_dataset()
            ours_rng, jax_rng = np.random.RandomState(3), np.random.RandomState(3)
        ours = list(ours_dm.epoch_batches(ours_ds, ours_rng, shuffle))
        theirs = list(jax_dm.epoch_batches(jax_ds, jax_rng, shuffle))
        assert len(ours) == len(theirs) == 3  # 5 shapes, the last batch wrapped
        for a, b in zip(ours, theirs):
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours[0]["pts_raw_ms"].shape[1] % 4096 == 0
    assert ours[0]["pts_query_ms"].shape[1] == (patches or 64)


def test_batched_builds_match_jax():
    from test_torch_train import jax_step_draws

    rng = np.random.RandomState(4)
    b, n, q, raw = 3, 200, 40, 300
    pts = rng.rand(b, n, 3).astype(np.float32)
    queries = rng.rand(b, q, 3).astype(np.float32)
    pts_raw = rng.rand(b, raw, 3).astype(np.float32)
    valid = rng.rand(b, raw) > 0.3
    key = jax.random.key(11)
    theirs = jbuild_graph(jnp.asarray(pts), key, tile=64)
    ours = build_fkaconv_graph_batch(torch.from_numpy(pts), jax_step_draws(key, b, n))
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if k.startswith("ids"):
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(
        build_proj_ids_batch(torch.from_numpy(pts), torch.from_numpy(queries), 16).numpy(),
        np.asarray(jbuild_proj_ids(jnp.asarray(pts), jnp.asarray(queries), k=16, tile=64)))
    np.testing.assert_allclose(
        extract_local_patches_batch(torch.from_numpy(pts_raw), torch.from_numpy(valid),
                                    torch.from_numpy(queries), 12).numpy(),
        np.asarray(jextract(jnp.asarray(pts_raw), jnp.asarray(valid), jnp.asarray(queries),
                            num_pts_local=12, tile=64)),
        rtol=1e-6, atol=1e-6)


def test_confusion_and_metrics_match_jax():
    rng = np.random.RandomState(5)
    pred = (rng.rand(3, 50) > 0.4).astype(np.int64)
    gt = (rng.rand(3, 50) > 0.5).astype(np.int32)
    ours = {k: float(v) for k, v in cls.binary_confusion(torch.from_numpy(pred),
                                                         torch.from_numpy(gt)).items()}
    theirs = {k: float(v) for k, v in jcls.binary_confusion_jax(jnp.asarray(pred),
                                                                 jnp.asarray(gt)).items()}
    assert ours == theirs
    assert cls.metrics_from_confusion(ours) == jcls.metrics_from_confusion(theirs)
    assert (cls.compare_predictions_binary_arrays(gt[0], pred[0], "x")
            == jcls.compare_predictions_binary_arrays(gt[0], pred[0], "x"))
    empty = dict.fromkeys(("true_pos", "true_neg", "false_pos", "false_neg", "predictions"), 0)
    assert str(cls.metrics_from_confusion(empty)) == str(jcls.metrics_from_confusion(empty))
    assert cls.rmse(pred[0], gt[0]) == jcls.rmse(pred[0], gt[0])


def test_test_report_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    results = {"loss": rng.rand(4), "loss_components_mean": rng.rand(4),
               "abs_dist_rms": np.full(4, np.nan), "accuracy": rng.rand(4),
               "precision": np.array([0.5, np.nan, 1.0, 0.25]), "recall": rng.rand(4) * 1e-6,
               "f1_score": rng.rand(4) * 1e4}
    names = ["a", "b,c", "d", "e"]
    with pytest.warns(RuntimeWarning):  # the all-NaN RMSE column, in both
        ours = make_test_report(names, results, str(tmp_path / "t" / "metrics_m.xlsx"), ["sign"])
    with pytest.warns(RuntimeWarning):
        theirs = jax_make_test_report(names, results, str(tmp_path / "j" / "metrics_m.xlsx"),
                                      ["sign"])
    np.testing.assert_array_equal(ours, theirs)
    text = open(tmp_path / "t" / "metrics_m.csv").read()
    assert text == open(tmp_path / "j" / "metrics_m.csv").read()
    rows = list(csv.reader(text.splitlines()))
    header, index, cells = read_xlsx(str(tmp_path / "t" / "metrics_m.xlsx"))
    assert header == rows[0][1:] and index == [r[0] for r in rows[1:]]
    for row, got in zip(rows[1:], cells):
        assert [float(v) if v else None for v in row[1:]] == got


def test_cli_fit_test_predict_end_to_end(tmp_path, capsys):
    in_file = write_training_dataset(str(tmp_path / "ds"), n_train=3, n_val=1, n_test=2,
                                     n_pts=200, n_query=32)
    configs = [a for c in ("poco", "ppsurf", "ppsurf_50nn")
               for a in ("-c", os.path.join(REPO, "configs", f"{c}.yaml"))]
    root, results = str(tmp_path / "models"), str(tmp_path / "results")
    args = [*configs, "--device", "cpu", "--data.init_args.in_file", in_file,
            "--data.init_args.manifold_points", "64", "--data.init_args.batch_size", "2",
            "--data.init_args.patches_per_shape", "16", "--data.init_args.workers", "1",
            "--model.init_args.network_latent_size", "16",
            "--model.init_args.pointnet_latent_size", "16",
            "--model.init_args.num_pts_local", "8", "--model.init_args.k", "8",
            "--trainer.max_epochs", "1", "--trainer.default_root_dir", root,
            "--model.init_args.results_dir", results]
    assert cli.main(["fit", *args]) == 0
    ckpt = os.path.join(root, "version_0", "checkpoints", "last.pt")
    assert os.path.isfile(ckpt) and os.path.isfile(os.path.join(root, "version_0", "config.yaml"))
    assert "fit: 2 steps" in capsys.readouterr().out

    assert cli.main(["test", *args]) == 0
    assert os.path.isfile(os.path.join(root, "version_0", "config_test.yaml"))
    report = os.path.join(results, "ppsurf_50nn", "ds", "metrics_ppsurf_50nn")
    rows = list(csv.reader(open(report + ".csv")))
    assert [r[0] for r in rows] == ["Shape", "test_0", "test_1", "AVERAGE", "MEDIAN", "STDEV"]
    assert np.isfinite(float(rows[1][1])) and os.path.isfile(report + ".xlsx")

    # predict takes the newest last.pt under the trainer's root
    rc = cli.main(["predict", *args, "--model.init_args.gen_resolution_global", "9",
                   "--model.init_args.gen_subsample_manifold_iter", "1",
                   "--model.init_args.gen_refine_iter", "1"])
    out = capsys.readouterr().out
    assert f"weights {ckpt}" in out and rc in (0, 1)
    assert os.path.isfile(os.path.join(root, "version_0", "config_predict.yaml"))
