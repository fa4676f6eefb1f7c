"""The port's campaign twins and host tuning on the CPU.

- each twin in `ppsurf_tpu_torch/campaigns/` calls the port's `cli.main`
  (and `make_comparison.main`) with the argv sequence the JAX package's
  root `full_run_*.py` passes to its own, both recorded with the entry
  points monkeypatched, over a tree where some test sets are missing;
- `full_run_pps_mini` runs for real with `--device cpu` on a two-shape
  dataset at a tiny size (1 epoch, narrow widths, res 33): `last.pt`, the
  test report and the predict outputs are written, and `freeze_gc` runs
  once a shape on the predict path;
- `utils/alloc.py` is idempotent and keeps its switches.
"""
from __future__ import annotations

import gc
import importlib
import os

import pytest

from tests.test_torch_data import write_training_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("full_run_pps", "full_run_pps_mini", "full_run_poco", "full_run_poco_mini")


def _recorded_calls(monkeypatch, module, comp_module, extra):
    calls = []
    monkeypatch.setattr(module, "main", lambda argv: calls.append(("cli", list(argv))) or 0)
    monkeypatch.setattr(comp_module, "main", lambda argv: calls.append(("comp", list(argv))) or 0)
    module.run(extra)
    return calls


@pytest.mark.parametrize("name", SCRIPTS)
def test_campaign_argv_sequences_equal(name, tmp_path, monkeypatch):
    import ppsurf_tpu.eval.make_comparison as jcomp
    import ppsurf_tpu_torch.eval.make_comparison as pcomp

    for d in ("abc", "famous_dense", "real_world"):
        os.makedirs(tmp_path / "datasets" / d)
        (tmp_path / "datasets" / d / "testset.txt").write_text("s\n")
    monkeypatch.chdir(tmp_path)
    extra = ["--device", "cpu", "--trainer.max_epochs", "1"]
    theirs = _recorded_calls(monkeypatch, importlib.import_module(name), jcomp, extra)
    ours = _recorded_calls(monkeypatch,
                           importlib.import_module(f"ppsurf_tpu_torch.campaigns.{name}"),
                           pcomp, extra)
    assert ours == theirs
    subs = [argv[0] for kind, argv in ours if kind == "cli"]
    assert subs[:2] == ["fit", "test"] and set(subs[2:]) == {"predict"}
    assert all(argv[-4:] == extra for kind, argv in ours if kind == "cli")
    if name == "full_run_pps":
        assert subs.count("predict") == 3
        assert ours[-1] == ("comp", ["--dataset_names", "abc", "famous_dense", "real_world"])


def test_campaign_datasets_equal():
    import full_run_pps

    from ppsurf_tpu_torch.campaigns import full_run_poco, full_run_pps as port

    assert port.DATASETS == full_run_pps.DATASETS and full_run_poco.DATASETS is port.DATASETS


def test_mini_campaign_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    from ppsurf_tpu_torch.campaigns import full_run_pps_mini
    from ppsurf_tpu_torch.recon import predict

    in_file = write_training_dataset(str(tmp_path / "ds"), n_train=3, n_val=1, n_test=2,
                                     n_pts=200, n_query=32)
    froze = []
    monkeypatch.setattr(predict, "freeze_gc", lambda: froze.append(1))
    monkeypatch.chdir(REPO)  # the configs' relative paths
    root, results = str(tmp_path / "models"), str(tmp_path / "results")
    full_run_pps_mini.run([
        "--device", "cpu", "--data.init_args.in_file", in_file,
        "--data.init_args.manifold_points", "64", "--data.init_args.batch_size", "2",
        "--data.init_args.patches_per_shape", "16", "--data.init_args.workers", "1",
        "--model.init_args.network_latent_size", "16",
        "--model.init_args.pointnet_latent_size", "16",
        "--model.init_args.num_pts_local", "8", "--model.init_args.k", "8",
        "--model.init_args.gen_resolution_global", "33",
        "--model.init_args.gen_subsample_manifold_iter", "1",
        "--model.init_args.gen_refine_iter", "1",
        "--trainer.max_epochs", "1", "--trainer.default_root_dir", root,
        "--model.init_args.results_dir", results])
    out = capsys.readouterr().out
    assert "=== fit ===" in out and "=== test ===" in out and "=== predict ===" in out
    assert os.path.isfile(os.path.join(root, "version_0", "checkpoints", "last.pt"))
    rdir = os.path.join(results, "ppsurf_mini", "ds")
    assert os.path.isfile(os.path.join(rdir, "metrics_ppsurf_mini.csv"))
    assert os.path.isfile(os.path.join(root, "version_0", "config_predict.yaml"))
    assert "of 2 shapes reconstructed" in out
    assert len(froze) == 2  # once a shape


def test_alloc_is_idempotent_and_keeps_its_switches(monkeypatch):
    from ppsurf_tpu_torch.utils import alloc

    monkeypatch.setattr(alloc, "_done", False)
    monkeypatch.setattr(alloc, "_gc_done", False)
    before = gc.get_threshold()
    try:
        alloc.tune_host_allocator()
        assert alloc._done
        alloc.tune_host_allocator()  # a second call does nothing
        monkeypatch.setenv("PPSURF_NO_GC_TUNE", "1")
        alloc.freeze_gc()
        assert gc.get_threshold() == before and not alloc._gc_done
        monkeypatch.delenv("PPSURF_NO_GC_TUNE")
        alloc.freeze_gc()
        assert gc.get_threshold() == before[:2] + (1000,) and gc.get_freeze_count() > 0
        gc.set_threshold(*before[:2], 7)
        alloc.freeze_gc()  # the threshold is raised once only
        assert gc.get_threshold()[2] == 7
    finally:
        gc.unfreeze()
        gc.set_threshold(*before)
