"""The port's benchmark twin (`bench_torch.py`, `ppsurf_tpu_torch/tools/bench.py`)
on the CPU: f32, the committed weights, a 2 000-point `torus_cloud`, res
33, 1 encoder pass, refine 2.

- one pass of the twin gives `Predictor.reconstruct_shape`'s mesh;
- `python bench_torch.py --device cpu ...` ends in a line of exactly
  `bench.py`'s four keys, its value the median of the printed passes and
  `vs_baseline` 60 s over it; it writes no file (`BENCH_LAST_GOOD.json`
  keeps its bytes);
- without `--device` and without CUDA it exits 1 with the error line and
  no value;
- `--weights random` gives a mesh near the blend's sphere;
- `ops/opcount.field_macs` equals a count taken by walking the built
  network's weights (PPSurf at P=50 and P=100, POCO).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppsurf_tpu_torch.data.synthetic import torus_cloud
from ppsurf_tpu_torch.io.ply import save_ply
from ppsurf_tpu_torch.models.norm import Dense
from ppsurf_tpu_torch.ops.opcount import field_macs
from ppsurf_tpu_torch.recon.predict import Predictor
from ppsurf_tpu_torch.tools import bench
from ppsurf_tpu_torch.train.model import poco_spec, ppsurf_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, PASSES, REFINE = 33, 1, 2
SMALL = ["--device", "cpu", "--precision", "32", "--resolution", str(RES),
         "--passes", str(PASSES), "--refine", str(REFINE)]
KEYS = ["metric", "value", "unit", "vs_baseline"]


@pytest.fixture(scope="module")
def cloud():
    return torus_cloud(2000, seed=0)


def test_a_pass_gives_the_predictors_mesh(cloud):
    predictor, weights = bench.make_predictor(bench.parse_args(SMALL), torch.device("cpu"))
    mesh, rec = bench.reconstruct(predictor, cloud, RES)
    spec = ppsurf_spec(gen_subsample_manifold_iter=PASSES, gen_refine_iter=REFINE)
    ref = Predictor(spec, device="cpu", verbose=False).reconstruct_shape(
        cloud, seed=bench.SEED, resolution=RES)
    assert weights == "committed" and predictor.spec.dtype == torch.float32
    assert mesh.faces.shape[0] > 1000
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    np.testing.assert_array_equal(mesh.vertices, ref.vertices)
    assert set(rec["timings"]) == {"encode", "grow", "mesh", "refine", "clean"}
    assert rec["prefill_bands"] == 0 and rec["queries"] > 0


@pytest.fixture(scope="module")
def script_run(cloud, tmp_path_factory):
    """`python bench_torch.py` as a subprocess, from an empty directory."""
    tmp = tmp_path_factory.mktemp("bench")
    ply = str(tmp / "cloud.ply")
    save_ply(ply, cloud)
    last_good = os.path.join(REPO, "BENCH_LAST_GOOD.json")
    before = open(last_good, "rb").read()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), *SMALL,
                           "--cloud", ply, "--reps", "2"],
                          cwd=tmp, capture_output=True, text=True, timeout=600)
    after = open(last_good, "rb").read()
    return proc, sorted(os.listdir(tmp)), before == after


def test_script_ends_in_the_four_keys(script_run):
    proc, _, _ = script_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result) == KEYS
    assert result["metric"] == f"ppsurf50nn_e2e_reconstruction_res{RES}"
    assert result["unit"] == "s/object" and result["value"] > 0


def test_value_is_the_median_of_the_passes(script_run):
    proc, _, _ = script_run
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    details = [line for line in proc.stderr.splitlines() if line.startswith("# detail: ")]
    detail = json.loads(details[-1][len("# detail: "):])
    passes = detail["passes_s"]
    assert len(passes) == 2
    assert len([line for line in proc.stderr.splitlines() if line.startswith("# pass ")]) == 2
    assert result["value"] == round(statistics.median(passes), 3)
    assert result["vs_baseline"] == round(60 / result["value"], 3)
    assert detail["card"] == "cpu" and detail["dtype"] == "float32"
    assert detail["points"] == 2000 and detail["faces"] > 1000
    assert detail["launches"] == {}  # the plain versions on the CPU


def test_script_writes_no_file(script_run):
    _, files, last_good_kept = script_run
    assert files == ["cloud.ply"]
    assert last_good_kept


def test_without_cuda_it_prints_the_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--resolution", str(RES)]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    result = json.loads(out[-1])
    assert result["value"] is None and result["vs_baseline"] is None
    assert "CUDA" in result["error"]
    assert result["metric"] == f"ppsurf50nn_e2e_reconstruction_res{RES}"


def test_random_weights_give_the_blends_sphere(cloud):
    args = bench.parse_args(SMALL + ["--weights", "random"])
    predictor, weights = bench.make_predictor(args, torch.device("cpu"))
    mesh, _ = bench.reconstruct(predictor, cloud, RES, transform=bench.sphere_blend(cloud))
    radius = float(np.abs(cloud).max())
    off = np.abs(np.linalg.norm(mesh.vertices, axis=1) - radius)
    # the surface lies where |q| - radius = -0.01 x field, the field in
    # [-1, 1], plus the mesh's voxel error
    assert weights == "random" and mesh.faces.shape[0] > 1000
    assert np.percentile(off, 99) <= 0.01 + 2.0 / RES


def _walked_macs(spec) -> int:
    """Multiply-adds a field query by the network's weights: the decoder's
    layers on each of the k neighbours (fc1 on the 3 relative-position
    inputs, its latent rows folded into the latents once a shape), fc8
    once; PointNet's per-point layers on each of the P patch points, the
    STN head (stn2.fc*) once; the MLP once; the encoder not at all."""
    k, p = spec.k, spec.num_pts_local
    total = 0
    for name, mod in spec.make_network().named_modules():
        if not isinstance(mod, Dense) or name.startswith("encoder."):
            continue
        n_in, n_out = mod.kernel.shape
        if name == "projection.fc1":
            n_in = 3
        if name.startswith("projection.") and name != "projection.fc8":
            rows = k
        elif name.startswith("point_net.") and not name.startswith("point_net.stn2.fc"):
            rows = p
        else:
            rows = 1
        total += rows * n_in * n_out
    return total


@pytest.mark.parametrize("spec", [ppsurf_spec(), ppsurf_spec(num_pts_local=100), poco_spec()],
                         ids=["ppsurf_p50", "ppsurf_p100", "poco"])
def test_field_count_walks_the_weights(spec):
    assert field_macs(spec) == _walked_macs(spec)
