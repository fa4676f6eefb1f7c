"""Shared pieces of the benchmark's own tests (run from the repository's
root: `python -m pytest benchmark/tests -q`)."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where none is present")


# limits of the tiny f32 cells, on the numbers the full cells compare:
# sound runs read about 1e-6 (latents, field), 0 (vertices, every sign
# alike) and a mesh corner's distance to the surface of at most 0.05 of
# an edge (refine 4 leaves a sixteenth of an edge)
TINY_LIMITS = {"latent_gap": 1e-3, "field_gap": 1e-3, "vertex_p90": 1e-3, "grid_sign": 1e-3,
               "corner_p90": 0.2}


def tiny_cell(config_name: str, precision: str = "f32", **mix):
    """A cell of the configuration at a size the CPU holds: a 2 500-point
    torus cloud, res 33, 2 encoder passes of one 1 500-point chunk
    each, refine 4, in `precision`."""
    from benchmark.harness import common

    cfg = common.load_json(os.path.join(common.BENCH_DIR, "configs", config_name + ".json"))
    cfg.update(gen_subsample_manifold_iter=2, gen_subsample_manifold=1500, gen_refine_iter=4,
               precision=precision)
    m = common.load_json(os.path.join(common.BENCH_DIR, "traffic", "rec_torus60k.json"))
    m.update(points=2500, resolution=33, sample_every=16, refine_rows=64, grid_rows=4096,
             face_rows=256, check_objects=2)
    m.update(mix)
    e2e = [{"name": "s_per_object", "unit": "s/object"}, {"name": "setup_s", "unit": "s"}]
    return common.Cell(f"tiny.{config_name}", cfg, m, e2e, [], dict(TINY_LIMITS))


# the tiny training cell: sound float32 runs read a first-step loss gap
# of 0 to 1e-5, a median leaf's gradient gap about 2e-5 and change gap
# about 2e-3
TINY_TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.01, "change_gap": 0.02}


def tiny_train_cell(precision: str = "f32"):
    """PPSurf training at a size the CPU holds: batch 2 of 6 solids of
    1 500-2 500 points, 1 000 manifold points, 100 queries a solid."""
    from benchmark.harness import common

    cfg = common.load_json(os.path.join(common.BENCH_DIR, "configs", "pps50nn.json"))
    cfg.update(precision=precision)
    m = common.load_json(os.path.join(common.BENCH_DIR, "traffic", "train_solids_b10.json"))
    m.update(shapes=6, points=[1500, 2500], queries=100, manifold_points=1000, batch_size=2,
             workers=2)
    e2e = [{"name": "train_step_s", "unit": "s/step"}, {"name": "setup_s", "unit": "s"}]
    return common.Cell("tiny.train", cfg, m, e2e, [], dict(TINY_TRAIN_LIMITS))


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
