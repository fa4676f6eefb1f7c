"""The comp_dense comparison.

Port of `ppsurf_tpu/figures/comp_dense.py`
(reference `source/figures/comp_dense.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_dense
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'famous_dense', 'thingi10k_scans_dense',
]
METHODS = None

if __name__ == "__main__":
    run_comparison("comp_dense", DATASETS, methods=METHODS)
