"""The comp_original comparison.

Port of `ppsurf_tpu/figures/comp_original.py`
(reference `source/figures/comp_original.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_original
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc', 'famous_original', 'thingi10k_scans_original',
]
METHODS = None

if __name__ == "__main__":
    run_comparison("comp_original", DATASETS, methods=METHODS)
