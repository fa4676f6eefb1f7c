"""The comp_noisefree comparison.

Port of `ppsurf_tpu/figures/comp_noisefree.py`
(reference `source/figures/comp_noisefree.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_noisefree
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc_noisefree', 'famous_noisefree', 'thingi10k_scans_noisefree',
]
METHODS = None

if __name__ == "__main__":
    run_comparison("comp_noisefree", DATASETS, methods=METHODS)
