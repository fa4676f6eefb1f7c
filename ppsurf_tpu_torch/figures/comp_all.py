"""The comp_all comparison.

Port of `ppsurf_tpu/figures/comp_all.py`
(reference `source/figures/comp_all.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_all
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc', 'abc_extra_noisy', 'abc_noisefree', 'famous_original', 'famous_noisefree',
    'famous_sparse', 'famous_dense', 'famous_extra_noisy', 'thingi10k_scans_original',
    'thingi10k_scans_dense', 'thingi10k_scans_sparse', 'thingi10k_scans_extra_noisy',
    'thingi10k_scans_noisefree',
]
METHODS = None

if __name__ == "__main__":
    run_comparison("comp_all", DATASETS, methods=METHODS)
