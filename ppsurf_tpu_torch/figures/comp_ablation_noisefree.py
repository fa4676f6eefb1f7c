"""The comp_ablation_noisefree comparison.

Port of `ppsurf_tpu/figures/comp_ablation_noisefree.py`
(reference `source/figures/comp_ablation_noisefree.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_ablation_noisefree
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc_noisefree', 'famous_noisefree', 'thingi10k_scans_noisefree',
]
METHODS = [
    'ppsurf_25nn', 'ppsurf_50nn', 'ppsurf_vanilla', 'ppsurf_merge_sum',
]

if __name__ == "__main__":
    run_comparison("comp_ablation_noisefree", DATASETS, methods=METHODS)
