"""The comp_ablation_noisy comparison.

Port of `ppsurf_tpu/figures/comp_ablation_noisy.py`
(reference `source/figures/comp_ablation_noisy.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_ablation_noisy
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc_extra_noisy', 'famous_extra_noisy', 'thingi10k_scans_extra_noisy',
]
METHODS = [
    'ppsurf_25nn', 'ppsurf_50nn', 'ppsurf_vanilla', 'ppsurf_merge_sum',
]

if __name__ == "__main__":
    run_comparison("comp_ablation_noisy", DATASETS, methods=METHODS)
