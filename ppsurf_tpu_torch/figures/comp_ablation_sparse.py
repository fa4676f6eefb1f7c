"""The comp_ablation_sparse comparison.

Port of `ppsurf_tpu/figures/comp_ablation_sparse.py`
(reference `source/figures/comp_ablation_sparse.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_ablation_sparse
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'famous_sparse', 'thingi10k_scans_sparse',
]
METHODS = [
    'ppsurf_25nn', 'ppsurf_50nn', 'ppsurf_vanilla', 'ppsurf_merge_sum',
]

if __name__ == "__main__":
    run_comparison("comp_ablation_sparse", DATASETS, methods=METHODS)
