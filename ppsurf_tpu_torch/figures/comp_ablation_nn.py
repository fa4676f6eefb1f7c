"""The comp_ablation_nn comparison.

Port of `ppsurf_tpu/figures/comp_ablation_nn.py`
(reference `source/figures/comp_ablation_nn.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_ablation_nn
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc',
]
METHODS = [
    'ppsurf_10nn', 'ppsurf_25nn', 'ppsurf_50nn', 'ppsurf_100nn', 'ppsurf_200nn',
]

if __name__ == "__main__":
    run_comparison("comp_ablation_nn", DATASETS, methods=METHODS)
