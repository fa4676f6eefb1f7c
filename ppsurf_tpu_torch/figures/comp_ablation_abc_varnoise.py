"""The comp_ablation_abc_varnoise comparison.

Port of `ppsurf_tpu/figures/comp_ablation_abc_varnoise.py`
(reference `source/figures/comp_ablation_abc_varnoise.py`): its datasets and
methods, through the port's `figures/comp_base.run_comparison`.

    python -m ppsurf_tpu_torch.figures.comp_ablation_abc_varnoise
"""
from ppsurf_tpu_torch.figures.comp_base import run_comparison

DATASETS = [
    'abc',
]
METHODS = [
    'ppsurf_vanilla', 'ppsurf_vanilla_zeros_global', 'ppsurf_vanilla_zeros_local',
    'ppsurf_vanilla_qpoints', 'ppsurf_sym_max', 'ppsurf_10nn', 'ppsurf_25nn', 'ppsurf_50nn',
    'ppsurf_merge_sum', 'ppsurf_200nn',
]

if __name__ == "__main__":
    run_comparison("comp_ablation_abc_varnoise", DATASETS, methods=METHODS)
