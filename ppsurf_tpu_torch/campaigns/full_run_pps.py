"""The PPSurf 50NN campaign: fit on the ABC training set, test, predict
every test set present, then compare the methods on them.

    python -m ppsurf_tpu_torch.campaigns.full_run_pps [extra args]

Port of the root `full_run_pps.py` (reference `full_run_pps.py`): the same
stacked configs and the same argv sequence to the port's `cli.main`, a
test set whose `datasets/<name>/testset.txt` is missing skipped, then the
port's `eval/make_comparison` over the test sets present. Run from the
repository root (the config and dataset paths are relative). The extra
args reach every CLI call, e.g. `--device cpu` or
`--data.init_args.in_file <training set>`.
"""
import os
import sys

from ppsurf_tpu_torch.cli import main

DATASETS = [
    "abc", "abc_extra_noisy", "abc_noisefree",
    "famous_original", "famous_noisefree", "famous_sparse", "famous_dense",
    "famous_extra_noisy", "thingi10k_scans_original", "thingi10k_scans_dense",
    "thingi10k_scans_sparse", "thingi10k_scans_extra_noisy",
    "thingi10k_scans_noisefree", "real_world",
]


def run(extra=()):
    base = [
        "-c", "configs/poco.yaml",
        "-c", "configs/ppsurf.yaml",
        "-c", "configs/ppsurf_50nn.yaml",
    ]
    args = list(extra)
    print("=== fit ===")
    main(["fit"] + base + args)
    print("=== test ===")
    main(["test"] + base + ["--data.init_args.in_file", "datasets/abc/testset.txt"] + args)
    for dataset in DATASETS:
        in_file = f"datasets/{dataset}/testset.txt"
        if not os.path.isfile(in_file):
            print(f"skip {dataset}: {in_file} missing")
            continue
        print(f"=== predict {dataset} ===")
        main(["predict"] + base + ["--data.init_args.in_file", in_file] + args)

    from ppsurf_tpu_torch.eval.make_comparison import main as comp_main

    present = [d for d in DATASETS if os.path.isfile(f"datasets/{d}/testset.txt")]
    if present:
        comp_main(["--dataset_names"] + present)


if __name__ == "__main__":
    run(sys.argv[1:])
