"""The POCO baseline campaign: fit, test, predict every test set present.

    python -m ppsurf_tpu_torch.campaigns.full_run_poco [extra args]

Port of the root `full_run_poco.py` (reference `full_run_poco.py`): the
same configs and argv sequence to the port's `cli.main`, and the test
sets of `full_run_pps`. Run from the repository root; the extra args
reach every CLI call.
"""
import os
import sys

from ppsurf_tpu_torch.campaigns.full_run_pps import DATASETS
from ppsurf_tpu_torch.cli import main


def run(extra=()):
    base = ["-c", "configs/poco.yaml"]
    args = list(extra)
    print("=== fit ===")
    main(["fit"] + base + args)
    print("=== test ===")
    main(["test"] + base + ["--data.init_args.in_file", "datasets/abc/testset.txt"] + args)
    for dataset in DATASETS:
        in_file = f"datasets/{dataset}/testset.txt"
        if not os.path.isfile(in_file):
            continue
        print(f"=== predict {dataset} ===")
        main(["predict"] + base + ["--data.init_args.in_file", in_file] + args)


if __name__ == "__main__":
    run(sys.argv[1:])
