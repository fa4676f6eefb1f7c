"""The mini POCO run: fit -> test -> predict on one small dataset.

    python -m ppsurf_tpu_torch.campaigns.full_run_poco_mini [extra args]

Port of the root `full_run_poco_mini.py` (reference
`full_run_poco_mini.py`): the `poco_mini` configs and the same argv
sequence to the port's `cli.main`. Run from the repository root; the extra
args reach every CLI call.
"""
import sys

from ppsurf_tpu_torch.cli import main


def run(extra=()):
    base = ["-c", "configs/poco.yaml", "-c", "configs/poco_mini.yaml"]
    args = list(extra)
    for sub in ("fit", "test", "predict"):
        print(f"=== {sub} ===")
        main([sub] + base + args)


if __name__ == "__main__":
    run(sys.argv[1:])
