"""The mini PPSurf run: fit -> test -> predict on one small dataset.

    python -m ppsurf_tpu_torch.campaigns.full_run_pps_mini [extra args]

Port of the root `full_run_pps_mini.py` (reference `full_run_pps_mini.py`,
the reference's de-facto integration test): the `ppsurf_mini` configs
(res 129, `datasets/abc_minimal`) and the same argv sequence to the port's
`cli.main`, in this process. Run from the repository root; the extra args
reach every CLI call, e.g. `--data.init_args.in_file <testset.txt>`,
`--trainer.max_epochs 1`, `--device cpu`.
"""
import sys

from ppsurf_tpu_torch.cli import main


def run(extra=()):
    base = [
        "-c", "configs/poco.yaml",
        "-c", "configs/ppsurf.yaml",
        "-c", "configs/ppsurf_mini.yaml",
    ]
    args = list(extra)
    print("=== fit ===")
    main(["fit"] + base + args)
    print("=== test ===")
    main(["test"] + base + args)
    print("=== predict ===")
    main(["predict"] + base + args)


if __name__ == "__main__":
    run(sys.argv[1:])
