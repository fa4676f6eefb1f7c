"""Score a method's reconstructions of a dataset against its ground truth.

Port of `ppsurf_tpu/eval/make_evaluation.py` (reference
`source/make_evaluation.py`): Chamfer, F1, IoU and normal-error tables for
each method's `<results_dir>/<model>/<dataset>/meshes/{shape}.xyz.ply`
against `<data_dir>/<dataset>/03_meshes/{shape}.ply`, skipped where the
tables are newer than every mesh (`utils.fs.call_necessary`).

    python -m ppsurf_tpu_torch.eval.make_evaluation \\
        --model_names ppsurf_50nn --dataset_names abc_minimal \\
        [--results_dir results] [--data_dir datasets] [--num_samples 100000] \\
        [--device cuda|cpu]

The inside/outside tests of IoU and F1 run on `--device`: kernel W1 on the
card (the default), the plain PyTorch version with `--device cpu`.
"""
from __future__ import annotations

import argparse
import os
import typing

import torch

from ppsurf_tpu_torch.data.datasets import read_shape_list
from ppsurf_tpu_torch.device import resolve_device
from ppsurf_tpu_torch.eval.reports import make_quantitative_comparison
from ppsurf_tpu_torch.utils.fs import call_necessary


def evaluate_method_on_dataset(
    model_name: str,
    dataset_name: str,
    results_dir: str = "results",
    data_dir: str = "datasets",
    num_samples: int = 100000,
    workers: int = 8,
    force: bool = False,
    device: typing.Union[str, torch.device, None] = None,
) -> typing.Optional[dict]:
    """The four tables of one method on one dataset (metric -> CSV path);
    None where the dataset is missing or the tables are up to date."""
    device = resolve_device(device)
    in_file = os.path.join(data_dir, dataset_name, "testset.txt")
    if not os.path.isfile(in_file):
        print(f"skip {dataset_name}: no {in_file}")
        return None
    shape_names = read_shape_list(in_file)
    gt_dir = os.path.join(data_dir, dataset_name, "03_meshes")
    gt_meshes = [os.path.join(gt_dir, f"{n}.ply") for n in shape_names]
    method_dir = os.path.join(results_dir, model_name, dataset_name)
    template = os.path.join(method_dir, "meshes/{}.xyz.ply")

    outputs = [
        os.path.join(method_dir, f) for f in
        ("chamfer_distance.csv", "f1.csv", "iou.csv", "normal_error.csv")
    ]
    rec_meshes = [template.format(n) for n in shape_names]
    if not force and not call_necessary(gt_meshes + rec_meshes, outputs):
        print(f"skip {model_name}/{dataset_name}: up to date")
        return None

    return make_quantitative_comparison(
        shape_names=shape_names,
        gt_mesh_files=gt_meshes,
        result_headers=[model_name],
        result_file_templates=[template],
        comp_output_dir=method_dir,
        num_samples=num_samples,
        num_processes=workers,
        device=device,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_names", type=str, nargs="+", required=True)
    parser.add_argument("--dataset_names", type=str, nargs="+", required=True)
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--data_dir", type=str, default="datasets")
    parser.add_argument("--num_samples", type=int, default=100000)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    for model in args.model_names:
        for dataset in args.dataset_names:
            print(f"evaluating {model} on {dataset}")
            evaluate_method_on_dataset(
                model, dataset, args.results_dir, args.data_dir,
                args.num_samples, args.workers, device=device,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
