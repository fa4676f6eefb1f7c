"""`test` subcommand's classification eval and `predict`'s mesh scoring.

Port of `run_test` (`ppsurf_tpu/train/evaluate.py:26-94`, reference
`PocoModel.test_step` / `on_test_epoch_end`, `source/poco_model.py:134-181`):
batch size 1 over the test set, each shape's loss and confusion metrics,
written by `eval.reports.make_test_report` to `metrics_{name}.csv` and
`.xlsx`. The shapes' graph draws come from a generator seeded with `seed`.
`evaluate_reconstructions` (`ppsurf_tpu/train/evaluate.py:88-117`, reference
`on_predict_epoch_end`, `source/poco_model.py:275-300`) scores the meshes
`predict` wrote against the dataset's ground truth.
"""
from __future__ import annotations

import os
import typing

import numpy as np
import torch

from ppsurf_tpu_torch.data.datasets import (
    ShapeDataset, get_meshes_dir, get_results_dir, in_file_is_dataset, read_shape_list,
)
from ppsurf_tpu_torch.device import resolve_device
from ppsurf_tpu_torch.eval.reports import make_quantitative_comparison, make_test_report
from ppsurf_tpu_torch.metrics.classification import compare_predictions_binary_arrays
from ppsurf_tpu_torch.train.loop import eval_step, to_device
from ppsurf_tpu_torch.train.model import ModelSpec


def run_test(
    spec: ModelSpec,
    net: torch.nn.Module,
    dataset: ShapeDataset,
    results_dir: typing.Optional[str] = None,
    seed: int = 42,
) -> typing.Tuple[float, float, float]:
    """Evaluate the classifier (on its parameters' device) at the ground-truth
    query points of every test shape -> (loss mean, RMSE mean, F1 mean)."""
    device = next(net.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    per_shape: typing.Dict[str, list] = {
        "loss": [], "loss_components_mean": [], "abs_dist_rms": [],
        "accuracy": [], "precision": [], "recall": [], "f1_score": [],
    }
    for idx in range(len(dataset)):
        item = dataset[idx]
        batch = to_device({k: v[None] for k, v in item.items()}, device)
        draws = spec.draw_step(1, batch["pts_ms"].shape[1], generator, device)
        loss_t, _, logits = eval_step(net, spec, batch, draws)
        loss = float(loss_t)
        pred = logits.argmax(-1)[0].cpu().numpy()
        m = compare_predictions_binary_arrays(item["occ"], pred, dataset.shape_names[idx])

        per_shape["loss"].append(loss)
        per_shape["loss_components_mean"].append(loss)
        per_shape["abs_dist_rms"].append(np.nan)  # reference logs NaN here
        for k in ("accuracy", "precision", "recall", "f1_score"):
            per_shape[k].append(m[k])
        print(f"test [{idx + 1}/{len(dataset)}] {dataset.shape_names[idx]}: "
              f"loss={loss:.4f} f1={m['f1_score']:.4f}", flush=True)

    rdir = results_dir or get_results_dir(spec.results_dir, spec.name, dataset.in_file)
    os.makedirs(rdir, exist_ok=True)
    loss_mean, rmse_mean, f1_mean = make_test_report(
        shape_names=dataset.shape_names,
        results={k: np.asarray(v) for k, v in per_shape.items()},
        output_file=os.path.join(rdir, f"metrics_{spec.name}.xlsx"),
        output_names=list(spec.output_names),
    )
    print(f"Test results (mean): Loss={loss_mean}, RMSE={rmse_mean}, F1={f1_mean}")
    return loss_mean, rmse_mean, f1_mean


def evaluate_reconstructions(
    spec: ModelSpec,
    in_file: str,
    results_dir: typing.Optional[str] = None,
    num_samples: int = 100000,
    device: typing.Union[str, torch.device, None] = None,
) -> typing.Optional[typing.Dict[str, str]]:
    """Chamfer, F1, IoU and normal-error tables of the meshes `predict` wrote
    for a dataset (`<results>/meshes/{shape}.xyz.ply`) against its
    `03_meshes/{shape}.ply`; metric -> CSV path. None for a single cloud or
    a dataset without ground truth. IoU and F1 test inside/outside on
    `device` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if not in_file_is_dataset(in_file):
        return None
    rdir = results_dir or get_results_dir(spec.results_dir, spec.name, in_file)
    shape_names = read_shape_list(in_file)
    gt_dir = get_meshes_dir(in_file)
    if not os.path.exists(gt_dir):
        print(f"Warning: {gt_dir} not found. Skipping evaluation.")
        return None
    gt_meshes = [os.path.join(gt_dir, f"{n}.ply") for n in shape_names]
    os.makedirs(rdir, exist_ok=True)
    return make_quantitative_comparison(
        shape_names=shape_names,
        gt_mesh_files=gt_meshes,
        result_headers=[spec.name],
        result_file_templates=[os.path.join(rdir, "meshes/{}.xyz.ply")],
        comp_output_dir=rdir,
        num_samples=num_samples,
        device=device,
    )
