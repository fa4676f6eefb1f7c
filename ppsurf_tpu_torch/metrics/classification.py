"""Binary classification metrics (occupancy-sign prediction quality).

Port of `ppsurf_tpu/metrics/classification.py` (reference
`source/base/metrics.py:10-117`): `binary_confusion` counts on the
predictions' device, for the train step to sum over steps; the host-side
`metrics_from_confusion`, `compare_predictions_binary_arrays` and `rmse`
are numpy copies of the JAX package's.
"""
from __future__ import annotations

import typing

import numpy as np
import torch


def binary_confusion(predicted: torch.Tensor, ground_truth: torch.Tensor) -> dict:
    """Confusion counts (f32 scalars on the device) of {0,1} predictions
    (`ppsurf_tpu/metrics/classification.py:17-27`)."""
    pred = (predicted > 0).float()
    gt = (ground_truth > 0).float()
    return {
        # a fill, not a host-to-device copy: the train step never waits
        "predictions": torch.full((), float(pred.numel()), device=pred.device),
        "true_pos": (pred * gt).sum(),
        "true_neg": ((1 - pred) * (1 - gt)).sum(),
        "false_pos": (pred * (1 - gt)).sum(),
        "false_neg": ((1 - pred) * gt).sum(),
    }


def metrics_from_confusion(conf: typing.Dict[str, float]) -> typing.Dict[str, float]:
    """accuracy / precision / recall / f1 with NaN on empty denominators
    (reference `metrics.py:10-38`)."""
    tp = float(conf["true_pos"])
    tn = float(conf["true_neg"])
    fp = float(conf["false_pos"])
    fn = float(conf["false_neg"])
    total = float(conf["predictions"])
    acc = (tp + tn) / total if total else float("nan")
    prec = tp / (tp + fp) if (tp + fp) else float("nan")
    rec = tp / (tp + fn) if (tp + fn) else float("nan")
    f1 = (
        2.0 * prec * rec / (prec + rec)
        if (prec + rec) and not (np.isnan(prec) or np.isnan(rec))
        else float("nan")
    )
    return {
        "accuracy": acc,
        "precision": prec,
        "recall": rec,
        "f1_score": f1,
        "true_pos": tp,
        "true_neg": tn,
        "false_pos": fp,
        "false_neg": fn,
        "predictions": total,
    }


def compare_predictions_binary_arrays(
    ground_truth: np.ndarray, predicted: np.ndarray, prediction_name: typing.Optional[str] = None
) -> dict:
    """Host-side full confusion dict (reference `metrics.py:87-117`)."""
    if ground_truth.shape != predicted.shape:
        raise ValueError("ground truth and prediction have different sizes")
    gt = (ground_truth > 0.0).astype(np.int32)
    pred = (predicted > 0.0).astype(np.int32)
    res = {}
    if prediction_name is not None:
        res["comp_name"] = prediction_name
    conf = {
        "predictions": float(gt.size),
        "true_pos": float(np.sum((pred == 1) & (gt == 1))),
        "true_neg": float(np.sum((pred == 0) & (gt == 0))),
        "false_pos": float(np.sum((pred == 1) & (gt == 0))),
        "false_neg": float(np.sum((pred == 0) & (gt == 1))),
    }
    res.update(metrics_from_confusion(conf))
    res["positives"] = float(np.sum(pred == 1))
    res["negatives"] = float(np.sum(pred == 0))
    res["pos_gt"] = float(np.sum(gt == 1))
    res["neg_gt"] = float(np.sum(gt == 0))
    res["true"] = res["true_pos"] + res["true_neg"]
    res["false"] = res["false_pos"] + res["false_neg"]
    return res


def rmse(predictions: np.ndarray, targets: np.ndarray) -> float:
    """Reference `metrics.py:272-273`."""
    return float(np.sqrt(((predictions - targets) ** 2).mean()))
