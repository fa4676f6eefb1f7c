"""Reconstruction-quality metrics of meshes: Chamfer, Hausdorff, IoU, F1 and
normal error.

Port of `ppsurf_tpu/metrics/mesh_metrics.py:31-168` (reference
`source/base/metrics.py:120-324`) with the same samples, seeds (42),
counts and formulas. Nearest neighbours go through the host kd-tree
(`metrics.proximity.nn_query`), surface samples through
`metrics.sampling`, and the inside/outside tests of IoU and F1 through the
winding number (`metrics.winding.points_inside`) on `device`: kernel W1 on
a CUDA card (the default), the plain PyTorch version on the CPU. IoU and
F1 each test both meshes, so scoring one shape launches W1 four times.
"""
from __future__ import annotations

import os
import typing

import numpy as np

from ppsurf_tpu_torch.io.ply import load_ply
from ppsurf_tpu_torch.metrics.classification import compare_predictions_binary_arrays
from ppsurf_tpu_torch.metrics.proximity import nn_query
from ppsurf_tpu_torch.metrics.sampling import sample_mesh, sample_surface
from ppsurf_tpu_torch.metrics.winding import Device, points_inside


def _nn_dists(pts: np.ndarray, queries: np.ndarray) -> np.ndarray:
    return nn_query(pts, queries, k=1)[0][:, 0]


def chamfer_distance(
    file_in: str, file_ref: str, samples_per_model: int = 100000, num_processes: int = 1
):
    """Symmetric Chamfer distance over surface samples: both directions'
    distances summed over the total sample count."""
    new_samples = sample_mesh(file_in, samples_per_model)
    ref_samples = sample_mesh(file_ref, samples_per_model)
    if new_samples.shape[0] == 0 or ref_samples.shape[0] == 0:
        return file_in, file_ref, -1.0

    ref_new = _nn_dists(new_samples, ref_samples)
    new_ref = _nn_dists(ref_samples, new_samples)
    chamfer = (ref_new.sum() + new_ref.sum()) / (
        new_samples.shape[0] + ref_samples.shape[0]
    )
    return file_in, file_ref, float(chamfer)


def hausdorff_distance(file_in: str, file_ref: str, samples_per_model: int = 10000):
    """(file_in, file_ref, new->ref, ref->new, symmetric) Hausdorff distances."""
    new_samples = sample_mesh(file_in, samples_per_model)
    ref_samples = sample_mesh(file_ref, samples_per_model)
    if new_samples.shape[0] == 0 or ref_samples.shape[0] == 0:
        return file_in, file_ref, -1.0, -1.0, -1.0
    d_new_ref = float(_nn_dists(ref_samples, new_samples).max())
    d_ref_new = float(_nn_dists(new_samples, ref_samples).max())
    return file_in, file_ref, d_new_ref, d_ref_new, max(d_new_ref, d_ref_new)


def _load_pair(file_in, file_ref):
    try:
        return load_ply(file_in), load_ply(file_ref)
    except (OSError, ValueError):
        return None, None


def _occupancy_samples(num_samples: int, num_dims: int = 3) -> np.ndarray:
    """Uniform points in the unit cube, seed 42 (reference `metrics.py:163-164`)."""
    rng = np.random.default_rng(seed=42)
    return rng.random(size=(num_samples, num_dims)) - 0.5


def intersection_over_union(file_in: str, file_ref: str, num_samples: int = 100000,
                            device: Device = None):
    """Volumetric IoU over uniform cube samples."""
    mesh_in, mesh_ref = _load_pair(file_in, file_ref)
    if mesh_in is None:
        return file_in, file_ref, np.nan
    samples = _occupancy_samples(num_samples)
    occ_in = points_inside(mesh_in, samples, device)
    occ_ref = points_inside(mesh_ref, samples, device)
    union = np.logical_or(occ_in, occ_ref).sum()
    if union == 0:
        return file_in, file_ref, 0.0
    iou = np.logical_and(occ_in, occ_ref).sum() / union
    return file_in, file_ref, float(iou)


def f1_approx(file_in: str, file_ref: str, num_samples: int = 100000,
              device: Device = None):
    """Occupancy F1 over uniform cube samples."""
    mesh_in, mesh_ref = _load_pair(file_in, file_ref)
    if mesh_in is None:
        return file_in, file_ref, np.nan
    samples = _occupancy_samples(num_samples)
    occ_in = points_inside(mesh_in, samples, device)
    occ_ref = points_inside(mesh_ref, samples, device)
    stats = compare_predictions_binary_arrays(occ_ref, occ_in, "f1_approx")
    f1 = 0.0 if np.isnan(stats["f1_score"]) else stats["f1_score"]
    return file_in, file_ref, float(f1)


def normal_error_approx(
    file_in: str, file_ref: str, num_samples: int = 100000, num_processes: int = 1
):
    """Mean angle between the normals of each reconstruction sample and of
    its nearest ground-truth sample."""
    mesh_in, mesh_ref = _load_pair(file_in, file_ref)
    if mesh_in is None or mesh_in.is_empty or mesh_ref.is_empty:
        return file_in, file_ref, np.nan

    rng = np.random.default_rng(42)
    samples_rec, fi_rec = sample_surface(mesh_in, num_samples, rng, return_face_index=True)
    normals_rec = mesh_in.face_normals()[fi_rec]
    samples_gt, fi_gt = sample_surface(mesh_ref, num_samples, rng, return_face_index=True)
    normals_gt = mesh_ref.face_normals()[fi_gt]

    ids = nn_query(samples_gt, samples_rec, k=1)[1][:, 0]
    cosine = np.clip(np.einsum("ij,ij->i", normals_rec, normals_gt[ids]), -1, 1)
    return file_in, file_ref, float(np.nanmean(np.arccos(cosine)))


MetricName = typing.Literal["chamfer", "iou", "normals", "f1"]


def get_metric_mesh_single_file(
    gt_mesh_file: str, mesh_file: str, num_samples: int, metric: MetricName = "chamfer",
    device: Device = None,
) -> float:
    """One metric of one mesh against its ground truth; NaN where the mesh
    is missing, FileExistsError where the ground truth is."""
    if os.path.isfile(mesh_file) and os.path.isfile(gt_mesh_file):
        fn = {
            "chamfer": lambda: chamfer_distance(mesh_file, gt_mesh_file, num_samples),
            "iou": lambda: intersection_over_union(mesh_file, gt_mesh_file, num_samples,
                                                   device),
            "normals": lambda: normal_error_approx(mesh_file, gt_mesh_file, num_samples),
            "f1": lambda: f1_approx(mesh_file, gt_mesh_file, num_samples, device),
        }[metric]
        return fn()[2]
    if not os.path.isfile(gt_mesh_file):
        raise FileExistsError(f"GT mesh missing: {gt_mesh_file}")
    print(f"WARNING: mesh missing: {mesh_file}")
    return float(np.nan)


def get_metric_meshes(
    result_file_template: typing.Sequence[str],
    shape_list: typing.Sequence[str],
    gt_mesh_files: typing.Sequence[str],
    num_samples: int = 10000,
    metric: MetricName = "chamfer",
    num_processes: int = 1,
    device: Device = None,
) -> typing.List[np.ndarray]:
    """One metric for every method (a result file template each) and shape,
    in this process: the inside/outside tests already batch on the card."""
    results = []
    for template in result_file_template:
        vals = [
            get_metric_mesh_single_file(
                gt_mesh_files[i], template.format(shape_name), num_samples, metric, device
            )
            for i, shape_name in enumerate(shape_list)
        ]
        results.append(np.asarray(vals))
    return results
