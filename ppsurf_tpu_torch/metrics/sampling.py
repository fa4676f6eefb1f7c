"""Mesh surface sampling for the mesh metrics.

Port of `ppsurf_tpu/metrics/sampling.py` (reference
`source/base/point_cloud.py:181-189`, trimesh's `sample_surface`): the same
numpy draws in the same order, so a seed gives the same samples bit for
bit as the JAX package.
"""
from __future__ import annotations

import typing

import numpy as np

from ppsurf_tpu_torch.io.ply import Mesh


def sample_surface(
    mesh: Mesh, num_samples: int, rng: typing.Optional[np.random.Generator] = None,
    return_face_index: bool = False,
):
    """Area-weighted uniform surface samples (seed 42 unless `rng` is given)."""
    if rng is None:
        rng = np.random.default_rng(42)
    areas = mesh.face_areas()
    total = areas.sum()
    if mesh.faces.shape[0] == 0 or total <= 0:
        empty = np.zeros((0, 3), np.float64)
        return (empty, np.zeros((0,), np.int64)) if return_face_index else empty

    probs = areas / total
    face_idx = rng.choice(mesh.faces.shape[0], size=num_samples, p=probs)
    # uniform barycentric coordinates
    r1 = np.sqrt(rng.random(num_samples))
    r2 = rng.random(num_samples)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces[face_idx]
    samples = a[:, None] * v[f[:, 0]] + b[:, None] * v[f[:, 1]] + c[:, None] * v[f[:, 2]]
    if return_face_index:
        return samples, face_idx
    return samples


def sample_mesh(mesh_file: str, num_samples: int) -> np.ndarray:
    """(num_samples, 3) samples of a mesh file; empty for an unreadable or
    empty mesh."""
    from ppsurf_tpu_torch.io import load_ply

    try:
        mesh = load_ply(mesh_file)
    except (OSError, ValueError):
        return np.zeros((0, 3), np.float64)
    if mesh.is_empty:
        return np.zeros((0, 3), np.float64)
    return sample_surface(mesh, num_samples)
