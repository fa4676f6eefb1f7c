"""Inside/outside tests for meshes by the generalized winding number.

Port of `ppsurf_tpu/metrics/winding.py:83-92` (the IoU and F1 metrics'
replacement for the reference's pysdf sign, `source/base/proximity.py:11-17`,
`metrics.py:157-219`). For a watertight mesh the winding number is about 1
inside and 0 outside; inside means greater than 0.5. The numbers come from
`ops.winding.winding`: kernel W1 on a CUDA device, the plain PyTorch
version on the CPU.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from ppsurf_tpu_torch.device import resolve_device
from ppsurf_tpu_torch.io.ply import Mesh
from ppsurf_tpu_torch.ops.winding import winding

Device = typing.Union[str, torch.device, None]


def winding_number(mesh: Mesh, queries: np.ndarray, device: Device = None) -> np.ndarray:
    """(Q,) f32 winding numbers of `queries` (Q, 3) against `mesh`, computed
    on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=dev)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    return winding(q, v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]).cpu().numpy()


def points_inside(mesh: Mesh, queries: np.ndarray, device: Device = None) -> np.ndarray:
    """Bool mask of the queries inside the (near-watertight) mesh; all False
    for an empty mesh. The reference's sign convention: inside is `sdf > 0`
    (`metrics.py:175-176`)."""
    dev = resolve_device(device)
    if mesh.is_empty:
        return np.zeros(queries.shape[0], bool)
    return winding_number(mesh, queries, dev) > 0.5
