"""Training checkpoints of the port.

`fit` writes `<root>/version_{v}/checkpoints/last.pt` (the reference's
`models/{name}/version_{v}/checkpoints` layout, `configs/poco.yaml:22-25`):
a `torch.save` of a dict with the training step, the network's variables
as the JAX package's nested `{'params', 'batch_stats'}` tree (flax names,
CPU f32 tensors as leaves) and the optimizer's `state_dict`. The JAX
package's orbax checkpoints are not read here; its inference `.npz`
(`ppsurf_tpu.convert.infer_npz`) is, and `convert/torch_ckpt.py` writes
the reference's Lightning checkpoints in this format.
"""
from __future__ import annotations

import os
import typing

import numpy as np
import torch

from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, to_jax_variables

CHECKPOINT_NAME = "last.pt"


def _map_tree(tree: dict, fn) -> dict:
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def save_checkpoint(path: str, net: torch.nn.Module,
                    optimizer: typing.Optional[torch.optim.Optimizer], step: int) -> str:
    """Write `net`'s variables, the optimizer state and the step to `path`
    (written to a temporary file first, then renamed)."""
    return save_variables(path, to_jax_variables(net), step,
                          None if optimizer is None else optimizer.state_dict())


def save_variables(path: str, variables: dict, step: int,
                   optimizer_state: typing.Optional[dict] = None) -> str:
    """Write nested {'params', 'batch_stats'} numpy variables, an optimizer
    `state_dict` (or None) and the step to `path` in `save_checkpoint`'s
    format."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "step": int(step),
        "variables": _map_tree(variables, lambda a: torch.from_numpy(
            np.array(a, dtype=np.float32, copy=True))),
        "optimizer": optimizer_state,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    """`save_checkpoint`'s dict, its variables as numpy trees."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    payload["variables"] = _map_tree(payload["variables"], lambda t: t.numpy())
    return payload


def load_checkpoint_variables(path: str) -> dict:
    """Nested {'params', 'batch_stats'} numpy variables from a port
    checkpoint (`.pt`) or an inference `.npz`."""
    if path.endswith(".npz"):
        return load_infer_npz(path)
    if path.endswith(".pt"):
        return load_checkpoint(path)["variables"]
    raise ValueError(f"{path}: the port reads its own `.pt` checkpoints and inference "
                     "`.npz` files; orbax checkpoints are read by the JAX package "
                     "(ppsurf_tpu.convert.infer_npz writes the `.npz`)")


def find_last_checkpoint(root_dir: str) -> typing.Optional[str]:
    """The newest `version_{v}/checkpoints/last.pt` under a model root."""
    if not os.path.isdir(root_dir):
        return None
    versions = sorted((d for d in os.listdir(root_dir)
                       if d.startswith("version_") and d[8:].isdigit()),
                      key=lambda d: int(d[8:]), reverse=True)
    for v in versions:
        cand = os.path.join(root_dir, v, "checkpoints", CHECKPOINT_NAME)
        if os.path.isfile(cand):
            return cand
    return None

