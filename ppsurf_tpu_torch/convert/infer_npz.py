"""Weights for the port: the JAX package's inference npz and variables.

`load_infer_npz` reads the compact interchange format the JAX package
ships (`models_pretrained/*.npz`, keys 'params/...' and 'batch_stats/...',
large kernels stored as f16). `from_jax_variables` flattens such a nested
variables tree, of a PPSurf or a POCO network (or one made by
`convert/init.py`), into the port's state dict: the port's modules carry the
flax names, so 'params/encoder/cv0/fc1/kernel' becomes
'encoder.cv0.fc1.kernel' and 'batch_stats/point_net/bn1/mean' becomes
'point_net.bn1.mean'. Flax `Dense` kernels stay (in, out) and the port
computes `x @ W`. `to_jax_variables` is the inverse: a network's state as
that nested tree, parameters under 'params', buffers under 'batch_stats'.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def load_infer_npz(path: str) -> dict:
    """npz with 'params/...'/'batch_stats/...' keys -> nested variables
    (numpy leaves, f16 kernels upcast to f32)."""
    out: dict = {c: {} for c in COLLECTIONS}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = z[key]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            node[parts[-1]] = arr
    return out


def _flatten(tree: dict, prefix: str, out: typing.Dict[str, np.ndarray]) -> None:
    for name, node in tree.items():
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(node, dict):
            _flatten(node, path, out)
        else:
            out[path] = np.asarray(node)


def from_jax_variables(variables: dict, net: typing.Optional[torch.nn.Module] = None
                       ) -> typing.Dict[str, torch.Tensor]:
    """Nested JAX variables -> the port's f32 state dict.

    With `net`, the state is checked against `net.state_dict()`: a key
    left over, a key missing or a shape that differs raises ValueError,
    so every weight of the file is consumed exactly once.
    """
    extra = set(variables) - set(COLLECTIONS)
    if extra:
        raise ValueError(f"unknown variable collections: {sorted(extra)}")
    flat: typing.Dict[str, np.ndarray] = {}
    for coll in COLLECTIONS:
        part: typing.Dict[str, np.ndarray] = {}
        _flatten(variables.get(coll, {}), "", part)
        clash = set(part) & set(flat)
        if clash:
            raise ValueError(f"keys in both collections: {sorted(clash)[:5]}")
        flat.update(part)
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in flat.items()
    }
    if net is not None:
        want = net.state_dict()
        missing = sorted(set(want) - set(state))
        left = sorted(set(state) - set(want))
        if missing or left:
            raise ValueError(
                f"weights do not match the network: missing {missing[:8]}"
                f" ({len(missing)}), left over {left[:8]} ({len(left)})"
            )
        bad = [k for k in state if tuple(state[k].shape) != tuple(want[k].shape)]
        if bad:
            raise ValueError(
                "shape mismatch: "
                + ", ".join(f"{k} {tuple(state[k].shape)} vs {tuple(want[k].shape)}"
                            for k in bad[:8])
            )
    return state


def to_jax_variables(net: torch.nn.Module) -> dict:
    """The network's state as nested {'params', 'batch_stats'} numpy f32
    trees in flax names: `from_jax_variables(to_jax_variables(net), net)`
    gives `net.state_dict()` back."""
    out: dict = {c: {} for c in COLLECTIONS}
    for coll, named in (("params", net.named_parameters()),
                        ("batch_stats", net.named_buffers())):
        for name, tensor in named:
            node = out[coll]
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = tensor.detach().to("cpu", torch.float32).numpy().copy()
    return out


def load_network(spec, variables: dict, device: torch.device) -> torch.nn.Module:
    """Build `spec`'s network, load `variables` strictly and move it to
    `device` in eval mode, its parameters frozen (`requires_grad` False):
    the network of an inference path."""
    net = spec.make_network()
    net.load_state_dict(from_jax_variables(variables, net), strict=True)
    return net.to(device).eval().requires_grad_(False)
