"""Dict and list aggregation helpers.

Port of `ppsurf_tpu/utils/container.py` (reference
`source/base/container.py:10-128`); `tensor_list_to_array` also takes
torch tensors (on any device).
"""
from __future__ import annotations

import typing

import numpy as np


def flatten_dicts(
    dicts: typing.Sequence[typing.Mapping], flatten_lists: bool = False
) -> typing.List[dict]:
    """Flatten nested dicts one level: inner dict keys are lifted to the
    top; with `flatten_lists`, list items become `{key}_{i}`."""
    out = []
    for d in dicts:
        flat: dict = {}
        for k, v in d.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    flat[kk] = vv
            elif flatten_lists and isinstance(v, (list, tuple)):
                for i, vv in enumerate(v):
                    flat[f"{k}_{i}"] = vv
            else:
                flat[k] = v
        out.append(flat)
    return out


def aggregate_dicts_np(
    dicts: typing.Sequence[typing.Mapping], method: str = "mean"
) -> dict:
    """Aggregate same-key values across dicts: 'mean' (NaN skipped),
    'concat' or 'stack'; string values are collected as a list."""
    keys = dicts[0].keys()
    out = {}
    for k in keys:
        values = [d[k] for d in dicts]
        if isinstance(values[0], str):
            out[k] = values
        elif method == "mean":
            out[k] = float(np.nanmean(np.asarray(values, dtype=np.float64)))
        elif method == "concat":
            out[k] = np.concatenate([np.atleast_1d(np.asarray(v)) for v in values])
        elif method == "stack":
            out[k] = np.stack([np.asarray(v) for v in values])
        else:
            raise ValueError(f"unknown method {method}")
    return out


aggregate_dicts = aggregate_dicts_np


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):  # a torch tensor
        return t.detach().cpu().numpy()
    return np.asarray(t)


def tensor_list_to_array(tensors: typing.Sequence) -> np.ndarray:
    """Concatenate a list of arrays or tensors into one numpy array."""
    return np.concatenate([_to_numpy(t) for t in tensors])
