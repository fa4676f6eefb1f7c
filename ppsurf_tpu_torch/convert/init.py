"""Seeded random weights for a spec's network, in the JAX package's tree.

The card has no JAX, and the repository commits trained weights for PPSurf
only, so a run of another configuration (POCO) draws its weights here:
`init_variables(spec, seed)` returns the nested flax-shaped
`{'params': ..., 'batch_stats': ...}` tree that `PocoNetwork.init` /
`PPSurfNetwork.init` of `ppsurf_tpu` would make (same names and shapes),
filled from a numpy generator with flax's default initialisers: Dense and
FKAConv kernels lecun-normal (a normal truncated at two standard
deviations, variance 1/fan_in), biases zero, norm scales one, alpha and
beta one, BatchNorm statistics (0, 1), the FKAConv normalisation radius
one. `load_network(spec, init_variables(spec))` loads it like any
converted checkpoint.
"""
from __future__ import annotations

import math

import numpy as np

# the std of a standard normal truncated to [-2, 2], which flax's
# truncated lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.RandomState, shape, std: float) -> np.ndarray:
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std / _TRUNC_STD).astype(np.float32)


def _value(rng: np.random.RandomState, leaf: str, shape) -> np.ndarray:
    if leaf in ("kernel", "cv"):
        fan_in = math.prod(shape[:-1])  # (in, out) or (in, ksize, out)
        return _truncated_normal(rng, shape, math.sqrt(1.0 / fan_in))
    if leaf in ("bias", "mean"):
        return np.zeros(shape, np.float32)
    if leaf in ("scale", "alpha", "beta", "var", "norm_radius"):
        return np.ones(shape, np.float32)
    raise ValueError(f"no initialiser for a leaf named {leaf!r}")


def init_variables(spec, seed: int = 0) -> dict:
    """Nested {'params', 'batch_stats'} of numpy f32 leaves for `spec`'s
    network: parameters under 'params', buffers (BatchNorm statistics,
    FKAConv radii) under 'batch_stats'."""
    net = spec.make_network()
    rng = np.random.RandomState(seed)
    out: dict = {"params": {}, "batch_stats": {}}
    groups = (("params", net.named_parameters()), ("batch_stats", net.named_buffers()))
    for coll, named in groups:
        for name, tensor in named:
            node = out[coll]
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = _value(rng, leaf, tuple(tensor.shape))
    return out
