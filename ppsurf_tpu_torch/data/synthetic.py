"""Seeded synthetic clouds: the smoke's and the benchmark's input."""
from __future__ import annotations

import numpy as np


def torus_cloud(n: int, seed: int) -> np.ndarray:
    """n points on a torus with a sphere beside it, in the unit cube."""
    rng = np.random.RandomState(seed)
    n_t = n * 2 // 3
    u, v = rng.rand(2, n_t) * 2 * np.pi
    big, small = 0.28, 0.1
    torus = np.stack([(big + small * np.cos(v)) * np.cos(u) - 0.1,
                      (big + small * np.cos(v)) * np.sin(u),
                      small * np.sin(v)], axis=1)
    d = rng.randn(n - n_t, 3)
    sphere = d / np.linalg.norm(d, axis=1, keepdims=True) * 0.15 + [0.3, 0.0, 0.25]
    pts = np.concatenate([torus, sphere]) + rng.randn(n, 3) * 1e-3
    return pts.astype(np.float32)
