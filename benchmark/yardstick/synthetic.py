"""Seeded synthetic clouds (a frozen copy of the program's
`data/synthetic.py::torus_cloud`, with a seed of any size)."""
from __future__ import annotations

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.RandomState:
    """A numpy generator for `seed` (any non-negative whole number, also
    past 32 bits) and a stream of small ids (e.g. the object's index)."""
    words = [int(s) & 0xFFFFFFFF for s in stream]
    seed = int(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if seed == 0:
            break
    return np.random.RandomState(np.array(words, dtype=np.uint32))


def torus_cloud(n: int, rng: np.random.RandomState) -> np.ndarray:
    """n points on a torus with a sphere beside it, in the unit cube: the
    same shape for every draw, only the samples and the noise move."""
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


CLOUDS = {"torus_sphere": torus_cloud}
