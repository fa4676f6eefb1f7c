"""Seeded analytic solids and the training dataset made of them (a frozen
copy of `chip_smoke.py::solid` and `write_training_dataset`).

`write_dataset` writes the reference layout the program's loader reads
(`trainset.txt`, `04_pts_vis/<name>.xyz.ply`, `05_query_pts` and
`05_query_dist/<name>.ply.npy`) and returns the same arrays in memory, so
the reference reads what the program reads without going through the
program's readers.
"""
from __future__ import annotations

import os
import typing

import numpy as np

KINDS = ("sphere", "torus", "ellipsoid")


def solid(kind: str, rng: np.random.RandomState, n: int, queries: np.ndarray
          ) -> typing.Tuple[np.ndarray, np.ndarray]:
    """n surface points of a seeded analytic solid at a random pose in the
    unit cube, and the signed distances of `queries` to it (negative
    inside; the ellipsoid's is the scaled sphere's, exact in sign)."""
    u = rng.rand(4)
    q = u / np.linalg.norm(u)  # a rotation from a random unit quaternion
    w, x, y, z = q
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    centre = (rng.rand(3) - 0.5) * 0.1
    local = (queries - centre) @ rot  # queries in the solid's frame
    if kind == "sphere":
        r = 0.2 + 0.15 * rng.rand()
        d = rng.randn(n, 3)
        surf = d / np.linalg.norm(d, axis=1, keepdims=True) * r
        dist = np.linalg.norm(local, axis=1) - r
    elif kind == "torus":
        big, small = 0.22 + 0.08 * rng.rand(), 0.06 + 0.05 * rng.rand()
        a, b = rng.rand(2, n) * 2 * np.pi
        surf = np.stack([(big + small * np.cos(b)) * np.cos(a),
                         (big + small * np.cos(b)) * np.sin(a), small * np.sin(b)], axis=1)
        ring = np.linalg.norm(local[:, :2], axis=1) - big
        dist = np.sqrt(ring ** 2 + local[:, 2] ** 2) - small
    else:
        radii = 0.12 + 0.25 * rng.rand(3)
        d = rng.randn(n, 3)
        surf = d / np.linalg.norm(d, axis=1, keepdims=True) * radii
        dist = (np.linalg.norm(local / radii, axis=1) - 1.0) * radii.min()
    return (surf @ rot.T + centre).astype(np.float32), dist.astype(np.float32)


def _write_ply(path: str, pts: np.ndarray) -> None:
    """A binary little-endian PLY of float x, y, z vertices."""
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {pts.shape[0]}\nproperty float x\nproperty float y\n"
            "property float z\nend_header\n").encode("ascii")
    with open(path, "wb") as fp:
        fp.write(head)
        fp.write(np.ascontiguousarray(pts, "<f4").tobytes())


def write_dataset(root: str, rng: np.random.RandomState, shapes: int, queries: int,
                  points: typing.Tuple[int, int]) -> typing.List[dict]:
    """`shapes` solids (sphere, torus, ellipsoid in turn) of points[0] to
    points[1] points, each with `queries` uniform queries in [-0.5, 0.5]^3
    and their signed distances, under `root`, listed in trainset.txt (the
    val and test lists hold the first shape). Returns each shape's
    {name, pts, queries, dist}."""
    for d in ("04_pts_vis", "05_query_pts", "05_query_dist"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    out = []
    for i in range(shapes):
        name = f"{KINDS[i % 3]}_{i:02d}"
        q = (rng.rand(queries, 3) - 0.5).astype(np.float32)
        pts, dist = solid(KINDS[i % 3], rng, int(rng.randint(points[0], points[1] + 1)), q)
        _write_ply(os.path.join(root, "04_pts_vis", name + ".xyz.ply"), pts)
        np.save(os.path.join(root, "05_query_pts", name + ".ply.npy"), q)
        np.save(os.path.join(root, "05_query_dist", name + ".ply.npy"), dist)
        out.append(dict(name=name, pts=pts, queries=q, dist=dist))
    names = "\n".join(s["name"] for s in out) + "\n"
    for split, text in (("trainset", names), ("valset", out[0]["name"] + "\n"),
                        ("testset", out[0]["name"] + "\n")):
        with open(os.path.join(root, split + ".txt"), "w") as fp:
            fp.write(text)
    return out
