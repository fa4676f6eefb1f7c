"""Nearest-neighbour and closest-point-on-mesh queries on the host.

Port of `ppsurf_tpu/metrics/proximity.py` (reference
`source/base/proximity.py:20-81`). Every nearest-neighbour query of the
metrics goes through `nn_query`: the repository's C++ kd-tree
(`native.NativeKdTree`), or scipy's cKDTree where the host library is not
built. `get_closest_point_on_mesh` projects each point onto its k nearest
triangles by centroid (Ericson, Real-Time Collision Detection §5.1.5) and
keeps the closest: exact whenever the true closest triangle is among them.
"""
from __future__ import annotations

import typing

import numpy as np

from ppsurf_tpu_torch.io.ply import Mesh


def nn_query(
    pts: np.ndarray, queries: np.ndarray, k: int = 1
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """(dists (Q, k), ids (Q, k)) nearest neighbours of `queries` in `pts`."""
    from ppsurf_tpu_torch import native

    if native.available():
        return native.NativeKdTree(np.ascontiguousarray(pts, np.float32)).query(
            np.ascontiguousarray(queries, np.float32), k=k
        )
    from scipy.spatial import cKDTree

    dists, ids = cKDTree(pts).query(queries, k=k)
    if k == 1:
        dists, ids = dists[:, None], ids[:, None]
    return dists, ids


def closest_point_on_triangles(
    points: np.ndarray, tri_a: np.ndarray, tri_b: np.ndarray, tri_c: np.ndarray
) -> np.ndarray:
    """Closest point on triangle i to points[i] ((N, 3) each)."""
    ab = tri_b - tri_a
    ac = tri_c - tri_a
    ap = points - tri_a

    d1 = np.einsum("ij,ij->i", ab, ap)
    d2 = np.einsum("ij,ij->i", ac, ap)

    bp = points - tri_b
    d3 = np.einsum("ij,ij->i", ab, bp)
    d4 = np.einsum("ij,ij->i", ac, bp)

    cp = points - tri_c
    d5 = np.einsum("ij,ij->i", ab, cp)
    d6 = np.einsum("ij,ij->i", ac, cp)

    result = np.empty_like(points)
    done = np.zeros(points.shape[0], bool)

    def assign(mask, value):
        m = mask & ~done
        result[m] = value[m] if value.ndim == 2 else value
        done[m] = True

    # vertex regions
    assign((d1 <= 0) & (d2 <= 0), tri_a)
    assign((d3 >= 0) & (d4 <= d3), tri_b)
    assign((d6 >= 0) & (d5 <= d6), tri_c)

    # edge AB
    vc = d1 * d4 - d3 * d2
    with np.errstate(invalid="ignore", divide="ignore"):
        v_ab = d1 / (d1 - d3)
    assign((vc <= 0) & (d1 >= 0) & (d3 <= 0), tri_a + np.nan_to_num(v_ab)[:, None] * ab)

    # edge AC
    vb = d5 * d2 - d1 * d6
    with np.errstate(invalid="ignore", divide="ignore"):
        w_ac = d2 / (d2 - d6)
    assign((vb <= 0) & (d2 >= 0) & (d6 <= 0), tri_a + np.nan_to_num(w_ac)[:, None] * ac)

    # edge BC
    va = d3 * d6 - d5 * d4
    with np.errstate(invalid="ignore", divide="ignore"):
        w_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6))
    assign(
        (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
        tri_b + np.nan_to_num(w_bc)[:, None] * (tri_c - tri_b),
    )

    # interior
    denom = va + vb + vc
    with np.errstate(invalid="ignore", divide="ignore"):
        v = vb / denom
        w = vc / denom
    interior = tri_a + np.nan_to_num(v)[:, None] * ab + np.nan_to_num(w)[:, None] * ac
    assign(np.ones_like(done), interior)
    return result


def get_closest_point_on_mesh(
    mesh: Mesh, points: np.ndarray, k_candidates: int = 32
) -> typing.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(closest_points, distances, face_ids) for each query point."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces
    centroids = v[f].mean(axis=1)
    k = min(k_candidates, f.shape[0])

    _, cand = nn_query(centroids, points, k=k)

    n, kk = cand.shape
    pts_rep = np.repeat(points.astype(np.float64), kk, axis=0)
    tris = f[cand.reshape(-1)]
    closest = closest_point_on_triangles(
        pts_rep, v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    ).reshape(n, kk, 3)
    d = np.linalg.norm(closest - points[:, None, :], axis=2)
    best = np.argmin(d, axis=1)
    idx = np.arange(n)
    return (
        closest[idx, best],
        d[idx, best],
        cand[idx, best].astype(np.int64),
    )


def normal_error(file_in: str, file_ref: str, num_samples: int = 100000):
    """Mean angle between each reference sample's face normal and the normal
    of its closest face on the reconstruction (reference `metrics.py:222-243`;
    the metrics' dispatcher uses the sampling variant `normal_error_approx`)."""
    from ppsurf_tpu_torch.io import load_ply
    from ppsurf_tpu_torch.metrics.sampling import sample_surface

    try:
        mesh_in = load_ply(file_in)
        mesh_ref = load_ply(file_ref)
    except (OSError, ValueError):
        return file_in, file_ref, np.nan
    if mesh_in.is_empty or mesh_ref.is_empty:
        return file_in, file_ref, np.nan

    rng = np.random.default_rng(42)
    samples, face_index = sample_surface(mesh_ref, num_samples, rng, return_face_index=True)
    normals_ref = mesh_ref.face_normals()[face_index]
    _, _, faces_in = get_closest_point_on_mesh(mesh_in, samples)
    normals_in = mesh_in.face_normals()[faces_in]
    cosine = np.clip(np.einsum("ij,ij->i", normals_ref, normals_in), -1, 1)
    return file_in, file_ref, float(np.nanmean(np.arccos(cosine)))
