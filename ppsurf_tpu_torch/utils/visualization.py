"""Scalar-coloured point clouds, distance-coloured meshes and headless
renders of meshes and point clouds.

Port of `ppsurf_tpu/utils/visualization.py` (reference
`source/base/visualization.py`): the same procedural colour map, the
Chamfer-coloured reconstruction (vertices coloured by their distance to
samples of the ground truth, on the port's host kd-tree), the camera of
the reference's figures and the first-party z-buffer renderer of
`native/ppsurf_native.cpp`. PNGs are written by `utils/png.py` (the
machine the port runs on has no PIL). The JAX package's PIL painter for
hosts without the native library is not carried over: `_render_arrays`
raises there for a mesh; a point cloud falls back to `_splat_numpy`.
"""
from __future__ import annotations

import os
import typing

import numpy as np

from ppsurf_tpu_torch.io.ply import Mesh, save_ply
from ppsurf_tpu_torch.utils.math3d import normalize_data


def _colormap(values01: np.ndarray) -> np.ndarray:
    """(N,) in [0, 1] -> (N, 3) uint8, a viridis-like procedural map."""
    t = np.clip(values01, 0.0, 1.0)
    r = np.clip(1.63 * t - 0.38 * np.sin(6.28 * t) - 0.3, 0, 1)
    g = np.clip(0.06 + 0.92 * t, 0, 1)
    b = np.clip(0.38 + 0.7 * np.cos(3.0 * t - 0.6) - 0.25 * t, 0, 1)
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


def plot_pts_scalar_data(
    pts: np.ndarray,
    data: np.ndarray,
    file_path: str,
    prop_min: float = 0.0,
    prop_max: float = 1.0,
) -> None:
    """Write a PLY point cloud coloured by a scalar property."""
    pts = np.asarray(pts).reshape(-1, 3)
    data = np.asarray(data).reshape(-1)
    norm = normalize_data(data, in_min=prop_min, in_max=prop_max, out_min=0.0, out_max=1.0,
                          clip=True)
    save_ply(file_path, pts, vertex_colors=_colormap(norm))


def visualize_chamfer_distance(
    rec_mesh_file: str,
    gt_mesh_file: str,
    output_mesh_file: str,
    min_vertex_count: int = 10000,
    dist_cut_off: float = 0.03,
) -> typing.Optional[str]:
    """Colour the reconstruction's vertices by their distance to samples of
    the ground-truth surface: a vertex-coloured PLY at `output_mesh_file`
    and the raw distances in a `.npz` beside it. None where either mesh is
    unreadable or empty."""
    from ppsurf_tpu_torch.io.ply import load_ply
    from ppsurf_tpu_torch.metrics.mesh_metrics import _nn_dists
    from ppsurf_tpu_torch.metrics.sampling import sample_surface

    try:
        rec = load_ply(rec_mesh_file)
        gt = load_ply(gt_mesh_file)
    except (OSError, ValueError):
        return None
    if rec.is_empty or gt.is_empty:
        return None

    gt_samples = sample_surface(gt, max(min_vertex_count, 100000))
    dists = _nn_dists(gt_samples, rec.vertices.astype(np.float64))
    norm = np.clip(dists / dist_cut_off, 0.0, 1.0)
    colored = Mesh(vertices=rec.vertices, faces=rec.faces, vertex_colors=_colormap(norm))
    os.makedirs(os.path.dirname(os.path.abspath(output_mesh_file)), exist_ok=True)
    colored.export(output_mesh_file)
    np.savez(os.path.splitext(output_mesh_file)[0] + ".npz", distances=dists)
    return output_mesh_file


def visualize_chamfer_distance_pool(
    rec_meshes: typing.Sequence[str],
    gt_meshes: typing.Sequence[str],
    output_meshes: typing.Sequence[str],
    dist_cut_off: float = 0.03,
    num_processes: int = 1,
) -> typing.List[typing.Optional[str]]:
    """`visualize_chamfer_distance` over lists of files, one after the
    other (the kd-tree queries are native already)."""
    return [visualize_chamfer_distance(r, g, o, dist_cut_off=dist_cut_off)
            for r, g, o in zip(rec_meshes, gt_meshes, output_meshes)]


def _euler_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix of static-frame XYZ Euler angles (trimesh's
    `set_camera(angles=...)` convention)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def camera_view_matrix(
    vertices: np.ndarray,
    angles: typing.Tuple[float, float, float] = (np.pi * 0.25, np.pi * 0.25, 0.0),
    distance_scale: float = 2.2,
) -> np.ndarray:
    """World-to-camera 4x4 of the reference's figure viewpoint (angles
    (pi/4, pi/4, 0), distance 2.2 half-extents, looking at the bounding
    box's centre)."""
    center = 0.5 * (vertices.min(axis=0) + vertices.max(axis=0))
    extent = float(np.linalg.norm(vertices.max(axis=0) - vertices.min(axis=0)))
    rot = _euler_xyz(*angles)  # the camera's orientation in world space
    eye = center + rot @ np.array([0.0, 0.0, 1.0]) * distance_scale * max(extent, 1e-9) * 0.5
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = -rot.T @ eye
    return view


def _render_arrays(
    vertices: np.ndarray,
    faces: typing.Optional[np.ndarray],
    colors: typing.Optional[np.ndarray],
    resolution: typing.Tuple[int, int],
    fov_deg: float,
) -> np.ndarray:
    """(H, W, 3) uint8 render on a white background: a mesh where `faces`
    has rows (the native renderer; raises where the host library is not
    built), else a point cloud (the native splats, else `_splat_numpy`)."""
    from ppsurf_tpu_torch import native

    w, h = int(resolution[0]), int(resolution[1])
    img = np.full((h, w, 3), 255, np.uint8)
    if vertices.shape[0] == 0:
        return img
    view = camera_view_matrix(vertices)
    if faces is not None and faces.shape[0] > 0:
        if not native.available():
            raise RuntimeError("rendering a mesh needs the host library "
                               "native/ppsurf_native.cpp, which did not build here")
        return native.render_mesh_native(vertices, faces, colors, view, w, h, fov_deg, img)
    if native.available():
        return native.render_points_native(vertices, colors, view, w, h, fov_deg,
                                           max(1, h // 512), img)
    return _splat_numpy(vertices, colors, view, w, h, fov_deg, img)


def _project(vertices, view, w, h, fov_deg):
    cam = vertices @ view[:3, :3].T + view[:3, 3]
    zc = np.maximum(1e-6, -cam[:, 2])
    f = 0.5 * h / np.tan(0.5 * np.deg2rad(fov_deg))
    px = 0.5 * w + f * cam[:, 0] / zc
    py = 0.5 * h - f * cam[:, 1] / zc
    return px, py, zc


def _splat_numpy(vertices, colors, view, w, h, fov_deg, img):
    """One-pixel splats of a point cloud, far to near, in numpy."""
    px, py, zc = _project(vertices, view, w, h, fov_deg)
    order = np.argsort(-zc)
    xi = np.clip(px[order].astype(int), 0, w - 1)
    yi = np.clip(py[order].astype(int), 0, h - 1)
    rgb = (colors[order] if colors is not None
           else np.tile(np.array([60, 90, 180], np.uint8), (xi.shape[0], 1)))
    img[yi, xi] = rgb
    return img


def render_scene(
    mesh_file: str,
    rendering_file: str,
    resolution: typing.Tuple[int, int] = (1024, 1024),
    fov_deg: float = 45.0,
) -> None:
    """Render a mesh or point-cloud file (PLY, or `.npy` points) to a PNG."""
    from ppsurf_tpu_torch.io.ply import load_ply
    from ppsurf_tpu_torch.io.point_cloud import load_pts
    from ppsurf_tpu_torch.utils.fs import make_dir_for_file
    from ppsurf_tpu_torch.utils.png import write_png

    if not os.path.isfile(mesh_file):
        print(f"Rendering failed, file not found: {mesh_file}")
        return
    colors = None
    if mesh_file.endswith(".npy"):
        vertices = np.load(mesh_file).astype(np.float32).reshape(-1, 3)
        faces = None
    else:
        try:
            mesh = load_ply(mesh_file)
            vertices, faces = mesh.vertices, mesh.faces
            colors = getattr(mesh, "vertex_colors", None)
            if faces is not None and faces.shape[0] == 0:
                faces = None
        except Exception:
            vertices = load_pts(mesh_file).astype(np.float32)[:, :3]
            faces = None
    img = _render_arrays(vertices, faces, colors, resolution, fov_deg)
    make_dir_for_file(rendering_file)
    write_png(rendering_file, img)


def render_meshes(
    all_meshes_in: typing.Sequence[str],
    all_renders_out: typing.Sequence[str],
    workers: int = 1,
) -> None:
    """Render many meshes, skipping renders newer than their mesh."""
    from ppsurf_tpu_torch.utils.fs import call_necessary
    from ppsurf_tpu_torch.utils.mp import start_process_pool

    assert len(all_meshes_in) == len(all_renders_out)
    params = [(m, r) for m, r in zip(all_meshes_in, all_renders_out) if call_necessary(m, r)]
    start_process_pool(render_scene, params, num_processes=workers)
