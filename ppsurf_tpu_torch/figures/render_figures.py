"""Render the assembled figure data to PNGs.

Port of `ppsurf_tpu/figures/render_figures.py` (in place of the
reference's Blender pipeline, `source/figures/render_meshes_blender.py`)
on the port's renderer and PNG writer (`utils/visualization.py`,
`utils/png.py`): every mesh under the `prepare_figures` tree
(`results/figures/**`) to `<mesh>.png`, and every `{method}_dist.npz` to
`{method}_dist.png`, its vertices coloured by a yellow-orange-red ramp of
distance over `--dist_cut_off`. Renders newer than their input are kept.

    python -m ppsurf_tpu_torch.figures.render_figures [--figures_dir results/figures]
        [--workers 8] [--resolution 1024] [--dist_cut_off 0.02]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ppsurf_tpu_torch.utils.fs import call_necessary
from ppsurf_tpu_torch.utils.mp import start_process_pool
from ppsurf_tpu_torch.utils.visualization import render_scene


def _ylorrd(values01: np.ndarray) -> np.ndarray:
    """Yellow-orange-red error ramp, (N,) in [0, 1] -> (N, 3) uint8."""
    t = np.clip(values01, 0.0, 1.0)
    r = np.clip(1.0 - 0.2 * t, 0, 1)
    g = np.clip(1.0 - 1.1 * t + 0.15 * t * t, 0, 1)
    b = np.clip(0.6 - 1.8 * t, 0, 1)
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


def render_dist_npz(npz_file: str, out_png: str, dist_cut_off: float = 0.02,
                    resolution: int = 1024) -> None:
    """Render a `{method}_dist.npz` (vertices, faces, distances) coloured
    by its distances."""
    from ppsurf_tpu_torch.utils.fs import make_dir_for_file
    from ppsurf_tpu_torch.utils.png import write_png
    from ppsurf_tpu_torch.utils.visualization import _render_arrays

    data = np.load(npz_file)
    colors = _ylorrd(data["distances"] / dist_cut_off)
    img = _render_arrays(data["vertices"].astype(np.float32), data["faces"].astype(np.int32),
                         colors, (resolution, resolution), 45.0)
    make_dir_for_file(out_png)
    write_png(out_png, img)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--figures_dir", type=str, default="results/figures")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--resolution", type=int, default=1024)
    parser.add_argument("--dist_cut_off", type=float, default=0.02)
    args = parser.parse_args(argv)

    mesh_jobs = []
    for ply in glob.glob(os.path.join(args.figures_dir, "**", "*.ply"), recursive=True):
        if ply.endswith("_dist_col.ply"):
            continue
        png = ply[:-4] + ".png"
        if call_necessary(ply, png):
            mesh_jobs.append((ply, png, (args.resolution, args.resolution)))
    start_process_pool(render_scene, mesh_jobs, num_processes=args.workers)

    dist_jobs = []
    for npz in glob.glob(os.path.join(args.figures_dir, "**", "*_dist.npz"), recursive=True):
        png = npz[:-4] + ".png"
        if call_necessary(npz, png):
            dist_jobs.append((npz, png, args.dist_cut_off, args.resolution))
    start_process_pool(render_dist_npz, dist_jobs, num_processes=args.workers)
    print(f"rendered {len(mesh_jobs)} meshes, {len(dist_jobs)} distance fields")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
