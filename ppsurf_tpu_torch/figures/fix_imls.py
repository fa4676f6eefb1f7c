"""Re-align third-party neural-IMLS results with the ground truth's frame.

Port of `ppsurf_tpu/figures/fix_imls.py` (reference
`source/figures/fix_imls.py:1-77`), numpy only: IMLS meshes arrive
normalized to the unit cube; each is scaled by the largest extent of its
ground-truth mesh's bounding box and moved to that box's centre, and
written where the evaluation reads meshes.

    python -m ppsurf_tpu_torch.figures.fix_imls
"""
from __future__ import annotations

import os

import numpy as np

from ppsurf_tpu_torch.utils.fs import call_necessary, make_dir_for_file
from ppsurf_tpu_torch.utils.mp import start_process_pool

DATASETS = [
    "abc",
    "abc_noisefree",
    "famous_noisefree",
    "famous_original",
    "famous_sparse",
    "famous_dense",
    "thingi10k_scans_original",
    "thingi10k_scans_dense",
    "thingi10k_scans_sparse",
    "thingi10k_scans_noisefree",
]  # no extra-noisy results are published


def revert_normalization(src: str, gt: str, dst: str) -> None:
    """The mesh `src` in the frame of the ground truth `gt`, written to
    `dst`; nothing where `src` is missing or `gt` is flat."""
    from ppsurf_tpu_torch.io.ply import load_ply, save_ply

    if not os.path.isfile(src):
        print(f"File not found: {src}")
        return
    mesh_gt = load_ply(gt)
    bmin = mesh_gt.vertices.min(axis=0)
    bmax = mesh_gt.vertices.max(axis=0)
    extents = bmax - bmin
    if extents.min() == 0.0:
        return
    scale = float(extents.max())
    center = 0.5 * (bmin + bmax)

    mesh = load_ply(src)
    verts = np.asarray(mesh.vertices, np.float64) * scale + center
    make_dir_for_file(dst)
    save_ply(dst, verts.astype(np.float32), mesh.faces)


def main(datasets_path: str = "datasets", results_path: str = "results",
         workers: int = 8) -> None:
    for d in DATASETS:
        test_set = os.path.join(datasets_path, d, "testset.txt")
        if not os.path.isfile(test_set):
            continue
        with open(test_set) as fp:
            shapes = [ln.strip() for ln in fp if ln.strip()]
        jobs = []
        for s in shapes:
            src = os.path.join(results_path, "neural_imls misaligned", d, "meshes", s + ".ply")
            gt = os.path.join(datasets_path, d, "03_meshes", s + ".ply")
            dst = os.path.join(results_path, "neural_imls", d, "meshes", s + ".ply")
            if call_necessary((src, gt), dst, verbose=False):
                jobs.append((src, gt, dst))
        start_process_pool(revert_normalization, jobs, num_processes=workers)


if __name__ == "__main__":
    main()
