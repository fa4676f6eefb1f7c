"""Assemble the paper figures' data: copies of the ground truth, input
cloud and each method's mesh, and each mesh's vertex-to-ground-truth
distances.

Port of `ppsurf_tpu/figures/prepare_figures.py` (reference
`source/figures/prepare_figures.py:1-218`) on the port's
`metrics/proximity.get_closest_point_on_mesh`: for each (dataset, shape)
it gathers `gt.ply`, `pc.ply` and a `{method}.ply` for each method under
`{figure_path}/{dataset}/{shape}/`, and writes `{method}_dist.npz`
(vertices, faces, distances: the reconstruction midpoint-subdivided until
it has `min_vertex_count` vertices, each vertex's distance to the closest
point of the ground truth) with a distance-coloured `{method}_dist_col.ply`
beside it. The published configurations follow the reference's shape IDs.

    python -m ppsurf_tpu_torch.figures.prepare_figures
"""
from __future__ import annotations

import os
import shutil
import typing

import numpy as np

from ppsurf_tpu_torch.utils.fs import call_necessary, make_dir_for_file
from ppsurf_tpu_torch.utils.mp import start_process_pool


def _copy_file(src: str, dst: str) -> None:
    if not os.path.isfile(src):
        print(f"File not found: {src}")
        return
    make_dir_for_file(dst)
    shutil.copy(src, dst)


def _subdivide(vertices: np.ndarray, faces: np.ndarray):
    """One midpoint-subdivision pass (4 faces per face)."""
    e0 = 0.5 * (vertices[faces[:, 0]] + vertices[faces[:, 1]])
    e1 = 0.5 * (vertices[faces[:, 1]] + vertices[faces[:, 2]])
    e2 = 0.5 * (vertices[faces[:, 2]] + vertices[faces[:, 0]])
    base = vertices.shape[0]
    nf = faces.shape[0]
    i0 = base + np.arange(nf)
    i1 = base + nf + np.arange(nf)
    i2 = base + 2 * nf + np.arange(nf)
    new_vertices = np.concatenate([vertices, e0, e1, e2])
    new_faces = np.concatenate(
        [
            np.stack([faces[:, 0], i0, i2], axis=1),
            np.stack([i0, faces[:, 1], i1], axis=1),
            np.stack([i2, i1, faces[:, 2]], axis=1),
            np.stack([i0, i1, i2], axis=1),
        ]
    )
    return new_vertices, new_faces


def get_vertex_distances(
    input_mesh_file: str,
    reference_mesh_file: str,
    output_npz_file: str,
    min_vertex_count: typing.Optional[int] = 10000,
    distance_batch_size: int = 10000,
    dist_cut_off: float = 0.1,
) -> None:
    """Distances from (subdivided) rec-mesh vertices to the GT surface,
    saved as npz {vertices, faces, distances} plus a colored debug PLY
    (reference `prepare_figures.py:_get_vertex_distances`)."""
    from ppsurf_tpu_torch.io.ply import load_ply, save_ply
    from ppsurf_tpu_torch.metrics.proximity import get_closest_point_on_mesh
    from ppsurf_tpu_torch.utils.visualization import _colormap

    if not os.path.isfile(input_mesh_file):
        print(f"File not found: {input_mesh_file}")
        return
    rec = load_ply(input_mesh_file)
    gt = load_ply(reference_mesh_file)
    vertices = np.asarray(rec.vertices, np.float64)
    faces = np.asarray(rec.faces, np.int64)
    if min_vertex_count is not None and faces.size:
        while vertices.shape[0] < min_vertex_count:
            vertices, faces = _subdivide(vertices, faces)

    distances = np.concatenate([
        get_closest_point_on_mesh(gt, vertices[i : i + distance_batch_size])[1]
        for i in range(0, vertices.shape[0], distance_batch_size)
    ])

    make_dir_for_file(output_npz_file)
    np.savez(
        file=output_npz_file, vertices=vertices, faces=faces,
        distances=distances,
    )
    colors = _colormap(np.clip(distances / dist_cut_off, 0.0, 1.0))
    save_ply(
        output_npz_file[:-4] + "_col.ply",  # {method}_dist.npz -> _dist_col.ply
        vertices.astype(np.float32), faces.astype(np.int64),
        vertex_colors=colors,
    )


def assemble_figure_data(
    figure_path: str,
    objects: typing.Sequence[typing.Tuple[str, str]],
    datasets_path: str = "datasets",
    results_path: str = "results",
    methods: typing.Sequence[str] = (),
    workers: int = 0,
    min_vertex_count: int = 10000,
    distance_batch_size: int = 1000,
) -> None:
    """Copy GT/PC/method meshes into `{figure_path}/{dataset}/{shape}/` and
    write `{method}_dist.npz` distance fields
    (reference `prepare_figures.py:_assemble_figure_data`)."""
    gt_in = [
        os.path.join(datasets_path, d, "03_meshes", s + ".ply")
        for d, s in objects
    ]
    gt_out = [os.path.join(figure_path, d, s, "gt.ply") for d, s in objects]
    pc_in = [
        os.path.join(datasets_path, d, "04_pts_vis", s + ".xyz.ply")
        for d, s in objects
    ]
    pc_out = [os.path.join(figure_path, d, s, "pc.ply") for d, s in objects]

    copies = list(zip(gt_in, gt_out)) + list(zip(pc_in, pc_out))
    for d, s in objects:
        for m in methods:
            copies.append(
                (
                    os.path.join(results_path, m, d, "meshes", s + ".xyz.ply"),
                    os.path.join(figure_path, d, s, m + ".ply"),
                )
            )
    start_process_pool(
        _copy_file,
        [p for p in copies if call_necessary(p[0], p[1], verbose=False)],
        num_processes=workers,
    )

    dist_jobs = []
    for d, s in objects:
        gt = os.path.join(figure_path, d, s, "gt.ply")
        for m in methods:
            rec = os.path.join(figure_path, d, s, m + ".ply")
            out = os.path.join(figure_path, d, s, m + "_dist.npz")
            if call_necessary((rec, gt), out, verbose=False):
                dist_jobs.append(
                    (rec, gt, out, min_vertex_count, distance_batch_size)
                )
    start_process_pool(get_vertex_distances, dist_jobs, num_processes=workers)


# The published figure configurations (same shape IDs as the reference
# paper figures, `prepare_figures.py:91-218`).
METHODS_COMP = [
    "neural_imls", "pgr", "sap_optim", "sap", "p2s",
    "poco Pts_gen_sub3k_iter10", "ppsurf_merge_sum",
]
OBJECTS_COMP = [
    ("abc", "00010429_fc56088abf10474bba06f659_trimesh_004"),
    ("abc", "00011602_c087f04c99464bf7ab2380c4_trimesh_000"),
    ("abc", "00013052_9084b77631834dd584b2ac93_trimesh_033"),
    ("abc", "00014452_55263057b8f440a0bb50b260_trimesh_017"),
    ("abc", "00017014_fbef9df8f24940a0a2df6ccb_trimesh_001"),
    ("abc", "00990573_d1914c7f68f9a6b58bed9421_trimesh_000"),
    ("abc_noisefree", "00012754_b17656deace54b61b3130c7e_trimesh_019"),
    ("abc_noisefree", "00011696_1ca1ad2a09504ff1bf83cf74_trimesh_029"),
    ("abc_noisefree", "00016680_5a9a2a2a5eb64501863164e9_trimesh_000"),
    ("abc_noisefree", "00017682_f0ea0b827ae34675a4162390_trimesh_003"),
    ("abc_noisefree", "00019114_87f2e2e15b2746ffa4a2fd9a_trimesh_003"),
    ("abc_noisefree", "00011171_db6e2de6f4ae4ec493ebe2aa_trimesh_047"),
]
METHODS_ABLATION = [
    "ppsurf_vanilla_zeros_local", "ppsurf_vanilla_zeros_global",
    "ppsurf_vanilla_sym_max", "ppsurf_vanilla_qpoints",
    "ppsurf_vanilla", "ppsurf_merge_sum",
]
OBJECTS_ABLATION = [
    ("abc", "00012451_f54bcfcb352445bf90726b58_trimesh_001"),
    ("abc", "00014221_57e4213b31844b5b95cc62cd_trimesh_000"),
    ("abc", "00015159_57353d3381fb481182d9bdc6_trimesh_013"),
    ("abc", "00990546_db31ddca9d3585c330dcce3a_trimesh_000"),
    ("abc", "00993692_494894597fe7b39310a44a99_trimesh_000"),
]
OBJECTS_REAL = [
    ("real_world", "madersperger_cropped"),
    ("real_world", "statue_ps_outliers2_cropped"),
    ("real_world", "torch_ps_outliers2"),
]
OBJECTS_DATASETS = [
    ("abc", "00013052_9084b77631834dd584b2ac93_trimesh_033"),
    ("abc_noisefree", "00013052_9084b77631834dd584b2ac93_trimesh_033"),
    ("abc_extra_noisy", "00013052_9084b77631834dd584b2ac93_trimesh_033"),
    ("famous_dense", "hand"),
    ("famous_extra_noisy", "hand"),
    ("famous_noisefree", "hand"),
    ("famous_original", "hand"),
    ("famous_sparse", "hand"),
    ("thingi10k_scans_dense", "54725"),
    ("thingi10k_scans_extra_noisy", "54725"),
    ("thingi10k_scans_noisefree", "54725"),
    ("thingi10k_scans_original", "54725"),
    ("thingi10k_scans_sparse", "54725"),
]
OBJECTS_LIMITATIONS = [("thingi10k_scans_sparse", "274379")]


def main(workers: int = 8) -> None:
    assemble_figure_data(
        "results/figures/comp", OBJECTS_COMP, methods=METHODS_COMP,
        workers=workers,
    )
    assemble_figure_data(
        "results/figures/ablation", OBJECTS_ABLATION,
        methods=METHODS_ABLATION, workers=workers,
    )
    assemble_figure_data(
        "results/figures/real_world", OBJECTS_REAL, methods=METHODS_COMP,
        workers=workers,
    )
    assemble_figure_data(
        "results/figures/datasets", OBJECTS_DATASETS, methods=[],
        workers=workers,
    )
    assemble_figure_data(
        "results/figures/limitations", OBJECTS_LIMITATIONS,
        methods=["ppsurf_merge_sum"], workers=workers,
    )


if __name__ == "__main__":
    main()
