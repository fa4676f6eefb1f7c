"""Dataset directory conventions and host-side shape loading for
reconstruction.

A copy of the numpy-only parts of `ppsurf_tpu/data/datasets.py` (the
directory conventions, `:31-105`, and `ShapeDataset`'s loading of a
shape's cloud, `:111-197`; reference `source/occupancy_data_module.py`),
reading files with the port's own `io`. The training-side batch assembly
and its prefetcher come with the training port.

A dataset is named by its `.txt` shape list inside the dataset directory:
`<dataset>/testset.txt` lists shape names whose clouds lie in
`<dataset>/04_pts_vis/<name>.xyz.ply`; any other file is one cloud.
"""
from __future__ import annotations

import dataclasses
import os
import typing

import numpy as np

from ppsurf_tpu_torch.io.point_cloud import load_pts, pre_process_pts
from ppsurf_tpu_torch.utils import math3d


# --- directory conventions (reference `occupancy_data_module.py:19-86`) ---

def in_file_is_dataset(in_file: str) -> bool:
    return os.path.splitext(in_file)[1].lower() == ".txt"


def get_dataset_dir(in_file: str) -> str:
    return os.path.dirname(in_file)


def get_dataset_name(in_file: str) -> str:
    return os.path.basename(get_dataset_dir(in_file))


def get_meshes_dir(in_file: str) -> str:
    return os.path.join(get_dataset_dir(in_file), "03_meshes")


def get_pc_dir(in_file: str) -> str:
    return os.path.join(get_dataset_dir(in_file), "04_pts_vis")


def get_pc_file(in_file: str, shape_name: str) -> str:
    if in_file_is_dataset(in_file):
        return os.path.join(get_dataset_dir(in_file), "04_pts_vis", shape_name + ".xyz.ply")
    return in_file


def get_training_data_dir(in_file: str) -> typing.Tuple[str, str]:
    dataset_dir = get_dataset_dir(in_file)
    return (
        os.path.join(dataset_dir, "05_query_pts"),
        os.path.join(dataset_dir, "05_query_dist"),
    )


def get_set_files(in_file: str) -> typing.Tuple[str, str, str]:
    if in_file_is_dataset(in_file):
        d = os.path.dirname(in_file)
        return (
            os.path.join(d, "trainset.txt"),
            os.path.join(d, "valset.txt"),
            os.path.join(d, "testset.txt"),
        )
    return in_file, in_file, in_file


def get_results_dir(out_dir: str, name: str, in_file: str) -> str:
    return os.path.join(out_dir, name, get_dataset_name(in_file))


def read_shape_list(shape_list_file: str) -> typing.List[str]:
    with open(shape_list_file) as f:
        names = [x.strip() for x in f.readlines()]
    return [x for x in names if x]


@dataclasses.dataclass
class DatasetPaths:
    in_file: str

    @property
    def is_dataset(self) -> bool:
        return in_file_is_dataset(self.in_file)

    @property
    def trainset(self) -> str:
        return get_set_files(self.in_file)[0]

    @property
    def valset(self) -> str:
        return get_set_files(self.in_file)[1]

    @property
    def testset(self) -> str:
        return get_set_files(self.in_file)[2]


class ShapeDataset:
    """The shapes of a dataset `.txt` (or one cloud file) for
    reconstruction: `shape_names` and `load_raw_shape`, each cloud read at
    full resolution; a single file is normalized into the unit cube with
    the model's padding, as the JAX package does
    (`ppsurf_tpu/data/datasets.py:175-190`)."""

    def __init__(self, in_file: str, padding_factor: float = 0.05):
        self.in_file = in_file
        self.padding_factor = padding_factor
        if in_file_is_dataset(in_file):
            self.shape_names = read_shape_list(in_file)
        else:
            self.shape_names = [in_file]

    def __len__(self) -> int:
        return len(self.shape_names)

    def load_raw_shape(self, index: int) -> typing.Tuple[np.ndarray, np.ndarray]:
        """Load + (maybe) normalize the full-resolution cloud."""
        pc_file = get_pc_file(self.in_file, self.shape_names[index])
        pts = load_pts(pc_file)
        pts, normals = pre_process_pts(pts)
        if not in_file_is_dataset(self.in_file):
            # single files are normalized on the fly
            # (`occupancy_data_module.py:235-238`)
            center, scale = math3d.get_points_normalization_info(
                pts, self.padding_factor
            )
            pts = math3d.normalize_points_with_info(pts, center, scale)
        return pts.astype(np.float32), normals.astype(np.float32)
