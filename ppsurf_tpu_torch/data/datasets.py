"""Dataset directory conventions and host-side shape loading.

A copy of `ppsurf_tpu/data/datasets.py` (reference
`source/occupancy_data_module.py`, `poco_data_loader.py` and
`ppsurf_data_loader.py`), which is numpy only, reading files with the
port's own `io`: the directory conventions, `ShapeDataset` (a shape's
cloud, its query points and signed distances, `patches_per_shape`, the
rotation augmentation, the manifold subsample, the raw cloud padded to a
multiple of 4096, per-item seeds drawn serially), the prefetching
iterator and `OccupancyDataModule.epoch_batches`. The same files and seed
give batches bit-identical to the JAX package's. The support pyramid,
the kNN id sets and the patches are built on the device in the step
(`train.model.ModelSpec.assemble_step_data`).

A dataset is named by its `.txt` shape list inside the dataset directory:
`<dataset>/testset.txt` lists shape names whose clouds lie in
`<dataset>/04_pts_vis/<name>.xyz.ply`; any other file is one cloud.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import typing
import weakref

import numpy as np

from ppsurf_tpu_torch.io.point_cloud import load_pts, pre_process_pts
from ppsurf_tpu_torch.utils import math3d
from ppsurf_tpu_torch.utils.spans import span


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


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class ShapeDataset:
    """Host-side per-shape loading with deterministic seeding.

    Yields numpy dicts with static shapes:
      pts_ms (N, 3), pts_query_ms (Q, 3), occ (Q,), shape_id (),
      pts_raw_ms (R, 3) padded, raw_valid (R,) bool.
    Replaces reference `PocoDataset`/`PPSurfDataset.__getitem__`
    (`poco_data_loader.py:273-396`, `ppsurf_data_loader.py:48-123`); patch
    extraction and all id-set building moved on device.
    """

    def __init__(
        self,
        in_file: str,
        manifold_points: typing.Optional[int] = 10000,
        padding_factor: float = 0.05,
        seed: int = 42,
        do_data_augmentation: bool = True,
        with_query_data: bool = True,
        with_raw_cloud: bool = True,
        raw_pad_multiple: int = 4096,
        patches_per_shape: typing.Optional[int] = None,
    ):
        self.in_file = in_file
        self.manifold_points = manifold_points
        self.padding_factor = padding_factor
        self.seed = seed
        self.do_data_augmentation = do_data_augmentation
        self.with_query_data = with_query_data
        self.with_raw_cloud = with_raw_cloud
        self.patches_per_shape = patches_per_shape

        if in_file_is_dataset(in_file):
            self.shape_names = read_shape_list(in_file)
        else:
            self.shape_names = [in_file]

        # static raw-cloud capacity: max vertex count over the set, rounded up
        self.raw_pad_size = 0
        if with_raw_cloud:
            max_pts = 1
            for name in self.shape_names:
                pc_file = get_pc_file(in_file, name)
                max_pts = max(max_pts, self._peek_num_points(pc_file))
            self.raw_pad_size = _round_up(max_pts, raw_pad_multiple)

        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()

    @staticmethod
    def _peek_num_points(pc_file: str) -> int:
        if pc_file.lower().endswith(".ply"):
            with open(pc_file, "rb") as fp:
                head = fp.read(4096).decode("ascii", errors="replace")
            for line in head.splitlines():
                if line.startswith("element vertex"):
                    return int(line.split()[-1])
        return load_pts(pc_file).shape[0]

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

    def draw_seeds(self, n: int) -> typing.List[int]:
        """Draw n per-item augmentation seeds from the dataset stream.

        Drawn serially (under the lock) so parallel prefetch workers see
        the exact seed sequence a serial pass would — batch contents are
        identical for any worker count.
        """
        with self._lock:
            return [int(self._rng.randint(0, 2**31 - 1)) for _ in range(n)]

    def __getitem__(self, index: int) -> typing.Dict[str, np.ndarray]:
        return self.fetch(index)

    def fetch(
        self, index: int, rng_seed: typing.Optional[int] = None
    ) -> typing.Dict[str, np.ndarray]:
        pts_raw, normals_raw = self.load_raw_shape(index)

        if rng_seed is None:
            (rng_seed,) = self.draw_seeds(1)
        rng = np.random.RandomState(rng_seed)

        item: typing.Dict[str, np.ndarray] = {"shape_id": np.int32(index)}

        # query points + occupancy labels (`poco_data_loader.py:366-380`)
        pts_query = np.zeros((0, 3), np.float32)
        dist = np.zeros((0,), np.float32)
        if self.with_query_data:
            query_pts_dir, query_dist_dir = get_training_data_dir(self.in_file)
            qf = os.path.join(query_pts_dir, self.shape_names[index] + ".ply.npy")
            df = os.path.join(query_dist_dir, self.shape_names[index] + ".ply.npy")
            if os.path.isfile(qf):
                pts_query = np.load(qf).astype(np.float32)
                dist = np.load(df).astype(np.float32)

        if self.patches_per_shape and self.patches_per_shape > 0 and pts_query.shape[0]:
            ids = rng.choice(pts_query.shape[0], self.patches_per_shape)
            pts_query = pts_query[ids]
            dist = dist[ids]

        # augmentation: one uniform random rotation for cloud + queries
        # (`poco_data_loader.py:318-337`)
        if self.do_data_augmentation:
            rot = math3d.random_rotation_matrix(rng)
            pts_raw = math3d.transform_points(pts_raw, rot)
            normals_raw = math3d.transform_points(
                normals_raw, np.block([[rot[:3, :3], np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])
            )
            if pts_query.shape[0]:
                pts_query = math3d.transform_points(pts_query, rot)

        # manifold subsample (`poco_data_loader.py:354-363`)
        if self.manifold_points is not None:
            replace = pts_raw.shape[0] < self.manifold_points
            choice = rng.choice(pts_raw.shape[0], self.manifold_points, replace=replace)
            pts_ms = pts_raw[choice]
        else:
            pts_ms = pts_raw

        item["pts_ms"] = np.ascontiguousarray(pts_ms, np.float32)
        item["pts_query_ms"] = np.ascontiguousarray(pts_query, np.float32)
        # occupancy class from the *sign* of the distance
        # (`poco_data_loader.py:252-255`)
        item["occ"] = (dist > 0.0).astype(np.int32)
        item["dist_ms"] = dist

        if self.with_raw_cloud:
            r = self.raw_pad_size
            n = min(pts_raw.shape[0], r)
            raw = np.zeros((r, 3), np.float32)
            raw[:n] = pts_raw[:n]
            valid = np.zeros((r,), bool)
            valid[:n] = True
            item["pts_raw_ms"] = raw
            item["raw_valid"] = valid

        return item

    def collate(
        self,
        indices: typing.Sequence[int],
        seeds: typing.Optional[typing.Sequence[int]] = None,
    ) -> typing.Dict[str, np.ndarray]:
        if seeds is None:
            seeds = self.draw_seeds(len(indices))
        items = [self.fetch(i, s) for i, s in zip(indices, seeds)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


class _PrefetchIterator:
    """Bounded multi-worker batch prefetch (ordered delivery).

    Replaces the reference's DataLoader worker processes
    (`configs/device_server.yaml:7` budgets 48/GPU; our host work is only
    load + augment since graph building moved on device, so threads
    suffice — numpy releases the GIL for the heavy parts). Determinism:
    per-item augmentation seeds are drawn SERIALLY at submission time
    (ShapeDataset.draw_seeds), so batches are bit-identical for any
    worker count, including the old single-slot behavior.
    """

    def __init__(self, make_batch, batch_indices, prepare=None, workers=1):
        from concurrent.futures import ThreadPoolExecutor

        self._make_batch = make_batch
        self._prepare = prepare  # serial, ordered; returns extra args
        self._batches = list(batch_indices)
        self._workers = max(1, int(workers))
        self._depth = self._workers + 2
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers, thread_name_prefix="prefetch"
        )
        self._futures = collections.deque()
        self._pos = 0
        # abandoning the iterator mid-epoch (break, exception, early exit)
        # must not leak the non-daemon worker pool + in-flight loads
        self._finalizer = weakref.finalize(
            self, _PrefetchIterator._shutdown_pool, self._pool
        )
        self._top_up()

    @staticmethod
    def _shutdown_pool(pool):
        pool.shutdown(wait=False, cancel_futures=True)

    def close(self):
        self._futures.clear()
        self._finalizer()

    def _top_up(self):
        while (
            self._pos < len(self._batches)
            and len(self._futures) < self._depth
        ):
            idx = self._batches[self._pos]
            extra = self._prepare(idx) if self._prepare is not None else ()
            self._futures.append(self._pool.submit(self._make_batch, idx, *extra))
            self._pos += 1

    def __iter__(self):
        return self

    def __next__(self):
        if not self._futures:
            self._finalizer()
            raise StopIteration
        with span("data.wait"):
            batch = self._futures.popleft().result()
        self._top_up()
        return batch


class OccupancyDataModule:
    """Train/val/test/predict loaders over the dataset-dir conventions.

    Parity: reference `OccupancyDataModule` (`occupancy_data_module.py:88-172`)
    minus the worker processes (graph building is on device) and the
    DistributedSampler (the port trains on one device).
    """

    def __init__(
        self,
        in_file: str,
        batch_size: int = 10,
        manifold_points: int = 10000,
        padding_factor: float = 0.05,
        seed: int = 42,
        do_data_augmentation: bool = True,
        patches_per_shape: typing.Optional[int] = None,
        with_raw_cloud: bool = True,
        workers: int = 0,  # prefetch worker threads (0 -> 1); reference
        # budgets 48 DataLoader processes/GPU (device_server.yaml:7)
    ):
        self.paths = DatasetPaths(in_file)
        self.batch_size = batch_size
        self.manifold_points = manifold_points
        self.padding_factor = padding_factor
        self.seed = seed
        self.do_data_augmentation = do_data_augmentation
        self.patches_per_shape = patches_per_shape
        self.with_raw_cloud = with_raw_cloud
        self.workers = workers

    def _make_dataset(self, in_file, augment, reconstruction=False):
        return ShapeDataset(
            in_file=in_file,
            manifold_points=None if reconstruction else self.manifold_points,
            padding_factor=self.padding_factor,
            seed=self.seed,
            do_data_augmentation=augment,
            with_query_data=not reconstruction,
            with_raw_cloud=self.with_raw_cloud or reconstruction,
            patches_per_shape=self.patches_per_shape,
        )

    def train_dataset(self) -> ShapeDataset:
        return self._make_dataset(self.paths.trainset, self.do_data_augmentation)

    def val_dataset(self) -> ShapeDataset:
        return self._make_dataset(self.paths.valset, False)

    def test_dataset(self) -> ShapeDataset:
        return self._make_dataset(self.paths.testset, False)

    def predict_dataset(self) -> ShapeDataset:
        return self._make_dataset(self.paths.testset, False, reconstruction=True)

    def epoch_batches(
        self, dataset: ShapeDataset, rng: np.random.RandomState, shuffle: bool,
        batch_size: typing.Optional[int] = None, drop_last: bool = False,
    ):
        """Iterate batches of collated numpy dicts with background prefetch."""
        bs = batch_size or self.batch_size
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        # static batch shapes: wrap around to fill the last batch
        if len(order) % bs != 0 and not drop_last:
            pad = bs - len(order) % bs
            order = np.concatenate([order, order[:pad]])
        elif drop_last:
            order = order[: len(order) - len(order) % bs]
        batches = [order[i : i + bs] for i in range(0, len(order), bs)]
        return _PrefetchIterator(
            dataset.collate,
            batches,
            # seeds drawn serially at submission: worker-count-invariant
            prepare=lambda idx: (dataset.draw_seeds(len(idx)),),
            workers=self.workers or 1,
        )
