"""Per-shape reconstruction driver.

Port of `ppsurf_tpu/recon/predict.py` (reference `PocoModel.predict_step`,
`source/poco_model.py:183-273`): latent accumulation over the full cloud,
region-grown field evaluation, marching cubes, bisection refinement of the
vertices, mesh cleanup; `predict_dataset` runs it over a dataset or one
cloud file and writes each mesh where the JAX package writes it.
"""
from __future__ import annotations

import os
import time
import typing

import numpy as np
import torch

from ppsurf_tpu_torch.convert.infer_npz import load_infer_npz, load_network
from ppsurf_tpu_torch.data.datasets import ShapeDataset, get_results_dir, in_file_is_dataset
from ppsurf_tpu_torch.device import resolve_device
from ppsurf_tpu_torch.io.ply import Mesh
from ppsurf_tpu_torch.io.point_cloud import load_pts, pre_process_pts
from ppsurf_tpu_torch.parallel.mesh import get_data_mesh, is_distributed
from ppsurf_tpu_torch.recon.engine import reconstruct_mesh
from ppsurf_tpu_torch.recon.field import EncoderDraws, FieldEvaluator, LatentEncoder, Transform
from ppsurf_tpu_torch.train.model import ModelSpec, ppsurf_spec
from ppsurf_tpu_torch.utils import math3d
from ppsurf_tpu_torch.utils.alloc import freeze_gc

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "models_pretrained", "ppsurf_mini_infer.npz",
)


class Predictor:
    """Reconstructs normalized point clouds with one network (PPSurf or
    POCO, after `spec.kind`).

    Weights come from `variables` (a nested JAX-style tree), else the
    inference `.npz` at `weights`, else, for PPSurf, the committed
    `DEFAULT_WEIGHTS` (its PointNet takes any patch size, so they serve
    every `num_pts_local`); no POCO weights are committed. device defaults
    to CUDA and raises if none is present; pass device='cpu' to run the
    plain PyTorch path. `devices` shards the field's query chunks over
    the first that many local devices of `device`'s type
    (`recon/field.py`), clamped to those present, as
    `ppsurf_tpu/recon/predict.py:36-53`; None or 1, or a process group
    (one device a rank), evaluates on `device` alone.
    """

    def __init__(self, spec: typing.Optional[ModelSpec] = None,
                 variables: typing.Optional[dict] = None,
                 weights: typing.Optional[str] = None,
                 device: typing.Union[str, torch.device, None] = None,
                 verbose: bool = True, devices: typing.Optional[int] = None):
        self.device = resolve_device(device)
        self.devices = None  # the sharded field's devices
        if devices is not None and not is_distributed():  # a rank drives one device
            local = get_data_mesh(devices, self.device).devices  # clamped to those present
            if len(local) > 1:
                self.devices = list(local)
                self.device = self.devices[0]
        self.spec = spec or ppsurf_spec()
        if variables is None:
            if weights is None and not self.spec.is_ppsurf:
                raise ValueError(f"no weights for the {self.spec.kind} network: pass "
                                 "`variables` or an inference .npz as `weights`")
            variables = load_infer_npz(weights or DEFAULT_WEIGHTS)
        self.net = load_network(self.spec, variables, self.device)
        self.encoder = LatentEncoder(self.net, self.spec)
        self.verbose = verbose
        self.last_evaluator: typing.Optional[FieldEvaluator] = None

    def _progress(self, msg: str) -> None:
        if self.verbose:
            print(f"  [rec] {msg}", flush=True)

    @torch.inference_mode()
    def reconstruct_shape(
        self,
        pts_raw: np.ndarray,
        seed: int = 42,
        resolution: typing.Optional[int] = None,
        generator: typing.Optional[torch.Generator] = None,
        draws: typing.Optional[EncoderDraws] = None,
        transform: typing.Optional[Transform] = None,
        timings: typing.Optional[typing.Dict[str, float]] = None,
    ) -> typing.Optional[Mesh]:
        """Reconstruct one (normalized) cloud -> mesh in normalized space,
        or None when the field never crosses zero.

        The encoder's random draws come from `draws`, else `generator`,
        else a generator on the device seeded with `seed`. `timings`
        receives host-clock seconds per phase."""
        spec = self.spec
        marks = {} if timings is None else timings
        pts_raw = np.ascontiguousarray(pts_raw, np.float32)
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        pts = torch.from_numpy(pts_raw).to(self.device)
        latents = self.encoder(pts, generator=generator, draws=draws)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        marks["encode"] = time.perf_counter() - t0
        self._progress(f"latents for {pts_raw.shape[0]} pts in {marks['encode']:.2f}s")

        evaluator = FieldEvaluator(self.net, spec, pts_raw, latents, transform=transform,
                                   devices=self.devices)
        self.last_evaluator = evaluator
        # the live object graph out of gen-2 collections, which would
        # otherwise fire inside the host phases' numpy allocations
        freeze_gc()
        return reconstruct_mesh(
            evaluator,
            input_points=pts_raw,
            resolution=resolution or spec.gen_resolution_global,
            padding=1,
            mc_value=0.0,
            refine_iter=spec.gen_refine_iter,
            out_value=1.0,
            progress=self._progress if self.verbose else None,
            refine_device=evaluator.refine_bisection,
            timings=marks,
            device=self.device,
        )

    def predict_dataset(self, dataset: ShapeDataset,
                        results_dir: typing.Optional[str] = None, seed: int = 42,
                        ) -> typing.List[typing.Tuple[str, typing.Optional[str], float]]:
        """Reconstruct every shape and write its mesh
        (`ppsurf_tpu/recon/predict.py:111-165`); returns (name, out_file or
        None, seconds) a shape.

        A dataset `.txt` writes `<results_dir or
        spec.results_dir/spec.name/dataset>/meshes/<shape>.xyz.ply` in the
        normalized space of its clouds; a single cloud file writes
        `<results_dir or spec.results_dir>/<base>/<base>.ply`, the base name
        keeping its extension, in the input's coordinates."""
        spec = self.spec
        in_file = dataset.in_file
        results = []
        for idx, name in enumerate(dataset.shape_names):
            t0 = time.perf_counter()
            pts_raw, _ = dataset.load_raw_shape(idx)
            if in_file_is_dataset(in_file):
                rdir = results_dir or get_results_dir(spec.results_dir, spec.name, in_file)
                out_file = os.path.join(rdir, "meshes", os.path.basename(name) + ".xyz.ply")
            else:
                base = os.path.basename(in_file)
                out_file = os.path.join(results_dir or spec.results_dir, base, base + ".ply")

            if os.path.isfile(os.path.dirname(out_file)):
                # e.g. `rec cloud.ply <cloud's dir>`: <dir>/cloud.ply is the input
                raise FileExistsError(f"{os.path.dirname(out_file)} is a file: cannot "
                                      f"write {out_file}")
            mesh = self.reconstruct_shape(pts_raw, seed=seed)
            if mesh is None:
                print(f"No reconstruction for {name}")
                results.append((name, None, time.perf_counter() - t0))
                continue
            if not in_file_is_dataset(in_file):
                # de-normalize single-file inputs (`poco_model.py:256-265`)
                pts_orig, _ = pre_process_pts(load_pts(in_file))
                center, scale = math3d.get_points_normalization_info(
                    pts_orig, spec.padding_factor)
                mesh = Mesh(
                    vertices=math3d.denormalize_points_with_info(
                        mesh.vertices.astype(np.float64), center, scale
                    ).astype(np.float32),
                    faces=mesh.faces,
                )
            os.makedirs(os.path.dirname(out_file), exist_ok=True)
            mesh.export(out_file)
            seconds = time.perf_counter() - t0
            self._progress(f"{name}: {seconds:.2f}s -> {out_file}")
            results.append((name, out_file, seconds))
        return results
