"""Model specification of the port: network factory and step-side data
assembly.

Mirrors `ppsurf_tpu.train.model.ModelSpec` (`ppsurf_tpu/train/model.py:29-94`,
reference `configs/poco.yaml:41-59` + `configs/ppsurf.yaml:4-13`) for the
two network kinds, POCO and PPSurf. `assemble_step_data` builds a batch's
FKAConv graphs, decoder ids and (PPSurf) patches on the batch's device,
every kNN through K1 on a card: 15 calls a cloud for PPSurf (13 for the
graph, 1 for the decoder ids, 1 masked call on the padded raw cloud for
the patches), 14 for POCO.
"""
from __future__ import annotations

import dataclasses
import typing

import torch
from torch import nn

from ppsurf_tpu_torch.models.poco import PocoNetwork
from ppsurf_tpu_torch.models.ppsurf import PPSurfNetwork
from ppsurf_tpu_torch.ops.graph import (
    Draws, build_fkaconv_graph_batch, build_proj_ids_batch, draw_graph,
)
from ppsurf_tpu_torch.ops.patches import extract_local_patches_batch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model configuration."""

    name: str = "ppsurf"
    kind: str = "ppsurf"  # 'poco' | 'ppsurf'
    in_channels: int = 3
    out_channels: int = 2
    k: int = 64  # decoder neighborhood
    network_latent_size: int = 256
    pointnet_latent_size: int = 256
    num_pts_local: typing.Optional[int] = 50  # None for POCO
    gen_subsample_manifold: int = 10000
    gen_subsample_manifold_iter: int = 10
    gen_resolution_global: int = 257
    rec_batch_size: int = 50000
    gen_refine_iter: int = 10
    output_names: typing.Tuple[str, ...] = ("imp_surf_sign",)
    results_dir: str = "results"
    padding_factor: float = 0.05
    dtype: torch.dtype = torch.float32

    @property
    def is_ppsurf(self) -> bool:
        return self.kind == "ppsurf"

    def make_network(self) -> nn.Module:
        if self.is_ppsurf:
            return PPSurfNetwork(
                in_channels=self.in_channels,
                latent_size=self.network_latent_size,
                out_channels=self.out_channels,
                k=self.k,
                num_pts_local=self.num_pts_local,
                pointnet_latent_size=self.pointnet_latent_size,
                dtype=self.dtype,
            )
        return PocoNetwork(
            in_channels=self.in_channels,
            latent_size=self.network_latent_size,
            out_channels=self.out_channels,
            k=self.k,
            dtype=self.dtype,
        )

    @staticmethod
    def draw_step(batch_size: int, n: int, generator: torch.Generator,
                  device: torch.device) -> typing.List[Draws]:
        """The subsampling draws of a step's graphs: one cloud's per item."""
        return [draw_graph(n, generator, device) for _ in range(batch_size)]

    def assemble_step_data(self, batch: typing.Dict[str, torch.Tensor],
                           draws: typing.Sequence[Draws]) -> typing.Dict[str, torch.Tensor]:
        """The network's inputs for one training or evaluation step
        (`ppsurf_tpu/train/model.py:72-94`, replacing the reference's
        DataLoader workers, `poco_data_loader.py:243-270` and
        `ppsurf_data_loader.py:61-89`): batch tensors pts_ms (B, N, 3),
        pts_query_ms (B, Q, 3) and, for PPSurf, pts_raw_ms (B, R, 3) with
        raw_valid (B, R); `draws` from `draw_step`."""
        pts = batch["pts_ms"]
        pts_query = batch["pts_query_ms"]
        data = {"pts": pts, "pts_query": pts_query}
        data.update(build_fkaconv_graph_batch(pts, draws))
        data["proj_ids"] = build_proj_ids_batch(pts, pts_query, self.k)
        if self.is_ppsurf:
            data["pts_local_ps"] = extract_local_patches_batch(
                batch["pts_raw_ms"], batch["raw_valid"], pts_query, self.num_pts_local)
        return data


def poco_spec(**overrides) -> ModelSpec:
    """POCO baseline configuration (reference `configs/poco.yaml`)."""
    defaults = dict(name="poco", kind="poco", network_latent_size=32, num_pts_local=None)
    defaults.update(overrides)
    return ModelSpec(**defaults)


def ppsurf_spec(**overrides) -> ModelSpec:
    """PPSurf configuration (reference `configs/ppsurf.yaml` +
    `configs/ppsurf_50nn.yaml`)."""
    defaults = dict(name="ppsurf_50nn", kind="ppsurf", network_latent_size=256,
                    pointnet_latent_size=256, num_pts_local=50)
    defaults.update(overrides)
    return ModelSpec(**defaults)
