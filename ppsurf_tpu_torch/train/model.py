"""Model specification of the port (inference only).

Mirrors `ppsurf_tpu.train.model.ModelSpec` (`ppsurf_tpu/train/model.py:29-51`,
reference `configs/poco.yaml:41-59` + `configs/ppsurf.yaml:4-13`) for the
two network kinds, POCO and PPSurf; the training-side data assembly stays
in the JAX package until training is ported.
"""
from __future__ import annotations

import dataclasses
import typing

import torch
from torch import nn

from ppsurf_tpu_torch.models.poco import PocoNetwork
from ppsurf_tpu_torch.models.ppsurf import PPSurfNetwork


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
