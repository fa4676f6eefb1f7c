"""PPSurf network: global POCO branch + local PointNet branch, sum-fused.

Port of `ppsurf_tpu/models/ppsurf.py` (reference `source/ppsurf_model.py:39-117`):
FKAConv encoder (SiLU, x4d bug fixed), InterpAttentionKHeadsNet
projection (latent -> latent), PointNetfeat over per-query local patches,
sum fusion and the 3-layer MLP (dropout 0.3) to two logits. `forward(data,
train)` runs all of it under autograd; the `feat_proj`/`feat_pn` and
`latents_projected` shortcuts of `from_latent` serve inference only.
"""
from __future__ import annotations

import typing

import torch
from torch import nn

from ppsurf_tpu_torch.models.decoder import InterpAttentionKHeadsNet
from ppsurf_tpu_torch.models.fkaconv import FKAConvNetwork
from ppsurf_tpu_torch.models.norm import silu
from ppsurf_tpu_torch.models.pointnet import MLP, Masks, PointNetfeat


class PPSurfNetwork(nn.Module):
    def __init__(self, in_channels: int = 3, latent_size: int = 256,
                 out_channels: int = 2, k: int = 64, num_pts_local: int = 50,
                 pointnet_latent_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.k = k
        self.num_pts_local = num_pts_local
        self.encoder = FKAConvNetwork(in_channels, latent_size, activation=silu,
                                      dtype=dtype)
        self.projection = InterpAttentionKHeadsNet(latent_size, latent_size, k,
                                                   dtype=dtype)
        self.point_net = PointNetfeat(pointnet_latent_size, latent_size, dtype=dtype)
        self.mlp = MLP(latent_size, out_channels, num_layers=3, dropout=0.3, dtype=dtype)

    def forward(self, data: typing.Dict[str, torch.Tensor], train: bool = False,
                generator: typing.Optional[torch.Generator] = None,
                masks: typing.Optional[Masks] = None) -> torch.Tensor:
        """data: `get_latent`'s and `from_latent`'s inputs -> (B, Q, 2)
        logits; `generator`/`masks` feed the MLP's dropout in train mode."""
        data = dict(data, latents=self.encoder(data, train))
        return self.from_latent(data, train, generator, masks)

    def get_latent(self, data: typing.Dict[str, torch.Tensor],
                   train: bool = False) -> torch.Tensor:
        """data: pts (B, N, 3) and the FKAConv graph -> (B, N, L) latents."""
        return self.encoder(data, train)

    def from_latent(self, data: typing.Dict[str, torch.Tensor], train: bool = False,
                    generator: typing.Optional[torch.Generator] = None,
                    masks: typing.Optional[Masks] = None) -> torch.Tensor:
        """Decoder + local branch from precomputed latents -> (B, Q, 2) logits.

        Needs latents (B, N, L), pts (B, N, 3), pts_query (B, Q, 3),
        proj_ids (B, Q, k), pts_local_ps (B, Q, P, 3); a precomputed
        `feat_proj` or `feat_pn` (B, Q, L) replaces its branch.
        """
        feat_proj = data.get("feat_proj")
        if feat_proj is None:
            feat_proj = self.projection(
                data["latents"], data["pts"], data["pts_query"], data["proj_ids"],
                last_layer=True,
                latents_projected=bool(data.get("latents_projected", False)),
            )
        feat_pn = data.get("feat_pn")
        if feat_pn is None:
            pts_local = data["pts_local_ps"]
            b, q, p, _ = pts_local.shape
            feat_pn = self.point_net(pts_local.reshape(b * q, p, 3), train).reshape(b, q, -1)
        feat_all = feat_proj + feat_pn  # sum fusion (`ppsurf_model.py:100`)
        b, q, _ = feat_all.shape
        logits = self.mlp(feat_all.reshape(b * q, -1), train, generator, masks)
        return logits.reshape(b, q, -1)
