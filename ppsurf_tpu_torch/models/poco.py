"""POCO network: FKAConv encoder + interpolation-attention decoder.

Port of `ppsurf_tpu/models/poco.py:22-68` (reference `PocoNetwork`,
`source/poco_model.py:332-359`): the FKAConv encoder in the
reference POCO configuration (ReLU kernel-net activation, the x4d bug
kept, `ppsurf_tpu/models/fkaconv.py:199, 251-256`) and the
InterpAttentionKHeadsNet decoder at the latent width (32), 64 heads, with
fc8 going straight to the two logits. `forward(data, train)` runs both
under autograd; `from_latent`'s shortcuts serve inference only.
"""
from __future__ import annotations

import typing

import torch
from torch import nn

from ppsurf_tpu_torch.models.decoder import InterpAttentionKHeadsNet
from ppsurf_tpu_torch.models.fkaconv import FKAConvNetwork


class PocoNetwork(nn.Module):
    def __init__(self, in_channels: int = 3, latent_size: int = 32,
                 out_channels: int = 2, k: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.k = k
        self.encoder = FKAConvNetwork(in_channels, latent_size, activation=torch.relu,
                                      x4d_bug_fixed=False, dtype=dtype)
        self.projection = InterpAttentionKHeadsNet(latent_size, out_channels, k,
                                                   dtype=dtype)

    def forward(self, data: typing.Dict[str, torch.Tensor], train: bool = False,
                generator: typing.Optional[torch.Generator] = None,
                masks=None) -> torch.Tensor:
        """data: pts, the FKAConv graph, pts_query and proj_ids -> (B, Q, 2)
        logits. POCO has no dropout: `generator` and `masks` are unused."""
        latents = self.encoder(data, train)
        return self.projection(latents, data["pts"], data["pts_query"], data["proj_ids"],
                               last_layer=True)

    def get_latent(self, data: typing.Dict[str, torch.Tensor],
                   train: bool = False) -> torch.Tensor:
        """data: pts (B, N, 3) and the FKAConv graph -> (B, N, L) latents."""
        return self.encoder(data, train)

    def from_latent(self, data: typing.Dict[str, torch.Tensor]) -> torch.Tensor:
        """Decoder from precomputed latents -> (B, Q, 2) logits.

        Needs latents (B, N, L), pts (B, N, 3), pts_query (B, Q, 3) and
        proj_ids (B, Q, k); a precomputed `feat_proj` (the decoder tail and
        fc8, as `FieldEvaluator` computes them) is returned as it is.
        """
        feat_proj = data.get("feat_proj")
        if feat_proj is not None:
            return feat_proj
        return self.projection(
            data["latents"], data["pts"], data["pts_query"], data["proj_ids"],
            last_layer=True,
            latents_projected=bool(data.get("latents_projected", False)),
        )
