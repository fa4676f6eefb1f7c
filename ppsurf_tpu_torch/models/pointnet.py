"""PointNet local-patch encoder with feature STN and attention pooling.

Port of `ppsurf_tpu/models/pointnet.py` (reference `source/base/nn.py:72-417`)
in the PPSurf configuration only: PointNetfeat(use_point_stn=False,
use_feat_stn=True, sym_op='att'), plus the 3-layer constant-width MLP head
with dropout. The modules hold the weights under the flax names. The eval
forward pass of `PointNetfeat` is `ops.pointnet_att` (kernels K4/K5 on
CUDA tensors, their plain versions on CPU tensors); in train mode it runs
`forward_plain`, the modules' own differentiable forward, with BatchNorm
on the batch's statistics.
"""
from __future__ import annotations

import typing

import torch
from torch import nn

from ppsurf_tpu_torch.models.norm import BatchNorm, Dense, softmax
from ppsurf_tpu_torch.ops.pointnet_att import pointnet_att, pointnet_tables


def _dense_bn_relu(dense: Dense, bn: BatchNorm, x: torch.Tensor, train: bool) -> torch.Tensor:
    return torch.relu(bn(dense(x), train))


class STN(nn.Module):
    """Feature spatial transformer predicting a (dim x dim) matrix
    (reference `nn.py:133-190`, one scale)."""

    def __init__(self, net_size_max: int = 1024, dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half, quarter = net_size_max // 2, net_size_max // 4
        self.conv1 = Dense(dim, 64, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        self.conv2 = Dense(64, 128, dtype=dtype)
        self.bn2 = BatchNorm(128, dtype=dtype)
        self.conv3 = Dense(128, net_size_max, dtype=dtype)
        self.bn3 = BatchNorm(net_size_max, dtype=dtype)
        self.fc1 = Dense(net_size_max, half, dtype=dtype)
        self.bn4 = BatchNorm(half, dtype=dtype)
        self.fc2 = Dense(half, quarter, dtype=dtype)
        self.bn5 = BatchNorm(quarter, dtype=dtype)
        self.fc3 = Dense(quarter, dim * dim, dtype=dtype)
        self.dim = dim

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, N, dim) -> (B, dim, dim): the predicted matrix plus the
        identity, in the compute dtype."""
        h = _dense_bn_relu(self.conv1, self.bn1, x, train)
        h = _dense_bn_relu(self.conv2, self.bn2, h, train)
        h = _dense_bn_relu(self.conv3, self.bn3, h, train).amax(dim=1)  # symmetric op
        h = _dense_bn_relu(self.fc1, self.bn4, h, train)
        h = _dense_bn_relu(self.fc2, self.bn5, h, train)
        h = self.fc3(h)
        eye = torch.eye(self.dim, device=h.device).reshape(1, -1)
        return (h.float() + eye).to(h.dtype).reshape(-1, self.dim, self.dim)


class AttentionPool(nn.Module):
    """Scalar-logit attention pooling over points (reference
    `AttentionPoco`, `nn.py:72-96`)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_query = Dense(channels, 1, dtype=dtype)
        self.fc_value = Dense(channels, channels, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, C) -> (B, C): softmax over the N points of a scalar
        logit, the values weighted and summed in f32."""
        dt = self.dtype
        weights = softmax(self.fc_query(x), 1, dt)  # (B, N, 1)
        return (weights * self.fc_value(x).float()).sum(dim=1).to(dt)


class PointNetfeat(nn.Module):
    """PointNet feature extractor (reference `nn.py:255-373`), PPSurf
    configuration. forward: (B, N, 3) patches -> (B, output_size)."""

    def __init__(self, net_size_max: int = 256, output_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0a = Dense(3, 64, dtype=dtype)
        self.bn0a = BatchNorm(64, dtype=dtype)
        self.conv0b = Dense(64, 64, dtype=dtype)
        self.bn0b = BatchNorm(64, dtype=dtype)
        self.stn2 = STN(net_size_max, dim=64, dtype=dtype)
        self.conv1 = Dense(64, 64, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        self.conv2 = Dense(64, 128, dtype=dtype)
        self.bn2 = BatchNorm(128, dtype=dtype)
        self.conv3 = Dense(128, output_size, dtype=dtype)
        self.bn3 = BatchNorm(output_size, dtype=dtype)
        self.att = AttentionPool(output_size, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            return self.forward_plain(x, train=True)
        return pointnet_att(x.to(self.dtype), pointnet_tables(self))

    def forward_plain(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The modules' own forward (`ppsurf_tpu/models/pointnet.py:151-217`),
        differentiable, BatchNorm in train or eval mode."""
        x = x.to(self.dtype)
        x = _dense_bn_relu(self.conv0a, self.bn0a, x, train)
        x = _dense_bn_relu(self.conv0b, self.bn0b, x, train)
        trans = self.stn2(x, train)
        # einsum('bij,bnj->bni'): the rows of x through the transform
        x = torch.matmul(x.float(), trans.float().transpose(1, 2)).to(self.dtype)
        x = _dense_bn_relu(self.conv1, self.bn1, x, train)
        x = _dense_bn_relu(self.conv2, self.bn2, x, train)
        x = self.bn3(self.conv3(x), train)
        return self.att(x)


Masks = typing.Sequence[torch.Tensor]


class MLP(nn.Module):
    """Dense stack with BN + ReLU + dropout, constant width (reference
    `nn.py:376-417`, halving_size=False).

    Dropout acts in train mode only, as flax `nn.Dropout`: kept entries
    divided by the keep rate, the rest zero. Its keep masks (one bool
    tensor per hidden layer, shaped as its output) are given as `masks`,
    else drawn from `generator`, else from torch's global generator."""

    def __init__(self, input_size: int, output_size: int, num_layers: int = 3,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        for i in range(num_layers - 1):
            setattr(self, f"fc{i}", Dense(input_size, input_size, dtype=dtype))
            setattr(self, f"bn{i}", BatchNorm(input_size, dtype=dtype))
        self.fc_final = Dense(input_size, output_size, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: typing.Optional[torch.Generator] = None,
                masks: typing.Optional[Masks] = None) -> torch.Tensor:
        keep = 1.0 - self.dropout
        for i in range(self.num_layers - 1):
            x = _dense_bn_relu(getattr(self, f"fc{i}"), getattr(self, f"bn{i}"), x, train)
            if train and self.dropout > 0.0:
                mask = masks[i] if masks is not None else torch.rand(
                    x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.fc_final(x)
