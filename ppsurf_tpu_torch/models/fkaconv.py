"""FKAConv point-convolution encoder, channels-last.

Port of `ppsurf_tpu/models/fkaconv.py` (reference `source/base/nn.py:420-652`)
with the segmentation head, in both configurations: PPSurf's (SiLU
kernel-net activation, the x4d bug fixed) and POCO's (ReLU, the bug kept:
the global-max bottleneck's output is discarded, `fkaconv.py:251-256`).
Every forward takes `train`: in train mode BatchNorm normalizes with the
batch's statistics and each layer's learned normalization radius (a
buffer, as in the JAX package's `batch_stats`) takes its EMA step before
the layer divides by it (`ppsurf_tpu/models/fkaconv.py:95-106`). The
gathers and the two contractions per layer are plain PyTorch, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import typing

import torch
from torch import nn

from ppsurf_tpu_torch.models.norm import BatchNorm, Dense, InstanceNorm, _param, silu


NORM_RADIUS_MOMENTUM = 0.1  # `fkaconv.py:77`, reference `nn.py:608-613`


def gather_neighbors(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """values (B, N, C), ids (B, M, K) -> (B, M, K, C)."""
    batch = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return values[batch, ids]


def max_pool_neighbors(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Max over gathered neighbors (reference `max_pool`, `nn.py:677-680`),
    as argmax and gather: the gradient goes to the first maximum, as in
    the JAX package (`fkaconv.py:41-52`)."""
    gathered = gather_neighbors(values, ids)  # (B, M, K, C)
    idx = gathered.argmax(dim=2, keepdim=True)
    return torch.gather(gathered, 2, idx)[:, :, 0, :]


def interpolate(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Mean over k gathered neighbors (reference `interpolate`, `nn.py:684-697`)."""
    gathered = gather_neighbors(values, ids.clamp_min(0))
    if ids.shape[-1] > 1:
        return gathered.mean(dim=2)
    return gathered[:, :, 0, :]


class FKAConvLayer(nn.Module):
    """Feature-Kernel-Alignment convolution (reference `nn.py:557-652`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 16,
                 activation: typing.Callable = silu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ks = kernel_size
        self.dtype = dtype
        self.activation = activation
        self.fc1 = Dense(3, ks, use_bias=False, dtype=dtype)
        self.fc2 = Dense(2 * ks, ks, use_bias=False, dtype=dtype)
        self.fc3 = Dense(2 * ks, ks, use_bias=False, dtype=dtype)
        self.bn1 = InstanceNorm(ks, dtype=dtype)
        self.bn2 = InstanceNorm(ks, dtype=dtype)
        self.alpha = _param()
        self.beta = _param()
        self.cv = _param(in_channels, ks, out_channels)
        self.register_buffer("norm_radius", torch.ones(()))

    def forward(self, x, pts, support_points, neighbors_indices, train: bool = False):
        dt = self.dtype
        act = self.activation
        ptsg = gather_neighbors(pts, neighbors_indices)  # (B, M, K, 3)
        xg = gather_neighbors(x, neighbors_indices)  # (B, M, K, C)

        local = ptsg - support_points[:, :, None, :]
        ld = local.detach()  # the distances carry no gradient (`fkaconv.py:90-93`)
        distances = torch.sqrt(torch.clamp((ld * ld).sum(-1), min=0.0))
        if train:
            # EMA of the mean largest neighbour distance, used at once
            with torch.no_grad():
                m = NORM_RADIUS_MOMENTUM
                self.norm_radius.copy_(self.norm_radius * (1.0 - m)
                                       + distances.amax(dim=2).mean() * m)
        local = (local / self.norm_radius).to(dt)

        # sigmoid distance weights (`nn.py:619-624`)
        dw = torch.sigmoid(-self.alpha * distances + self.beta)
        dw_sum = dw.sum(dim=2, keepdim=True)
        dw_sum = dw_sum + (dw_sum == 0.0).float() + 1e-6
        dw = (dw / dw_sum * distances.shape[2]).to(dt)[..., None]

        num_k = neighbors_indices.shape[-1]
        mat = self.fc1(local)
        mat = act(mat if num_k == 1 else self.bn1(mat))
        mp1 = (mat * dw).amax(dim=2, keepdim=True)
        mat = torch.cat([mat, mp1.expand_as(mat)], dim=-1)
        mat = self.fc2(mat)
        mat = act(mat if num_k == 1 else self.bn2(mat))
        mp2 = (mat * dw).amax(dim=2, keepdim=True)
        mat = torch.cat([mat, mp2.expand_as(mat)], dim=-1)
        mat = act(self.fc3(mat)) * dw  # (B, M, K, ksize)

        # (x^T · mat), then the (1, K) conv as one product (`nn.py:647-650`)
        feats = torch.einsum(
            "bmkc,bmkj->bmcj", xg.to(dt).float(), mat.float()
        ).to(dt)
        b, m, c, j = feats.shape
        out = torch.matmul(
            feats.reshape(b, m, c * j).float(),
            self.cv.to(dt).float().reshape(c * j, -1),
        )
        return out.to(dt)


class ResidualBlock(nn.Module):
    """Bottleneck residual block around FKAConv (reference `nn.py:420-450`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 16,
                 activation: typing.Callable = silu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = in_channels // 2
        self.cv0 = Dense(in_channels, half, dtype=dtype)
        self.bn0 = BatchNorm(half, dtype=dtype)
        self.cv1 = FKAConvLayer(half, half, kernel_size, activation, dtype=dtype)
        self.bn1 = BatchNorm(half, dtype=dtype)
        self.cv2 = Dense(half, out_channels, dtype=dtype)
        self.bn2 = BatchNorm(out_channels, dtype=dtype)
        if in_channels != out_channels:
            self.shortcut = Dense(in_channels, out_channels, dtype=dtype)
            self.bn_shortcut = BatchNorm(out_channels, dtype=dtype)
        else:
            self.shortcut = None

    def forward(self, x, pts, support_points, neighbors_indices, train: bool = False):
        h = torch.relu(self.bn0(self.cv0(x), train))
        h = self.cv1(h, pts, support_points, neighbors_indices, train)
        h = torch.relu(self.bn1(h, train))
        h = self.bn2(self.cv2(h), train)

        x_short = x
        if self.shortcut is not None:
            x_short = self.bn_shortcut(self.shortcut(x_short), train)
        if x_short.shape[1] != h.shape[1]:  # downsampling level
            x_short = max_pool_neighbors(x_short, neighbors_indices)
        return torch.relu(h + x_short)


class FKAConvNetwork(nn.Module):
    """Residual FKAConv U-Net with the per-point latent head
    (reference `nn.py:453-554`, segmentation=True). `x4d_bug_fixed=False`
    keeps the reference POCO quirk (`nn.py:530-534`): x4d = x4, while cv5
    and bn5 stay in the weights."""

    def __init__(self, in_channels: int = 3, out_channels: int = 256,
                 hidden: int = 64, activation: typing.Callable = silu,
                 x4d_bug_fixed: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        hd = hidden
        self.dtype = dtype
        self.x4d_bug_fixed = x4d_bug_fixed

        def res(cin, cout):
            return ResidualBlock(cin, cout, 16, activation, dtype=dtype)

        self.cv0 = FKAConvLayer(in_channels, hd, 16, activation, dtype=dtype)
        self.bn0 = BatchNorm(hd, dtype=dtype)
        self.resnetb01 = res(hd, hd)
        self.resnetb10 = res(hd, 2 * hd)
        self.resnetb11 = res(2 * hd, 2 * hd)
        self.resnetb20 = res(2 * hd, 4 * hd)
        self.resnetb21 = res(4 * hd, 4 * hd)
        self.resnetb30 = res(4 * hd, 8 * hd)
        self.resnetb31 = res(8 * hd, 8 * hd)
        self.resnetb40 = res(8 * hd, 16 * hd)
        self.resnetb41 = res(16 * hd, 16 * hd)
        self.cv5 = Dense(32 * hd, 16 * hd, dtype=dtype)
        self.bn5 = BatchNorm(16 * hd, dtype=dtype)
        self.cv3d = Dense(24 * hd, 8 * hd, dtype=dtype)
        self.bn3d = BatchNorm(8 * hd, dtype=dtype)
        self.cv2d = Dense(12 * hd, 4 * hd, dtype=dtype)
        self.bn2d = BatchNorm(4 * hd, dtype=dtype)
        self.cv1d = Dense(6 * hd, 2 * hd, dtype=dtype)
        self.bn1d = BatchNorm(2 * hd, dtype=dtype)
        self.cv0d = Dense(3 * hd, hd, dtype=dtype)
        self.bn0d = BatchNorm(hd, dtype=dtype)
        self.fcout = Dense(hd, out_channels, dtype=dtype)

    def forward(self, data: typing.Dict[str, torch.Tensor],
                train: bool = False) -> torch.Tensor:
        relu = torch.relu
        pts = data["pts"]  # (B, N, 3)
        x = torch.ones_like(pts, dtype=self.dtype)  # reference feeds ones (`nn.py:517`)
        s1, s2, s3, s4 = (data[f"support{i}"] for i in range(1, 5))

        x0 = relu(self.bn0(self.cv0(x, pts, pts, data["ids00"], train), train))
        x0 = self.resnetb01(x0, pts, pts, data["ids00"], train)
        x1 = self.resnetb10(x0, pts, s1, data["ids01"], train)
        x1 = self.resnetb11(x1, s1, s1, data["ids11"], train)
        x2 = self.resnetb20(x1, s1, s2, data["ids12"], train)
        x2 = self.resnetb21(x2, s2, s2, data["ids22"], train)
        x3 = self.resnetb30(x2, s2, s3, data["ids23"], train)
        x3 = self.resnetb31(x3, s3, s3, data["ids33"], train)
        x4 = self.resnetb40(x3, s3, s4, data["ids34"], train)
        x4 = self.resnetb41(x4, s4, s4, data["ids44"], train)

        # global max in f32, then the bottleneck; the reference POCO
        # discards it (`nn.py:533-534`), but in train mode its BatchNorm
        # still updates its running statistics, as in the JAX package
        if self.x4d_bug_fixed or train:
            x5 = x4.float().amax(dim=1, keepdim=True).expand_as(x4).to(x4.dtype)
            x4d = relu(self.bn5(self.cv5(torch.cat([x4, x5], dim=-1)), train))
        if not self.x4d_bug_fixed:
            x4d = x4

        x3d = interpolate(x4d, data["ids43"])
        x3d = relu(self.bn3d(self.cv3d(torch.cat([x3d, x3], dim=-1)), train))
        x2d = interpolate(x3d, data["ids32"])
        x2d = relu(self.bn2d(self.cv2d(torch.cat([x2d, x2], dim=-1)), train))
        x1d = interpolate(x2d, data["ids21"])
        x1d = relu(self.bn1d(self.cv1d(torch.cat([x1d, x1], dim=-1)), train))
        xout = interpolate(x1d, data["ids10"])
        xout = relu(self.bn0d(self.cv0d(torch.cat([xout, x0], dim=-1)), train))
        return self.fcout(xout)
