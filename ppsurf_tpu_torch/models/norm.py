"""Dense and normalization layers with the JAX package's numerics.

Parameters carry the flax names (`kernel`, `bias`, `scale`, `mean`,
`var`) so `convert.from_jax_variables` maps weights one to one.

- `dense`: flax `nn.Dense(dtype=dt)` — input and kernel are rounded to dt
  (flax's `promote_dtype`), the product accumulates in f32 and rounds to
  dt, then the bias is added in dt. Kernels are (in, out).
- `silu`: `jax.nn.silu` as XLA evaluates its ops, each rounded to dt.
- `softmax`: `jax.nn.softmax` on a dt tensor — shift, exp, sum and the
  division each round to dt; the sum accumulates in f32.
- `BatchNorm`: torch BatchNorm1d over channels-last tensors
  (`ppsurf_tpu/models/norm.py:21-66`). In train mode the statistics of the
  batch, over all non-channel axes in f32 with the biased variance, both
  normalize and update the running statistics in place
  (new = 0.9*old + 0.1*batch); in eval mode the running statistics are
  folded as `x*inv + (bias - mean*inv)` in f32. The result is cast to dt.
- `InstanceNorm`: affine instance norm with its statistics in f32, used by
  the FKAConv kernel-weight net.
"""
from __future__ import annotations

import typing

import torch
from torch import nn


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: typing.Optional[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """`x @ kernel` of dt-rounded operands, accumulated in f32 and rounded
    to dt, plus the bias in dt."""
    y = torch.matmul(x.to(dt).float(), kernel.to(dt).float()).to(dt)
    if bias is not None:
        y = (y.float() + bias.to(dt).float()).to(dt)
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`, x * (1 / (1 + exp(-x))), each of the four operations
    rounded to x's dtype, as the JAX package's bf16 graph computes it
    (torch's fused `F.silu` rounds once and differs in 39% of bf16
    outputs)."""
    dt = x.dtype
    f = x.float()
    e = torch.exp(-f).to(dt).float()
    s = (1.0 / (1.0 + e).to(dt).float()).to(dt).float()
    return (f * s).to(dt)


def softmax(x: torch.Tensor, dim: int, dt: torch.dtype) -> torch.Tensor:
    """Softmax of x along dim in the compute dtype dt, returned as f32
    holding dt values; entries of -inf get weight 0."""
    x = x.float()
    # the shift carries no gradient, as jax.nn.softmax's stop_gradient
    d = (x - x.amax(dim=dim, keepdim=True).detach()).to(dt).float()
    e = torch.exp(d).to(dt).float()
    return (e / e.sum(dim=dim, keepdim=True).to(dt).float()).to(dt).float()


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(in_features, out_features)
        self.bias = _param(out_features) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias, self.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis."""

    MOMENTUM = 0.1  # torch's; flax's 0.9 in the JAX package

    def __init__(self, num_ch: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = _param(num_ch)
        self.bias = _param(num_ch)
        self.register_buffer("mean", torch.zeros(num_ch))
        self.register_buffer("var", torch.ones(num_ch))

    def folded(self) -> typing.Tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift) with y = x*inv + shift, both f32."""
        inv = self.scale.float() * torch.rsqrt(self.var.float() + self.epsilon)
        return inv, self.bias.float() - self.mean.float() * inv

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            inv, shift = self.folded()
            return (x.float() * inv + shift).to(self.dtype)
        x32 = x.float()
        axes = tuple(range(x.dim() - 1))
        mean = x32.mean(dim=axes)
        var = x32.var(dim=axes, unbiased=False)
        with torch.no_grad():
            m = self.MOMENTUM
            self.mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.var.mul_(1.0 - m).add_(var.detach() * m)
        inv = self.scale * torch.rsqrt(var + self.epsilon)
        return (x32 * inv + (self.bias - mean * inv)).to(self.dtype)


class InstanceNorm(nn.Module):
    """Affine instance norm over all axes except batch (0) and channel (-1)."""

    def __init__(self, num_ch: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = _param(num_ch)
        self.bias = _param(num_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        x32 = x.float()
        mean = x32.mean(dim=axes, keepdim=True)
        var = x32.var(dim=axes, keepdim=True, unbiased=False)
        y = (x32 - mean) / torch.sqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(self.dtype)
