"""Shared low-level blocks: fp32 GroupNorm, timestep embeddings, NHWC
linear/conv layers and the 3×3 conv with the kernel dispatch.

Counterpart of `sd_tpu/nn/layers.py`. Layout is NHWC as in the TPU package.
Every layer holds its parameters in one dtype (`dtype`) on one device and
casts its input to that dtype, which is what flax's `dtype=` does for the
TPU package's bf16 inference policy (and a no-op in fp32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.kernels import conv2d as conv_k


def _empty(shape, dtype, device, channels_last=False):
    t = torch.empty(shape, dtype=dtype, device=device)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """`nn.Dense`: y = x @ Wᵀ + b with W stored [out, in] (torch layout)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty((out_features, in_features), dtype, device)
        self.bias = _empty((out_features,), dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv2d(nn.Module):
    """`nn.Conv` over NHWC input; weight stored OIHW in channels_last memory
    format (physically [O, kh, kw, C])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty((out_channels, in_channels, kernel_size, kernel_size),
                             dtype, device, channels_last=True)
        self.bias = _empty((out_channels,), dtype, device)
        self.stride = stride
        self.padding = kernel_size // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_k.conv_nhwc(x.to(self.weight.dtype), self.weight, self.bias,
                                self.stride, self.padding)


class Conv3x3(Conv2d):
    """Stride-1 SAME 3×3 conv that dispatches big-spatial shapes to the
    direct-conv kernel (`kernels/conv2d.py`) under the TPU package's shape
    rule, and everything else to the plain conv."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_conv3x3(x, self.weight, self.bias)


def apply_conv3x3(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Functional 3×3 SAME conv with the kernel-vs-plain dispatch."""
    x = x.to(w.dtype)
    if conv_k.conv3x3_wants_pallas(x.shape, x.shape[-1], w.shape[0], x.dtype):
        return conv_k.conv3x3_same_trainable(x, w, b)
    return conv_k._xla_conv3x3(x, w, b)


class GroupNorm32(nn.Module):
    """GroupNorm over the channel (last) axis, computed in fp32 and returned
    in the input dtype. Exactly `num_groups` groups when C divides; otherwise
    the largest divisor of C that keeps >= 2 channels per group (the TPU
    package's fallback for tiny test widths)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        if channels % num_groups == 0:
            groups = num_groups
        else:
            groups = min(num_groups, max(channels // 2, 1))
            while channels % groups != 0:
                groups -= 1
        self.groups = groups
        self.eps = eps
        self.weight = _empty((channels,), dtype, device)
        self.bias = _empty((channels,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        x32 = x.float()
        xr = x32.reshape(x.shape[0], -1, self.groups, C // self.groups)
        mu = xr.mean(dim=(1, 3), keepdim=True)
        var = (xr * xr).mean(dim=(1, 3), keepdim=True) - mu * mu
        y = (xr - mu) * torch.rsqrt(var + self.eps)
        y = y.reshape(x.shape) * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis computed in fp32, returned in the input
    dtype (flax's default eps of 1e-6 unless given)."""

    def __init__(self, features: int, eps: float = 1e-6, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty((features,), dtype, device)
        self.bias = _empty((features,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True) -> torch.Tensor:
    """Sinusoidal timestep embeddings [N, dim] in fp32; cat([cos, sin]) with
    `flip_sin_to_cos=True` (the default), else cat([sin, cos])."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    else:
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def zeros_init_conv(in_channels: int, out_channels: int, kernel_size: int = 3,
                    *, dtype=torch.float32, device=None) -> Conv2d:
    """Conv whose kernel and bias start at zero (`init_params_` honours the
    `zero_init` mark)."""
    conv = Conv2d(in_channels, out_channels, kernel_size, dtype=dtype,
                  device=device)
    conv.zero_init = True
    return conv
