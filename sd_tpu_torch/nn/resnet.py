"""Residual blocks: the codec (CompVis) variant and the SD-UNet variant.

Counterpart of `sd_tpu/nn/resnet.py`. `ResnetBlock` carries the optional
time-embedding input of the pixel-space DDPM UNet. `ResBlockSD` is ported
on the SD-v1 path only: no scale-shift norm, no built-in up/down-sampling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.nn.layers import (Conv2d, Conv3x3, Dense, GroupNorm32,
                                    zeros_init_conv)


class ResnetBlock(nn.Module):
    """Codec / DDPM resblock: GN(eps 1e-6) → swish → conv1, plus the
    projected time embedding when `temb_channels` is set (`temb_proj`, the
    pixel-space DDPM UNet's), GN → swish → dropout → conv2, 1×1
    `nin_shortcut` when the width changes. Both 3×3 convs dispatch to the
    direct-conv kernel at the big decoder levels. Dropout is the identity at
    0 (every config) and outside training; a training forward with
    `dropout > 0` raises (its masks cannot be held against the TPU
    package's)."""

    def __init__(self, in_channels: int, out_channels: int | None = None, *,
                 temb_channels: int | None = None, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        out_channels = out_channels or in_channels
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm32(in_channels, 32, eps=1e-6, **kw)
        self.conv1 = Conv3x3(in_channels, out_channels, **kw)
        self.temb_proj = (Dense(temb_channels, out_channels, **kw)
                          if temb_channels is not None else None)
        self.norm2 = GroupNorm32(out_channels, 32, eps=1e-6, **kw)
        self.conv2 = Conv3x3(out_channels, out_channels, **kw)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1, **kw)
                             if in_channels != out_channels else None)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, None, None, :]
        h = F.silu(self.norm2(h))
        if self.dropout > 0 and self.training:
            raise NotImplementedError(
                "ResnetBlock dropout > 0 in training is not ported yet (ROADMAP Queue 1)")
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class ResBlockSD(nn.Module):
    """SD-UNet resblock: GN → silu → conv, + time embedding, GN → silu →
    zero-init conv, 1×1 `skip` when the width changes."""

    def __init__(self, in_channels: int, emb_channels: int,
                 out_channels: int | None = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        out_channels = out_channels or in_channels
        kw = dict(dtype=dtype, device=device)
        self.in_norm = GroupNorm32(in_channels, 32, **kw)
        self.in_conv = Conv2d(in_channels, out_channels, 3, **kw)
        self.emb_proj = Dense(emb_channels, out_channels, **kw)
        self.out_norm = GroupNorm32(out_channels, 32, **kw)
        self.out_conv = zeros_init_conv(out_channels, out_channels, **kw)
        self.skip = (Conv2d(in_channels, out_channels, 1, **kw)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, None, None, :]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h
