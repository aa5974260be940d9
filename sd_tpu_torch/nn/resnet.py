"""Residual blocks: the codec (CompVis) variant and the SD-UNet variant.

Counterpart of `sd_tpu/nn/resnet.py`. `ResnetBlock` carries the optional
time-embedding input of the pixel-space DDPM UNet. `ResBlockSD` carries the
guided-diffusion options: scale-shift ("AdaGN") conditioning, built-in
up/down-sampling (the UNet's `resblock_updown`) and a 3×3 skip. Both drop
at the TPU package's site (`dropout`, after the second GN → silu) inside a
training step's `dropout_rng`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.nn.layers import (Conv2d, Conv3x3, Dense, GroupNorm32, dropout,
                                    zeros_init_conv)
from sd_tpu_torch.nn.updown import avg_pool_2x, nearest_upsample_2x


class ResnetBlock(nn.Module):
    """Codec / DDPM resblock: GN(eps 1e-6) → swish → conv1, plus the
    projected time embedding when `temb_channels` is set (`temb_proj`, the
    pixel-space DDPM UNet's), GN → swish → dropout → conv2, 1×1
    `nin_shortcut` when the width changes. Both 3×3 convs dispatch to the
    direct-conv kernel at the big decoder levels."""

    def __init__(self, in_channels: int, out_channels: int | None = None, *,
                 temb_channels: int | None = None, dropout: float = 0.0,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        out_channels = out_channels or in_channels
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
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
        h = dropout(F.silu(self.norm2(h)), self.dropout, self)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class ResBlockSD(nn.Module):
    """SD-UNet resblock: GN → silu (→ nearest-2× `up` or 2×2-average `down`
    of both branches) → conv, then the time embedding: added before GN →
    silu, or with `use_scale_shift_norm` projected to 2·out and applied as
    GN(h)·(1 + scale) + shift before the silu; → zero-init conv. The skip is
    a 1×1 (3×3 with `use_conv_skip`) `skip` conv when the width changes."""

    def __init__(self, in_channels: int, emb_channels: int,
                 out_channels: int | None = None, *, use_scale_shift_norm: bool = False,
                 up: bool = False, down: bool = False, use_conv_skip: bool = False,
                 dropout: float = 0.0, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        out_channels = out_channels or in_channels
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dropout = dropout
        self.resample = (nearest_upsample_2x if up else avg_pool_2x if down else None)
        self.in_norm = GroupNorm32(in_channels, 32, **kw)
        self.in_conv = Conv2d(in_channels, out_channels, 3, **kw)
        self.emb_proj = Dense(emb_channels, (2 if use_scale_shift_norm else 1) * out_channels,
                              **kw)
        self.out_norm = GroupNorm32(out_channels, 32, **kw)
        self.out_conv = zeros_init_conv(out_channels, out_channels, **kw)
        self.skip = (Conv2d(in_channels, out_channels, 3 if use_conv_skip else 1, **kw)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_norm(x))
        if self.resample is not None:
            h, x = self.resample(h), self.resample(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + emb_out)
        h = self.out_conv(dropout(F.silu(h), self.dropout, self))
        if self.skip is not None:
            x = self.skip(x)
        return x + h
