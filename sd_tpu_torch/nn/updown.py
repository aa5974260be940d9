"""Spatial up/down-sampling blocks (NHWC).

Counterpart of `sd_tpu/nn/updown.py`: the stride-2 conv downsample of the
UNet and (asymmetric padding) the encoder, and the nearest-2× + 3×3 conv
upsample of the UNet and the decoder; with `with_conv=False` (the UNet's
`conv_resample=False`, the resblocks' built-in resampling) the nearest-2×
upsample alone and a 2×2 average pool. The TPU package runs the upsample
conv as four 2×2 phase convs at low resolution (`upsample_conv_2x`), a
weight-exact rewrite of the plain form computed here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.kernels.conv2d import conv_nhwc
from sd_tpu_torch.nn.layers import Conv2d


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of NHWC input."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool at stride 2 of NHWC input (an odd edge dropped)."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


class Upsample(nn.Module):
    """2× nearest upsample followed by a 3×3 conv (none without
    `with_conv`)."""

    def __init__(self, channels: int, *, with_conv: bool = True, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, dtype=dtype, compute_dtype=compute_dtype,
                            device=device)
                     if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """2× downsample: stride-2 3×3 conv with one pixel of padding on each
    side, or with `asymmetric_padding` (the codec's convention) none before
    and one after each spatial axis; without `with_conv`, a 2×2 average
    pool."""

    def __init__(self, channels: int, *, with_conv: bool = True,
                 asymmetric_padding: bool = False, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, stride=2, dtype=dtype,
                            compute_dtype=compute_dtype, device=device)
                     if with_conv else None)
        self.asymmetric_padding = asymmetric_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is None:
            return avg_pool_2x(x)
        if not self.asymmetric_padding:
            return self.conv(x)
        dt = self.conv.cdtype
        x = F.pad(x.to(dt), (0, 0, 0, 1, 0, 1))
        return conv_nhwc(x, self.conv.weight.to(dt), self.conv.bias.to(dt), stride=2,
                         padding=0)
