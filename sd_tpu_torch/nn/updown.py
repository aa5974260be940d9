"""Spatial up/down-sampling blocks (NHWC).

Counterpart of `sd_tpu/nn/updown.py` on the SD-v1 path: the stride-2 conv
downsample of the UNet and (asymmetric padding) the encoder, and the
nearest-2× + 3×3 conv upsample of the UNet and the decoder. The TPU package
runs that upsample conv as four 2×2 phase convs at low resolution
(`upsample_conv_2x`), a weight-exact rewrite of the plain form computed
here.
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


class Upsample(nn.Module):
    """2× nearest upsample followed by a 3×3 conv."""

    def __init__(self, channels: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class Downsample(nn.Module):
    """2× downsample: stride-2 3×3 conv with one pixel of padding on each
    side, or with `asymmetric_padding` (the codec's convention) none before
    and one after each spatial axis."""

    def __init__(self, channels: int, *, asymmetric_padding: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype,
                           device=device)
        self.asymmetric_padding = asymmetric_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.asymmetric_padding:
            return self.conv(x)
        x = F.pad(x.to(self.conv.weight.dtype), (0, 0, 0, 1, 0, 1))
        return conv_nhwc(x, self.conv.weight, self.conv.bias, stride=2, padding=0)
