"""Pixel-space DDPM UNet (capability config #1).

Counterpart of `sd_tpu/models/unet_ddpm.py` `UNetDDPM`: the sinusoidal time
embedding through a two-layer MLP, `conv_in` to `base_channels`, a down path
of time-conditioned resblocks (self-attention at `attn_levels`, stride-2
downsampling with one pixel of padding on each side), a res-attn-res
bottleneck, an up path that concatenates [h, skip] before each of its
`num_res_blocks + 1` resblocks per level, and GN(eps 1e-6) → silu →
zero-initialised `conv_out`. NHWC, the TPU package's parameter names.

The parameters are stored in `dtype` and computed in `compute_dtype` (the
TPU package's `dtype`: fp32 parameters with bf16 compute under
`model.params.dtype: bfloat16`, whose level-3 attention blocks then take the
flash training kernels). The resblocks drop at `dropout` inside a training
step's `dropout_rng`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.attention import AttnBlock
from sd_tpu_torch.nn.layers import (Conv2d, Dense, GroupNorm32, timestep_embedding,
                                    zeros_init_conv)
from sd_tpu_torch.nn.resnet import ResnetBlock
from sd_tpu_torch.nn.updown import Downsample, Upsample


class UNetDDPM(nn.Module):
    """The ε-model of pixel-space DDPM; built on the card unless `device`
    names another. `forward(x [B, H, W, in_channels], t [B])` → [B, H, W,
    out_channels]."""

    def __init__(self, base_channels: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 attn_levels: Sequence[int] = (3,), num_res_blocks: int = 2,
                 out_channels: int = 3, dropout: float = 0.0, in_channels: int = 3, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=resolve_device(device))
        base, temb_ch = base_channels, base_channels * 4
        self.base_channels, self.out_channels = base, out_channels
        self.ch_mult, self.attn_levels = tuple(ch_mult), tuple(attn_levels)
        self.num_res_blocks = num_res_blocks
        res = lambda cin, cout: ResnetBlock(cin, cout, temb_channels=temb_ch,
                                            dropout=dropout, **kw)
        self.time_mlp1 = Dense(base, temb_ch, **kw)
        self.time_mlp2 = Dense(temb_ch, temb_ch, **kw)
        self.conv_in = Conv2d(in_channels, base, 3, **kw)

        skips, h = [base], base
        for level, mult in enumerate(self.ch_mult):
            ch = base * mult
            for i in range(num_res_blocks):
                setattr(self, f"down_{level}_res_{i}", res(h, ch))
                h = ch
                if level in self.attn_levels:
                    setattr(self, f"down_{level}_attn_{i}", AttnBlock(h, **kw))
                skips.append(h)
            if level != len(self.ch_mult) - 1:
                setattr(self, f"down_{level}_downsample", Downsample(h, **kw))
                skips.append(h)

        self.mid_res1 = res(h, h)
        self.mid_attn = AttnBlock(h, **kw)
        self.mid_res2 = res(h, h)

        for level, mult in reversed(list(enumerate(self.ch_mult))):
            ch = base * mult
            for i in range(num_res_blocks + 1):
                setattr(self, f"up_{level}_res_{i}", res(h + skips.pop(), ch))
                h = ch
                if level in self.attn_levels:
                    setattr(self, f"up_{level}_attn_{i}", AttnBlock(h, **kw))
            if level != 0:
                setattr(self, f"up_{level}_upsample", Upsample(h, **kw))

        self.norm_out = GroupNorm32(h, 32, eps=1e-6, **kw)
        self.conv_out = zeros_init_conv(h, out_channels, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, self.base_channels)
        temb = self.time_mlp2(F.silu(self.time_mlp1(temb)))

        h = self.conv_in(x)
        skips = [h]
        last = len(self.ch_mult) - 1
        for level in range(len(self.ch_mult)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h, temb)
                if level in self.attn_levels:
                    h = getattr(self, f"down_{level}_attn_{i}")(h)
                skips.append(h)
            if level != last:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)

        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb)), temb)

        for level in reversed(range(len(self.ch_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = getattr(self, f"up_{level}_res_{i}")(h, temb)
                if level in self.attn_levels:
                    h = getattr(self, f"up_{level}_attn_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(h)

        return self.conv_out(F.silu(self.norm_out(h)))
