"""First-stage codec encoder and decoder (CompVis KL-f8 layout).

Counterpart of `sd_tpu/models/codec.py` `Encoder` and `Decoder`:
  Encoder: conv_in → per level [ResnetBlock ×N] → asymmetric-pad Downsample
           → mid (res-attn-res) → GN/swish/conv_out to 2·z (`double_z`);
  Decoder: conv_in(z) → mid (res-attn-res) → per level [ResnetBlock ×(N+1)]
           → Upsample → GN/swish/conv_out.
The mid-block attention is the single-head flash kernel at d = 512 in bf16;
the ResnetBlock 3×3 convs at the 128²–512² levels are the direct-conv kernel
in bf16 outside training. Per-level attention (`attn_resolutions`) and the
auxiliary codec heads are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.nn.attention import AttnBlock
from sd_tpu_torch.nn.layers import Conv2d, GroupNorm32
from sd_tpu_torch.nn.resnet import ResnetBlock
from sd_tpu_torch.nn.updown import Downsample, Upsample


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, in_channels: int = 3,
                 z_channels: int = 4, double_z: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = Conv2d(in_channels, ch, 3, **kw)
        block_in = ch
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks):
                setattr(self, f"down_{level}_block_{i}",
                        ResnetBlock(block_in, ch * mult, **kw))
                block_in = ch * mult
            if level != self.num_levels - 1:
                setattr(self, f"down_{level}_downsample",
                        Downsample(block_in, asymmetric_padding=True, **kw))
        self.mid_block_1 = ResnetBlock(block_in, **kw)
        # the TPU package's unnamed `make_attn` child is auto-named AttnBlock_0
        self.AttnBlock_0 = AttnBlock(block_in, **kw)
        self.mid_block_2 = ResnetBlock(block_in, **kw)
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels,
                               3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in range(self.num_levels):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != self.num_levels - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
        h = self.mid_block_2(self.AttnBlock_0(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, z_channels: int = 4, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, **kw)
        self.mid_block_1 = ResnetBlock(block_in, **kw)
        # the TPU package's unnamed `make_attn` child is auto-named AttnBlock_0
        self.AttnBlock_0 = AttnBlock(block_in, **kw)
        self.mid_block_2 = ResnetBlock(block_in, **kw)
        for level in reversed(range(self.num_levels)):
            out = ch * ch_mult[level]
            for i in range(num_res_blocks + 1):
                setattr(self, f"up_{level}_block_{i}",
                        ResnetBlock(block_in, out, **kw))
                block_in = out
            if level != 0:
                setattr(self, f"up_{level}_upsample", Upsample(block_in, **kw))
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(block_in, out_ch, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block_2(self.AttnBlock_0(self.mid_block_1(h)))
        for level in reversed(range(self.num_levels)):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))
