"""First-stage codec encoder and decoder (CompVis KL-f8 layout).

Counterpart of `sd_tpu/models/codec.py` `Encoder` and `Decoder`:
  Encoder: conv_in → per level [ResnetBlock (+attn) ×N] → asymmetric-pad
           Downsample → mid (res-attn-res) → GN/swish/conv_out to 2·z
           (`double_z`);
  Decoder: conv_in(z) → mid (res-attn-res) → per level [ResnetBlock (+attn)
           ×(N+1)] → Upsample → GN/swish/conv_out.
A level whose resolution (`resolution` halved per level) is in
`attn_resolutions` has an attention block after each ResnetBlock; every
attention block is `make_attn(attn_type)`'s, named as the TPU package's
flax auto-names them: `<class>_<k>` in the order they are built, so the
encoder's mid block is the last index and the decoder's is index 0. The
single-head attention takes the flash kernel at d = 512 in bf16 where the
shape rule holds; the ResnetBlock 3×3 convs at the 128²–512² levels are the
direct-conv kernel in bf16 outside training. The auxiliary codec heads are
not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.nn.attention import make_attn
from sd_tpu_torch.nn.layers import Conv2d, GroupNorm32
from sd_tpu_torch.nn.resnet import ResnetBlock
from sd_tpu_torch.nn.updown import Downsample, Upsample


class _CodecAttention(nn.Module):
    """The attention blocks' naming: `_attn(key, channels, kw)` builds the
    next `make_attn` block under its flax name and records it under `key`
    ((level, block) or "mid")."""

    def _init_attn(self, attn_type: str) -> None:
        self.attn_type = attn_type
        self.attn_names: dict = {}

    def _attn(self, key, channels: int, kw: dict) -> None:
        block = make_attn(self.attn_type, channels, **kw)
        name = f"{type(block).__name__}_{len(self.attn_names)}"
        setattr(self, name, block)
        self.attn_names[key] = name

    def _apply_attn(self, key, h: torch.Tensor) -> torch.Tensor:
        name = self.attn_names.get(key)
        return h if name is None else getattr(self, name)(h)


class Encoder(_CodecAttention):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, in_channels: int = 3,
                 z_channels: int = 4, double_z: bool = True,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 attn_type: str = "vanilla", *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self._init_attn(attn_type)
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = Conv2d(in_channels, ch, 3, **kw)
        block_in, res = ch, resolution
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks):
                setattr(self, f"down_{level}_block_{i}",
                        ResnetBlock(block_in, ch * mult, **kw))
                block_in = ch * mult
                if res in attn_resolutions:
                    self._attn((level, i), block_in, kw)
            if level != self.num_levels - 1:
                setattr(self, f"down_{level}_downsample",
                        Downsample(block_in, asymmetric_padding=True, **kw))
                res //= 2
        self.mid_block_1 = ResnetBlock(block_in, **kw)
        self._attn("mid", block_in, kw)
        self.mid_block_2 = ResnetBlock(block_in, **kw)
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels,
                               3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in range(self.num_levels):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
                h = self._apply_attn((level, i), h)
            if level != self.num_levels - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
        h = self.mid_block_2(self._apply_attn("mid", self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(_CodecAttention):
    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 attn_type: str = "vanilla", *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self._init_attn(attn_type)
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[-1]
        res = resolution // 2 ** (self.num_levels - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, **kw)
        self.mid_block_1 = ResnetBlock(block_in, **kw)
        self._attn("mid", block_in, kw)
        self.mid_block_2 = ResnetBlock(block_in, **kw)
        for level in reversed(range(self.num_levels)):
            out = ch * ch_mult[level]
            for i in range(num_res_blocks + 1):
                setattr(self, f"up_{level}_block_{i}",
                        ResnetBlock(block_in, out, **kw))
                block_in = out
                if res in attn_resolutions:
                    self._attn((level, i), block_in, kw)
            if level != 0:
                setattr(self, f"up_{level}_upsample", Upsample(block_in, **kw))
                res *= 2
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(block_in, out_ch, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block_2(self._apply_attn("mid", self.mid_block_1(h)))
        for level in reversed(range(self.num_levels)):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
                h = self._apply_attn((level, i), h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))
