"""The CompVis codec-style diffusion UNet ("Model"), the third UNet family.

Counterpart of `sd_tpu/models/unet_compvis.py` `UNetCompVis`: the codec's
blocks with a timestep embedding (`[sin, cos]` layout, `flip_sin_to_cos=False`,
through `temb_dense0` → silu → `temb_dense1`) injected into every
`ResnetBlock`; per level `num_res_blocks` blocks, each followed by
`make_attn(attn_type)` where the level's resolution is in
`attn_resolutions`, then the asymmetric-pad stride-2 `Downsample`; a mid
block (res → attention → res); the up path of `num_res_blocks + 1` blocks a
level over the concatenated skips with nearest-2× `Upsample`s; GN (eps
1e-6) → silu → `conv_out`. NHWC. The attention blocks carry the TPU
package's flax auto-names (`AttnBlock_k`, `LinearAttention_k` in build
order: down path, mid, up path), as the codec's do
(`models/codec.py _CodecAttention`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.models.codec import _CodecAttention
from sd_tpu_torch.nn.layers import Conv2d, Dense, GroupNorm32, timestep_embedding
from sd_tpu_torch.nn.resnet import ResnetBlock
from sd_tpu_torch.nn.updown import Downsample, Upsample


class UNetCompVis(_CodecAttention):
    """Time-conditioned codec UNet; built on the card unless `device` names
    another."""

    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, resamp_with_conv: bool = True, resolution: int = 256,
                 use_timestep: bool = True, attn_type: str = "vanilla", in_channels: int = 3,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self._init_attn(attn_type)
        self.ch, self.use_timestep = ch, use_timestep
        self.num_levels, self.num_res_blocks = len(ch_mult), num_res_blocks
        temb_ch = ch * 4 if use_timestep else None
        res_kw = dict(temb_channels=temb_ch, dropout=dropout, **kw)
        if use_timestep:
            self.temb_dense0 = Dense(ch, ch * 4, **kw)
            self.temb_dense1 = Dense(ch * 4, ch * 4, **kw)
        self.conv_in = Conv2d(in_channels, ch, 3, **kw)

        block_in, res = ch, resolution
        chans = [ch]
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks):
                setattr(self, f"down_{level}_block_{i}",
                        ResnetBlock(block_in, ch * mult, **res_kw))
                block_in = ch * mult
                if res in attn_resolutions:
                    self._attn(("down", level, i), block_in, kw)
                chans.append(block_in)
            if level != self.num_levels - 1:
                setattr(self, f"down_{level}_downsample",
                        Downsample(block_in, with_conv=resamp_with_conv,
                                   asymmetric_padding=True, **kw))
                chans.append(block_in)
                res //= 2

        self.mid_block_1 = ResnetBlock(block_in, **res_kw)
        self._attn("mid", block_in, kw)
        self.mid_block_2 = ResnetBlock(block_in, **res_kw)

        for level in reversed(range(self.num_levels)):
            for i in range(num_res_blocks + 1):
                setattr(self, f"up_{level}_block_{i}",
                        ResnetBlock(block_in + chans.pop(), ch * ch_mult[level], **res_kw))
                block_in = ch * ch_mult[level]
                if res in attn_resolutions:
                    self._attn(("up", level, i), block_in, kw)
            if level != 0:
                setattr(self, f"up_{level}_upsample",
                        Upsample(block_in, with_conv=resamp_with_conv, **kw))
                res *= 2

        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(block_in, out_ch, 3, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, W, in_channels], t [B] timesteps (needed with
        `use_timestep`) → [B, H, W, out_ch]."""
        temb = None
        if self.use_timestep:
            if t is None:
                raise ValueError("a time-conditioned UNetCompVis needs timesteps")
            temb = timestep_embedding(t, self.ch, flip_sin_to_cos=False)
            temb = self.temb_dense1(F.silu(self.temb_dense0(temb)))

        h = self.conv_in(x)
        hs = [h]
        for level in range(self.num_levels):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h, temb)
                h = self._apply_attn(("down", level, i), h)
                hs.append(h)
            if level != self.num_levels - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                hs.append(h)

        h = self.mid_block_2(self._apply_attn("mid", self.mid_block_1(h, temb)), temb)

        for level in reversed(range(self.num_levels)):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(torch.cat([h, hs.pop()], dim=-1), temb)
                h = self._apply_attn(("up", level, i), h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(h)

        return self.conv_out(F.silu(self.norm_out(h)))
