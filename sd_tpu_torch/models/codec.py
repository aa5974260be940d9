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
direct-conv kernel in bf16 outside training. Every block computes in
`compute_dtype` and its resblocks drop at `dropout` inside a training step's
`dropout_rng`.

The auxiliary codec heads, with the TPU package's names: `SimpleDecoder`,
`UpsampleDecoder`, `LatentRescaler` (resblocks, a bilinear resize by
`factor` as `jax.image.resize` computes it, attention, resblocks),
`MergedRescaleEncoder` / `MergedRescaleDecoder` (an encoder then a
rescaler, a rescaler then a decoder), `Upsampler`, `Resize` and
`FirstStagePostProcessor`. flax infers a head's input width; here it is
`in_channels`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.models.conditioners import float_resize
from sd_tpu_torch.nn.attention import AttnBlock, make_attn
from sd_tpu_torch.nn.layers import Conv2d, GroupNorm32
from sd_tpu_torch.nn.resnet import ResnetBlock
from sd_tpu_torch.nn.updown import Downsample, Upsample, avg_pool_2x, nearest_upsample_2x


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
                 attn_type: str = "vanilla", dropout: float = 0.0, *, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        rkw = dict(dropout=dropout, **kw)
        self._init_attn(attn_type)
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = Conv2d(in_channels, ch, 3, **kw)
        block_in, res = ch, resolution
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks):
                setattr(self, f"down_{level}_block_{i}",
                        ResnetBlock(block_in, ch * mult, **rkw))
                block_in = ch * mult
                if res in attn_resolutions:
                    self._attn((level, i), block_in, kw)
            if level != self.num_levels - 1:
                setattr(self, f"down_{level}_downsample",
                        Downsample(block_in, asymmetric_padding=True, **kw))
                res //= 2
        self.mid_block_1 = ResnetBlock(block_in, **rkw)
        self._attn("mid", block_in, kw)
        self.mid_block_2 = ResnetBlock(block_in, **rkw)
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
                 attn_type: str = "vanilla", dropout: float = 0.0, *, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        rkw = dict(dropout=dropout, **kw)
        self._init_attn(attn_type)
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[-1]
        res = resolution // 2 ** (self.num_levels - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, **kw)
        self.mid_block_1 = ResnetBlock(block_in, **rkw)
        self._attn("mid", block_in, kw)
        self.mid_block_2 = ResnetBlock(block_in, **rkw)
        for level in reversed(range(self.num_levels)):
            out = ch * ch_mult[level]
            for i in range(num_res_blocks + 1):
                setattr(self, f"up_{level}_block_{i}",
                        ResnetBlock(block_in, out, **rkw))
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


# -- the auxiliary heads ----------------------------------------------------------


def _kw(dtype, compute_dtype, device) -> dict:
    return dict(dtype=dtype, compute_dtype=compute_dtype, device=device)


def _bilinear(h: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(h, ..., "bilinear")` in h's dtype."""
    return float_resize(h, height, width, "bilinear").to(h.dtype)


class SimpleDecoder(nn.Module):
    """1×1 `conv_in`, resblocks to 2·, 4·, 2· the width (`res1`–`res3`),
    1×1 `conv_mid` back, nearest 2× upsample, GN → swish → 3×3 `conv_out`."""

    def __init__(self, in_channels: int, out_channels: int = 3, *, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        kw, c = _kw(dtype, compute_dtype, device), in_channels
        self.conv_in = Conv2d(c, c, 1, **kw)
        self.res1 = ResnetBlock(c, 2 * c, **kw)
        self.res2 = ResnetBlock(2 * c, 4 * c, **kw)
        self.res3 = ResnetBlock(4 * c, 2 * c, **kw)
        self.conv_mid = Conv2d(2 * c, c, 1, **kw)
        self.norm_out = GroupNorm32(c, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(c, out_channels, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.res3(self.res2(self.res1(self.conv_in(x))))
        h = nearest_upsample_2x(self.conv_mid(h))
        return self.conv_out(F.silu(self.norm_out(h)))


class UpsampleDecoder(nn.Module):
    """Per level `num_res_blocks + 1` resblocks to `ch`·mult
    (`level_{l}_block_{i}`), a nearest 2× upsample between levels, GN →
    swish → 3×3 `conv_out`."""

    def __init__(self, in_channels: int, out_channels: int = 3, ch: int = 128,
                 num_res_blocks: int = 2, ch_mult: Sequence[int] = (2, 2),
                 dropout: float = 0.0, *, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        kw = _kw(dtype, compute_dtype, device)
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        c = in_channels
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks + 1):
                setattr(self, f"level_{level}_block_{i}",
                        ResnetBlock(c, ch * mult, dropout=dropout, **kw))
                c = ch * mult
        self.norm_out = GroupNorm32(c, 32, eps=1e-6, **kw)
        self.conv_out = Conv2d(c, out_channels, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for level in range(len(self.ch_mult)):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"level_{level}_block_{i}")(h)
            if level != len(self.ch_mult) - 1:
                h = nearest_upsample_2x(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class LatentRescaler(nn.Module):
    """3×3 `conv_in` to `mid_channels`, `depth` resblocks (`res_before_{i}`),
    a bilinear resize to round(H·factor) × round(W·factor) (at least 1),
    `attn`, `depth` resblocks (`res_after_{i}`), 1×1 `conv_out`."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int,
                 out_channels: int, depth: int = 2, *, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        kw = _kw(dtype, compute_dtype, device)
        self.factor, self.depth = factor, depth
        self.conv_in = Conv2d(in_channels, mid_channels, 3, **kw)
        for i in range(depth):
            setattr(self, f"res_before_{i}", ResnetBlock(mid_channels, **kw))
        self.attn = AttnBlock(mid_channels, **kw)
        for i in range(depth):
            setattr(self, f"res_after_{i}", ResnetBlock(mid_channels, **kw))
        self.conv_out = Conv2d(mid_channels, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(self.depth):
            h = getattr(self, f"res_before_{i}")(h)
        H, W = h.shape[1], h.shape[2]
        h = _bilinear(h, max(1, round(H * self.factor)), max(1, round(W * self.factor)))
        h = self.attn(h)
        for i in range(self.depth):
            h = getattr(self, f"res_after_{i}")(h)
        return self.conv_out(h)


class MergedRescaleEncoder(nn.Module):
    """`encoder` (single z of ch·`intermediate_chn_mult` channels), then a
    `rescaler` to `out_ch`."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, intermediate_chn_mult: int = 2,
                 rescale_factor: float = 1.0, rescale_module_depth: int = 1, out_ch: int = 4,
                 in_channels: int = 3, *, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        kw = _kw(dtype, compute_dtype, device)
        inter = ch * intermediate_chn_mult
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               in_channels=in_channels, z_channels=inter, double_z=False,
                               attn_resolutions=attn_resolutions, resolution=resolution, **kw)
        self.rescaler = LatentRescaler(rescale_factor, inter, inter, out_ch,
                                       rescale_module_depth, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rescaler(self.encoder(x))


class MergedRescaleDecoder(nn.Module):
    """A `rescaler` from `z_channels` to z_channels·ch_mult[-1], then the
    `decoder`."""

    def __init__(self, z_channels: int = 4, out_ch: int = 3, resolution: int = 256,
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 rescale_factor: float = 1.0, rescale_module_depth: int = 1, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = _kw(dtype, compute_dtype, device)
        tmp = z_channels * ch_mult[-1]
        self.rescaler = LatentRescaler(rescale_factor, z_channels, tmp, tmp,
                                       rescale_module_depth, **kw)
        self.decoder = Decoder(ch=ch, out_ch=out_ch, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks, z_channels=tmp,
                               attn_resolutions=attn_resolutions, resolution=resolution, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(z))


class Upsampler(nn.Module):
    """A `rescaler` by out_size / (in_size / 2), then a `decoder` of
    log2(out_size / in_size) + 1 levels of `ch_mult` each."""

    def __init__(self, in_size: int, out_size: int, in_channels: int, out_channels: int,
                 ch_mult: int = 2, *, dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        if out_size < in_size:
            raise ValueError(f"Upsampler: out_size {out_size} < in_size {in_size}")
        kw = _kw(dtype, compute_dtype, device)
        num_blocks = int(math.log2(out_size // in_size)) + 1
        self.rescaler = LatentRescaler(out_size / (in_size / 2), in_channels,
                                       2 * in_channels, in_channels, 1, **kw)
        self.decoder = Decoder(ch=in_channels, out_ch=out_channels,
                               ch_mult=[ch_mult] * num_blocks, num_res_blocks=2,
                               z_channels=in_channels, resolution=out_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(x))


class Resize(nn.Module):
    """Optional stride-2 3×3 `conv` (`with_conv`), then a bilinear resize by
    `scale_factor` (none at 1)."""

    def __init__(self, scale_factor: float = 1.0, with_conv: bool = False,
                 in_channels: int | None = None, *, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = (Conv2d(in_channels, in_channels, 3, stride=2,
                            **_kw(dtype, compute_dtype, device)) if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        if self.scale_factor == 1.0:
            return x
        H, W = x.shape[1], x.shape[2]
        return _bilinear(x, round(H * self.scale_factor), round(W * self.scale_factor))


class FirstStagePostProcessor(nn.Module):
    """GroupNorm (min(32, C) groups) → 3×3 `proj` → swish, then per
    `ch_mult` entry a resblock to proj·mult (`block_{i}`) and a 2×2 average
    pool; with `reshape_to_sequence` the map flattened to [B, H·W, C]."""

    def __init__(self, ch_mult: Sequence[int] = (1, 2), in_channels: int = 4,
                 proj_channels: int | None = None, dropout: float = 0.0,
                 pretrained_out_channels: int | None = None,
                 reshape_to_sequence: bool = False, *, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        kw = _kw(dtype, compute_dtype, device)
        proj = proj_channels or in_channels
        self.ch_mult, self.reshape_to_sequence = tuple(ch_mult), reshape_to_sequence
        self.proj_norm = GroupNorm32(in_channels, min(32, in_channels), **kw)
        self.proj = Conv2d(in_channels, proj, 3, **kw)
        c = proj
        for i, mult in enumerate(ch_mult):
            setattr(self, f"block_{i}", ResnetBlock(c, proj * mult, dropout=dropout, **kw))
            c = proj * mult

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.proj(self.proj_norm(z)))
        for i in range(len(self.ch_mult)):
            h = avg_pool_2x(getattr(self, f"block_{i}")(h))
        if self.reshape_to_sequence:
            h = h.reshape(h.shape[0], -1, h.shape[-1])
        return h
