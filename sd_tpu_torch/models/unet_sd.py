"""SD UNet — the ε-model of the text-to-image pipeline.

Counterpart of `sd_tpu/models/unet_sd.py` `UNetModel` on its
spatial-transformer path (the SD-v1 configuration). Submodules carry the
TPU package's parameter names (`in_0_0_res`, `in_0_0_attn`, `mid_attn`,
`out_3_2_up`, ...), so `weights.load_flax_params` maps its param tree
mechanically. The parameter-free serving options, read at every call and
set by `set_options`: ToMe (`tome_ratio`, `tome_min_tokens`, in every
SpatialTransformer, `nn/tome.py`) and FreeU (`freeu` = (b1, b2, s1, s2):
the decoder's backbone channels amplified and its skips low-pass filtered at
the two deepest widths, arXiv:2309.11497). ControlNet/IP-Adapter inputs,
class labels, the codebook head, `num_head_channels`, `resblock_updown` and
`conv_resample=False` are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.attention import SpatialTransformer
from sd_tpu_torch.nn.layers import (Conv2d, Dense, GroupNorm32,
                                    timestep_embedding, zeros_init_conv)
from sd_tpu_torch.nn.resnet import ResBlockSD
from sd_tpu_torch.nn.updown import Downsample, Upsample

# the options `set_options` swaps; the rest of the configuration is fixed
SERVING_OPTIONS = ("tome_ratio", "tome_min_tokens", "freeu")


def _fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """x [B, H, W, C] with the low-frequency (DC-centred) band of its
    spatial spectrum scaled by `scale`: a complex64 FFT over H and W."""
    B, H, W, C = x.shape
    f = torch.fft.fftshift(torch.fft.fftn(x.float().to(torch.complex64), dim=(1, 2)),
                           dim=(1, 2))
    ch, cw = H // 2, W // 2
    mask = torch.ones((1, H, W, 1), dtype=torch.float32, device=x.device)
    mask[:, max(ch - threshold, 0):ch + threshold, max(cw - threshold, 0):cw + threshold] = scale
    f = torch.fft.ifftn(torch.fft.ifftshift(f * mask, dim=(1, 2)), dim=(1, 2))
    return f.real.to(x.dtype)


def _apply_freeu(h: torch.Tensor, skip: torch.Tensor, mc: int,
                 freeu: tuple[float, float, float, float]):
    """FreeU at the two deepest decoder widths (4·mc, 2·mc): the backbone's
    first half of the channels times b, the skip's low band times s."""
    b1, b2, s1, s2 = freeu
    C = h.shape[-1]
    for width, b, s in ((mc * 4, b1, s1), (mc * 2, b2, s2)):
        if C == width:
            h = torch.cat([h[..., :C // 2] * b, h[..., C // 2:]], dim=-1)
            return h, _fourier_filter(skip, 1, s)
    return h, skip


class UNetModel(nn.Module):
    """The SD UNet; built on the card unless `device` names another."""

    def __init__(
        self,
        in_channels: int = 4,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        use_spatial_transformer: bool = True,
        transformer_depth: int = 1,
        context_dim: int | None = 768,
        tome_ratio: float = 0.0,
        tome_min_tokens: int = 1024,
        freeu: Sequence[float] | None = None,
        *,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if not use_spatial_transformer:
            raise NotImplementedError(
                "only the spatial-transformer UNet is ported")
        kw = dict(dtype=dtype, device=resolve_device(device))
        mc = model_channels
        self.model_channels = mc
        self.freeu = None if freeu is None else tuple(freeu)
        self.num_res_blocks = num_res_blocks
        self.channel_mult = tuple(channel_mult)
        emb_ch = mc * 4

        def attn(ch, name):
            setattr(self, name, SpatialTransformer(
                ch, num_heads, ch // num_heads, transformer_depth, context_dim,
                tome_ratio=tome_ratio, tome_min_tokens=tome_min_tokens, **kw))

        self.time_embed_1 = Dense(mc, emb_ch, **kw)
        self.time_embed_2 = Dense(emb_ch, emb_ch, **kw)
        self.input_conv = Conv2d(in_channels, mc, 3, **kw)

        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res",
                        ResBlockSD(ch, emb_ch, mult * mc, **kw))
                ch = mult * mc
                if ds in attention_resolutions:
                    attn(ch, f"in_{level}_{i}_attn")
                chans.append(ch)
            if level != len(channel_mult) - 1:
                setattr(self, f"in_{level}_down", Downsample(ch, **kw))
                chans.append(ch)
                ds *= 2

        self.mid_res1 = ResBlockSD(ch, emb_ch, ch, **kw)
        attn(ch, "mid_attn")
        self.mid_res2 = ResBlockSD(ch, emb_ch, ch, **kw)

        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                skip_ch = chans.pop()
                setattr(self, f"out_{level}_{i}_res",
                        ResBlockSD(ch + skip_ch, emb_ch, mult * mc, **kw))
                ch = mult * mc
                if ds in attention_resolutions:
                    attn(ch, f"out_{level}_{i}_attn")
                if level != 0 and i == num_res_blocks:
                    setattr(self, f"out_{level}_up", Upsample(ch, **kw))
                    ds //= 2

        self.out_norm = GroupNorm32(ch, 32, **kw)
        self.out_conv = zeros_init_conv(ch, out_channels, **kw)

    def set_options(self, **updates) -> None:
        """Swap the parameter-free serving options (`SERVING_OPTIONS`); the
        next call runs with them."""
        unknown = set(updates) - set(SERVING_OPTIONS)
        if unknown:
            raise TypeError(f"not a parameter-free UNet option: {sorted(unknown)} "
                            f"(options: {SERVING_OPTIONS})")
        if "freeu" in updates:
            self.freeu = None if updates["freeu"] is None else tuple(updates["freeu"])
        for mod in self.modules():
            if isinstance(mod, SpatialTransformer):
                for name in ("tome_ratio", "tome_min_tokens"):
                    if name in updates:
                        setattr(mod, name, updates[name])

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, W, C_in] latent, timesteps [B], context [B, 77, Cc]."""
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_2(F.silu(self.time_embed_1(emb)))

        def block(name, h):
            mod = getattr(self, name, None)
            if mod is None:
                return h
            if isinstance(mod, ResBlockSD):
                return mod(h, emb)
            if isinstance(mod, SpatialTransformer):
                return mod(h, context)
            return mod(h)

        levels = len(self.channel_mult)
        h = self.input_conv(x)
        hs = [h]
        for level in range(levels):
            for i in range(self.num_res_blocks):
                h = block(f"in_{level}_{i}_res", h)
                h = block(f"in_{level}_{i}_attn", h)
                hs.append(h)
            if level != levels - 1:
                h = block(f"in_{level}_down", h)
                hs.append(h)

        h = block("mid_attn", block("mid_res1", h))
        h = block("mid_res2", h)

        for level in reversed(range(levels)):
            for i in range(self.num_res_blocks + 1):
                skip = hs.pop()
                if self.freeu is not None:
                    h, skip = _apply_freeu(h, skip, self.model_channels, self.freeu)
                h = torch.cat([h, skip], dim=-1)
                h = block(f"out_{level}_{i}_res", h)
                h = block(f"out_{level}_{i}_attn", h)
            h = block(f"out_{level}_up", h)

        return self.out_conv(F.silu(self.out_norm(h)))
