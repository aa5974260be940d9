"""SD UNet — the ε-model of the text-to-image pipeline.

Counterpart of `sd_tpu/models/unet_sd.py` `UNetModel`: the spatial-
transformer UNet (the SD-v1 configuration) and, with
`use_spatial_transformer=False`, the self-attention UNet of the
super-resolution configs (`SelfAttentionBlock2D` at each attention level, no
text context). The heads are `num_heads`, or the width over
`num_head_channels` where that is given. Submodules carry the
TPU package's parameter names (`in_0_0_res`, `in_0_0_attn`, `mid_attn`,
`out_3_2_up`, ...), so `weights.load_flax_params` maps its param tree
mechanically. The parameter-free serving options, read at every call and
set by `set_options`: ToMe (`tome_ratio`, `tome_min_tokens`, in every
SpatialTransformer, `nn/tome.py`) and FreeU (`freeu` = (b1, b2, s1, s2):
the decoder's backbone channels amplified and its skips low-pass filtered at
the two deepest widths, arXiv:2309.11497). `forward` takes ControlNet's
residuals (`control=`, models/controlnet.py) and IP-Adapter's image payload
(`ip=`, models/ip_adapter.py). The guided-diffusion (ADM) options:
`num_classes` (class labels `y` through the `label_emb` embedding, added to
the time embedding), `use_scale_shift_norm` in every resblock,
`resblock_updown` (the `in_{l}_down` / `out_{l}_up` resampling as resblocks
with built-in 2×2-average / nearest-2× resampling), `conv_resample=False`
(the resampling without its conv) and the codebook head `n_embed`
(`id_norm` → 1×1 `id_out` to codebook logits, in place of `out_norm` /
`out_conv`). `AttentionPool2d` is the CLIP-style attention pooling head.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.kernels import attention as attn_k
from sd_tpu_torch.nn.attention import SpatialTransformer
from sd_tpu_torch.nn.layers import (Conv2d, Dense, GroupNorm32, _empty,
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


class SelfAttentionBlock2D(nn.Module):
    """The attention block of the UNet without spatial transformers: GN (32
    groups, eps 1e-5, fp32) → 1×1 `qkv` → multi-head self-attention over the
    H·W tokens → zero-init 1×1 `proj_out` → residual. The qkv split is the
    TPU package's, [B, HW, 3, heads, C/heads] (the three outer, the heads
    inner), not the reference's heads-outer legacy order; the attention goes
    through `kernels.attention.dot_product_attention`, whose shape rule picks
    the flash kernel or the plain path."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.heads = channels // num_head_channels if num_head_channels != -1 else num_heads
        self.norm = GroupNorm32(channels, 32, **kw)
        self.qkv = Conv2d(channels, 3 * channels, 1, **kw)
        self.proj_out = zeros_init_conv(channels, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        qkv = self.qkv(self.norm(x)).reshape(B, H * W, 3, self.heads, C // self.heads)
        q, k, v = qkv.unbind(2)
        out = attn_k.dot_product_attention(q, k, v).reshape(B, H, W, C)
        return x + self.proj_out(out)


def attention_block(ch: int, use_spatial_transformer: bool, num_heads: int,
                    num_head_channels: int, transformer_depth: int, context_dim: int | None,
                    **kw) -> nn.Module:
    """The UNet's (and its ControlNet's) attention block over `ch` channels:
    a SpatialTransformer (`kw` may carry its ToMe and dropout options) or, without
    spatial transformers, a SelfAttentionBlock2D; heads of
    `num_head_channels` where that is given, else `num_heads`."""
    if not use_spatial_transformer:
        return SelfAttentionBlock2D(ch, num_heads, num_head_channels, **kw)
    if num_head_channels == -1:
        heads, dim_head = num_heads, ch // num_heads
    else:
        heads, dim_head = ch // num_head_channels, num_head_channels
    return SpatialTransformer(ch, heads, dim_head, transformer_depth, context_dim, **kw)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling of x [B, H, W, C] to [B, output_dim]: the
    mean token prepended to the H·W tokens, a learned
    `positional_embedding` [H·W + 1, C] added, `qkv_proj` to 3·C split as
    [B, n + 1, 3, heads, C/heads], the mean token's query alone attending
    over all n + 1 tokens, `c_proj` of the result."""

    def __init__(self, spatial: int, channels: int, num_heads: int,
                 output_dim: int | None = None, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.num_heads = num_heads
        self.positional_embedding = _empty((spatial + 1, channels), dtype, kw["device"])
        self.qkv_proj = Dense(channels, 3 * channels, **kw)
        self.c_proj = Dense(channels, output_dim or channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None].to(tokens.dtype)
        qkv = self.qkv_proj(tokens).reshape(B, H * W + 1, 3, self.num_heads,
                                            C // self.num_heads)
        q, k, v = qkv[:, :1, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = attn_k.dot_product_attention(q, k, v).reshape(B, 1, C)
        return self.c_proj(out)[:, 0]


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
        num_head_channels: int = -1,
        use_spatial_transformer: bool = True,
        transformer_depth: int = 1,
        context_dim: int | None = 768,
        tome_ratio: float = 0.0,
        tome_min_tokens: int = 1024,
        freeu: Sequence[float] | None = None,
        num_classes: int | None = None,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        conv_resample: bool = True,
        n_embed: int | None = None,
        dropout: float = 0.0,
        *,
        dtype=torch.float32,
        compute_dtype=None,
        device=None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=resolve_device(device))
        mc = model_channels
        self.model_channels = mc
        self.num_classes, self.n_embed = num_classes, n_embed
        self.freeu = None if freeu is None else tuple(freeu)
        # the block layout, which the SD checkpoint walk reads
        self.num_res_blocks = num_res_blocks
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.transformer_depth = transformer_depth
        emb_ch = mc * 4

        def attn(ch, name):
            st_kw = dict(tome_ratio=tome_ratio, tome_min_tokens=tome_min_tokens,
                         dropout=dropout)
            setattr(self, name, attention_block(
                ch, use_spatial_transformer, num_heads, num_head_channels, transformer_depth,
                context_dim, **(st_kw if use_spatial_transformer else {}), **kw))

        def res(c_in, c_out, **updown):
            return ResBlockSD(c_in, emb_ch, c_out, use_scale_shift_norm=use_scale_shift_norm,
                              dropout=dropout, **updown, **kw)

        self.time_embed_1 = Dense(mc, emb_ch, **kw)
        self.time_embed_2 = Dense(emb_ch, emb_ch, **kw)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_ch, dtype=dtype,
                                          device=kw["device"]).requires_grad_(False)
        self.input_conv = Conv2d(in_channels, mc, 3, **kw)

        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res", res(ch, mult * mc))
                ch = mult * mc
                if ds in attention_resolutions:
                    attn(ch, f"in_{level}_{i}_attn")
                chans.append(ch)
            if level != len(channel_mult) - 1:
                setattr(self, f"in_{level}_down",
                        res(ch, ch, down=True) if resblock_updown
                        else Downsample(ch, with_conv=conv_resample, **kw))
                chans.append(ch)
                ds *= 2

        self.mid_res1 = res(ch, ch)
        attn(ch, "mid_attn")
        self.mid_res2 = res(ch, ch)

        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                skip_ch = chans.pop()
                setattr(self, f"out_{level}_{i}_res", res(ch + skip_ch, mult * mc))
                ch = mult * mc
                if ds in attention_resolutions:
                    attn(ch, f"out_{level}_{i}_attn")
                if level != 0 and i == num_res_blocks:
                    setattr(self, f"out_{level}_up",
                            res(ch, ch, up=True) if resblock_updown
                            else Upsample(ch, with_conv=conv_resample, **kw))
                    ds //= 2

        if n_embed is not None:
            self.id_norm = GroupNorm32(ch, 32, **kw)
            self.id_out = Conv2d(ch, n_embed, 1, **kw)
        else:
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
                context: torch.Tensor | None = None, y: torch.Tensor | None = None,
                control: Sequence[torch.Tensor] | None = None,
                ip: dict | None = None) -> torch.Tensor:
        """x [B, H, W, C_in] latent, timesteps [B], context [B, 77, Cc], y
        [B] class labels (a class-conditional model needs them). `control`:
        ControlNet's residuals, one per input-block output in order and a
        last one for the middle block (len(hs) + 1): the last is added to the
        middle block's output, each other to its skip before FreeU. `ip`:
        IP-Adapter's {"layers": {attn_name: {block_name: {to_k_ip,
        to_v_ip}}}, "tokens": [B, n, Cc], "scale": float}, read by each
        listed cross-attention."""
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_2(F.silu(self.time_embed_1(emb)))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs labels")
            emb = emb + self.label_emb(y).to(emb.dtype)

        def block(name, h):
            mod = getattr(self, name, None)
            if mod is None:
                return h
            if isinstance(mod, ResBlockSD):
                return mod(h, emb)
            if isinstance(mod, SpatialTransformer):
                entry = None
                if ip is not None and name in ip["layers"]:
                    entry = (ip["layers"][name], ip["tokens"], ip["scale"])
                return mod(h, context, ip=entry)
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

        ctrl = list(control) if control is not None else None
        if ctrl is not None:
            if len(ctrl) != len(hs) + 1:
                raise ValueError(f"control expects {len(hs) + 1} residuals, got {len(ctrl)}")
            h = h + ctrl.pop()

        for level in reversed(range(levels)):
            for i in range(self.num_res_blocks + 1):
                skip = hs.pop()
                if ctrl is not None:
                    skip = skip + ctrl.pop()
                if self.freeu is not None:
                    h, skip = _apply_freeu(h, skip, self.model_channels, self.freeu)
                h = torch.cat([h, skip], dim=-1)
                h = block(f"out_{level}_{i}_res", h)
                h = block(f"out_{level}_{i}_attn", h)
            h = block(f"out_{level}_up", h)

        if self.n_embed is not None:
            return self.id_out(self.id_norm(h))
        return self.out_conv(F.silu(self.out_norm(h)))
