"""ControlNet: spatially-conditioned control of a frozen SD UNet (Zhang, Rao
& Agrawala, arXiv:2302.05543), the inference half.

Counterpart of `sd_tpu/models/controlnet.py`: the control branch is a copy
of the UNet's encoder and middle block under the same module names (so
`init_controlnet_from_unet` copies the trained weights by name), a
pixel-space hint encoder of stride-2 convs down to the latent grid ending in
a zero conv, and a zero-init 1×1 projection of every residual: one per
skip connection of the base UNet and one for its middle block, which
`UNetModel.forward(control=...)` adds. With fresh (zero) projections the
controlled forward is the base forward bit for bit. The branch's attention
and feed-forward take the UNet's kernels at the UNet's shapes. `train_ldm`'s
ControlNet branch (`train/runners.py ldm_branch`) trains it over the frozen
UNet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.models.unet_sd import UNetModel, attention_block
from sd_tpu_torch.nn.attention import SpatialTransformer
from sd_tpu_torch.nn.layers import Conv2d, Dense, timestep_embedding, zeros_init_conv
from sd_tpu_torch.nn.resnet import ResBlockSD
from sd_tpu_torch.nn.updown import Downsample

HINT_LADDER = (16, 32, 96, 256)


class ControlNet(nn.Module):
    """The control branch; its options are the UNet's (a class-conditional
    branch embeds labels as the UNet does, its resblocks take scale-shift
    norm where the UNet's do, and its attention is the UNet's kind:
    spatial transformers or self-attention blocks), plus the hint's
    channels and `hint_downsamples` = log2 of the first stage's factor (3
    for SD-v1's f8). Built on the card unless `device` names another."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int = 8,
                 use_spatial_transformer: bool = True, transformer_depth: int = 1,
                 context_dim: int | None = 768, hint_channels: int = 3,
                 hint_downsamples: int = 3, num_classes: int | None = None,
                 use_scale_shift_norm: bool = False, num_head_channels: int = -1, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        mc = model_channels
        self.model_channels, self.num_res_blocks = mc, num_res_blocks
        self.channel_mult, self.hint_downsamples = tuple(channel_mult), hint_downsamples
        self.num_classes = num_classes
        emb_ch = mc * 4

        def res(c_in, c_out):
            return ResBlockSD(c_in, emb_ch, c_out, use_scale_shift_norm=use_scale_shift_norm,
                              **kw)

        def attn(ch):
            return attention_block(ch, use_spatial_transformer, num_heads, num_head_channels,
                                   transformer_depth, context_dim, **kw)

        self.time_embed_1 = Dense(mc, emb_ch, **kw)
        self.time_embed_2 = Dense(emb_ch, emb_ch, **kw)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_ch, **kw).requires_grad_(False)
        self.hint_in = Conv2d(hint_channels, 16, 3, **kw)
        ch = 16
        for i in range(hint_downsamples):
            ch_a = HINT_LADDER[min(i, len(HINT_LADDER) - 1)]
            ch_down = HINT_LADDER[min(i + 1, len(HINT_LADDER) - 1)]
            setattr(self, f"hint_{i}_a", Conv2d(ch, ch_a, 3, **kw))
            setattr(self, f"hint_{i}_down", Conv2d(ch_a, ch_down, 3, stride=2, **kw))
            ch = ch_down
        self.hint_zero = zeros_init_conv(ch, mc, **kw)
        self.input_conv = Conv2d(in_channels, mc, 3, **kw)
        self.zero_conv_0 = zeros_init_conv(mc, mc, 1, **kw)
        ch, ds, k = mc, 1, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res", res(ch, mult * mc))
                ch = mult * mc
                if ds in attention_resolutions:
                    setattr(self, f"in_{level}_{i}_attn", attn(ch))
                setattr(self, f"zero_conv_{k}", zeros_init_conv(ch, ch, 1, **kw))
                k += 1
            if level != len(channel_mult) - 1:
                setattr(self, f"in_{level}_down", Downsample(ch, **kw))
                setattr(self, f"zero_conv_{k}", zeros_init_conv(ch, ch, 1, **kw))
                k += 1
                ds *= 2
        self.mid_res1 = res(ch, ch)
        self.mid_attn = attn(ch)
        self.mid_res2 = res(ch, ch)
        self.mid_zero_conv = zeros_init_conv(ch, ch, 1, **kw)

    def forward(self, x: torch.Tensor, hint: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None,
                y: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
        """x [B, h, w, C_in] latent, hint [B, H, W, hint_channels] pixels, y
        [B] class labels (a class-conditional branch needs them) → the
        residuals, one per UNet skip connection in order, then the middle
        block's."""
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_2(F.silu(self.time_embed_1(emb)))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs labels")
            emb = emb + self.label_emb(y).to(emb.dtype)
        g = F.silu(self.hint_in(hint))
        for i in range(self.hint_downsamples):
            g = F.silu(getattr(self, f"hint_{i}_down")(F.silu(getattr(self, f"hint_{i}_a")(g))))
        h = self.input_conv(x) + self.hint_zero(g)
        outs = [self.zero_conv_0(h)]
        levels, k = len(self.channel_mult), 1
        for level in range(levels):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"in_{level}_{i}_res")(h, emb)
                attn = getattr(self, f"in_{level}_{i}_attn", None)
                if attn is not None:
                    h = self._attend(attn, h, context)
                outs.append(getattr(self, f"zero_conv_{k}")(h))
                k += 1
            if level != levels - 1:
                h = getattr(self, f"in_{level}_down")(h)
                outs.append(getattr(self, f"zero_conv_{k}")(h))
                k += 1
        h = self.mid_res2(self._attend(self.mid_attn, self.mid_res1(h, emb), context), emb)
        outs.append(self.mid_zero_conv(h))
        return tuple(outs)

    @staticmethod
    def _attend(attn: nn.Module, h: torch.Tensor, context: torch.Tensor | None) -> torch.Tensor:
        return attn(h, context) if isinstance(attn, SpatialTransformer) else attn(h)


CONTROLNET_KEYS = ("in_channels", "model_channels", "num_res_blocks", "attention_resolutions",
                   "channel_mult", "num_heads", "use_spatial_transformer", "transformer_depth",
                   "context_dim", "num_classes", "use_scale_shift_norm", "num_head_channels")


def controlnet_from_unet_config(unet_cfg: dict, hint_channels: int = 3,
                                hint_downsamples: int = 3, dtype=torch.float32,
                                device=None) -> ControlNet:
    """The control branch mirroring a UNet config dict (a config's
    `unet.params`)."""
    kw = {k: unet_cfg[k] for k in CONTROLNET_KEYS if unet_cfg.get(k) is not None}
    return ControlNet(hint_channels=hint_channels, hint_downsamples=hint_downsamples,
                      dtype=dtype, device=device, **kw)


@torch.no_grad()
def init_controlnet_from_unet(controlnet: ControlNet, unet: UNetModel) -> ControlNet:
    """The paper's initialisation, in place: the UNet's encoder, middle block,
    time embedding and input conv copied into the control branch by name
    (the hint encoder and the zero projections keep their values)."""
    theirs = dict(unet.named_parameters())
    for name, p in controlnet.named_parameters():
        top = name.split(".")[0]
        if name in theirs and (top.startswith(("in_", "mid_", "time_embed", "label_emb"))
                               or top == "input_conv"):
            p.copy_(theirs[name])
    return controlnet


def controlled_apply_fn(unet: UNetModel, controlnet: ControlNet, control_scale: float = 1.0):
    """The controlled UNet apply: `(x, t, ctx, y=None, control=None)`; with
    a hint image `control` the branch's residuals (times `control_scale`
    where it is not 1) go into the UNet, without one the plain UNet."""

    def apply(x, t, ctx, y=None, control=None):
        if control is None:
            return unet(x, t, ctx, y)
        res = controlnet(x, control, t, ctx, y)
        if control_scale != 1.0:
            res = tuple(r * control_scale for r in res)
        return unet(x, t, ctx, y, control=res)

    return apply
