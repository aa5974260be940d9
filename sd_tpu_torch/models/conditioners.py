"""The image conditioner of IP-Adapter: a CLIP ViT-B/32 visual tower.

Counterpart of the image half of `sd_tpu/models/conditioners.py`
(`ClipVisionTransformer`, `clip_image_preprocess`, `FrozenClipImageEmbedder`;
the text and class conditioners there are not ported yet). The tower is the
port's CLIP encoder layer (`models/clip_text.py`, no mask) behind a patch
embedding, a class token and learned positions, with LayerNorms in fp32 and
a [width, output_dim] projection of the class token. Preprocessing resizes
with `bicubic_resize`, a float resize that is `jax.image.resize(...,
"bicubic")`: Keys' cubic (a = −0.5), the kernel widened by the scale when
downsampling (antialias), weights normalised per output pixel, no rounding;
`float_resize` does the same with the triangle kernel for "bilinear" (the
super-resolution model's LR conditioning, `train/sr.py`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.models.clip_text import ClipEncoderLayer, ClipTextConfig
from sd_tpu_torch.nn.layers import Conv2d, LayerNorm, _empty

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


RESIZE_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def resize_weights(n_in: int, n_out: int, method: str = "bicubic",
                   device=None) -> torch.Tensor:
    """[n_in, n_out] fp32 weights of the bicubic or bilinear resize along one
    axis (JAX's `compute_weight_mat` with antialias)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = RESIZE_KERNELS[method](x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def float_resize(x: torch.Tensor, height: int, width: int,
                 method: str = "bicubic") -> torch.Tensor:
    """Float images x [B, H, W, C] resized to [B, height, width, C] in fp32 as
    `jax.image.resize(x, ..., method)` resizes them; an axis whose size does
    not change is left as it is."""
    x = x.float()
    if x.shape[1] != height:
        x = torch.einsum("bhwc,hk->bkwc", x,
                         resize_weights(x.shape[1], height, method, x.device))
    if x.shape[2] != width:
        x = torch.einsum("bhwc,wk->bhkc", x,
                         resize_weights(x.shape[2], width, method, x.device))
    return x


def bicubic_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return float_resize(x, height, width, "bicubic")


def clip_image_preprocess(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC images → the CLIP input: bicubic resize to size², then
    CLIP's normalisation."""
    x = (bicubic_resize(x, size, size) + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


class ClipVisionTransformer(nn.Module):
    """CLIP ViT-B/32 visual tower → image embedding [B, output_dim]. Built on
    the card unless `device` names another."""

    def __init__(self, patch_size: int = 32, width: int = 768, layers: int = 12,
                 heads: int = 12, output_dim: int = 512, image_size: int = 224, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.width, self.layers = width, layers
        self.patch_embed = Conv2d(3, width, patch_size, stride=patch_size, bias=False,
                                  padding=0, **kw)
        self.class_embedding = _empty((width,), dtype, device)
        self.position_embedding = _empty(((image_size // patch_size) ** 2 + 1, width),
                                         dtype, device)
        self.ln_pre = LayerNorm(width, **kw)
        cfg = ClipTextConfig(hidden_size=width, num_heads=heads)
        for i in range(layers):
            setattr(self, f"layer_{i}", ClipEncoderLayer(cfg, **kw))
        self.ln_post = LayerNorm(width, **kw)
        self.proj = _empty((width, output_dim), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.patch_embed(x).reshape(B, -1, self.width)
        cls = self.class_embedding.to(h.dtype).expand(B, 1, self.width)
        h = torch.cat([cls, h], dim=1) + self.position_embedding[None].to(h.dtype)
        h = self.ln_pre(h.float()).to(h.dtype)
        no_mask = torch.zeros((1, 1, h.shape[1], h.shape[1]), dtype=torch.float32,
                              device=h.device)
        for i in range(self.layers):
            h = getattr(self, f"layer_{i}")(h, no_mask)
        h = self.ln_post(h[:, 0].float())
        return (h @ self.proj.float()).to(x.dtype)


class FrozenClipImageEmbedder(nn.Module):
    """Preprocessing and the ViT-B/32 tower: [-1, 1] images [B, H, W, 3] →
    [B, 512] embeddings."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        self.visual = ClipVisionTransformer(dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.visual(clip_image_preprocess(x))
