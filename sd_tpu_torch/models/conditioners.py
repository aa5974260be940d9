"""Conditioners: the class embedder, the transformer / BERT text
embedders with their host tokenizer, the spatial rescaler, the hybrid pair,
and the image conditioner of IP-Adapter (a CLIP ViT-B/32 visual tower).

Counterpart of `sd_tpu/models/conditioners.py`. `ClassEmbedder` maps labels
to an `embedding` row (the `adm` key's conditioning). `TransformerEmbedder`
and `BERTEmbedder` run token ids through the port's `TransformerWrapper`
(`models/x_transformer.py`) under the name `transformer`;
`BERTTokenizerHost` tokenizes on the host as the TPU package's does: the
Hugging Face `bert-base-uncased` tokenizer where a local copy is installed,
else the same md5 hash of each lower-cased word ([CLS] 101, words to 999 +
hash mod (vocab − 1000), [SEP] 102, zero padding), so both packages give
the same ids. `SpatialRescaler` resizes `n_stages` times by `multiplier`
(round(H·multiplier) pixels) as `jax.image.resize` does, then an optional
1×1 `channel_mapper`; `HybridConditioner` returns {c_concat, c_crossattn}
from its two conditioners.

The image tower is the port's CLIP encoder layer (`models/clip_text.py`,
no mask) behind a patch embedding, a class token and learned positions,
with LayerNorms in fp32 and a [width, output_dim] projection of the class
token. Preprocessing resizes with `bicubic_resize`, a float resize that is
`jax.image.resize(..., "bicubic")`: Keys' cubic (a = −0.5), the kernel
widened by the scale when downsampling (antialias), weights normalised per
output pixel, no rounding; `float_resize` does the same with the triangle
kernel for "bilinear" (the super-resolution model's LR conditioning,
`train/sr.py`), and picks pixel floor((o + ½)·n_in / n_out) for
"nearest".
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.models.clip_text import ClipEncoderLayer, ClipTextConfig
from sd_tpu_torch.models.x_transformer import TransformerWrapper
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
    axis (JAX's `compute_weight_mat` with antialias), or the one-hot
    columns of the nearest resize (input pixel floor((o + ½)·n_in / n_out),
    computed in fp32)."""
    if method == "nearest":
        src = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out).floor().long()
        return torch.nn.functional.one_hot(src, n_in).T.float().to(device)
    if method not in RESIZE_KERNELS:
        raise ValueError(f"unknown resize method {method!r}: nearest, bilinear or bicubic")
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


class ClassEmbedder(nn.Module):
    """Class labels → their `embedding` rows [B, embed_dim]: a batch dict's
    `key` entry (or the labels themselves), flattened. Built on the card
    unless `device` names another."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, key: str = "class_label", *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.key = key
        self.embedding = nn.Embedding(n_classes, embed_dim, dtype=dtype,
                                      device=resolve_device(device)).requires_grad_(False)

    def forward(self, batch, key: str | None = None) -> torch.Tensor:
        c = batch[key or self.key] if isinstance(batch, dict) else batch
        return self.embedding(c.reshape(-1))


class TransformerEmbedder(nn.Module):
    """Token ids [B, L] → contextual embeddings [B, L, n_embed] through a
    `TransformerWrapper` of depth `n_layer`."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int, max_seq_len: int = 77, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.transformer = TransformerWrapper(vocab_size, max_seq_len, n_embed, n_layer,
                                              dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)


class BERTTokenizerHost:
    """Host-side BERT tokenizer: texts → int32 ids [len(texts), max_length]
    (the Hugging Face tokenizer when a local copy of `bert-base-uncased` is
    installed, else the md5 hash fallback); called, it returns the ids, or
    with `vq_interface` (None, None, [None, None, ids])."""

    def __init__(self, max_length: int = 77, vq_interface: bool = True,
                 vocab_size: int = 30522):
        self.max_length = max_length
        self.vq_interface = vq_interface
        self.vocab_size = vocab_size
        try:
            from transformers import BertTokenizerFast

            self._tok = BertTokenizerFast.from_pretrained("bert-base-uncased",
                                                          local_files_only=True)
        except Exception:
            self._tok = None

    def tokenize(self, texts: list[str]) -> np.ndarray:
        if self._tok is not None:
            enc = self._tok(texts, truncation=True, max_length=self.max_length,
                            padding="max_length", return_tensors="np")
            return enc["input_ids"].astype(np.int32)
        out = np.zeros((len(texts), self.max_length), np.int32)
        for i, t in enumerate(texts):
            ids = [101]                                   # [CLS]
            for w in t.lower().split()[: self.max_length - 2]:
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids.append(h % (self.vocab_size - 1000) + 999)
            ids.append(102)                               # [SEP]
            out[i, : len(ids)] = ids
        return out

    def __call__(self, texts: list[str]):
        tokens = self.tokenize(texts)
        return (None, None, [None, None, tokens]) if self.vq_interface else tokens

    def decode(self, text):
        return text


class BERTEmbedder(nn.Module):
    """The BERT-style text conditioner of the CompVis text-to-image LDM:
    token ids [B, L] (`BERTTokenizerHost`) → [B, L, n_embed] through a
    `TransformerWrapper` (n_embed 1280, 32 layers, 8 heads of 64)."""

    def __init__(self, n_embed: int = 1280, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, embedding_dropout: float = 0.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.transformer = TransformerWrapper(vocab_size, max_seq_len, n_embed, n_layer,
                                              emb_dropout=embedding_dropout, dtype=dtype,
                                              device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)


class SpatialRescaler(nn.Module):
    """x [B, H, W, C] resized `n_stages` times to round(H·multiplier) ×
    round(W·multiplier) (at least 1) by `method` ("nearest", "bilinear",
    "bicubic"; `float_resize`), then, with `out_channels`, a 1×1
    `channel_mapper`."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: int | None = None, bias: bool = False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        if method != "nearest" and method not in RESIZE_KERNELS:
            raise ValueError(f"unknown resize method {method!r}: nearest, bilinear or bicubic")
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        self.channel_mapper = (
            Conv2d(in_channels, out_channels, 1, bias=bias, dtype=dtype,
                   device=resolve_device(device)) if out_channels is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        for _ in range(self.n_stages):
            H, W = x.shape[1:3]
            x = float_resize(x, max(1, round(H * self.multiplier)),
                             max(1, round(W * self.multiplier)), self.method).to(dtype)
        return x if self.channel_mapper is None else self.channel_mapper(x)


class HybridConditioner(nn.Module):
    """Two conditioners → {"c_concat": [concat_conditioner(c_concat)],
    "c_crossattn": [crossattn_conditioner(c_crossattn)]} (the `hybrid`
    key's conditioning)."""

    def __init__(self, concat_conditioner: nn.Module, crossattn_conditioner: nn.Module):
        super().__init__()
        self.concat_conditioner = concat_conditioner
        self.crossattn_conditioner = crossattn_conditioner

    def forward(self, c_concat, c_crossattn) -> dict:
        return {"c_concat": [self.concat_conditioner(c_concat)],
                "c_crossattn": [self.crossattn_conditioner(c_crossattn)]}


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
