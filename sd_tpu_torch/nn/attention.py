"""Attention blocks: codec self-attention and the SD transformer
(self/cross-attention, GEGLU feed-forward, SpatialTransformer).

Counterpart of `sd_tpu/nn/attention.py`, on the SD-v1 path: the unmasked
self-attention branch through the head-packed flash kernel at inference and
the differentiable flash attention in training, the cross-attention branch
through the fused cross-attention kernel where the TPU package's opt-in gate
holds (`SD_TPU_PALLAS_XATTN=1`) and the plain einsum attention otherwise,
self-attention through [B, H, S, D] projections where the opt-in packed
route holds (`SD_TPU_ATTN_PACKED=1`, after the head-packed one), the
GEGLU feed-forward through the fused kernel where the TPU package's shape
rule sends it (their plain versions when a gradient is wanted). NHWC layout;
LayerNorm and softmax in fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_tpu_torch.kernels import attention as attn_k
from sd_tpu_torch.kernels import cross_attention as xattn_k
from sd_tpu_torch.kernels import geglu as geglu_k
from sd_tpu_torch.nn.layers import Conv2d, Dense, GroupNorm32, LayerNorm


class LayerNorm32(LayerNorm):
    """LayerNorm computed in fp32 with flax's eps of 1e-6."""


class AttnBlock(nn.Module):
    """Codec self-attention: GN → 1×1 q/k/v → single-head attention over
    H·W tokens → 1×1 proj_out → residual."""

    def __init__(self, channels: int, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm32(channels, 32, eps=1e-6, **kw)
        self.q = Conv2d(channels, channels, 1, **kw)
        self.k = Conv2d(channels, channels, 1, **kw)
        self.v = Conv2d(channels, channels, 1, **kw)
        self.proj_out = Conv2d(channels, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, H * W, 1, C)
        k = self.k(h).reshape(B, H * W, 1, C)
        v = self.v(h).reshape(B, H * W, 1, C)
        out = attn_k.dot_product_attention(q, k, v).reshape(B, H, W, C)
        return x + self.proj_out(out)


class CrossAttention(nn.Module):
    """Multi-head attention with kv from `context` (or x for
    self-attention); to_q/to_k/to_v without bias, to_out with bias."""

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        kw = dict(dtype=dtype, device=device)
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, **kw)
        self.to_k = Dense(context_dim, inner, bias=False, **kw)
        self.to_v = Dense(context_dim, inner, bias=False, **kw)
        self.to_out = Dense(inner, query_dim, **kw)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        B, N, C = x.shape
        ctx = x if context is None else context
        M = ctx.shape[1]
        h, d = self.heads, self.dim_head
        dt = self.to_q.weight.dtype
        if context is None and attn_k.hpacked_flash_ok(N, M, h, d, dt):
            # projection-native [B, N, H·D] straight into the kernel
            out = attn_k.hpacked_flash_attention(self.to_q(x), self.to_k(x), self.to_v(x), h)
            return self.to_out(out)
        if context is not None and xattn_k.crossattn_kv_wants_pallas(N, M, h, d, C, dt):
            # K/V projected plainly (77 tokens), then q-projection, softmax
            # and out-projection in one kernel
            return xattn_k.crossattn_kv_trainable(
                x.to(dt).contiguous(), self.to_q.weight, self.to_k(ctx), self.to_v(ctx),
                self.to_out.weight, self.to_out.bias, h)
        if context is None and attn_k.packed_flash_ok(N, M, h, d, dt):
            # opt-in: [B, H, S, D] projections, heads folded into the batch
            xd = x.to(dt)
            proj = lambda lin: torch.einsum("bsc,hdc->bhsd", xd, lin.weight.view(h, d, C))
            out = attn_k.packed_flash_attention(proj(self.to_q), proj(self.to_k),
                                                proj(self.to_v))
            return (torch.einsum("bhsd,chd->bsc", out, self.to_out.weight.view(C, h, d))
                    + self.to_out.bias)
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        out = attn_k.dot_product_attention(
            q.reshape(B, N, h, d), k.reshape(B, M, h, d),
            v.reshape(B, M, h, d)).reshape(B, N, h * d)
        return self.to_out(out)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward: proj_in to 2·4C, a·gelu_erf(g), proj_out to C —
    the fused kernel where the TPU package's shape rule sends it."""

    def __init__(self, dim: int, mult: int = 4, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        inner = dim * mult
        self.inner = inner
        self.proj_in = Dense(dim, 2 * inner, dtype=dtype, device=device)
        self.proj_out = Dense(inner, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.proj_in.weight.dtype)
        C = x.shape[-1]
        args = (x, self.proj_in.weight, self.proj_in.bias,
                self.proj_out.weight, self.proj_out.bias)
        if geglu_k.geglu_wants_pallas(x.numel() // C, C, self.inner, x.dtype):
            return geglu_k.geglu_ff_trainable(*args)
        return geglu_k._geglu_xla(*args)


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attention → cross-attention → GEGLU feed-forward, each
    with a residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm32(dim, **kw)
        self.attn1 = CrossAttention(dim, None, heads, dim_head, **kw)
        self.norm2 = LayerNorm32(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, **kw)
        self.norm3 = LayerNorm32(dim, **kw)
        self.ff = FeedForwardGEGLU(dim, **kw)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN → 1×1 proj_in → `depth` transformer blocks over H·W tokens →
    zero-init 1×1 proj_out → residual."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 depth: int = 1, context_dim: int | None = None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm32(channels, 32, eps=1e-6, **kw)
        self.proj_in = Conv2d(channels, inner, 1, **kw)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, **kw))
        self.proj_out = Conv2d(inner, channels, 1, **kw)
        self.proj_out.zero_init = True

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[-1]
        h = h.reshape(B, H * W, inner)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        return x + self.proj_out(h.reshape(B, H, W, inner))
