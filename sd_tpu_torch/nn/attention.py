"""Attention blocks: codec self-attention, linear attention and the
`make_attn` factory, and the SD transformer (self/cross-attention, GEGLU
feed-forward, SpatialTransformer).

Counterpart of `sd_tpu/nn/attention.py`. The codec's `make_attn` builds
`AttnBlock` (vanilla), `LinearAttention` (linear: k softmaxed over the
tokens, context = kᵀv, out = context·q, each product accumulated in fp32)
or an identity (none). On the SD-v1 path: the unmasked
self-attention branch through the head-packed flash kernel at inference and
the differentiable flash attention in training, the cross-attention branch
through the fused cross-attention kernel where the TPU package's opt-in gate
holds (`SD_TPU_PALLAS_XATTN=1`) and the plain einsum attention otherwise,
self-attention through [B, H, S, D] projections where the opt-in packed
route holds (`SD_TPU_ATTN_PACKED=1`, after the head-packed one), the
GEGLU feed-forward through the fused kernel where the TPU package's shape
rule sends it (their plain versions when a gradient is wanted), and ToMe's
token merging around the self-attention where `tome_ratio` asks for it
(`nn/tome.py`). Two inference additions: the probe path, explicit fp32
softmax probabilities recorded for Self-Attention Guidance and the
cross-attention heatmaps (`utils/attn_viz.py`) at the calls
`nn/attn_probe.py` captures; and IP-Adapter's decoupled cross-attention
(`models/ip_adapter.py`, arXiv:2308.06721), a second attention read over
projected image tokens with adapter-owned K/V kernels ([in, out], the TPU
package's layout), summed before the output projection; a call with an
image payload stays off the fused cross-attention kernel, as in the TPU
package. NHWC layout; LayerNorm and softmax in fp32. Every block computes in
its layers' `compute_dtype` (the stored dtype when None). Dropout, inside a
training step's `dropout_rng`, at the TPU package's sites: each
cross-attention's output after `to_out` on every route, and the
feed-forward's gated activation before `proj_out` (the unfused GEGLU then,
as in the TPU package; the kernel route otherwise).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.kernels import attention as attn_k
from sd_tpu_torch.kernels import cross_attention as xattn_k
from sd_tpu_torch.kernels import geglu as geglu_k
from sd_tpu_torch.nn import attn_probe
from sd_tpu_torch.nn.layers import (Conv2d, Dense, GroupNorm32, LayerNorm, dropout,
                                    dropout_generator)
from sd_tpu_torch.nn.tome import build_tome


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class LayerNorm32(LayerNorm):
    """LayerNorm computed in fp32 with flax's eps of 1e-6."""


class AttnBlock(nn.Module):
    """Codec self-attention: GN → 1×1 q/k/v → single-head attention over
    H·W tokens → 1×1 proj_out → residual."""

    def __init__(self, channels: int, *, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
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


class LinearAttention(nn.Module):
    """kv-first linear attention: 1×1 `to_qkv` (no bias) → per head k
    softmaxed in fp32 over the H·W tokens, context = kᵀv and out = context·q
    with fp32 accumulation → 1×1 `to_out` → residual. O(N·d²) instead of
    O(N²·d); no kernel of its own, as in the TPU package."""

    def __init__(self, channels: int, heads: int = 4, dim_head: int = 32, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Conv2d(channels, 3 * inner, 1, bias=False, **kw)
        self.to_out = Conv2d(inner, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(B, H * W, 3, h, d)
        q, k, v = qkv.unbind(2)                                   # [B, N, h, d]
        k = torch.softmax(k.float(), dim=1).to(x.dtype)
        context = torch.einsum("bnhd,bnhe->bhde", k.float(), v.float())
        out = torch.einsum("bhde,bnhd->bnhe", context.to(x.dtype).float(), q.float())
        return x + self.to_out(out.to(x.dtype).reshape(B, H, W, h * d))


class _Identity(nn.Module):
    """`make_attn("none")`: no attention, no parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def make_attn(attn_type: str, channels: int, *, dtype=torch.float32,
              compute_dtype=None, device=None) -> nn.Module:
    """The codec's attention block over `channels`: "vanilla" (`AttnBlock`),
    "linear" (`LinearAttention`) or "none". The TPU package names each such
    unnamed child `<class name>_<k>`, k counting the blocks in the order
    they are built."""
    kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
    if attn_type == "vanilla":
        return AttnBlock(channels, **kw)
    if attn_type == "linear":
        return LinearAttention(channels, **kw)
    if attn_type == "none":
        return _Identity()
    raise ValueError(f"unknown attn_type {attn_type!r}")


class CrossAttention(nn.Module):
    """Multi-head attention with kv from `context` (or x for
    self-attention); to_q/to_k/to_v without bias, to_out with bias, then
    dropout. Split over a model axis (`tp`, `parallel/mesh.py
    shard_module_`), the block attends over its rank's heads and its
    output projection is summed over the axis, the bias added once."""

    tp = None

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.to_q = Dense(query_dim, inner, bias=False, **kw)
        self.to_k = Dense(context_dim, inner, bias=False, **kw)
        self.to_v = Dense(context_dim, inner, bias=False, **kw)
        self.to_out = Dense(inner, query_dim, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                ip_kv: tuple | None = None) -> torch.Tensor:
        """`ip_kv`: IP-Adapter's (to_k_ip, to_v_ip, image tokens [B, n, Cc],
        scale), read by a cross-attention call only."""
        return dropout(self._attend(x, context, ip_kv), self.dropout, self)

    def _attend(self, x: torch.Tensor, context: torch.Tensor | None,
                ip_kv: tuple | None) -> torch.Tensor:
        B, N, C = x.shape
        ctx = x if context is None else context
        M = ctx.shape[1]
        h, d = self.heads, self.dim_head
        tp = self.tp
        if tp is not None:
            h //= tp.size
        dt = self.to_q.cdtype
        ip = ip_kv if context is not None else None
        probe = attn_probe.wants_capture(self, N, is_self=context is None)
        if probe is not None:
            # explicit softmax from fp32 logits, recorded for the caller
            q = self.to_q(x).reshape(B, N, h, d)
            k, v = (f(ctx).reshape(B, M, h, d).float() for f in (self.to_k, self.to_v))
            probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * d ** -0.5,
                                  dim=-1)
            attn_probe.record(probe, probs)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt).float(), v).to(dt)
            return self.to_out(self._add_ip(out, q, ip).reshape(B, N, h * d))
        if context is None and attn_k.hpacked_flash_ok(N, M, h, d, dt):
            # projection-native [B, N, H·D] straight into the kernel
            out = attn_k.hpacked_flash_attention(self.to_q(x), self.to_k(x), self.to_v(x), h)
            return self.to_out(out)
        if (context is not None and ip is None
                and xattn_k.crossattn_kv_wants_pallas(N, M, h, d, C, dt)):
            # K/V projected plainly (77 tokens), then q-projection, softmax
            # and out-projection in one kernel (split: its rank's heads, the
            # bias after the sum)
            bo = self.to_out.bias.to(dt)
            xk = x if tp is None else tp.enter(x)
            out = xattn_k.crossattn_kv_trainable(
                xk.to(dt).contiguous(), self.to_q.weight.to(dt), self.to_k(ctx),
                self.to_v(ctx), self.to_out.weight.to(dt),
                bo if tp is None else torch.zeros_like(bo), h)
            return out if tp is None else tp.reduce(out, self.to_out.bias)
        if context is None and attn_k.packed_flash_ok(N, M, h, d, dt):
            # opt-in: [B, H, S, D] projections, heads folded into the batch
            xd = (x if tp is None else tp.enter(x)).to(dt)
            proj = lambda lin: torch.einsum("bsc,hdc->bhsd", xd,
                                            lin.weight.to(dt).view(h, d, C))
            out = attn_k.packed_flash_attention(proj(self.to_q), proj(self.to_k),
                                                proj(self.to_v))
            out = torch.einsum("bhsd,chd->bsc", out, self.to_out.weight.to(dt).view(C, h, d))
            if tp is not None:
                return tp.reduce(out, self.to_out.bias)
            return out + self.to_out.bias.to(dt)
        q = self.to_q(x).reshape(B, N, h, d)
        out = attn_k.dot_product_attention(q, self.to_k(ctx).reshape(B, M, h, d),
                                           self.to_v(ctx).reshape(B, M, h, d))
        return self.to_out(self._add_ip(out, q, ip).reshape(B, N, h * d))

    def _add_ip(self, out: torch.Tensor, q: torch.Tensor, ip: tuple | None) -> torch.Tensor:
        """IP-Adapter's image read over the adapter's K/V, summed before
        to_out (none without `ip`)."""
        if ip is None:
            return out
        if self.tp is not None:
            raise NotImplementedError("IP-Adapter's image read over a tensor-parallel UNet: "
                                      "its K/V kernels are not split")
        B, _, h, d = q.shape
        dt = self.to_q.cdtype
        wk, wv, tok, scale = ip
        k_i = (tok.to(dt) @ wk.to(dt)).reshape(B, tok.shape[1], h, d)
        v_i = (tok.to(dt) @ wv.to(dt)).reshape(B, tok.shape[1], h, d)
        return out + scale * attn_k.dot_product_attention(q, k_i, v_i).to(out.dtype)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward: proj_in to 2·4C, a·gelu_erf(g), proj_out to C —
    the fused kernel where the TPU package's shape rule sends it. With
    `glu=False` the plain MLP: proj_in to 4C, exact-erf gelu, proj_out.
    Dropout on the activation before proj_out; with it on, the gated form
    is the unfused one (the kernel has no dropout), as in the TPU package.
    The weights are cast to the compute dtype, the biases added in fp32
    (flax's promotion), but on the kernel route, which takes bf16 ones."""

    tp = None    # the model axis it is split over (`parallel/mesh.py shard_module_`)

    def __init__(self, dim: int, mult: int = 4, *, glu: bool = True, dropout: float = 0.0,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        inner = dim * mult
        self.inner, self.glu, self.dropout = inner, glu, dropout
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.proj_in = Dense(dim, (2 if glu else 1) * inner, **kw)
        self.proj_out = Dense(inner, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.proj_in.cdtype
        x = x.to(dt)
        tp = self.tp
        inner = self.inner if tp is None else self.inner // tp.size
        # a split block holds the columns [rank·inner, (rank + 1)·inner) of the activation
        cols = None if tp is None else (tp.rank * inner, inner, self.inner)
        if not self.glu:
            return self.proj_out(dropout(F.gelu(self.proj_in(x)), self.dropout, self,
                                         cols=cols))
        C = x.shape[-1]
        if tp is not None:
            x = tp.enter(x)
        w1, w2 = self.proj_in.weight.to(dt), self.proj_out.weight.to(dt)
        b1, b2 = self.proj_in.bias, self.proj_out.bias
        bo = b2 if tp is None else torch.zeros_like(b2)     # split: added after the sum
        if self.dropout > 0.0 and self.training and dropout_generator() is not None:
            h = F.linear(x.float(), w1.float()) + b1.float()
            a, g = h[..., :inner], h[..., inner:]
            y = dropout((a * F.gelu(g)).to(dt), self.dropout, self, cols=cols)
            out = (F.linear(y.float(), w2.float()) + bo.float()).to(dt)
        elif geglu_k.geglu_wants_pallas(x.numel() // C, C, inner, x.dtype):
            out = geglu_k.geglu_ff_trainable(x, w1, b1.to(dt), w2, bo.to(dt))
        else:
            out = geglu_k._geglu_xla(x, w1, b1, w2, bo)
        return out if tp is None else tp.reduce(out, b2)


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attention → cross-attention → GEGLU feed-forward, each
    with a residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, dropout: float = 0.0, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.norm1 = LayerNorm32(dim, **kw)
        self.attn1 = CrossAttention(dim, None, heads, dim_head, dropout, **kw)
        self.norm2 = LayerNorm32(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dropout, **kw)
        self.norm3 = LayerNorm32(dim, **kw)
        self.ff = FeedForwardGEGLU(dim, dropout=dropout, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                tome=None, ip_kv: tuple | None = None) -> torch.Tensor:
        """`tome`: ToMe's (merge, unmerge): the self-attention runs on the
        merged tokens, each merged token taking its destination's output;
        the cross-attention and feed-forward stay at full resolution.
        `ip_kv`: IP-Adapter's image read for the cross-attention."""
        merge, unmerge = tome if tome is not None else (_identity, _identity)
        x = x + unmerge(self.attn1(merge(self.norm1(x))))
        x = x + self.attn2(self.norm2(x), context, ip_kv=ip_kv)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN → 1×1 proj_in → `depth` transformer blocks over H·W tokens →
    zero-init 1×1 proj_out → residual. With `tome_ratio` > 0, each block
    merges tokens around its self-attention (ToMe) where the grid has at
    least `tome_min_tokens` tokens and 2 rows and columns; both are read at
    every call."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 depth: int = 1, context_dim: int | None = None, dropout: float = 0.0, *,
                 tome_ratio: float = 0.0, tome_min_tokens: int = 1024,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.norm = GroupNorm32(channels, 32, eps=1e-6, **kw)
        self.proj_in = Conv2d(channels, inner, 1, **kw)
        self.depth = depth
        self.tome_ratio, self.tome_min_tokens = tome_ratio, tome_min_tokens
        for i in range(depth):
            setattr(self, f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, dropout, **kw))
        self.proj_out = Conv2d(inner, channels, 1, **kw)
        self.proj_out.zero_init = True

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                ip: tuple | None = None) -> torch.Tensor:
        """`ip`: IP-Adapter's ({block_name: {to_k_ip, to_v_ip}}, image
        tokens, scale) for this transformer's blocks."""
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[-1]
        h = h.reshape(B, H * W, inner)
        use_tome = (self.tome_ratio > 0.0 and H * W >= self.tome_min_tokens
                    and H >= 2 and W >= 2)
        for i in range(self.depth):
            built = build_tome(h, H, W, self.tome_ratio) if use_tome else None
            ip_kv = None
            if ip is not None and f"block_{i}" in ip[0]:
                entry = ip[0][f"block_{i}"]
                ip_kv = (entry["to_k_ip"], entry["to_v_ip"], ip[1], ip[2])
            h = getattr(self, f"block_{i}")(h, context,
                                            tome=None if built is None else built[:2],
                                            ip_kv=ip_kv)
        return x + self.proj_out(h.reshape(B, H, W, inner))
