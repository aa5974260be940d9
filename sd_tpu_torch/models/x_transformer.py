"""The mini x-transformers library behind the BERT-style text conditioner.

Counterpart of `sd_tpu/models/x_transformer.py`: `XAttention` (multi-head
attention with causal masking, talking heads, sparse top-k, memory key /
values and query / key masks), `AttentionLayers` (stacks of attention,
cross-attention and feed-forward blocks with pre- or post-norm, macaron and
sandwich layouts, ScaleNorm / RMSNorm / rezero and GRU-gated residuals),
`XEncoder` and `TransformerWrapper` (token and absolute-position embeddings,
memory tokens, final LayerNorm, logits or embeddings head). Names are the
TPU package's (`attn_{i}`, `cross_{i}`, `ff_{i}`, `norm_{i}`, `rezero_{i}`,
`gate_{i}`, `gate_c_{i}`, `token_emb`, `pos_emb`, `memory_tokens`,
`to_logits`), so `weights.load_flax_params` maps the tree mechanically.

The attention keeps the TPU package's explicit form: logits from an fp32
product, masked to −1e9, softmax in fp32, the probabilities cast to the
values' dtype before PV (fp32 accumulation); it needs the probability
tensor for talking heads, top-k and the masks, so no flash kernel serves
it, as none does in the TPU package. The feed-forward is the UNet's
`FeedForwardGEGLU` (its fused kernel where the shape rule sends it). Dropout,
inside a training step's `dropout_rng`, at the TPU package's sites: the
attention probabilities before PV, the feed-forward's activation, the
embeddings after the positions are added.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.attention import FeedForwardGEGLU, LayerNorm32
from sd_tpu_torch.nn.layers import Dense, _empty, dropout

BIG_NEG = -1e9


class ScaleNorm(nn.Module):
    """x·g / max(‖x‖₂·C^-1/2, eps) with one scalar gain `g`, in fp32."""

    def __init__(self, eps: float = 1e-5, *, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.g = _empty((), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        n = torch.clamp(n * x.shape[-1] ** -0.5, min=self.eps)
        return (x.float() / n * self.g.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """x·g / max(‖x‖₂·C^-1/2, eps) with a gain `g` per channel, in fp32."""

    def __init__(self, dim: int, eps: float = 1e-8, *, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.g = _empty((dim,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        n = torch.clamp(n * x.shape[-1] ** -0.5, min=self.eps)
        return (x.float() / n * self.g.float()).to(x.dtype)


class XAttention(nn.Module):
    """Multi-head attention of x [B, N, dim] over itself or `context` [B, M,
    context_dim]: bias-free `to_q` / `to_k` / `to_v`, `num_mem_kv` learned
    key / value slots (`mem_k`, `mem_v` [heads, n, dim_head]) ahead of the
    keys, talking heads (`pre_softmax_proj` / `post_softmax_proj` [heads,
    heads] mixing the logits and the probabilities across heads), the
    query / key masks and the causal mask (the memory slots always
    visible), the top-k logits of each row kept (`sparse_topk`), `to_out`
    with bias."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 context_dim: int | None = None, causal: bool = False,
                 talking_heads: bool = False, sparse_topk: int | None = None,
                 num_mem_kv: int = 0, dropout: float = 0.0, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        inner = heads * dim_head
        kv_dim = context_dim or dim
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.talking_heads, self.sparse_topk = talking_heads, sparse_topk
        self.num_mem_kv, self.dropout = num_mem_kv, dropout
        self.to_q = Dense(dim, inner, bias=False, **kw)
        self.to_k = Dense(kv_dim, inner, bias=False, **kw)
        self.to_v = Dense(kv_dim, inner, bias=False, **kw)
        if num_mem_kv > 0:
            self.mem_k = _empty((heads, num_mem_kv, dim_head), dtype, device)
            self.mem_v = _empty((heads, num_mem_kv, dim_head), dtype, device)
        if talking_heads:
            self.pre_softmax_proj = _empty((heads, heads), dtype, device)
            self.post_softmax_proj = _empty((heads, heads), dtype, device)
        self.to_out = Dense(inner, dim, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None) -> torch.Tensor:
        B, N, _ = x.shape
        kv = x if context is None else context
        M = kv.shape[1]
        h, d, n_mem = self.heads, self.dim_head, self.num_mem_kv
        q = self.to_q(x).reshape(B, N, h, d)
        k = self.to_k(kv).reshape(B, M, h, d)
        v = self.to_v(kv).reshape(B, M, h, d)
        if n_mem > 0:
            mem = lambda p, like: p.permute(1, 0, 2)[None].expand(B, n_mem, h, d).to(like.dtype)
            k = torch.cat([mem(self.mem_k, k), k], dim=1)
            v = torch.cat([mem(self.mem_v, v), v], dim=1)
            M += n_mem

        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
        if self.talking_heads:
            logits = torch.einsum("bhqk,hg->bgqk", logits, self.pre_softmax_proj.float())
        if mask is not None or context_mask is not None:
            ones = lambda n: torch.ones((B, n), dtype=torch.bool, device=x.device)
            q_mask = mask if mask is not None else ones(N)
            if context is None:
                k_mask = q_mask
            else:
                k_mask = context_mask if context_mask is not None else ones(kv.shape[1])
            if n_mem > 0:
                k_mask = torch.cat([ones(n_mem), k_mask], dim=1)
            pair = q_mask[:, None, :, None] & k_mask[:, None, None, :]
            logits = torch.where(pair, logits, torch.full_like(logits, BIG_NEG))
        if self.causal:
            i = torch.arange(N, device=x.device)[:, None]
            j = torch.arange(M, device=x.device)[None, :]
            logits = logits.masked_fill(j - n_mem > i, BIG_NEG)
        if self.sparse_topk is not None and self.sparse_topk < M:
            kth = logits.topk(self.sparse_topk, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, torch.full_like(logits, BIG_NEG), logits)

        probs = torch.softmax(logits, dim=-1)
        if self.talking_heads:
            probs = torch.einsum("bhqk,hg->bgqk", probs, self.post_softmax_proj.float())
        probs = dropout(probs, self.dropout, self)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
        return self.to_out(out.reshape(B, N, h * d).to(x.dtype))


class AttentionLayers(nn.Module):
    """The block stack: layer types ("a" self-attention, "c"
    cross-attention, "f" feed-forward) of (a, c, f) with `cross_attend`,
    (f, a, f) with `macaron` (each FF halved), else (a, f), `depth` times;
    `sandwich_coef` c makes it c attentions, the default layout depth − c
    times, then c FFs. Each layer: residual, norm (before the branch with
    `pre_norm`, after the residual sum without; LayerNorm, ScaleNorm,
    RMSNorm, or none under rezero), the branch, its scalar `rezero_{i}`
    gain, and the sum or, with `gate_residual`, the GRU gate of
    `gate_{i}` / `gate_c_{i}`. Built on the card unless `device` names
    another."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64, *,
                 causal: bool = False, cross_attend: bool = False,
                 context_dim: int | None = None, use_scalenorm: bool = False,
                 use_rmsnorm: bool = False, use_rezero: bool = False,
                 gate_residual: bool = False, macaron: bool = False,
                 sandwich_coef: int | None = None, talking_heads: bool = False,
                 sparse_topk: int | None = None, num_mem_kv: int = 0, ff_glu: bool = True,
                 dropout: float = 0.0, pre_norm: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.dim, self.pre_norm, self.macaron = dim, pre_norm, macaron
        self.use_rezero, self.gate_residual = use_rezero, gate_residual
        if cross_attend:
            default = ("a", "c", "f")
        elif macaron:
            default = ("f", "a", "f")
        else:
            default = ("a", "f")
        if sandwich_coef:
            c = sandwich_coef
            self.layer_types = ("a",) * c + default * (depth - c) + ("f",) * c
        else:
            self.layer_types = default * depth
        for idx, lt in enumerate(self.layer_types):
            if not use_rezero:
                norm = (ScaleNorm(**kw) if use_scalenorm else RMSNorm(dim, **kw)
                        if use_rmsnorm else LayerNorm32(dim, **kw))
                setattr(self, f"norm_{idx}", norm)
            if lt == "a":
                setattr(self, f"attn_{idx}", XAttention(
                    dim, heads, dim_head, causal=causal, talking_heads=talking_heads,
                    sparse_topk=sparse_topk, num_mem_kv=num_mem_kv, dropout=dropout, **kw))
            elif lt == "c":
                setattr(self, f"cross_{idx}", XAttention(
                    dim, heads, dim_head, context_dim=context_dim, dropout=dropout, **kw))
            else:
                setattr(self, f"ff_{idx}", FeedForwardGEGLU(dim, glu=ff_glu, dropout=dropout,
                                                            **kw))
            if use_rezero:
                setattr(self, f"rezero_{idx}", _empty((), dtype, device))
            if gate_residual:
                setattr(self, f"gate_{idx}", Dense(2 * dim, 2 * dim, **kw))
                setattr(self, f"gate_c_{idx}", Dense(2 * dim, dim, **kw))

    def _norm(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return x if self.use_rezero else getattr(self, f"norm_{idx}")(x)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None) -> torch.Tensor:
        for idx, lt in enumerate(self.layer_types):
            residual = x
            h = self._norm(idx, x) if self.pre_norm else x
            if lt == "a":
                h = getattr(self, f"attn_{idx}")(h, mask=mask)
            elif lt == "c":
                h = getattr(self, f"cross_{idx}")(h, context=context, mask=mask,
                                                  context_mask=context_mask)
            else:
                h = getattr(self, f"ff_{idx}")(h)
                if self.macaron:
                    h = h * 0.5
            if self.use_rezero:
                h = h * getattr(self, f"rezero_{idx}")
            if self.gate_residual:
                z, r = torch.sigmoid(getattr(self, f"gate_{idx}")(
                    torch.cat([residual, h], dim=-1))).chunk(2, dim=-1)
                cand = torch.tanh(getattr(self, f"gate_c_{idx}")(
                    torch.cat([r * residual, h], dim=-1)))
                x = (1 - z) * residual + z * cand
            else:
                x = residual + h
            if not self.pre_norm:
                x = self._norm(idx, x)
        return x


def XEncoder(dim: int, depth: int, **kwargs) -> AttentionLayers:
    """A non-causal `AttentionLayers`."""
    if kwargs.pop("causal", False):
        raise ValueError("an encoder cannot be causal")
    return AttentionLayers(dim, depth, causal=False, **kwargs)


class TransformerWrapper(nn.Module):
    """Token ids [B, L] → `token_emb` + the first L rows of `pos_emb`
    [max_seq_len, dim], `num_memory_tokens` learned `memory_tokens` ahead
    (the mask extended over them), the attention stack (`attn_layers`, an
    `AttentionLayers` / `XEncoder`, or a plain stack of (dim, depth, heads,
    causal) under that name), the final LayerNorm `norm`, the memory tokens
    dropped, then the embeddings [B, L, dim] or, with `return_logits` (by
    default `not return_embeddings`), `to_logits` [B, L, num_tokens]; the
    head exists in both modes. Built on the card unless `device` names
    another."""

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int | None = None,
                 depth: int | None = None, heads: int = 8, *, num_memory_tokens: int = 0,
                 emb_dropout: float = 0.0, return_embeddings: bool = True,
                 causal: bool = False, attn_layers: AttentionLayers | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        if attn_layers is None:
            if dim is None or depth is None:
                raise ValueError("TransformerWrapper needs either attn_layers or (dim, depth)")
            attn_layers = AttentionLayers(dim, depth, heads, dim_head=64, causal=causal, **kw)
        dim = attn_layers.dim
        self.num_memory_tokens, self.emb_dropout = num_memory_tokens, emb_dropout
        self.return_embeddings = return_embeddings
        self.token_emb = nn.Embedding(num_tokens, dim, **kw).requires_grad_(False)
        self.pos_emb = _empty((max_seq_len, dim), dtype, device)
        if num_memory_tokens > 0:
            self.memory_tokens = _empty((num_memory_tokens, dim), dtype, device)
        self.attn_layers = attn_layers
        self.norm = LayerNorm32(dim, **kw)
        self.to_logits = Dense(dim, num_tokens, **kw)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor | None = None,
                return_logits: bool | None = None) -> torch.Tensor:
        B, L = tokens.shape
        x = self.token_emb(tokens)
        x = dropout(x + self.pos_emb[None, :L].to(x.dtype), self.emb_dropout, self)
        n_mem = self.num_memory_tokens
        if n_mem > 0:
            x = torch.cat([self.memory_tokens[None].expand(B, -1, -1).to(x.dtype), x], dim=1)
            if mask is not None:
                mask = torch.cat([torch.ones((B, n_mem), dtype=torch.bool, device=mask.device),
                                  mask], dim=1)
        x = self.norm(self.attn_layers(x, mask=mask))[:, n_mem:]
        want_logits = not self.return_embeddings if return_logits is None else return_logits
        return self.to_logits(x) if want_logits else x
