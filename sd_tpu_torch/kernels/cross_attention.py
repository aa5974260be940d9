"""Fused small-KV cross-attention: a hand-written CUDA kernel
(`csrc/cross_attention.cu`) and its plain PyTorch version.

Counterpart of `sd_tpu/kernels/cross_attention.py` (`crossattn_kv`,
`crossattn_kv_xla`, `crossattn_kv_trainable`, `crossattn_kv_wants_pallas`):
q-projection, an exact fp32 softmax over the pre-projected K/V of a short
context (the 77 CLIP tokens) and the output projection, in one kernel.
Weights are in torch Linear layout (wq [H·D, C], wo [C, H·D]; the TPU
package's are the transposes). Opt-in, as in the TPU package:
`SD_TPU_PALLAS_XATTN=1`.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build
from sd_tpu_torch.kernels import conv2d

LOG2E = 1.4426950408889634


def crossattn_kv_xla(x, wq, k, v, wo, bo, heads: int, *,
                     scale: float | None = None) -> torch.Tensor:
    """Plain version with the TPU package's reference numerics: the
    projections in x's dtype, fp32 logits and softmax, p cast to v's dtype
    before the fp32-accumulated p·v, the head outputs cast to x's dtype."""
    B, N, _ = x.shape
    M = k.shape[1]
    HD = wq.shape[0]
    d = HD // heads
    if scale is None:
        scale = d ** -0.5
    q = F.linear(x, wq).reshape(B, N, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.reshape(B, M, heads, d).float()) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                     v.reshape(B, M, heads, d).float())
    o = o.reshape(B, N, HD).to(x.dtype)
    return F.linear(o, wo, bo).to(x.dtype)


def crossattn_kv(x: torch.Tensor, wq: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                 heads: int, *, scale: float | None = None) -> torch.Tensor:
    """Fused `x·wqᵀ → softmax over k/v [B, M, H·D] → ·woᵀ + bo` of x
    [B, N, C]; output [B, N, C] in x's dtype. Forward only: on the card an
    input that needs a gradient raises."""
    if not x.is_cuda:
        return crossattn_kv_xla(x, wq, k, v, wo, bo, heads, scale=scale)
    kernels.refuse_grad("crossattn_kv", x, wq, k, v, wo, bo)
    B, N, C = x.shape
    M, HD = k.shape[1], wq.shape[0]
    d = HD // heads
    if (HD != heads * d or wq.shape != (HD, C) or k.shape != (B, M, HD)
            or v.shape != k.shape or wo.shape != (C, HD) or bo.shape != (C,)):
        raise ValueError(f"crossattn_kv: shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, wo {tuple(wo.shape)}, "
                         f"bo {tuple(bo.shape)} for {heads} heads")
    if C % 8 or d % 8 or not 1 <= M <= 256:
        raise ValueError(f"crossattn_kv: kernel takes C % 8 == 0, head dim % 8 == 0 "
                         f"and 1 <= M <= 256, got C={C}, d={d}, M={M}")
    for t, name in ((x, "x"), (wq, "wq"), (k, "k"), (v, "v"), (wo, "wo"), (bo, "bo")):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"crossattn_kv: {name} must be contiguous, 16-byte "
                             f"aligned bfloat16 on {x.device}")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(x)
    fn = _build.function("cross_attention", "sd_crossattn_fwd",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
    code = fn(x.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(), wo.data_ptr(),
              bo.data_ptr(), out.data_ptr(), B, N, C, M, heads, d,
              float(scale) * LOG2E, _build.stream_ptr(x.device))
    _build.check(code, "sd_crossattn_fwd")
    kernels.LAUNCHES["crossattn_kv"] += 1
    return out


def crossattn_kv_trainable(x, wq, k, v, wo, bo, heads: int, *,
                           scale: float | None = None) -> torch.Tensor:
    """`crossattn_kv` for inference, the plain version (autograd's own
    forward and backward) when a gradient is wanted: the TPU package's
    `crossattn_kv_trainable`."""
    if kernels.needs_grad(x, wq, k, v, wo, bo):
        return crossattn_kv_xla(x, wq, k, v, wo, bo, heads, scale=scale)
    return crossattn_kv(x, wq, k, v, wo, bo, heads, scale=scale)


def crossattn_kv_wants_pallas(N: int, M: int, heads: int, d: int, C: int,
                              dtype: torch.dtype = torch.bfloat16) -> bool:
    """The TPU gate: opt-in (`SD_TPU_PALLAS_XATTN=1`), outside a training
    step, the kernel's dtype, a short context (M ≤ 256) against at least 256
    queries, head dims and widths in multiples of 8, and Wq + Wo of at most
    8 MB."""
    if conv2d._TRAIN_CTX_VAR.get():
        return False
    if os.environ.get("SD_TPU_PALLAS_XATTN", "0") != "1":
        return False
    if dtype != torch.bfloat16:
        return False
    if M > 256 or N < 256 or N % 8 != 0:
        return False
    if d % 8 != 0 or C % 8 != 0:
        return False
    return 2 * C * heads * d * 2 <= 8 * 1024 * 1024
