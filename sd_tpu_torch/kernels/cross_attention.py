"""Small-KV cross-attention: hand-written CUDA kernels and their plain
PyTorch version.

Counterpart of `sd_tpu/kernels/cross_attention.py` (`crossattn_kv`,
`crossattn_kv_xla`, `crossattn_kv_trainable`, `crossattn_kv_wants_pallas`):
q-projection, an exact fp32 softmax over the pre-projected K/V of a short
context (the 77 CLIP tokens) and the output projection. On the card
`crossattn_kv` runs `csrc/cross_attention_sm90.cu` in three launches on the
TPU kernel's rounding points: the q projection (a `wgmma` GEMM), the
attention over a block of query rows and one head (`xattn_plan`), and the
output projection (the same GEMM); `csrc/cross_attention.cu`, the fused
`mma.sync` form, is its yardstick. `crossattn_kv_xla` is the plain version
and `_crossattn_kernel_ref` the kernel's numerics (q scaled to base-2 logits and
rounded, p and O rounded) in plain torch. Weights are in torch Linear layout
(wq [H·D, C], wo [C, H·D]; the TPU package's are the transposes). Opt-in, as
in the TPU package: `SD_TPU_PALLAS_XATTN=1`.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build
from sd_tpu_torch.kernels import conv2d
from sd_tpu_torch.kernels.flash_attention import H100_SMS

LOG2E = 1.4426950408889634
# what `xattn_plan` reads of csrc/cross_attention_sm90.cu: the GEMM blocks'
# 128 rows x 128 columns and the shared memory a block may hold
XATTN_GEMM_TILE = 128
XATTN_MAX_SMEM = 232448
# the C entry point of each source: the Hopper kernels `crossattn_kv`
# launches, and cross_attention.cu's, the yardstick it is timed against
_XATTN_ENTRY = {"sm90": ("cross_attention_sm90", "sd_crossattn_fwd_sm90"),
                "template": ("cross_attention", "sd_crossattn_fwd")}


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


def _crossattn_kernel_ref(x, wq, k, v, wo, bo, heads: int, *,
                          scale: float | None = None) -> torch.Tensor:
    """Plain version of the kernels' arithmetic, the TPU kernel's rounding
    points: q = (x·wqᵀ in fp32)·scale·log2 e rounded to x's dtype, base-2
    logits in fp32, p = exp2(s − max) rounded to v's dtype for p·v, O =
    (p·v) / l rounded to x's dtype (l the sum of the unrounded p), then
    O·woᵀ in fp32, bo added in fp32, one rounding."""
    B, N, _ = x.shape
    M = k.shape[1]
    HD = wq.shape[0]
    d = HD // heads
    if scale is None:
        scale = d ** -0.5
    dt = x.dtype
    q = (F.linear(x.float(), wq.float()) * (scale * LOG2E)).to(dt).reshape(B, N, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.reshape(B, M, heads, d).float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                      v.reshape(B, M, heads, d).float())
    o = (pv / p.sum(dim=-1).transpose(1, 2)[..., None]).reshape(B, N, HD).to(dt)
    return (F.linear(o.float(), wo.float()) + bo.float()).to(dt)


class XattnPlan(NamedTuple):
    rows: int          # query rows of an attention block: 64 or 128
    mp: int            # the context padded: 80, or 256
    attend_blocks: int
    q_blocks: int      # blocks of the q projection (128 x 128 tiles)
    o_blocks: int      # ... and of the output projection
    smem: int          # shared memory of an attention block (bytes)


def xattn_plan(B: int, N: int, M: int, heads: int, d: int, C: int) -> XattnPlan:
    """The Hopper kernels' grids at x [B, N, C], a context of M tokens and
    heads × d, decided from the shape alone: the attention takes 128 query
    rows a block (two warpgroups sharing one K/V tile) where that grid fills
    a wave of the H100, else 64; each projection takes 128 × 128 output
    tiles. Raises on a shape the kernels do not take: C or d not a multiple
    of 8, M outside 1..256, or q, K and V of one block past shared memory."""
    if C < 8 or C % 8 or d < 8 or d % 8 or heads < 1 or not 1 <= M <= 256 \
            or B < 1 or N < 1:
        raise ValueError(f"crossattn_kv: kernel takes C % 8 == 0, head dim % 8 == 0 "
                         f"and 1 <= M <= 256, got C={C}, d={d}, M={M}")
    mp = 80 if M <= 80 else 256
    dp = -(-d // 16) * 16
    rows = 128 if -(-N // 128) * heads * B >= H100_SMS else 64
    smem = (rows + 2 * mp) * dp * 2 + 8
    if smem > XATTN_MAX_SMEM and rows == 128:
        rows, smem = 64, (64 + 2 * mp) * dp * 2 + 8
    if smem > XATTN_MAX_SMEM:
        raise ValueError(f"crossattn_kv: q, K and V of head dim {d} over {M} tokens "
                         f"need {smem} bytes of shared memory, more than {XATTN_MAX_SMEM}")
    tiles = -(-(B * N) // XATTN_GEMM_TILE)
    return XattnPlan(rows, mp, -(-N // rows) * heads * B,
                     tiles * -(-(heads * d) // XATTN_GEMM_TILE),
                     tiles * -(-C // XATTN_GEMM_TILE), smem)


def _launch_xattn(x, wq, k, v, wo, bo, heads: int, scale: float | None,
                  source: str = "sm90") -> torch.Tensor:
    """One call of the cross-attention on `source` (see `_XATTN_ENTRY`): the
    Hopper kernels' three launches over a scratch that holds q, then O, or
    the template's one."""
    B, N, C = x.shape
    M, HD = k.shape[1], wq.shape[0]
    d = HD // heads
    if (HD != heads * d or wq.shape != (HD, C) or k.shape != (B, M, HD)
            or v.shape != k.shape or wo.shape != (C, HD) or bo.shape != (C,)):
        raise ValueError(f"crossattn_kv: shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, wo {tuple(wo.shape)}, "
                         f"bo {tuple(bo.shape)} for {heads} heads")
    plan = xattn_plan(B, N, M, heads, d, C)
    for t, name in ((x, "x"), (wq, "wq"), (k, "k"), (v, "v"), (wo, "wo"), (bo, "bo")):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"crossattn_kv: {name} must be contiguous, 16-byte "
                             f"aligned bfloat16 on {x.device}")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(x)
    lib, symbol = _XATTN_ENTRY[source]
    ptrs = [x.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), out.data_ptr()]
    ints = [B, N, C, M, heads, d]
    tail = []
    if source == "sm90":
        qo = torch.empty((B, N, HD), dtype=x.dtype, device=x.device)   # alive past the launch
        ptrs.append(qo.data_ptr())
        tail = [plan.rows]
    fn = _build.function(lib, symbol, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
                         + [ctypes.c_float] + [ctypes.c_int] * len(tail) + [ctypes.c_void_p])
    with _build.on_device(x.device):
        code = fn(*ptrs, *ints, float(scale) * LOG2E, *tail, _build.stream_ptr(x.device))
    _build.check(code, symbol)
    return out


def crossattn_kv(x: torch.Tensor, wq: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                 heads: int, *, scale: float | None = None) -> torch.Tensor:
    """`x·wqᵀ → softmax over k/v [B, M, H·D] → ·woᵀ + bo` of x [B, N, C];
    output [B, N, C] in x's dtype. On the card the Hopper kernels
    (`csrc/cross_attention_sm90.cu`), which take C % 8 == 0, d % 8 == 0,
    1 ≤ M ≤ 256 and any N (`xattn_plan`), and raise on anything else. Forward
    only: on the card an input that needs a gradient raises."""
    if not x.is_cuda:
        return crossattn_kv_xla(x, wq, k, v, wo, bo, heads, scale=scale)
    kernels.refuse_grad("crossattn_kv", x, wq, k, v, wo, bo)
    out = _launch_xattn(x, wq, k, v, wo, bo, heads, scale)
    kernels.LAUNCHES["crossattn_kv"] += 1
    kernels.LAUNCHES["crossattn_sm90"] += 1
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
