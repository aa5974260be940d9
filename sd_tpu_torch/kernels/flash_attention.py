"""Flash attention: hand-written CUDA kernels (`csrc/flash_attention.cu`,
`csrc/flash_attention_bwd.cu`), their plain PyTorch versions, and the
`torch.autograd.Function` that trains through them.

Counterpart of `sd_tpu/kernels/flash_attention.py`. The TPU package has two
forward kernels, `flash_attention` over [B, S, H, D] (transposed to
[B*H, S, D] around the kernel) and `flash_attention_hpacked` over the
projection-native [B, S, H*D]; here one kernel reads both through strides.
`flash_attention` is differentiable, as the TPU package's `jax.custom_vjp`
is: with grad off it runs the inference forward; with grad on, the training
forward that also keeps the base-2 row log-sum-exp, and a backward of a dQ
kernel (which writes delta = rowsum(dO∘O)) then a dK/dV kernel. Non-causal
only. `flash_attention_hpacked` is inference-only, as on the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _xla_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> torch.Tensor:
    """Plain attention with the kernel's numerics: fp32 logits and softmax,
    probabilities cast to the input dtype before the fp32-accumulated p·v."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _flash_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain training forward: (o [B, Sq, H, D] in q's dtype, lse2 [B, H, Sq]
    fp32), lse2 the base-2 log-sum-exp of the logits times scale·log2(e)."""
    s2 = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype).float(), v.float())
    return out.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _p_ds(q, k, v, lse, do, delta, scale: float):
    """p recomputed from lse2 (0 on rows whose lse2 is NEG_INF) and
    dS = p∘(dO·vᵀ − delta), both [B, H, Sq, Skv] fp32."""
    s2 = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    lse_ = lse[..., None]
    p = torch.where(lse_ > NEG_INF / 2, torch.exp2(s2 - lse_), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _flash_bwd_dq_ref(q, k, v, o, lse, do, scale: float):
    """Plain dQ with the kernel's numerics: (dq, delta), delta = rowsum(dO∘O)
    [B, H, Sq] fp32; dS cast to K's dtype before dS·K, fp32 accumulation."""
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    _, ds = _p_ds(q, k, v, lse, do, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), delta


def _flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale: float):
    """Plain dK/dV with the kernel's numerics: p cast to dO's dtype before
    pᵀ·dO and dS to Q's dtype before dSᵀ·Q, fp32 accumulation."""
    p, ds = _p_ds(q, k, v, lse, do, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_ref(q, k, v, o, lse, do, scale: float):
    """Plain backward of the training forward: (dq, dk, dv, delta)."""
    dq, delta = _flash_bwd_dq_ref(q, k, v, o, lse, do, scale)
    return (dq, *_flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale), delta)


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash attention: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"flash attention: {name} needs unit stride along D "
                         f"and strides that are multiples of 8, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} must be 16-byte aligned")


def _check_views(q, k, *rest, max_d: int = 512):
    """Shapes, head dim, device, dtype and strides of bf16 [B, S, H, D] views
    (`rest` are (tensor, name, like), `like` the view whose shape it has)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, D) or any(t.shape != like.shape for t, _, like in rest):
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, "
                         + ", ".join(f"{n} {tuple(t.shape)}" for t, n, _ in rest))
    if D % 8 or D > max_d:
        raise ValueError(f"flash attention: head dim {D} must be a multiple "
                         f"of 8 and at most {max_d}")
    devs = {q.device, k.device} | {t.device for t, _, _ in rest}
    if len(devs) != 1:
        raise ValueError(f"flash attention: tensors on {devs}")
    for t, name in ((q, "q"), (k, "k"), *((t, n) for t, n, _ in rest)):
        _check(t, name)
    return B, Sq, Skv, H, D


def _check_rows(t: torch.Tensor, name: str, B: int, H: int, Sq: int,
                device: torch.device) -> None:
    """A per-row statistic (lse2, delta): contiguous [B, H, Sq] fp32."""
    if (t.shape != (B, H, Sq) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"flash attention: {name} must be contiguous fp32 "
                         f"{(B, H, Sq)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, scale: float) -> None:
    """Run the inference kernel over strided [B, S, H, D] views (out written
    in place). It has no backward: an input that needs a gradient raises."""
    kernels.refuse_grad("flash attention forward", q, k, v)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (out, "out", q))
    fn = _build.function("flash_attention", "sd_flash_fwd", [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                                 ctypes.c_float, ctypes.c_void_p])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, H, Sq, Skv, D, _strides(q, k, v, out), float(scale) * LOG2E,
              _build.stream_ptr(q.device))
    _build.check(code, "sd_flash_fwd")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over q [B, Sq, H, D], k/v [B, Skv, H, D]: (o, lse2
    [B, H, Sq] fp32). On the card the kernel (head dim ≤ 128), else the plain
    version."""
    if not q.is_cuda:
        return _flash_lse_ref(q, k, v, scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (out, "out", q), max_d=128)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "sd_flash_fwd_lse",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                            ctypes.c_void_p])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), B, H, Sq, Skv, D, _strides(q, k, v, out),
              float(scale) * LOG2E, _build.stream_ptr(q.device))
    _build.check(code, "sd_flash_fwd_lse")
    kernels.LAUNCHES["flash_attention_lse"] += 1
    return out, lse


_BWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p])


def flash_bwd_dq(q, k, v, o, lse, do, scale: float):
    """(dq, delta [B, H, Sq] fp32) from the training forward's o and lse2
    and the output gradient do. On the card the dQ kernel, else the plain
    version."""
    if not q.is_cuda:
        return _flash_bwd_dq_ref(q, k, v, o, lse, do, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (o, "o", q), (do, "do", q),
                                    (dq, "dq", q), max_d=128)
    _check_rows(lse, "lse", B, H, Sq, q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "sd_flash_bwd_dq", _BWD_ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), B, H, Sq, Skv, D,
              _strides(q, k, v, o, do, dq), float(scale) * LOG2E, float(scale),
              _build.stream_ptr(q.device))
    _build.check(code, "sd_flash_bwd_dq")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) from lse2 and flash_bwd_dq's delta. On the card the dK/dV
    kernel (no atomics: the same bits on every run), else the plain
    version."""
    if not q.is_cuda:
        return _flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (do, "do", q), (dk, "dk", k),
                                    (dv, "dv", k), max_d=128)
    _check_rows(lse, "lse", B, H, Sq, q.device)
    _check_rows(delta, "delta", B, H, Sq, q.device)
    fn = _build.function("flash_attention_bwd", "sd_flash_bwd_dkv", _BWD_ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, H, Sq, Skv, D, _strides(q, k, v, do, dk, dv),
              float(scale) * LOG2E, float(scale), _build.stream_ptr(q.device))
    _build.check(code, "sd_flash_bwd_dkv")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The training path: the LSE forward, then the dQ and dK/dV kernels
    (the plain versions of all three off the card)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, out, lse, do, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over q [B, Sq, H, D], k/v [B, Skv, H, D] (non-causal);
    differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kernels.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, float(scale))
    if not q.is_cuda:
        return _xla_ref(q, k, v, scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, scale)
    kernels.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_hpacked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, heads: int, *,
                            scale: float | None = None) -> torch.Tensor:
    """Attention over projection-native q [B, Sq, H*D], k/v [B, Skv, H*D]:
    heads are read through strides, no transpose enters or leaves.
    Inference only (`hpacked_flash_ok` keeps training away from it)."""
    b, sq, hd = q.shape
    d = hd // heads
    if hd != heads * d:
        raise ValueError(f"width {hd} is not {heads} heads")
    if scale is None:
        scale = d ** -0.5
    split = lambda x: x.unflatten(2, (heads, d))
    if not q.is_cuda:
        return _xla_ref(split(q), split(k), split(v), scale).reshape(b, sq, hd)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(split(q), split(k), split(v), split(out), scale)
    kernels.LAUNCHES["flash_attention_hpacked"] += 1
    return out
