"""Attention front-end: one signature, the flash kernel or the plain path.

Counterpart of `sd_tpu/kernels/attention.py`. Layout q [B, Sq, H, D],
k/v [B, Skv, H, D]; the softmax runs in fp32 whatever the input dtype.

The shape rules below copy the TPU package's gates (`_pallas_ok`,
`hpacked_flash_ok`) with the backend check replaced by the kernel's dtype:
the CUDA kernel is bf16 only, so other dtypes take the plain path on any
device. Where a rule holds, the kernel wrapper runs (the kernel on the card,
its plain version elsewhere). `dot_product_attention` reaches the
differentiable `flash_attention`; the head-packed kernel is inference-only
and, as on the TPU, not chosen inside a training step (`training_trace`).

The inference variants are read from the environment at each call, as the
TPU package reads them when it traces (`sd_tpu/kernels/attention.py:207-210,
253-259`): `SD_TPU_FLASH_EXP=bf16` runs the softmax exponential in bf16,
`SD_TPU_FLASH_PV=int8` the PV product on int8 codes. Attention the gates
send to the plain path (the 77-token cross-attention, fp32, short sequences)
ignores them, as `_xla_attention` does.

So are the TPU package's routing switches (`sd_tpu/kernels/attention.py:149,
151, 188, 190, 232-234`): `SD_TPU_ATTN_IMPL=xla` sends every attention to the
plain path and turns the head-packed and packed routes off, `pallas` sends
`dot_product_attention` to the flash wrapper whatever the shape rule says
(bf16 only, by the dtype rule above; the `impl=` keyword does the same);
`SD_TPU_ATTN_HPACKED=0` turns the head-packed route off; `SD_TPU_ATTN_PACKED=1`
adds the opt-in [B, H, S, D] route (`packed_flash_attention`, heads folded into
the kernel's batch). `SD_TPU_FLASH_BWD=chunked` is read by the differentiable
flash attention (`flash_attention.use_pallas_bwd`).
"""

from __future__ import annotations

import os

import torch

from sd_tpu_torch.kernels import conv2d
from sd_tpu_torch.kernels import flash_attention as fa


# the TPU package's `_xla_attention` and `_xla_ref` are the same function
_xla_attention = fa._xla_ref


def _flash_shape_ok(sq: int, skv: int, d: int) -> bool:
    # the TPU gates' shape conditions: q rows in 128-row tiles, head dim up to
    # the codec's single-head 512, and long enough kv that the dense logits
    # are the bottleneck (cross-attention over 77 tokens stays plain)
    return sq % 128 == 0 and d <= 512 and skv >= 512 and sq >= 512


def flash_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """`_pallas_ok`: whether [B, S, H, D] attention takes the flash kernel."""
    return (q.dtype == torch.bfloat16
            and _flash_shape_ok(q.shape[1], k.shape[1], q.shape[3]))


def _impl_is_xla() -> bool:
    return os.environ.get("SD_TPU_ATTN_IMPL") == "xla"


def hpacked_flash_ok(sq: int, skv: int, heads: int, d: int,
                     dtype: torch.dtype = torch.bfloat16) -> bool:
    """`hpacked_flash_ok`: whether projection-native [B, S, H·D]
    self-attention takes the flash kernel (default on, off with
    `SD_TPU_ATTN_HPACKED=0` or `SD_TPU_ATTN_IMPL=xla`; never in a training
    step: the kernel has no backward)."""
    if os.environ.get("SD_TPU_ATTN_HPACKED", "1") != "1" or _impl_is_xla():
        return False
    if conv2d._TRAIN_CTX_VAR.get():
        return False
    return dtype == torch.bfloat16 and _flash_shape_ok(sq, skv, d)


def packed_flash_ok(sq: int, skv: int, heads: int, d: int,
                    dtype: torch.dtype = torch.bfloat16) -> bool:
    """`packed_flash_ok`: whether self-attention takes the [B, H, S, D]
    route (opt-in, `SD_TPU_ATTN_PACKED=1`; off with `SD_TPU_ATTN_IMPL=xla`;
    training included: the route is differentiable)."""
    if os.environ.get("SD_TPU_ATTN_PACKED") != "1" or _impl_is_xla():
        return False
    return dtype == torch.bfloat16 and _flash_shape_ok(sq, skv, d)


def packed_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, scale: float | None = None) -> torch.Tensor:
    """Flash attention over [B, H, S, D] self-attention tensors, heads folded
    into the kernel's batch as [B·H, S, 1, D] (no variants, as the TPU
    package's route passes none)."""
    B, H, S, D = q.shape
    fold = lambda x: x.contiguous().reshape(B * H, x.shape[2], 1, D)
    out = fa.flash_attention(fold(q), fold(k), fold(v), scale=scale)
    return out.reshape(B, H, S, D)


def flash_variants() -> dict:
    """The inference variants the environment asks for now."""
    return {"softmax_dtype": (torch.bfloat16 if os.environ.get("SD_TPU_FLASH_EXP") == "bf16"
                              else torch.float32),
            "pv_quant": "int8" if os.environ.get("SD_TPU_FLASH_PV") == "int8" else "none"}


def hpacked_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            heads: int, *, scale: float | None = None) -> torch.Tensor:
    """Flash attention over projection-native [B, S, H·D] tensors, with the
    variants the environment asks for."""
    return fa.flash_attention_hpacked(q, k, v, heads, scale=scale, **flash_variants())


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float | None = None,
                          impl: str | None = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H, D] tensors. `impl`:
    "xla" (the plain path), "pallas" (the flash wrapper, bf16 inputs) or
    None (the shape rule decides); `SD_TPU_ATTN_IMPL` sets it when not
    given, and any other value takes the plain path, as in the TPU package."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    impl = impl or os.environ.get("SD_TPU_ATTN_IMPL")
    use_flash = (q.dtype == torch.bfloat16 if impl == "pallas"
                 else impl is None and flash_ok(q, k))
    if use_flash:
        return fa.flash_attention(q, k, v, scale=scale, **flash_variants())
    return _xla_attention(q, k, v, scale)
