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
"""

from __future__ import annotations

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


def hpacked_flash_ok(sq: int, skv: int, heads: int, d: int,
                     dtype: torch.dtype = torch.bfloat16) -> bool:
    """`hpacked_flash_ok`: whether projection-native [B, S, H·D]
    self-attention takes the flash kernel (never in a training step: the
    kernel has no backward)."""
    if conv2d._TRAIN_CTX_VAR.get():
        return False
    return dtype == torch.bfloat16 and _flash_shape_ok(sq, skv, d)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H, D] tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if flash_ok(q, k):
        return fa.flash_attention(q, k, v, scale=scale)
    return _xla_attention(q, k, v, scale)
