"""Fused GEGLU feed-forward: a hand-written CUDA kernel (`csrc/geglu.cu`) and
its plain PyTorch version.

Counterpart of `sd_tpu/kernels/geglu.py`. Weights are in torch Linear layout
(w1 [2I, C], w2 [C, I]; the TPU package's are the transposes); activations
keep the [..., C] layout of the TPU package.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build

_KERNEL_WIDTHS = (128, 256, 320, 384, 512, 640)


def _geglu_xla(x, w1, b1, w2, b2):
    """Plain version with the kernel's numerics: fp32-accumulated products,
    exact (erf) gelu in fp32, the gated activation rounded to x's dtype."""
    dt = x.dtype
    h = F.linear(x.float(), w1.float()) + b1.float()
    inner = w1.shape[0] // 2
    a, g = h[..., :inner], h[..., inner:]
    y = (a * F.gelu(g)).to(dt)
    out = F.linear(y.float(), w2.float()) + b2.float()
    return out.to(dt)


def geglu_wants_pallas(n_tokens: int, c: int, inner: int,
                       dtype: torch.dtype = torch.bfloat16) -> bool:
    """The TPU gate's shape rule: many tokens, weights of at most 11 MB
    (the TPU kernel kept them whole in VMEM), and the kernel's dtype."""
    if dtype != torch.bfloat16:
        return False
    if n_tokens < 2048 or n_tokens % 256 != 0:
        return False
    weight_bytes = (c * 2 * inner + inner * c) * 2
    return inner % 128 == 0 and weight_bytes <= 11 * 1024 * 1024


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused `(x@w1ᵀ+b1) → a·gelu(g) → @w2ᵀ+b2` over flattened tokens.
    Forward only: on the card an input that needs a gradient raises."""
    if not x.is_cuda:
        return _geglu_xla(x, w1, b1, w2, b2)
    kernels.refuse_grad("geglu_ff", x, w1, b1, w2, b2)
    C = x.shape[-1]
    inner = w1.shape[0] // 2
    if w1.shape != (2 * inner, C) or w2.shape != (C, inner) \
            or b1.shape != (2 * inner,) or b2.shape != (C,):
        raise ValueError("geglu_ff: weight shapes do not match x")
    if C not in _KERNEL_WIDTHS or inner % 32:
        raise ValueError(f"geglu_ff: kernel takes C in {_KERNEL_WIDTHS} and "
                         f"inner % 32 == 0, got C={C}, inner={inner}")
    for t, name in ((x, "x"), (w1, "w1"), (b1, "b1"), (w2, "w2"), (b2, "b2")):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"geglu_ff: {name} must be contiguous bfloat16 "
                             f"on {x.device}")
    xf = x.reshape(-1, C)
    out = torch.empty_like(xf)
    fn = _build.function("geglu", "sd_geglu_fwd",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    code = fn(xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
              b2.data_ptr(), out.data_ptr(), xf.shape[0], C, inner,
              _build.stream_ptr(x.device))
    _build.check(code, "sd_geglu_fwd")
    kernels.LAUNCHES["geglu_ff"] += 1
    return out.view(x.shape)


def geglu_ff_trainable(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """`geglu_ff` for inference, the plain version (autograd's own forward
    and backward) when a gradient is wanted: the TPU package's
    `geglu_ff_trainable` (a custom VJP whose training forward is XLA's)."""
    if kernels.needs_grad(x, w1, b1, w2, b2):
        return _geglu_xla(x, w1, b1, w2, b2)
    return geglu_ff(x, w1, b1, w2, b2)
