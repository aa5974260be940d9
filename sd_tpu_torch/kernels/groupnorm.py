"""GroupNorm over [B, S, C]: a hand-written CUDA kernel (`csrc/groupnorm.cu`)
and its plain PyTorch version.

Counterpart of `sd_tpu/kernels/groupnorm.py` (`group_norm`,
`group_norm_xla`, `group_norm_trainable`, `group_norm_wants_pallas`).
Statistics in fp32 with the variance E[x²] − μ² clamped at 0, an optional
fp32 SiLU epilogue, output in x's dtype. Opt-in, as in the TPU package:
`SD_TPU_PALLAS_GN=1`.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build
from sd_tpu_torch.kernels import conv2d

# about two blocks per SM of the H100 (132 SMs) across the batch
_TARGET_BLOCKS = 264


def group_norm_xla(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                   groups: int = 32, eps: float = 1e-5,
                   act: str | None = None) -> torch.Tensor:
    """Plain version with the kernel's numerics (fp32 fast-variance stats,
    clamped at 0; SiLU in fp32 before the cast)."""
    B, S, C = x.shape
    x32 = x.float().reshape(B, S, groups, C // groups)
    mu = x32.mean(dim=(1, 3), keepdim=True)
    var = (x32 * x32).mean(dim=(1, 3), keepdim=True) - mu * mu
    y = (x32 - mu) * torch.rsqrt(var.clamp_min(0.0) + eps)
    y = y.reshape(B, S, C) * scale.float() + bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def _chunks(B: int, S: int) -> tuple[int, int]:
    """(rows per chunk, chunks) for the kernel's (chunks, B) grid."""
    want = max(1, min(S, -(-_TARGET_BLOCKS // B)))
    rows = -(-S // want)
    return rows, -(-S // rows)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm of x [B, S, C] over its channel (last) axis with affine
    scale and bias [C]; output in x's dtype. Forward only: on the card an
    input that needs a gradient raises."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: act must be None or 'silu', got {act!r}")
    if not x.is_cuda:
        return group_norm_xla(x, scale, bias, groups=groups, eps=eps, act=act)
    kernels.refuse_grad("group_norm", x, scale, bias)
    B, S, C = x.shape
    if C % 8 or C % groups:
        raise ValueError(f"group_norm: kernel takes C % 8 == 0 and C % groups == 0, "
                         f"got C={C}, groups={groups}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm: x must be contiguous, 16-byte aligned bfloat16")
    if scale.shape != (C,) or bias.shape != (C,) or scale.dtype != bias.dtype \
            or scale.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_norm: scale and bias must be [{C}] of one dtype, "
                         "float32 or bfloat16")
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm: {name} must be contiguous on {x.device}")
    rows, nchunk = _chunks(B, S)
    part = torch.empty((B, nchunk, groups, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = _build.function("groupnorm", "sd_group_norm_fwd",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    code = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
              part.data_ptr(), B, S, C, groups, rows, nchunk, float(eps),
              int(act == "silu"), int(scale.dtype == torch.float32),
              _build.stream_ptr(x.device))
    _build.check(code, "sd_group_norm_fwd")
    kernels.LAUNCHES["group_norm"] += 1
    return y


def group_norm_trainable(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int = 32, eps: float = 1e-5,
                         act: str | None = None) -> torch.Tensor:
    """`group_norm` for inference, the plain version (autograd's own forward
    and backward) when a gradient is wanted: the TPU package's
    `group_norm_trainable`."""
    if kernels.needs_grad(x, scale, bias):
        return group_norm_xla(x, scale, bias, groups=groups, eps=eps, act=act)
    return group_norm(x, scale, bias, groups=groups, eps=eps, act=act)


def group_norm_wants_pallas(shape: tuple, groups: int,
                            dtype: torch.dtype = torch.bfloat16) -> bool:
    """The TPU gate: opt-in (`SD_TPU_PALLAS_GN=1`), outside a training step,
    the kernel's dtype, channels in whole groups (at least 128), and
    [S, C] slabs of at most 3 MB (the UNet levels; the up-path concats and
    the codec maps stay plain)."""
    if conv2d._TRAIN_CTX_VAR.get():
        return False
    if os.environ.get("SD_TPU_PALLAS_GN", "0") != "1":
        return False
    if dtype != torch.bfloat16:
        return False
    C = shape[-1]
    S = 1
    for d in shape[1:-1]:
        S *= d
    if C < 128 or C % groups != 0:
        return False
    if S < 64 or S % 8 != 0:
        return False
    return S * C * 2 <= 3 * 1024 * 1024
