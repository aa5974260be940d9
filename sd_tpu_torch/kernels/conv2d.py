"""Direct 3×3 SAME convolution: a hand-written CUDA kernel
(`csrc/conv2d.cu`) and its plain PyTorch version.

Counterpart of `sd_tpu/kernels/conv2d.py` (`conv3x3_same`, `_xla_conv3x3`,
`conv3x3_same_trainable`, `conv3x3_wants_pallas`, `training_trace`).
Activations are NHWC as in the TPU package; the weight is the torch OIHW
tensor (the TPU package's is HWIO).
"""

from __future__ import annotations

import contextvars
import ctypes

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              stride: int = 1, padding=1) -> torch.Tensor:
    """NHWC convolution through F.conv2d on a channels-last view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _xla_conv3x3(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Plain version (`nn.Conv` semantics): the conv in x's dtype, then the
    bias added in x's dtype."""
    return conv_nhwc(x, w.to(x.dtype), None) + b.to(x.dtype)


# Set while a training step runs (`training_trace`), as the TPU package's
# `_TRAIN_CTX_VAR` is set around a traced train step: the conv kernel and the
# head-packed flash kernel stay out of training. A ContextVar, so concurrent
# callers in other threads or tasks do not see one another's flag.
_TRAIN_CTX_VAR = contextvars.ContextVar("sd_tpu_torch_training", default=False)


class training_trace:
    """Context manager marking a training step: the conv kernel and the
    head-packed flash kernel are not chosen inside it."""

    def __enter__(self):
        self._token = _TRAIN_CTX_VAR.set(True)

    def __exit__(self, *exc):
        _TRAIN_CTX_VAR.reset(self._token)
        return False


def conv3x3_wants_pallas(shape: tuple, c_in: int, c_out: int,
                         dtype: torch.dtype = torch.bfloat16) -> bool:
    """The TPU gate's shape rule: big spatial maps with channel counts in
    whole 128s, in the kernel's dtype, outside a training step."""
    if _TRAIN_CTX_VAR.get() or dtype != torch.bfloat16:
        return False
    H, W = shape[1], shape[2]
    if c_in < 128 or c_in % 128 != 0 or c_out % 128 != 0:
        return False
    return H * W >= 128 * 128 and W >= 128


def conv3x3_same(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3×3 conv of x [B, H, W, C] with w [O, C, 3, 3] and
    b [O]; fp32 accumulation, output in x's dtype. Forward only: on the card
    an input that needs a gradient raises."""
    if not x.is_cuda:
        return _xla_conv3x3(x, w, b)
    kernels.refuse_grad("conv3x3_same", x, w, b)
    B, H, W, C = x.shape
    O = w.shape[0]
    if w.shape != (O, C, 3, 3) or b.shape != (O,):
        raise ValueError(f"conv3x3_same: w {tuple(w.shape)}, b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if C % 32 or O % 128:
        raise ValueError(f"conv3x3_same: kernel takes C % 32 == 0 and "
                         f"O % 128 == 0, got C={C}, O={O}")
    for t, name in ((x, "x"), (w, "w"), (b, "b")):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"conv3x3_same: {name} must be bfloat16 on {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_same: x must be contiguous NHWC")
    # the kernel reads the weight as [O][3][3][C]: OIHW in channels_last
    wk = w.contiguous(memory_format=torch.channels_last)
    bk = b.contiguous()
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    fn = _build.function("conv2d", "sd_conv3x3_fwd",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
              B, H, W, C, O, _build.stream_ptr(x.device))
    _build.check(code, "sd_conv3x3_fwd")
    kernels.LAUNCHES["conv3x3_same"] += 1
    return y


def conv3x3_same_trainable(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """`conv3x3_same` for inference, the plain conv (autograd's own forward
    and backward) when a gradient is wanted: the TPU package's
    `conv3x3_same_trainable`."""
    if kernels.needs_grad(x, w, b):
        return _xla_conv3x3(x, w, b)
    return conv3x3_same(x, w, b)
