"""Direct 3×3 SAME convolution and the fused GroupNorm → SiLU → 3×3 conv:
hand-written CUDA kernels and their plain PyTorch versions. `conv3x3_same`
launches `csrc/conv2d_sm90.cu` (wgmma on TMA-loaded windows and weights);
the fused form launches `csrc/conv2d.cu`'s `PRO` form, whose plain form is
the Hopper conv's yardstick on the card. `_conv_window_ref` is a plain
version that follows the Hopper kernel's tiling and index arithmetic.

Counterpart of `sd_tpu/kernels/conv2d.py` (`conv3x3_same`, `_xla_conv3x3`,
`conv3x3_same_trainable`, `conv3x3_wants_pallas`, `training_trace`,
`gn_silu_conv3x3`, `_gn_stats_affine`, `_gn_silu_conv_xla`,
`gn_silu_conv3x3_trainable`). Activations are NHWC as in the TPU package;
the weight is the torch OIHW tensor (the TPU package's is HWIO). As in the
TPU package, no model path calls the fused form.
"""

from __future__ import annotations

import contextvars
import ctypes
import os

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
    """The TPU gate: on unless `SD_TPU_PALLAS_CONV` is set to anything but
    "1", outside a training step, the kernel's dtype, big spatial maps with
    channel counts in whole 128s."""
    if _TRAIN_CTX_VAR.get() or dtype != torch.bfloat16:
        return False
    if os.environ.get("SD_TPU_PALLAS_CONV", "1") != "1":
        return False
    H, W = shape[1], shape[2]
    if c_in < 128 or c_in % 128 != 0 or c_out % 128 != 0:
        return False
    return H * W >= 128 * 128 and W >= 128


def _conv_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor):
    """Checks what the conv kernels take; (weight as [O][3][3][C], bias,
    output) for a launch."""
    B, H, W, C = x.shape
    O = w.shape[0]
    if w.shape != (O, C, 3, 3) or b.shape != (O,):
        raise ValueError(f"{name}: w {tuple(w.shape)}, b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if C % 32 or O % 128:
        raise ValueError(f"{name}: kernel takes C % 32 == 0 and "
                         f"O % 128 == 0, got C={C}, O={O}")
    for t, tname in ((x, "x"), (w, "w"), (b, "b")):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"{name}: {tname} must be bfloat16 on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    # the kernel reads the weight as [O][3][3][C]: OIHW in channels_last
    wk = w.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")
    return wk, b.contiguous(), torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)


# the C entry point of each source of the plain 3×3 conv: the Hopper kernel
# `conv3x3_same` launches, and conv2d.cu's, the yardstick it is timed against
_CONV_ENTRY = {"sm90": ("conv2d_sm90", "sd_conv3x3_fwd_sm90"),
               "template": ("conv2d", "sd_conv3x3_fwd")}


def _launch_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 source: str = "sm90") -> torch.Tensor:
    """One launch of the 3×3 conv on `source` (see `_CONV_ENTRY`); the
    Hopper kernel's pre-pass writes the weights into a scratch of the
    weight's size, in the order its stages read them."""
    wk, bk, y = _conv_operands("conv3x3_same", x, w, b)
    lib, symbol = _CONV_ENTRY[source]
    ptrs = [x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr()]
    scratch = torch.empty_like(wk) if source == "sm90" else None   # alive past the launch
    if scratch is not None:
        ptrs.append(scratch.data_ptr())
    fn = _build.function(lib, symbol,
                         [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(*ptrs, *x.shape, y.shape[-1], _build.stream_ptr(x.device))
    _build.check(code, symbol)
    return y


def conv3x3_same(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3×3 conv of x [B, H, W, C] with w [O, C, 3, 3] and
    b [O]; fp32 accumulation, the bias added in fp32, output in x's dtype.
    On the card the Hopper kernel (`csrc/conv2d_sm90.cu`), which takes
    C % 32 == 0 and O % 128 == 0. Forward only: on the card an input that
    needs a gradient raises."""
    if not x.is_cuda:
        return _xla_conv3x3(x, w, b)
    kernels.refuse_grad("conv3x3_same", x, w, b)
    y = _launch_conv(x, w, b)
    kernels.LAUNCHES["conv3x3_same"] += 1
    return y


# the Hopper kernel's tile: output rows and pixels of a block, and the
# channels of one TMA box (`csrc/conv2d_sm90.cu` TH, TW)
CONV_TILE = (2, 128)
CONV_BOX_CHANNELS = 8


def _conv_window_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     tile: tuple[int, int] = CONV_TILE) -> torch.Tensor:
    """Plain version of the Hopper conv that repeats its index arithmetic:
    for each block of tile = (rows, pixels) outputs, the zero-filled input
    window as the TMA boxes land it, [box][row][pixel][8 channels] over rows
    y0 - 1 … y0 + rows and pixels x0 - 1 … x0 + pixels; each tap's A rows
    taken at the flat offset (r + dy)·(pixels + 2) + px + dx of that window;
    the nine products of each box accumulated in fp32, the bias added in
    fp32, one rounding to x's dtype; outputs past H or W dropped. x
    [B, H, W, C] with C % 8 == 0, w [O, C, 3, 3], b [O]."""
    TH, TW = tile
    B, H, W, C = x.shape
    O = w.shape[0]
    G = CONV_BOX_CHANNELS
    WH, WW = TH + 2, TW + 2
    # the B operand of tap (dy, dx) and box j: [O][8] rows of w[o, 8j:8j+8, dy, dx]
    wk = w.float().permute(2, 3, 1, 0).reshape(9, C // G, G, O)
    r, px = torch.meshgrid(torch.arange(TH), torch.arange(TW), indexing="ij")
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    xf = x.float()
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            win = torch.zeros((B, C // G, WH, WW, G), device=x.device)
            ys, xs = max(y0 - 1, 0), max(x0 - 1, 0)
            ye, xe = min(y0 - 1 + WH, H), min(x0 - 1 + WW, W)
            win[:, :, ys - (y0 - 1):ye - (y0 - 1), xs - (x0 - 1):xe - (x0 - 1)] = (
                xf[:, ys:ye, xs:xe].unflatten(-1, (C // G, G)).permute(0, 3, 1, 2, 4))
            flat = win.reshape(B, C // G, WH * WW, G)
            acc = torch.zeros((B, TH * TW, O), device=x.device)
            for j in range(C // G):
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    rows = ((r + dy) * WW + px + dx).flatten()
                    acc += flat[:, j, rows] @ wk[tap, j]
            out = (acc + b.float()).to(x.dtype).view(B, TH, TW, O)
            y[:, y0:y0 + TH, x0:x0 + TW] = out[:, :min(TH, H - y0), :min(TW, W - x0)]
    return y


def conv3x3_same_trainable(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """`conv3x3_same` for inference, the plain conv (autograd's own forward
    and backward) when a gradient is wanted: the TPU package's
    `conv3x3_same_trainable`."""
    if kernels.needs_grad(x, w, b):
        return _xla_conv3x3(x, w, b)
    return conv3x3_same(x, w, b)


# -- GroupNorm → SiLU → 3×3 conv ----------------------------------------------------


def _gn_stats_affine(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                     groups: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) fp32 (a, c) [B, C] folding GroupNorm's statistics
    and affine, so the normalized value is x·a + c: fp32 fast-variance stats
    clamped at 0, as in the TPU package."""
    B, H, W, C = x.shape
    cg = C // groups
    x32g = x.float().reshape(B, H * W, groups, cg)
    mu = x32g.mean(dim=(1, 3))                                  # [B, g]
    mu2 = (x32g * x32g).mean(dim=(1, 3))
    rinv = torch.rsqrt((mu2 - mu * mu).clamp_min(0.0) + eps)
    a = rinv.repeat_interleave(cg, -1) * gn_scale.float()[None]
    c = gn_bias.float()[None] - mu.repeat_interleave(cg, -1) * a
    return a, c


def _gn_silu_conv_xla(x, gn_scale, gn_bias, w, b, groups: int = 32,
                      eps: float = 1e-6) -> torch.Tensor:
    """Plain version with the fused kernel's numerics: normalize and SiLU in
    fp32, cast to x's dtype, then the conv of `_xla_conv3x3`."""
    a, c = _gn_stats_affine(x, gn_scale, gn_bias, groups, eps)
    y = x.float() * a[:, None, None, :] + c[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(x.dtype)
    return _xla_conv3x3(y, w, b)


def gn_silu_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor, *, groups: int = 32,
                    eps: float = 1e-6) -> torch.Tensor:
    """conv3x3(silu(GroupNorm(x))) of x [B, H, W, C]: the statistics in plain
    torch (`_gn_stats_affine`, one read of x), then one kernel that applies
    silu(x·a + c) to each input window as it lands and runs the 3×3 SAME conv,
    so the normalized tensor never reaches device memory. Forward only: on
    the card an input that needs a gradient raises."""
    if not x.is_cuda:
        return _gn_silu_conv_xla(x, gn_scale, gn_bias, w, b, groups, eps)
    kernels.refuse_grad("gn_silu_conv3x3", x, gn_scale, gn_bias, w, b)
    if x.shape[-1] % groups:
        raise ValueError(f"gn_silu_conv3x3: {x.shape[-1]} channels in {groups} groups")
    wk, bk, y = _conv_operands("gn_silu_conv3x3", x, w, b)
    a, c = _gn_stats_affine(x, gn_scale, gn_bias, groups, eps)
    fn = _build.function("conv2d", "sd_gn_silu_conv3x3_fwd",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), a.data_ptr(), c.data_ptr(),
              y.data_ptr(), *x.shape, y.shape[-1], _build.stream_ptr(x.device))
    _build.check(code, "sd_gn_silu_conv3x3_fwd")
    kernels.LAUNCHES["gn_silu_conv3x3"] += 1
    return y


class _GnSiluConv(torch.autograd.Function):
    """The TPU package's `_gnsc_fwd` / `_gnsc_bwd`: the fused kernel forward,
    a backward that recomputes the plain version once and differentiates it."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, w, b, groups, eps):
        ctx.save_for_backward(x, gn_scale, gn_bias, w, b)
        ctx.groups, ctx.eps = groups, eps
        return gn_silu_conv3x3(x, gn_scale, gn_bias, w, b, groups=groups, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _gn_silu_conv_xla(*saved, ctx.groups, ctx.eps)
            grads = torch.autograd.grad(out, saved, g)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None, None)


def gn_silu_conv3x3_trainable(x, gn_scale, gn_bias, w, b, groups: int = 32,
                              eps: float = 1e-6) -> torch.Tensor:
    """`gn_silu_conv3x3` with a backward: the kernel forward, the plain
    version recomputed and differentiated in backward (unlike
    `conv3x3_same_trainable`, the kernel runs under grad too)."""
    return _GnSiluConv.apply(x, gn_scale, gn_bias, w, b, groups, float(eps))
