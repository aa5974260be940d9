"""Shared low-level blocks: fp32 GroupNorm (with the opt-in kernel
dispatch), timestep embeddings, NHWC linear/conv layers and the 3×3 conv
with the kernel dispatch.

Counterpart of `sd_tpu/nn/layers.py`. Layout is NHWC as in the TPU package.
A layer stores its parameters in one dtype (`dtype`, flax's `param_dtype`)
and computes in `compute_dtype` (flax's `dtype`): it casts its parameters
and its input to it at use, and the gradient reaches the stored tensors
through those casts. `compute_dtype=None` computes in the stored dtype, so
a model cast in place (`init_gan_state`, the pipelines) computes in what it
was cast to, and a cast between equal dtypes is the tensor itself: nothing
moves where the two agree. The norms compute in fp32 whatever they are
given.

`dropout` is the one function that draws dropout masks: from the generator
a training step sets with `dropout_rng` (flax's `deterministic=False` with
a 'dropout' rng), at the modules' flax sites; without one, or in a module
in eval mode, it is the identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.kernels import conv2d as conv_k
from sd_tpu_torch.kernels import groupnorm as gn_k


# the step's dropout generator (`dropout_rng`); None: no dropout anywhere
_DROPOUT_GEN: contextvars.ContextVar = contextvars.ContextVar("sd_tpu_torch_dropout",
                                                              default=None)

# test hook: fn(module, name, shape, keep) -> bool keep mask, in place of the draw
mask_hook = None


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator | None):
    """Dropout on for the calls inside, its masks drawn from `generator`
    (None: off)."""
    token = _DROPOUT_GEN.set(generator)
    try:
        yield
    finally:
        _DROPOUT_GEN.reset(token)


def dropout_generator() -> torch.Generator | None:
    """The generator `dropout_rng` set, or None."""
    return _DROPOUT_GEN.get()


def dropout(x: torch.Tensor, rate: float, module: nn.Module,
            name: str = "Dropout_0", cols: tuple[int, int, int] | None = None) -> torch.Tensor:
    """flax's `nn.Dropout(rate)` at `module`'s child `name`: x / keep where
    a uniform draw from the step's generator is below keep = 1 − rate, 0
    elsewhere, in x's dtype. The identity at rate 0, in eval mode and
    outside `dropout_rng`. The draw is the whole batch's inside a
    data-parallel step (`parallel.mesh.global_draw`); `cols` (start, width,
    whole width): x holds those last-dim columns of the whole activation (a
    tensor-parallel rank's), and the mask is the whole draw's columns."""
    gen = _DROPOUT_GEN.get()
    if rate <= 0.0 or gen is None or not module.training:
        return x
    keep = 1.0 - rate
    if mask_hook is not None:
        mask = torch.as_tensor(mask_hook(module, name, tuple(x.shape), keep),
                               device=x.device)
    else:
        from sd_tpu_torch.parallel.mesh import global_draw

        rest = (*x.shape[1:-1], x.shape[-1] if cols is None else cols[2])[:x.dim() - 1]
        mask = global_draw(lambda n: torch.rand((n, *rest), generator=gen, device=gen.device),
                           x.shape[0])
        if cols is not None:
            mask = mask[..., cols[0]:cols[0] + cols[1]]
        mask = mask.to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def _empty(shape, dtype, device, channels_last=False):
    t = torch.empty(shape, dtype=dtype, device=device)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """`nn.Dense`: y = x @ Wᵀ + b with W stored [out, in] (torch layout).
    Split over a model axis (`parallel/mesh.py shard_module_`), `tp` is
    (the axis, "col" | "row") and the layer holds its rank's piece."""

    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        self.weight = _empty((out_features, in_features), dtype, device)
        self.bias = _empty((out_features,), dtype, device) if bias else None
        self.compute_dtype = compute_dtype

    @property
    def cdtype(self) -> torch.dtype:
        """The dtype the layer computes in."""
        return self.compute_dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp[0].linear(self, x, self.tp[1])
        dt = self.cdtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Module):
    """`nn.Conv` over NHWC input; weight stored OIHW in channels_last memory
    format (physically [O, kh, kw, C]). Padding kernel_size // 2 on each
    side unless `padding` is given (0 for a patch embedding)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, bias: bool = True, padding: int | None = None,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        self.weight = _empty((out_channels, in_channels, kernel_size, kernel_size),
                             dtype, device, channels_last=True)
        self.bias = _empty((out_channels,), dtype, device) if bias else None
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        self.compute_dtype = compute_dtype

    @property
    def cdtype(self) -> torch.dtype:
        """The dtype the layer computes in."""
        return self.compute_dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cdtype
        return conv_k.conv_nhwc(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                                self.stride, self.padding)


class Conv3x3(Conv2d):
    """Stride-1 SAME 3×3 conv that dispatches big-spatial shapes to the
    direct-conv kernel (`kernels/conv2d.py`) under the TPU package's shape
    rule, and everything else to the plain conv."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__(in_channels, out_channels, 3, dtype=dtype,
                         compute_dtype=compute_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_conv3x3(x, self.weight, self.bias, self.compute_dtype)


def apply_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Functional 3×3 SAME conv with the kernel-vs-plain dispatch, in
    `compute_dtype` (None: the weight's)."""
    dt = compute_dtype or w.dtype
    x, w, b = x.to(dt), w.to(dt), b.to(dt)
    if conv_k.conv3x3_wants_pallas(x.shape, x.shape[-1], w.shape[0], x.dtype):
        return conv_k.conv3x3_same_trainable(x, w, b)
    return conv_k._xla_conv3x3(x, w, b)


class GroupNorm32(nn.Module):
    """GroupNorm over the channel (last) axis, computed in fp32 and returned
    in the input dtype. Exactly `num_groups` groups when C divides; otherwise
    the largest divisor of C that keeps >= 2 channels per group (the TPU
    package's fallback for tiny test widths). Where the TPU package's gate
    holds (opt-in, `SD_TPU_PALLAS_GN=1`) it runs the GroupNorm kernel, as
    `_GroupNormCore` does; otherwise flax's module math, unclamped."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 *, dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        if channels % num_groups == 0:
            groups = num_groups
        else:
            groups = min(num_groups, max(channels // 2, 1))
            while channels % groups != 0:
                groups -= 1
        self.groups = groups
        self.eps = eps
        self.weight = _empty((channels,), dtype, device)
        self.bias = _empty((channels,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        if gn_k.group_norm_wants_pallas(x.shape, self.groups, x.dtype):
            # [B, S, C] rows for the kernel (a copy only if x is not NHWC-dense)
            xs = x.reshape(x.shape[0], -1, C).contiguous()
            y = gn_k.group_norm_trainable(xs, self.weight, self.bias,
                                          self.groups, self.eps)
            return y.reshape(x.shape)
        x32 = x.float()
        xr = x32.reshape(x.shape[0], -1, self.groups, C // self.groups)
        mu = xr.mean(dim=(1, 3), keepdim=True)
        var = (xr * xr).mean(dim=(1, 3), keepdim=True) - mu * mu
        y = (xr - mu) * torch.rsqrt(var + self.eps)
        y = y.reshape(x.shape) * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis computed in fp32, returned in the input
    dtype (flax's default eps of 1e-6 unless given)."""

    def __init__(self, features: int, eps: float = 1e-6, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty((features,), dtype, device)
        self.bias = _empty((features,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True) -> torch.Tensor:
    """Sinusoidal timestep embeddings [N, dim] in fp32; cat([cos, sin]) with
    `flip_sin_to_cos=True` (the default), else cat([sin, cos])."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    else:
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def zeros_init_conv(in_channels: int, out_channels: int, kernel_size: int = 3,
                    *, dtype=torch.float32, compute_dtype=None, device=None) -> Conv2d:
    """Conv whose kernel and bias start at zero (`init_params_` honours the
    `zero_init` mark)."""
    conv = Conv2d(in_channels, out_channels, kernel_size, dtype=dtype,
                  compute_dtype=compute_dtype, device=device)
    conv.zero_init = True
    return conv
