"""PatchGAN discriminator and ActNorm.

Counterpart of `sd_tpu/models/discriminator.py` `NLayerDiscriminator`,
`ActNorm` and `actnorm_ddi` (the auxiliary `UNetGenerator` is not ported
yet). NHWC at the module's input and output.

Numerics follow flax, not torch:
  * a conv runs in `promote_types(input, weight)` (flax's `dtype=None`):
    with bf16 weights, fp32 images go through fp32 convs and a bf16
    reconstruction through bf16 convs until the first norm;
  * BatchNorm is flax's: fp32 output, batch statistics with the fast
    variance E[x²] − E[x]² clamped at 0, running statistics updated with
    momentum 0.9 on the old value and the same biased variance, the affine
    (x − mean)·(rsqrt(var + eps)·scale) + bias in fp32. The running
    statistics are buffers (`mean`, `var`); a forward in batch-stat mode
    updates them only when asked (`update_stats=True`), as flax does only
    under `mutable=["batch_stats"]`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.layers import _empty


class PromotingConv(nn.Module):
    """4×4 conv (padding 1) over NCHW activations in the promoted dtype of
    input and weight; weight OIHW in channels_last memory format."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bias: bool = True, *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty((out_channels, in_channels, 4, 4), dtype, device,
                             channels_last=True)
        self.bias = _empty((out_channels,), dtype, device) if bias else None
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, stride=self.stride, padding=1)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)` over
    the channel axis of NCHW activations."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty((channels,), dtype, device)
        self.bias = _empty((channels,), dtype, device)
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, use_running_average: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        x = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1 - self.momentum)
                    self.var.mul_(self.momentum).add_(var.detach(), alpha=1 - self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]


class ActNorm(nn.Module):
    """Per-channel affine h = scale·(x + loc) (the flow-style norm), with an
    optional log-determinant; `weight` is the TPU package's `scale`. Over
    the channel axis of NCHW activations."""

    def __init__(self, channels: int, logdet: bool = False, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.loc = _empty((channels,), dtype, device)
        self.weight = _empty((channels,), dtype, device)
        self.logdet = logdet

    def forward(self, x: torch.Tensor, reverse: bool = False):
        loc, scale = self.loc[:, None, None], self.weight[:, None, None]
        if reverse:
            return x / (scale + 1e-6) - loc
        h = scale * (x + loc)
        if self.logdet:
            ld = torch.log(torch.abs(self.weight) + 1e-6).sum() * x.shape[2] * x.shape[3]
            return h, ld * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        return h


@torch.no_grad()
def actnorm_ddi(norm: ActNorm, batch: torch.Tensor) -> None:
    """Data-dependent init, in place: loc and scale such that scale·(x + loc)
    has zero mean and unit (population) std per channel over `batch`
    (NHWC, as the TPU package's)."""
    mean = batch.float().mean(dim=(0, 1, 2))
    std = batch.float().std(dim=(0, 1, 2), correction=0)
    norm.loc.copy_(-mean)
    norm.weight.copy_(1.0 / (std + 1e-6))


class NLayerDiscriminator(nn.Module):
    """Pix2Pix PatchGAN: 4×4 stride-2 convs → a 1-channel logit map, NHWC
    in and out. `dtype` is the parameters' (BatchNorm's running statistics
    stay fp32); built on the card unless `device` names another."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, use_actnorm: bool = False,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.n_layers = n_layers
        self.conv0 = PromotingConv(3, ndf, 2, **kw)
        prev = 1
        for n in range(1, n_layers + 1):
            nf = min(2**n, 8)
            setattr(self, f"conv{n}", PromotingConv(ndf * prev, ndf * nf,
                                                     2 if n < n_layers else 1,
                                                     bias=use_actnorm, **kw))
            setattr(self, f"norm{n}", (ActNorm if use_actnorm else BatchNorm)(ndf * nf, **kw))
            prev = nf
        self.conv_out = PromotingConv(ndf * prev, 1, 1, **kw)

    def forward(self, x: torch.Tensor, *, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        """Logits [B, h, w, 1]. `train`: BatchNorm on the batch's statistics
        (else on the running ones); `update_stats`: fold them into the
        running statistics."""
        h = F.leaky_relu(self.conv0(x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            norm = getattr(self, f"norm{n}")
            if isinstance(norm, BatchNorm):
                h = norm(h, use_running_average=not train, update_stats=update_stats)
            else:
                h = norm(h)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


@torch.no_grad()
def init_discriminator_(disc: nn.Module, generator: torch.Generator) -> None:
    """The TPU package's initialisers: conv kernels N(0, 0.02²) (DCGAN),
    zero biases, unit norm scales, zero ActNorm loc, BatchNorm running
    statistics at mean 0, var 1."""
    for mod in disc.modules():
        if isinstance(mod, PromotingConv):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator,
                                         device=mod.weight.device) * 0.02)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (BatchNorm, ActNorm)):
            mod.weight.fill_(1.0)
            (mod.bias if isinstance(mod, BatchNorm) else mod.loc).zero_()
            if isinstance(mod, BatchNorm):
                mod.mean.zero_()
                mod.var.fill_(1.0)
