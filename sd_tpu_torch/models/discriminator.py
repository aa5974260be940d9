"""PatchGAN discriminator and ActNorm.

Counterpart of `sd_tpu/models/discriminator.py` `NLayerDiscriminator`,
`ActNorm`, `actnorm_ddi` and the auxiliary GAN generator `UNetGenerator`
(reflection-padded convs, `ResidualBlock`s, transposed-conv upsampling).
NHWC at the module's input and output.

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
from sd_tpu_torch.nn.layers import Conv2d, _cast, _empty
from sd_tpu_torch.parallel.mesh import data_mean


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
            # a data-parallel step: the whole batch's statistics (every rank's mean)
            mean = data_mean(x.mean(dim=(0, 2, 3)))
            var = torch.clamp(data_mean((x * x).mean(dim=(0, 2, 3))) - mean * mean, min=0.0)
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


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC x reflection-padded by p on each spatial side (the edge row is
    not repeated, numpy's "reflect")."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect").permute(0, 2, 3, 1)


class ConvTranspose2x(nn.Module):
    """flax `nn.ConvTranspose(features, (3, 3), strides=(2, 2),
    padding="SAME")` over NHWC: the input dilated by 2 and padded (2, 1) on
    each spatial axis (lax's SAME padding of a transposed conv), then
    correlated with the kernel as stored (no flip); the output twice the
    input's size. Weight OIHW from flax's [kh, kw, in, out]."""

    def __init__(self, in_channels: int, out_channels: int, *, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__()
        self.weight = _empty((out_channels, in_channels, 3, 3), dtype, device,
                             channels_last=True)
        self.bias = _empty((out_channels,), dtype, device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        B, H, W, C = x.shape
        xd = x.new_zeros((B, C, 2 * H - 1, 2 * W - 1), dtype=dt)
        xd[:, :, ::2, ::2] = x.to(dt).permute(0, 3, 1, 2)
        y = F.conv2d(F.pad(xd, (2, 1, 2, 1)), self.weight.to(dt), _cast(self.bias, dt))
        return y.permute(0, 2, 3, 1)


class ResidualBlock(nn.Module):
    """x + conv2(relu(conv1(x))), each a 3×3 conv over the reflection-padded
    map."""

    def __init__(self, channels: int, *, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(padding=0, dtype=dtype, compute_dtype=compute_dtype, device=device)
        self.conv1 = Conv2d(channels, channels, 3, **kw)
        self.conv2 = Conv2d(channels, channels, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(_reflect_pad(x, 1)))
        return x + self.conv2(_reflect_pad(h, 1))


class UNetGenerator(nn.Module):
    """The small GAN generator: reflection pad 3 → 7×7 `stem` → relu, two
    stride-2 3×3 convs (`down1`, `down2`, ×2 and ×4 `ngf`) with relu,
    `n_res_blocks` `ResidualBlock`s (`res{i}`), two transposed convs
    (`up1`, `up2`) with relu, reflection pad 3 → 7×7 `head` → tanh. NHWC;
    built on the card unless `device` names another."""

    def __init__(self, ngf: int = 64, n_res_blocks: int = 6, out_channels: int = 3,
                 in_channels: int = 3, *, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=resolve_device(device))
        self.n_res_blocks = n_res_blocks
        self.stem = Conv2d(in_channels, ngf, 7, padding=0, **kw)
        self.down1 = Conv2d(ngf, 2 * ngf, 3, stride=2, **kw)
        self.down2 = Conv2d(2 * ngf, 4 * ngf, 3, stride=2, **kw)
        for i in range(n_res_blocks):
            setattr(self, f"res{i}", ResidualBlock(4 * ngf, **kw))
        self.up1 = ConvTranspose2x(4 * ngf, 2 * ngf, **kw)
        self.up2 = ConvTranspose2x(2 * ngf, ngf, **kw)
        self.head = Conv2d(ngf, out_channels, 7, padding=0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(_reflect_pad(x, 3)))
        h = F.relu(self.down2(F.relu(self.down1(h))))
        for i in range(self.n_res_blocks):
            h = getattr(self, f"res{i}")(h)
        h = F.relu(self.up2(F.relu(self.up1(h))))
        return torch.tanh(self.head(_reflect_pad(h, 3)))
