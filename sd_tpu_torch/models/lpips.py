"""LPIPS perceptual distance: VGG16 features and learned 1×1 heads.

Counterpart of `sd_tpu/models/lpips.py`: `Vgg16Features` (the five relu
stages of torchvision's VGG16, 2×2 max-pool between them), `LPIPS` (the
scaling layer, channel-unit normalisation with eps 1e-10, squared
difference, 1×1 `lin{i}` heads without bias, spatial average, sum over the
stages) in NHWC with fp32 feature math, the torchvision-checkpoint
importers and `make_lpips_fn`.

The parameters are frozen (never in an optimizer, `requires_grad` off):
gradients flow only through the inputs, which is what the GAN losses need.
No weights are in the repository. `make_lpips_fn`'s "auto" mode takes the
calibrated metric when a VGG16 checkpoint path is given, else the
fixed-seed random surrogate; unlike the TPU package it does not look in
torchvision's download cache for one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.layers import Conv2d, _empty
from sd_tpu_torch.weights import init_params_

# torchvision vgg16.features conv plan; the stages end at relu1_2, relu2_2,
# relu3_3, relu4_3 and relu5_3
_VGG_PLAN: tuple[tuple[int, ...], ...] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# the index of each conv in torchvision's `features` Sequential
_VGG_TORCH_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg_names() -> list[str]:
    return [f"conv{stage + 1}_{i + 1}" for stage, widths in enumerate(_VGG_PLAN)
            for i in range(len(widths))]


class Vgg16Features(nn.Module):
    """The VGG16 conv trunk: NHWC image → the five relu-stage feature maps."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        c_in = 3
        for stage, widths in enumerate(_VGG_PLAN):
            for i, w in enumerate(widths):
                setattr(self, f"conv{stage + 1}_{i + 1}",
                        Conv2d(c_in, w, 3, dtype=dtype, device=device))
                c_in = w

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        feats = []
        for stage, widths in enumerate(_VGG_PLAN):
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{stage + 1}_{i + 1}")(x))
            feats.append(x)
            if stage != len(_VGG_PLAN) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return tuple(feats)


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise along channels (the last axis)."""
    norm = torch.sqrt((x.float() ** 2).sum(dim=-1, keepdim=True))
    return (x / (norm + eps)).to(x.dtype)


def spatial_average(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of NHWC, kept as size-1 axes."""
    return x.mean(dim=(1, 2), keepdim=True)


class NetLin(nn.Module):
    """1×1 conv to one channel without bias; weight [1, C, 1, 1] (OIHW)."""

    def __init__(self, channels: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty((1, channels, 1, 1), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype).reshape(-1, 1)


class LPIPS(nn.Module):
    """Learned perceptual distance between NHWC images in [-1, 1]:
    [B, 1, 1, 1]. Built on the card unless `device` names another."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.vgg = Vgg16Features(dtype=dtype, device=device)
        for i, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{i}", NetLin(c, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=x.device)
        scale = torch.tensor(_SCALE, device=x.device)
        fx = self.vgg((x.float() - shift) / scale)
        fy = self.vgg((y.float() - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (normalize_tensor(a) - normalize_tensor(b)) ** 2
            total = total + spatial_average(getattr(self, f"lin{i}")(d.float()))
        return total


@torch.no_grad()
def import_torch_vgg16(lpips: LPIPS, state_dict: dict, prefix: str = "features.") -> None:
    """Copy torchvision VGG16 `features.*` conv weights into `lpips.vgg`
    (both OIHW: no permutation)."""
    for name, idx in zip(_vgg_names(), _VGG_TORCH_IDX):
        conv = getattr(lpips.vgg, name)
        conv.weight.copy_(torch.as_tensor(state_dict[f"{prefix}{idx}.weight"]))
        conv.bias.copy_(torch.as_tensor(state_dict[f"{prefix}{idx}.bias"]))


@torch.no_grad()
def import_torch_lpips_lins(lpips: LPIPS, state_dict: dict) -> None:
    """Copy the LPIPS `vgg.pth` heads (`lin{i}.model.1.weight` or
    `lins.{i}.model.1.weight`, [1, C, 1, 1]) into `lpips`."""
    for i in range(len(LPIPS_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        if key not in state_dict:
            key = f"lins.{i}.model.1.weight"
        getattr(lpips, f"lin{i}").weight.copy_(torch.as_tensor(state_dict[key]))


def make_lpips_fn(vgg_ckpt: str | None = None, lin_ckpt: str | None = None,
                  mode: str = "auto", seed: int = 0, device=None):
    """A frozen perceptual distance lpips_fn(x, y) -> [B, 1, 1, 1], or None.

    mode:
      "calibrated" — torchvision VGG16 weights from `vgg_ckpt` (raises
                     without one), the heads from `lin_ckpt` when given;
      "random"     — the fixed-seed random surrogate: VGG convs with
                     lecun-normal weights from `seed` and zero biases, unit
                     heads. Not the calibrated metric: a run using it says so;
      "auto"       — calibrated when `vgg_ckpt` is given, else random;
      "none"       — None (pixel-only losses).
    `lpips_fn.calibrated` tells which one was built."""
    if mode == "none":
        return None
    if mode == "auto":
        mode = "calibrated" if vgg_ckpt else "random"
    if mode == "calibrated" and vgg_ckpt is None:
        raise FileNotFoundError("mode='calibrated' needs torchvision vgg16 weights (vgg_ckpt=...)")
    if mode not in ("calibrated", "random"):
        raise ValueError(f"unknown LPIPS mode {mode!r}")
    model = LPIPS(device=device)
    init_params_(model.vgg, torch.Generator(model.lin0.weight.device).manual_seed(seed))
    with torch.no_grad():
        for i in range(len(LPIPS_CHANNELS)):
            getattr(model, f"lin{i}").weight.fill_(1.0)
    if vgg_ckpt is not None:
        import_torch_vgg16(model, torch.load(vgg_ckpt, map_location="cpu", weights_only=True))
    if lin_ckpt is not None:
        import_torch_lpips_lins(model, torch.load(lin_ckpt, map_location="cpu",
                                                  weights_only=True))
    model.requires_grad_(False)

    def lpips_fn(x, y):
        return model(x, y)

    lpips_fn.calibrated = mode == "calibrated"
    lpips_fn.model = model
    return lpips_fn
