"""A tiny image classifier and the classifier-free-guidance steering score.

Counterpart of `sd_tpu/eval/classifier.py`: train a small probe classifier
on the labelled real images, then score guided samples by the probe's
accuracy and confidence on the class they were asked for. Guidance steers
when the score at a guidance scale above 1 clears both chance and the score
at scale 1.

`TinyImageClassifier` is flax's module on NHWC images: four 3×3 convs at
stride 2 with flax's "SAME" padding (on an even side (0, 1) pixels, on an
odd one (1, 1)), each followed by GroupNorm (min(8, C) groups, eps 1e-6)
and SiLU, then the spatial mean and a dense head. `train_image_classifier`
trains it with Adam (optax's `adam`) on the mean softmax cross-entropy,
each step's batch indices and horizontal flips (along W) drawn from a
`torch.Generator` seeded by `seed`, or handed in by `draws(step) -> (idx,
flip)`, so that a test can give both packages the same draws. Its weights
start from the TPU package's initialisers (`weights.init_params_`) on the
same generator's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.layers import Conv2d, Dense, GroupNorm32
from sd_tpu_torch.train.diffusion import Adam
from sd_tpu_torch.weights import init_params_

MULTS = (1, 2, 4, 4)


def _same_pad(n: int, k: int = 3, s: int = 2) -> tuple[int, int]:
    """flax's "SAME" padding of one axis of n pixels: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class TinyImageClassifier(nn.Module):
    """Four conv(stride 2) → GroupNorm → SiLU blocks, the spatial mean and a
    dense head: [B, H, W, C_in] → logits [B, num_classes]."""

    def __init__(self, num_classes: int, width: int = 32, in_channels: int = 3, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        c = in_channels
        for i, mult in enumerate(MULTS):
            o = width * mult
            setattr(self, f"conv_{i}", Conv2d(c, o, 3, stride=2, padding=0, device=device))
            setattr(self, f"norm_{i}", GroupNorm32(o, num_groups=min(8, o), eps=1e-6,
                                                   device=device))
            c = o
        self.head = Dense(c, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(len(MULTS)):
            (hl, hh), (wl, wh) = _same_pad(x.shape[1]), _same_pad(x.shape[2])
            x = getattr(self, f"conv_{i}")(F.pad(x, (0, 0, wl, wh, hl, hh)))
            x = F.silu(getattr(self, f"norm_{i}")(x))
        return self.head(x.mean(dim=(1, 2)))


def train_image_classifier(images: np.ndarray, labels: np.ndarray, num_classes: int, *,
                           steps: int = 300, batch_size: int = 32, lr: float = 1e-3,
                           width: int = 32, seed: int = 0, augment_flip: bool = True,
                           draws: Callable[[int], tuple] | None = None,
                           device=None) -> tuple[TinyImageClassifier, dict]:
    """Train the probe on labelled [-1, 1] NHWC images held on the host, on
    the card unless `device` names another. Returns (module, {"params":
    {name: tensor}, "final_loss", "final_acc"}) with the last step's loss
    and batch accuracy."""
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int64)
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    model = TinyImageClassifier(num_classes, width, images.shape[-1], device=device)
    init_params_(model, gen)
    params = dict(model.requires_grad_(True).named_parameters())
    opt = Adam(lr=lr, grad_clip=None)
    opt_state = opt.init(list(params.values()))
    n = len(images)

    def draw(i: int):
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=device)
        return idx.cpu().numpy(), (torch.rand(batch_size, generator=gen, device=device) < 0.5)

    loss = acc = torch.zeros(())
    for i in range(steps):
        idx, flip = (draws or draw)(i)
        idx = np.asarray(idx)
        x = torch.from_numpy(images[idx]).to(device)
        y = torch.from_numpy(labels[idx]).to(device)
        if augment_flip:
            flip = torch.as_tensor(np.asarray(flip) if not torch.is_tensor(flip) else flip,
                                   device=device).reshape(-1, 1, 1, 1).bool()
            x = torch.where(flip, x.flip(2), x)
        logits = model(x)
        loss = F.cross_entropy(logits.float(), y)
        acc = (logits.argmax(-1) == y).float().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update_(list(params.values()), list(grads), opt_state)
    return model, {"params": {k: v.detach() for k, v in params.items()},
                   "final_loss": float(loss.detach()), "final_acc": float(acc)}


def classifier_fn(model: TinyImageClassifier,
                  params: dict[str, torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → logits through `model` with `params` (no gradient), the
    images moved to the parameters' device."""
    device = next(iter(params.values())).device

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, params, (torch.as_tensor(x).to(device),))

    return fn


def steering_score(logits_fn: Callable[[torch.Tensor], torch.Tensor], samples: np.ndarray,
                   target_class: int) -> dict:
    """A guided sample batch scored against the class it was asked for:
    {"accuracy": the share whose argmax is the target, "confidence": the
    mean softmax probability of the target}. Chance accuracy is
    1 / num_classes."""
    logits = logits_fn(torch.from_numpy(np.asarray(samples, np.float32)))
    logits = np.asarray(logits.float().cpu() if torch.is_tensor(logits) else logits)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return {"accuracy": float((logits.argmax(-1) == target_class).mean()),
            "confidence": float(probs[:, target_class].mean())}
