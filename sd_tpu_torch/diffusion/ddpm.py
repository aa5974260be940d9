"""DDPM process: the training loss.

Counterpart of `sd_tpu/diffusion/ddpm.py` on the training path:
`draw_training_noise` and `DDPMProcess.p_losses` (eps / x0 / v targets, l2 /
l1, min-SNR-γ weighting, the learned per-timestep logvar and the ELBO
weight). The ancestral sampler is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule

# model_fn(x, t, cond) -> prediction (eps, x0 or v by parameterization)
ModelFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over every dim but the batch dim."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def draw_training_noise(shape: tuple[int, ...], offset: float = 0.0, *,
                        generator: torch.Generator | None = None,
                        device=None) -> torch.Tensor:
    """Training noise ε ~ N(0, 1) in fp32, plus `offset`·ε_c with one ε_c per
    (sample, channel) when offset > 0 (the noise-offset trick)."""
    noise = torch.randn(shape, generator=generator, device=device)
    if offset > 0.0:
        dc_shape = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
        noise = noise + offset * torch.randn(dc_shape, generator=generator,
                                             device=device)
    return noise


@dataclasses.dataclass(frozen=True)
class DDPMProcess:
    """A schedule with a parameterization and a loss configuration."""

    schedule: DiffusionSchedule
    parameterization: str = "eps"          # "eps" | "x0" | "v"
    loss_type: str = "l2"                  # "l2" | "l1"
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    min_snr_gamma: float | None = None

    def p_losses(self, model_fn: ModelFn, x_start: torch.Tensor,
                 t: torch.Tensor, noise: torch.Tensor, cond: Any = None,
                 learned_logvar: torch.Tensor | None = None,
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Simple + VLB-weighted diffusion loss: (loss, logs), fp32."""
        sched = self.schedule
        x_noisy = sched.q_sample(x_start, t, noise)
        model_out = model_fn(x_noisy, t, cond)

        if self.parameterization == "eps":
            target = noise
        elif self.parameterization == "v":
            target = sched.get_v(x_start, noise, t)
        else:
            target = x_start
        err = model_out.float() - target.float()
        if self.loss_type == "l2":
            loss_raw = mean_flat(err**2)
        elif self.loss_type == "l1":
            loss_raw = mean_flat(err.abs())
        else:
            raise ValueError(f"unknown loss_type {self.loss_type!r}")

        logs = {}
        loss_weighted = loss_raw
        if self.min_snr_gamma is not None:
            abar_t = sched.alphas_cumprod[t].float()
            snr = abar_t / torch.clamp(1.0 - abar_t, min=1e-12)
            g = self.min_snr_gamma
            if self.parameterization == "eps":
                w = torch.clamp(snr, max=g) / torch.clamp(snr, min=1e-12)
            elif self.parameterization == "v":
                w = torch.clamp(snr, max=g) / (snr + 1.0)
            else:  # x0: the loss already carries a 1/SNR factor against ε-space
                w = torch.clamp(snr, max=g)
            loss_weighted = loss_raw * w
        loss_simple = loss_weighted.mean()
        logs["loss_simple"] = loss_simple

        if learned_logvar is not None:
            logvar_t = learned_logvar[t]
            loss = (loss_weighted / torch.exp(logvar_t) + logvar_t).mean()
            logs["loss_gamma"] = loss
        else:
            loss = loss_simple
        loss = self.l_simple_weight * loss

        loss_vlb = (sched.lvlb_weights[t] * loss_raw).mean()
        logs["loss_vlb"] = loss_vlb
        loss = loss + self.original_elbo_weight * loss_vlb
        logs["loss"] = loss
        return loss, logs
