"""DPM-Solver++(2M), deterministic or SDE ("dpm" / "dpm_sde").

Counterpart of `sd_tpu/diffusion/dpm_solver.py` (Lu et al.,
arXiv:2211.01095, Algorithm 2, data-prediction multistep): the per-step
coefficients are precomputed in float64 numpy into fp32 [S] tables, as in
the TPU package; a Python loop replaces its `lax.scan`. The SDE variant's
fresh noise per step comes from `noise(index, shape)` (scan index i), by
default drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule, _f32, _to, sub_timesteps
from sd_tpu_torch.diffusion.guidance import ModelFn, NoiseFn, gaussian_noise, guided


@dataclasses.dataclass(frozen=True)
class DPMSolverSchedule:
    """[S] tables over S+1 log-SNR nodes, index i = scan order (noisiest
    first); node S is ᾱ at t = 0."""

    timesteps: torch.Tensor    # int64 [S], the DDPM t fed to the model
    alpha_cur: torch.Tensor    # sqrt(ᾱ) at node i
    sigma_cur: torch.Tensor    # sqrt(1-ᾱ) at node i
    sigma_ratio: torch.Tensor  # σ_{i+1}/σ_i
    alpha_next: torch.Tensor   # sqrt(ᾱ) at node i+1
    em1: torch.Tensor          # expm1(-h_i), h_i = λ_{i+1} − λ_i
    r: torch.Tensor            # h_{i-1}/h_i (r[0] unused)
    num_steps: int

    @classmethod
    def create(cls, base: DiffusionSchedule, num_steps: int,
               method: str = "uniform") -> "DPMSolverSchedule":
        ts, abar = sub_timesteps(base, num_steps, method)
        tsd = ts[::-1].copy()
        nodes = np.concatenate([abar[tsd], abar[:1]])
        alpha, sigma = np.sqrt(nodes), np.sqrt(1.0 - nodes)
        h = np.diff(np.log(alpha) - np.log(sigma))
        r = np.ones_like(h)
        r[1:] = h[:-1] / h[1:]
        return cls(timesteps=torch.from_numpy(tsd.astype(np.int64)),
                   alpha_cur=_f32(alpha[:-1]), sigma_cur=_f32(sigma[:-1]),
                   sigma_ratio=_f32(sigma[1:] / sigma[:-1]), alpha_next=_f32(alpha[1:]),
                   em1=_f32(np.expm1(-h)), r=_f32(r), num_steps=int(len(tsd)))

    to = _to


def pred_x0(parameterization: str, x32, out32, alpha, sigma) -> torch.Tensor:
    """The model output at a node with sqrt(ᾱ) = alpha, sqrt(1-ᾱ) = sigma
    as x0 (fp32)."""
    if parameterization == "x0":
        return out32
    if parameterization == "v":
        return alpha * x32 - sigma * out32
    return (x32 - sigma * out32) / alpha


@dataclasses.dataclass(frozen=True)
class DPMSolverSampler:
    schedule: DiffusionSchedule
    parameterization: str = "eps"
    sde: bool = False

    def make_schedule(self, num_steps: int, method: str = "uniform") -> DPMSolverSchedule:
        return DPMSolverSchedule.create(self.schedule, num_steps, method=method)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...], x_T: torch.Tensor,
               num_steps: int = 15, cond=None, uncond=None, guidance_scale: float = 1.0,
               method: str = "uniform", dp: DPMSolverSchedule | None = None,
               guidance_rescale: float = 0.0, generator: torch.Generator | None = None,
               noise: NoiseFn | None = None) -> torch.Tensor:
        """S-call DPM-Solver++(2M) from x_T; the first step is first order
        (DDIM), the rest second order."""
        dp = (dp or self.make_schedule(num_steps, method)).to(x_T.device)
        noise = noise or gaussian_noise(generator, x_T.device)
        out_fn = guided(model_fn, cond, uncond, guidance_scale, guidance_rescale)
        img, prev_x0 = x_T, None
        for i in range(dp.num_steps):
            t = dp.timesteps[i].expand(shape[0])
            out32, x32 = out_fn(img, t).float(), img.float()
            x0 = pred_x0(self.parameterization, x32, out32, dp.alpha_cur[i], dp.sigma_cur[i])
            if i == 0:
                d = x0
            else:
                rr = dp.r[i]
                d = (1.0 + 1.0 / (2.0 * rr)) * x0 - (1.0 / (2.0 * rr)) * prev_x0
            sr, an, em1 = dp.sigma_ratio[i], dp.alpha_next[i], dp.em1[i]
            if self.sde:
                # exponential SDE integrator from the stored expm1(-h):
                # e^{-h} = 1 + em1, 1 − e^{-2h} = −em1·(2 + em1)
                exp_mh, om_e2h = 1.0 + em1, -em1 * (2.0 + em1)
                sig_next = sr * dp.sigma_cur[i]
                img_next = (sr * exp_mh * x32 + an * om_e2h * d
                            + sig_next * torch.sqrt(om_e2h) * noise(i, tuple(shape)))
            else:
                img_next = sr * x32 - an * em1 * d
            img, prev_x0 = img_next.to(img.dtype), x0
        return img
