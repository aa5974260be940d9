"""The k-diffusion family: Euler, Euler-ancestral, Heun ("euler",
"euler_a", "heun").

Counterpart of `sd_tpu/diffusion/k_samplers.py` (Karras et al.,
arXiv:2206.00364, Algorithms 1-2): the probability-flow ODE in σ-space,
x_k = x_t / sqrt(ᾱ_t), σ = sqrt((1-ᾱ)/ᾱ), S+1 nodes ending at σ = 0 (the
state is then x0 in data scale). Tables in fp32 from float64 numpy. Heun's
correction at the terminal node is discarded in the TPU package's scan; here
that model call is skipped (same result, one UNet call fewer). Euler-a's
noise per step comes from `noise(index, shape)` (scan index), by default
drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule, _f32, _to, sub_timesteps
from sd_tpu_torch.diffusion.guidance import ModelFn, NoiseFn, gaussian_noise, guided


@dataclasses.dataclass(frozen=True)
class KSchedule:
    timesteps: torch.Tensor  # int64 [S+1], t[S] = 0
    sigma: torch.Tensor      # fp32 [S+1], σ[S] = 0
    alpha: torch.Tensor      # fp32 [S+1], sqrt(ᾱ) (model-input scale)
    num_steps: int

    @classmethod
    def create(cls, base: DiffusionSchedule, num_steps: int,
               method: str = "uniform") -> "KSchedule":
        ts, abar = sub_timesteps(base, num_steps, method)
        tsd = ts[::-1].copy()
        nodes = abar[tsd]
        return cls(timesteps=torch.from_numpy(np.concatenate([tsd, [0]]).astype(np.int64)),
                   sigma=_f32(np.concatenate([np.sqrt((1.0 - nodes) / nodes), [0.0]])),
                   alpha=_f32(np.concatenate([np.sqrt(nodes), [1.0]])),
                   num_steps=int(len(tsd)))

    to = _to


@dataclasses.dataclass(frozen=True)
class KDiffusionSampler:
    schedule: DiffusionSchedule
    order: str = "euler"          # "euler" | "euler_a" | "heun"
    parameterization: str = "eps"

    def make_schedule(self, num_steps: int, method: str = "uniform") -> KSchedule:
        return KSchedule.create(self.schedule, num_steps, method=method)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...], x_T: torch.Tensor,
               num_steps: int = 30, cond=None, uncond=None, guidance_scale: float = 1.0,
               method: str = "uniform", ks: KSchedule | None = None,
               guidance_rescale: float = 0.0, generator: torch.Generator | None = None,
               noise: NoiseFn | None = None) -> torch.Tensor:
        """S-node Euler / Heun / Euler-a from x_T (the VP convention: a
        standard normal at t_max, lifted to σ-space here)."""
        if self.order not in ("euler", "euler_a", "heun"):
            raise ValueError(f"unknown k-diffusion order {self.order!r}")
        ks = (ks or self.make_schedule(num_steps, method)).to(x_T.device)
        sig = ks.sigma.cpu().numpy()
        noise = noise or gaussian_noise(generator, x_T.device)
        out_fn = guided(model_fn, cond, uncond, guidance_scale, guidance_rescale)
        b = shape[0]

        def deriv(xk32, i):
            """dx/dσ = (x − x0)/σ at node i."""
            a, s = ks.alpha[i], ks.sigma[i]
            out32 = out_fn((a * xk32).to(x_T.dtype), ks.timesteps[i].expand(b)).float()
            if self.parameterization == "x0":
                x0 = out32
            elif self.parameterization == "v":
                x0 = a * (a * xk32) - (a * s) * out32
            else:
                x0 = xk32 - s * out32
            return (xk32 - x0) / torch.clamp(s, min=1e-12)

        xk = x_T.float() / ks.alpha[0]
        for i in range(ks.num_steps):
            s_cur, s_next = ks.sigma[i], ks.sigma[i + 1]
            d = deriv(xk, i)
            if self.order == "euler_a":
                var_up = s_next**2 * (s_cur**2 - s_next**2) / torch.clamp(s_cur**2, min=1e-12)
                s_up = torch.sqrt(torch.clamp(var_up, min=0.0))
                s_down = torch.sqrt(torch.clamp(s_next**2 - s_up**2, min=0.0))
                xk = xk + (s_down - s_cur) * d + s_up * noise(i, tuple(shape))
                continue
            x_e = xk + (s_next - s_cur) * d
            if self.order == "heun" and sig[i + 1] > 0:
                xk = xk + (s_next - s_cur) * 0.5 * (d + deriv(x_e, i + 1))
            else:
                xk = x_e
        return xk.to(x_T.dtype)
