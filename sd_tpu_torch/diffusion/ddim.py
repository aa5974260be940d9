"""DDIM sampler with batched classifier-free guidance.

Counterpart of `sd_tpu/diffusion/ddim.py` `DDIMSampler.p_sample_ddim` and
`sample` (ε, x0 and v parameterizations, `guidance_rescale`). A Python loop
replaces the TPU package's `lax.scan`; the model sees the latent as given
(the caller's `model_fn` casts it) and the update runs in fp32. Noise for
eta > 0 comes from `noise(index, shape)` (DDIM table index), by default
drawn from an explicit `torch.Generator`. Self-attention guidance and the
inpainting mask are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from sd_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule, extract
from sd_tpu_torch.diffusion.guidance import ModelFn, NoiseFn, gaussian_noise, guided


@dataclasses.dataclass(frozen=True)
class DDIMSampler:
    schedule: DiffusionSchedule
    parameterization: str = "eps"

    def make_schedule(self, num_steps: int, eta: float = 0.0,
                      method: str = "uniform") -> DDIMSchedule:
        return DDIMSchedule.create(self.schedule, num_steps, eta=eta, method=method)

    def p_sample_ddim(self, out: torch.Tensor, x: torch.Tensor, index: int,
                      dd: DDIMSchedule, noise: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One DDIM update from the (guided) model output `out` at table
        index `index`; returns (x_prev, pred_x0)."""
        nd = x.ndim
        i = torch.tensor([index], device=x.device)
        a_t = extract(dd.alphas, i, nd)
        a_prev = extract(dd.alphas_prev, i, nd)
        sigma_t = extract(dd.sigmas, i, nd)
        sqrt_1m_at = extract(dd.sqrt_one_minus_alphas, i, nd)
        sqrt_at = torch.sqrt(a_t)

        x32, out32 = x.float(), out.float()
        if self.parameterization == "v":
            pred_x0 = sqrt_at * x32 - sqrt_1m_at * out32
            e32 = sqrt_1m_at * x32 + sqrt_at * out32
        elif self.parameterization == "x0":
            pred_x0 = out32
            e32 = (x32 - sqrt_at * pred_x0) / sqrt_1m_at
        else:
            e32 = out32
            pred_x0 = (x32 - sqrt_1m_at * e32) / sqrt_at
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e32
        x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if noise is not None:
            x_prev = x_prev + sigma_t * noise
        return x_prev.to(x.dtype), pred_x0.to(x.dtype)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...],
               x_T: torch.Tensor, num_steps: int = 50, cond=None, uncond=None,
               guidance_scale: float = 1.0, eta: float = 0.0,
               method: str = "uniform", dd: DDIMSchedule | None = None,
               guidance_rescale: float = 0.0,
               generator: torch.Generator | None = None,
               noise: NoiseFn | None = None) -> torch.Tensor:
        """S-step DDIM from the initial noise x_T [shape]."""
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T {tuple(x_T.shape)} != shape {tuple(shape)}")
        if dd is None:
            dd = self.make_schedule(num_steps, eta=eta, method=method)
        dd = dd.to(x_T.device)
        noise = noise or gaussian_noise(generator, x_T.device)
        stochastic = bool((dd.sigmas != 0).any())
        out_fn = guided(model_fn, cond, uncond, guidance_scale, guidance_rescale)
        img = x_T
        for index in range(dd.num_steps - 1, -1, -1):
            t = dd.timesteps[index].expand(shape[0])
            img, _ = self.p_sample_ddim(out_fn(img, t), img, index, dd,
                                        noise(index, tuple(shape)) if stochastic else None)
        return img
