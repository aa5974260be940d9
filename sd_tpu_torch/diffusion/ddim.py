"""DDIM sampler with batched classifier-free guidance.

Counterpart of `sd_tpu/diffusion/ddim.py` `DDIMSampler.p_sample_ddim` and
`sample` (ε, x0 and v parameterizations, `guidance_rescale`, the
inpainting blend) and the img2img pair `stochastic_encode` / `decode`. A
Python loop replaces the TPU package's `lax.scan`; the model sees the latent
as given (the caller's `model_fn` casts it) and the update runs in fp32.
Noise for eta > 0 comes from `noise(index, shape)` (DDIM table index), the
inpainting blend's fresh q_sample noise of each step from
`mask_noise(index, shape)`, by default both drawn from an explicit
`torch.Generator`. With `sag_scale` > 0, Self-Attention Guidance
(`p_sample_ddim_sag`, diffusion/sag.py): the model call goes through the
probe `sag_probs_fn`, and one more model call a step runs on the degraded
input.
"""

from __future__ import annotations

import dataclasses

import torch

from sd_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule, extract
from sd_tpu_torch.diffusion.guidance import (ModelFn, NoiseFn, apply_cfg, cat_cond,
                                             gaussian_noise, guided)
from sd_tpu_torch.diffusion.sag import degrade_pred_x0


@dataclasses.dataclass(frozen=True)
class DDIMSampler:
    schedule: DiffusionSchedule
    parameterization: str = "eps"

    def make_schedule(self, num_steps: int, eta: float = 0.0,
                      method: str = "uniform") -> DDIMSchedule:
        return DDIMSchedule.create(self.schedule, num_steps, eta=eta, method=method)

    def _eps_x0(self, out: torch.Tensor, x: torch.Tensor, sqrt_at: torch.Tensor,
                sqrt_1m_at: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The model output as (ε, x̂0) in fp32 under the parameterization."""
        x32, o32 = x.float(), out.float()
        if self.parameterization == "v":
            return sqrt_1m_at * x32 + sqrt_at * o32, sqrt_at * x32 - sqrt_1m_at * o32
        if self.parameterization == "x0":
            return (x32 - sqrt_at * o32) / sqrt_1m_at, o32
        return o32, (x32 - sqrt_1m_at * o32) / sqrt_at

    @staticmethod
    def _coefs(x: torch.Tensor, index: int, dd: DDIMSchedule):
        """(√ᾱ_t, √(1 − ᾱ_t)) of table index `index`, broadcast over x."""
        i = torch.tensor([index], device=x.device)
        return (torch.sqrt(extract(dd.alphas, i, x.ndim)),
                extract(dd.sqrt_one_minus_alphas, i, x.ndim))

    @staticmethod
    def _ddim_update(e32: torch.Tensor, pred_x0: torch.Tensor, x: torch.Tensor, index: int,
                     dd: DDIMSchedule, noise: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The DDIM update from ε and x̂0 (fp32) at table index `index`;
        returns (x_prev, pred_x0) in x's dtype."""
        i = torch.tensor([index], device=x.device)
        a_prev = extract(dd.alphas_prev, i, x.ndim)
        sigma_t = extract(dd.sigmas, i, x.ndim)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e32
        x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if noise is not None:
            x_prev = x_prev + sigma_t * noise
        return x_prev.to(x.dtype), pred_x0.to(x.dtype)

    def p_sample_ddim(self, out: torch.Tensor, x: torch.Tensor, index: int,
                      dd: DDIMSchedule, noise: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One DDIM update from the (guided) model output `out` at table
        index `index`; returns (x_prev, pred_x0)."""
        e32, pred_x0 = self._eps_x0(out, x, *self._coefs(x, index, dd))
        return self._ddim_update(e32, pred_x0, x, index, dd, noise)

    def p_sample_ddim_sag(self, model_fn: ModelFn, probs_fn, x: torch.Tensor,
                          t: torch.Tensor, index: int, dd: DDIMSchedule,
                          noise: torch.Tensor | None = None, cond=None, uncond=None,
                          guidance_scale: float = 1.0, cond_batched=None,
                          guidance_rescale: float = 0.0, sag_scale: float = 0.75
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """One DDIM update with Self-Attention Guidance; `probs_fn(x, t,
        cond) -> (model output, salience mask)` replaces the main model call.
        With CFG the SAG term rides the unconditional branch (its half of
        the mask):

            ε* = CFG(ε_u, ε_c) + s_sag · (ε_u − ε(x̃_t degraded, uncond))"""
        sqrt_at, sqrt_1m_at = self._coefs(x, index, dd)
        to_eps = lambda out, xx: self._eps_x0(out, xx, sqrt_at, sqrt_1m_at)[0]
        b = x.shape[0]
        if uncond is None or guidance_scale == 1.0:
            out, mask = probs_fn(x, t, cond)
            e_base = e_t = to_eps(out, x)
            guide_cond = cond
        else:
            both = cond_batched if cond_batched is not None else cat_cond(uncond, cond)
            out, mask2 = probs_fn(torch.cat([x, x]), torch.cat([t, t]), both)
            e_uncond, e_cond = to_eps(out[:b], x), to_eps(out[b:], x)
            mask = mask2[:b]
            e_t = apply_cfg(e_uncond, e_cond, guidance_scale, guidance_rescale)
            e_base, guide_cond = e_uncond, uncond

        # the ε_base-implied x̂0 degraded inside the mask, re-noised with the
        # same ε; guide away from the model's prediction there
        x32 = x.float()
        x0_deg = degrade_pred_x0((x32 - sqrt_1m_at * e_base) / sqrt_at, mask)
        x_deg = (sqrt_at * x0_deg + sqrt_1m_at * e_base).to(x.dtype)
        e_deg = to_eps(model_fn(x_deg, t, guide_cond), x_deg)
        e_t = e_t + sag_scale * (e_base - e_deg)
        return self._ddim_update(e_t, (x32 - sqrt_1m_at * e_t) / sqrt_at, x, index, dd, noise)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...],
               x_T: torch.Tensor, num_steps: int = 50, cond=None, uncond=None,
               guidance_scale: float = 1.0, eta: float = 0.0,
               method: str = "uniform", dd: DDIMSchedule | None = None,
               guidance_rescale: float = 0.0,
               generator: torch.Generator | None = None,
               noise: NoiseFn | None = None, mask: torch.Tensor | None = None,
               x0: torch.Tensor | None = None,
               mask_noise: NoiseFn | None = None, sag_scale: float = 0.0,
               sag_probs_fn=None, return_pred_x0: bool = False):
        """S-step DDIM from the initial noise x_T [shape]; with
        `return_pred_x0`, (x_0, every step's x̂0 stacked [S, *shape] in
        sampling order). With `mask` and
        `x0` (inpainting): before each step the region where mask is 1 is
        reset to q_sample(x0, t) with fresh noise, drawn at every step
        whatever eta is, as the TPU package draws it. `sag_scale` > 0 takes
        Self-Attention Guidance's step, which needs `sag_probs_fn(x, t,
        cond) -> (model output, salience mask)`."""
        if sag_scale > 0.0 and sag_probs_fn is None:
            raise ValueError("sag_scale > 0 requires sag_probs_fn")
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T {tuple(x_T.shape)} != shape {tuple(shape)}")
        if mask is not None and x0 is None:
            raise ValueError("inpainting requires x0")
        if dd is None:
            dd = self.make_schedule(num_steps, eta=eta, method=method)
        dd = dd.to(x_T.device)
        noise = noise or gaussian_noise(generator, x_T.device)
        mask_noise = mask_noise or gaussian_noise(generator, x_T.device)
        base = self.schedule.to(x_T.device) if mask is not None else None
        stochastic = bool((dd.sigmas != 0).any())
        out_fn = guided(model_fn, cond, uncond, guidance_scale, guidance_rescale)
        both = (cat_cond(uncond, cond) if sag_scale > 0.0 and uncond is not None
                and guidance_scale != 1.0 else None)
        img, pred_x0s = x_T, []
        for index in range(dd.num_steps - 1, -1, -1):
            t = dd.timesteps[index].expand(shape[0])
            if mask is not None:
                orig = base.q_sample(x0, t, mask_noise(index, tuple(x0.shape)))
                img = orig * mask + (1.0 - mask) * img
            step_noise = noise(index, tuple(shape)) if stochastic else None
            if sag_scale > 0.0:
                img, pred_x0 = self.p_sample_ddim_sag(
                    model_fn, sag_probs_fn, img, t, index, dd, step_noise, cond=cond,
                    uncond=uncond, guidance_scale=guidance_scale, cond_batched=both,
                    guidance_rescale=guidance_rescale, sag_scale=sag_scale)
            else:
                img, pred_x0 = self.p_sample_ddim(out_fn(img, t), img, index, dd, step_noise)
            if return_pred_x0:
                pred_x0s.append(pred_x0)
        return (img, torch.stack(pred_x0s)) if return_pred_x0 else img

    def stochastic_encode(self, x0: torch.Tensor, t_index: int, dd: DDIMSchedule,
                          noise: torch.Tensor) -> torch.Tensor:
        """x0 forward-diffused to DDIM table index `t_index` with the
        sub-schedule's ᾱ: √ᾱ·x0 + √(1−ᾱ)·noise, in x0's dtype."""
        a = dd.alphas[t_index].to(x0.device).float()
        return (torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise).to(x0.dtype)

    def decode(self, model_fn: ModelFn, x_latent: torch.Tensor, t_start: int,
               cond=None, uncond=None, guidance_scale: float = 1.0,
               dd: DDIMSchedule | None = None, num_steps: int = 50,
               generator: torch.Generator | None = None,
               noise: NoiseFn | None = None) -> torch.Tensor:
        """The img2img reverse pass from DDIM index `t_start` − 1 down to 0,
        with CFG (no rescale, as the TPU package's `decode` has none)."""
        if dd is None:
            dd = self.make_schedule(num_steps)
        dd = dd.to(x_latent.device)
        noise = noise or gaussian_noise(generator, x_latent.device)
        stochastic = bool((dd.sigmas != 0).any())
        out_fn = guided(model_fn, cond, uncond, guidance_scale)
        img = x_latent
        shape = tuple(x_latent.shape)
        for index in range(t_start - 1, -1, -1):
            t = dd.timesteps[index].expand(shape[0])
            img, _ = self.p_sample_ddim(out_fn(img, t), img, index, dd,
                                        noise(index, shape) if stochastic else None)
        return img
