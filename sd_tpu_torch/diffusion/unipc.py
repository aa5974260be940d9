"""UniPC-2 predictor-corrector sampler ("unipc", bh2 by default).

Counterpart of `sd_tpu/diffusion/unipc.py` (Zhao et al., arXiv:2302.04867,
multistep data prediction): every transition's coefficients precomputed in
float64 numpy into fp32 [S] tables; per step one model call at node i
first corrects the previous transition (UniC), then predicts node i+1
(UniP). The first transition and the last are first order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule, _f32, _to, sub_timesteps
from sd_tpu_torch.diffusion.dpm_solver import pred_x0
from sd_tpu_torch.diffusion.guidance import ModelFn, guided


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    timesteps: torch.Tensor    # int64 [S]
    alpha_cur: torch.Tensor    # sqrt(ᾱ) at node i
    sigma_cur: torch.Tensor    # sqrt(1-ᾱ) at node i
    sigma_ratio: torch.Tensor  # σ_{i+1}/σ_i
    alpha_next: torch.Tensor   # sqrt(ᾱ) at node i+1
    phi1: torch.Tensor         # expm1(-h_i)
    bh: torch.Tensor           # B(h): expm1(-h) (bh2) or -h (bh1)
    r0: torch.Tensor           # (λ_{i-1} − λ_i)/h_i (r0[0] = 1)
    rho_p: torch.Tensor        # predictor D1 weight (0 at the edges)
    rho_c0: torch.Tensor       # corrector weight on the history D1
    rho_c1: torch.Tensor       # corrector weight on D1_t
    num_steps: int

    @classmethod
    def create(cls, base: DiffusionSchedule, num_steps: int, method: str = "uniform",
               variant: str = "bh2") -> "UniPCSchedule":
        ts, abar = sub_timesteps(base, num_steps, method)
        tsd = ts[::-1].copy()
        nodes = np.concatenate([abar[tsd], abar[:1]])
        alpha, sigma = np.sqrt(nodes), np.sqrt(1.0 - nodes)
        lam = np.log(alpha) - np.log(sigma)
        h = np.diff(lam)
        hh = -h
        phi1 = np.expm1(hh)
        if variant == "bh1":
            bh = hh
        elif variant == "bh2":
            bh = np.expm1(hh)
        else:
            raise ValueError(f"unknown UniPC variant: {variant!r}")
        b1 = (phi1 / hh - 1.0) / bh
        b2 = ((phi1 / hh - 1.0) / hh - 0.5) * 2.0 / bh
        S = len(tsd)
        r0 = np.ones(S)
        if S > 1:
            r0[1:] = (lam[:-1][:-1] - lam[1:-1]) / h[1:]
        order2 = np.zeros(S, bool)
        if S > 2:
            order2[1:S - 1] = True
        denom = np.where(order2, 1.0 - r0, 1.0)
        return cls(timesteps=torch.from_numpy(tsd.astype(np.int64)),
                   alpha_cur=_f32(alpha[:-1]), sigma_cur=_f32(sigma[:-1]),
                   sigma_ratio=_f32(sigma[1:] / sigma[:-1]), alpha_next=_f32(alpha[1:]),
                   phi1=_f32(phi1), bh=_f32(bh), r0=_f32(r0),
                   rho_p=_f32(np.where(order2, 0.5, 0.0)),
                   rho_c0=_f32(np.where(order2, (b1 - b2) / denom, 0.0)),
                   rho_c1=_f32(np.where(order2, (b2 - r0 * b1) / denom, 0.5)),
                   num_steps=int(S))

    to = _to


@dataclasses.dataclass(frozen=True)
class UniPCSampler:
    schedule: DiffusionSchedule
    parameterization: str = "eps"
    variant: str = "bh2"
    use_corrector: bool = True

    def make_schedule(self, num_steps: int, method: str = "uniform") -> UniPCSchedule:
        return UniPCSchedule.create(self.schedule, num_steps, method=method,
                                    variant=self.variant)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...], x_T: torch.Tensor,
               num_steps: int = 10, cond=None, uncond=None, guidance_scale: float = 1.0,
               method: str = "uniform", up: UniPCSchedule | None = None,
               guidance_rescale: float = 0.0) -> torch.Tensor:
        """S-call UniPC from x_T."""
        up = (up or self.make_schedule(num_steps, method)).to(x_T.device)
        out_fn = guided(model_fn, cond, uncond, guidance_scale, guidance_rescale)
        zeros = torch.zeros(shape, device=x_T.device)
        img, last_x, m_prev, m_prev2 = x_T, zeros, zeros, zeros
        for i in range(up.num_steps):
            t = up.timesteps[i].expand(shape[0])
            out32, x32 = out_fn(img, t).float(), img.float()
            m = pred_x0(self.parameterization, x32, out32, up.alpha_cur[i], up.sigma_cur[i])
            x_work = x32
            if self.use_corrector and i > 0:
                # UniC: redo transition j = i-1 from last_x with m as the
                # corrector sample (c0 is 0 where j has no history)
                j = i - 1
                an_j = up.alpha_next[j]
                d1_hist = (m_prev2 - m_prev) / up.r0[j]
                d1_t = m - m_prev
                x_work = (up.sigma_ratio[j] * last_x - an_j * up.phi1[j] * m_prev
                          - an_j * up.bh[j] * (up.rho_c0[j] * d1_hist + up.rho_c1[j] * d1_t))
            # UniP: transition i from the corrected state
            an = up.alpha_next[i]
            d1 = (m_prev - m) / up.r0[i]
            img_next = (up.sigma_ratio[i] * x_work - an * up.phi1[i] * m
                        - an * up.bh[i] * up.rho_p[i] * d1)
            img, last_x, m_prev, m_prev2 = img_next.to(img.dtype), x_work, m, m_prev
        return img
