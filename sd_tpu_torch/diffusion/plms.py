"""PLMS / PNDM: 4th-order pseudo linear multistep on ε ("plms").

Counterpart of `sd_tpu/diffusion/plms.py` (Liu et al., arXiv:2202.09778):
an Adams–Bashforth combination of the last ≤ 4 ε evaluations (1st → 4th
order over the first four steps, the PNDM warm-up with one model call per
step), then the DDIM(η = 0) transfer. The state is fp32.
"""

from __future__ import annotations

import dataclasses

import torch

from sd_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
from sd_tpu_torch.diffusion.guidance import ModelFn, guided

# Adams–Bashforth coefficients, newest ε first; row k = order k+1
_AB_COEFFS = (
    (1.0, 0.0, 0.0, 0.0),
    (3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


@dataclasses.dataclass(frozen=True)
class PLMSSampler:
    schedule: DiffusionSchedule
    parameterization: str = "eps"

    def make_schedule(self, num_steps: int, method: str = "uniform") -> DDIMSchedule:
        return DDIMSchedule.create(self.schedule, num_steps, eta=0.0, method=method)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...], x_T: torch.Tensor,
               num_steps: int = 50, cond=None, uncond=None, guidance_scale: float = 1.0,
               method: str = "uniform", dd: DDIMSchedule | None = None,
               guidance_rescale: float = 0.0) -> torch.Tensor:
        """S-step PLMS from x_T."""
        dd = (dd or self.make_schedule(num_steps, method)).to(x_T.device)
        sched = self.schedule.to(x_T.device)
        out_fn = guided(model_fn, cond, uncond, guidance_scale, guidance_rescale)
        coeffs = torch.tensor(_AB_COEFFS, dtype=torch.float32, device=x_T.device)
        img = x_T.float()
        hist = [torch.zeros(shape, device=x_T.device)] * 4     # newest first
        for scan_i in range(dd.num_steps):
            index = dd.num_steps - 1 - scan_i
            t = dd.timesteps[index].expand(shape[0])
            out = out_fn(img, t)
            if self.parameterization == "x0":
                out = sched.predict_eps_from_start(img, t, out)
            elif self.parameterization == "v":
                out = sched.predict_eps_from_v(img, t, out)
            hist = [out.float()] + hist[:-1]
            w = coeffs[min(scan_i, 3)]
            e_prime = sum(w[k] * hist[k] for k in range(4))
            a_t, a_prev = dd.alphas[index], dd.alphas_prev[index]
            pred_x0 = (img - dd.sqrt_one_minus_alphas[index] * e_prime) / torch.sqrt(a_t)
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * e_prime
            img = torch.sqrt(a_prev) * pred_x0 + dir_xt
        return img
