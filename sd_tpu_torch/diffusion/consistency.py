"""Latent consistency distillation: the few-step student's loss and sampler.

Counterpart of `sd_tpu/diffusion/consistency.py` (consistency models, Song
et al. arXiv:2303.01469; LCM, Luo et al. arXiv:2310.04378): the boundary
scalings c_skip / c_out on integer timesteps, the boundary grid, the
ε / x̂0 coordinate change, the deterministic DDIM step between two
timesteps (the teacher's solver), the pseudo-Huber distance, and
`ConsistencyDistiller` with the consistency function f(z, t) = c_skip·z +
c_out·x̂0(z, t), the teacher's (optionally CFG-guided) step, the draw of a
training pair, the student's loss against the target network and the
multistep sampler. The grids are numpy integers (`np.round`, half to even).

Randomness: the pair's boundary index and noise, and the sampler's fresh
noise at each of its model calls (the last call's included, then thrown
away, as the TPU package draws it), come from a `torch.Generator` unless
they are handed in (`i=`, `noise=`), so a test can give both packages the
same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule, extract
from sd_tpu_torch.diffusion.guidance import ModelFn, NoiseFn, apply_cfg, cat_cond, gaussian_noise


def boundary_scalings(t: torch.Tensor, sigma_data: float = 0.5,
                      timestep_scaling: float = 10.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(c_skip, c_out) at integer timesteps, fp32: s = t·scaling,
    c_skip = σ_d² / (s² + σ_d²), c_out = s / √(s² + σ_d²); (1, 0) at t = 0."""
    s = t.to(torch.float32) * timestep_scaling
    denom = s**2 + sigma_data**2
    return sigma_data**2 / denom, s / torch.sqrt(denom)


def boundary_timesteps(num_timesteps: int, num_boundaries: int = 50) -> np.ndarray:
    """The ascending int32 grid of N + 1 boundaries 0 … T − 1: training
    pairs are adjacent entries, the sampler walks a descending subset."""
    return np.round(np.linspace(0, num_timesteps - 1, num_boundaries + 1)).astype(np.int32)


def model_out_to_eps_x0(schedule: DiffusionSchedule, out: torch.Tensor, z: torch.Tensor,
                        t: torch.Tensor, parameterization: str
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ε, x̂0) in fp32 implied by a model output under `parameterization`."""
    nd = z.ndim
    a = extract(schedule.sqrt_alphas_cumprod, t, nd)
    s = extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd)
    z32, o32 = z.float(), out.float()
    if parameterization == "v":
        return s * z32 + a * o32, a * z32 - s * o32
    if parameterization == "x0":
        return (z32 - a * o32) / s, o32
    return o32, (z32 - s * o32) / a


def ddim_step_to(schedule: DiffusionSchedule, z: torch.Tensor, eps: torch.Tensor,
                 t_from: torch.Tensor, t_to: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update t_from → t_to on the base ᾱ tables, in
    fp32, returned in z's dtype."""
    nd = z.ndim
    a_from = extract(schedule.sqrt_alphas_cumprod, t_from, nd)
    s_from = extract(schedule.sqrt_one_minus_alphas_cumprod, t_from, nd)
    a_to = extract(schedule.sqrt_alphas_cumprod, t_to, nd)
    s_to = extract(schedule.sqrt_one_minus_alphas_cumprod, t_to, nd)
    z32, e32 = z.float(), eps.float()
    x0 = (z32 - s_from * e32) / a_from
    return (a_to * x0 + s_to * e32).to(z.dtype)


def pseudo_huber(a: torch.Tensor, b: torch.Tensor, c: float | None = None) -> torch.Tensor:
    """Mean over the batch of √(‖a − b‖² + c²) − c (Song & Dhariwal,
    arXiv:2310.14189); c defaults to 0.00054·√dim."""
    d = a.float() - b.float()
    if c is None:
        c = 0.00054 * float(np.sqrt(np.prod(d.shape[1:])))
    sq = torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=-1)
    return torch.mean(torch.sqrt(sq + c**2) - c)


@dataclasses.dataclass(frozen=True)
class ConsistencyDistiller:
    """The consistency-distillation loss and few-step sampler over one
    schedule; teacher and student share its parameterization. A teacher
    step with `guidance_scale` > 1 and an `uncond` bakes that guidance into
    the student."""

    schedule: DiffusionSchedule
    parameterization: str = "eps"
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    num_boundaries: int = 50

    def on(self, device) -> "ConsistencyDistiller":
        """The distiller with its schedule's tables on `device`."""
        return dataclasses.replace(self, schedule=self.schedule.to(device))

    @property
    def boundaries(self) -> np.ndarray:
        return boundary_timesteps(self.schedule.num_timesteps, self.num_boundaries)

    def consistency_fn(self, model_fn: ModelFn, z: torch.Tensor, t: torch.Tensor,
                       cond: Any = None) -> torch.Tensor:
        """f(z, t) = c_skip·z + c_out·x̂0(z, t): one model call, fp32 inside,
        z's dtype out."""
        out = model_fn(z, t, cond)
        _, x0 = model_out_to_eps_x0(self.schedule, out, z, t, self.parameterization)
        c_skip, c_out = boundary_scalings(t, self.sigma_data, self.timestep_scaling)
        shape = c_skip.shape + (1,) * (z.ndim - 1)
        return (c_skip.reshape(shape) * z.float() + c_out.reshape(shape) * x0).to(z.dtype)

    def teacher_step(self, teacher_fn: ModelFn, z: torch.Tensor, t_from: torch.Tensor,
                     t_to: torch.Tensor, cond: Any = None, uncond: Any = None,
                     guidance_scale: float = 1.0) -> torch.Tensor:
        """The teacher's DDIM step t_from → t_to, with CFG folded into ε (one
        batched call over [uncond; cond])."""
        if uncond is None or guidance_scale == 1.0:
            out = teacher_fn(z, t_from, cond)
            eps, _ = model_out_to_eps_x0(self.schedule, out, z, t_from, self.parameterization)
        else:
            z_in, t_in = torch.cat([z, z]), torch.cat([t_from, t_from])
            out = teacher_fn(z_in, t_in, cat_cond(uncond, cond))
            e_all, _ = model_out_to_eps_x0(self.schedule, out, z_in, t_in,
                                           self.parameterization)
            e_u, e_c = e_all.chunk(2)
            eps = apply_cfg(e_u, e_c, guidance_scale)
        return ddim_step_to(self.schedule, z, eps, t_from, t_to)

    @torch.no_grad()
    def draw_pair(self, teacher_fn: ModelFn, z0: torch.Tensor, cond: Any = None,
                  uncond: Any = None, guidance_scale: float = 1.0,
                  generator: torch.Generator | None = None, i: torch.Tensor | None = None,
                  noise: torch.Tensor | None = None):
        """The gradient-free half of a step: a boundary index i ∈ [1, N]
        per sample (`i`, else drawn), z0 noised to t_hi = ts[i] (`noise`,
        else drawn, fp32), the teacher's step down to t_lo = ts[i − 1].
        Returns (z_hi, z_lo, t_hi, t_lo)."""
        d = self.on(z0.device)
        b = z0.shape[0]
        ts = torch.from_numpy(d.boundaries.astype(np.int64)).to(z0.device)
        if i is None:
            i = torch.randint(1, ts.shape[0], (b,), generator=generator, device=z0.device)
        if noise is None:
            noise = torch.randn(z0.shape, generator=generator, device=z0.device)
        i = i.to(z0.device)
        t_hi, t_lo = ts[i], ts[i - 1]
        z_hi = d.schedule.q_sample(z0, t_hi, noise.to(z0.device))
        z_lo = d.teacher_step(teacher_fn, z_hi, t_hi, t_lo, cond=cond, uncond=uncond,
                                 guidance_scale=guidance_scale)
        return z_hi, z_lo, t_hi, t_lo

    def student_loss(self, student_fn: ModelFn, target_fn: ModelFn, z_hi: torch.Tensor,
                     z_lo: torch.Tensor, t_hi: torch.Tensor, t_lo: torch.Tensor,
                     cond: Any = None) -> tuple[torch.Tensor, dict]:
        """The gradient-carrying half: the pseudo-Huber distance of
        f_θ(z_hi, t_hi) to the target network's f⁻(z_lo, t_lo) (no grad)."""
        d = self.on(z_hi.device)
        with torch.no_grad():
            f_target = d.consistency_fn(target_fn, z_lo, t_lo, cond)
        f_student = d.consistency_fn(student_fn, z_hi, t_hi, cond)
        loss = pseudo_huber(f_student, f_target)
        logs = {"loss": loss, "t_hi_mean": t_hi.float().mean(),
                "f_gap": (f_student.float() - f_target.float()).abs().mean().detach()}
        return loss, logs

    def distill_loss(self, student_fn: ModelFn, target_fn: ModelFn, teacher_fn: ModelFn,
                     z0: torch.Tensor, cond: Any = None, uncond: Any = None,
                     guidance_scale: float = 1.0, generator: torch.Generator | None = None,
                     i: torch.Tensor | None = None, noise: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, dict]:
        """`draw_pair` then `student_loss` (LCM Algorithm 1)."""
        z_hi, z_lo, t_hi, t_lo = self.draw_pair(teacher_fn, z0, cond, uncond, guidance_scale,
                                                generator, i, noise)
        return self.student_loss(student_fn, target_fn, z_hi, z_lo, t_hi, t_lo, cond)

    def sample_timesteps(self, num_steps: int) -> np.ndarray:
        """The descending boundaries the sampler visits: num_steps + 1
        indices of the grid, rounded half to even (N = 50, 4 steps: indices
        [50, 38, 25, 12, 0]), always from the terminal one."""
        ts_all = self.boundaries
        sel = np.unique(np.round(np.linspace(0, len(ts_all) - 1, num_steps + 1))
                        ).astype(int)[::-1]
        return ts_all[sel]

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...], x_T: torch.Tensor,
               num_steps: int = 4, cond: Any = None,
               generator: torch.Generator | None = None,
               noise: NoiseFn | None = None) -> torch.Tensor:
        """Multistep consistency sampling: f predicts x0 at the current
        boundary, then re-noises it to the next with fresh noise
        (`noise(k, shape)`, else drawn from `generator`, at every call, the
        last one's unused); one model call per step."""
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T {tuple(x_T.shape)} != shape {tuple(shape)}")
        d = self.on(x_T.device)
        taus = d.sample_timesteps(num_steps)
        noise = noise or gaussian_noise(generator, x_T.device)
        z, b = x_T, shape[0]
        for k in range(len(taus) - 1):
            t = torch.full((b,), int(taus[k]), dtype=torch.long, device=x_T.device)
            x0 = d.consistency_fn(model_fn, z, t, cond)
            n = noise(k, tuple(x0.shape))
            if k == len(taus) - 2:
                z = x0
            else:
                t_next = torch.full((b,), int(taus[k + 1]), dtype=torch.long, device=x_T.device)
                z = d.schedule.q_sample(x0, t_next, n)
        return z
