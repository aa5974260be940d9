"""Rectified flow: the straight noising path z_t = (1 − t)·x0 + t·ε, the
velocity objective and the ODE samplers.

Counterpart of `sd_tpu/diffusion/flow.py` (flow matching, Lipman et al.
arXiv:2210.02747; rectified flow, Liu et al. arXiv:2209.03003; the SD3
recipe, Esser et al. arXiv:2403.03206): `FlowSchedule` (the integer
lattice t ∈ [0, T) mapped to t_cont = t / (T − 1), with SD3's shift warp,
in fp32), `FlowProcess.p_losses` (the velocity MSE, uniform or
logit-normal-weighted over the uniform integer draw, with `DDPMProcess`'s
signature so `LatentDiffusion.training_loss` and the trainers take it as
they are) and `FlowEulerSampler` (Euler or midpoint steps from t = 1 to 0,
CFG through one batched model call, the velocities combined in fp32). The
integration grid is integer lattice steps rounded in numpy; the times, the
step sizes and the update are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import numpy as np
import torch

from sd_tpu_torch.diffusion.ddpm import mean_flat
from sd_tpu_torch.diffusion.guidance import ModelFn, apply_cfg, cat_cond


@dataclasses.dataclass(frozen=True)
class FlowSchedule:
    """The flow lattice: t_cont = shift-warped t / (T − 1). `shift` is SD3's
    resolution-dependent timestep shift, t' = shift·t / (1 + (shift − 1)·t)
    (1 is the identity)."""

    num_timesteps: int = 1000
    shift: float = 1.0

    def t_cont(self, t: torch.Tensor) -> torch.Tensor:
        """Integer lattice steps → continuous times in [0, 1], fp32."""
        u = t.to(torch.float32) / (self.num_timesteps - 1)
        if self.shift != 1.0:
            u = self.shift * u / (1.0 + (self.shift - 1.0) * u)
        return u

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """(1 − t)·x0 + t·ε in fp32, in x_start's dtype: exactly x0 at t = 0
        and ε at t = T − 1."""
        u = self.t_cont(t)
        u = u.reshape(u.shape + (1,) * (x_start.ndim - 1))
        return ((1.0 - u) * x_start.float() + u * noise.float()).to(x_start.dtype)


@dataclasses.dataclass(frozen=True)
class FlowProcess:
    """The flow-matching training process: the model predicts the velocity
    v = ε − x0; the loss is its MSE, importance-weighted by the
    logit-normal density of t_cont with `timestep_density="logit_normal"`."""

    parameterization: ClassVar[str] = "flow"
    schedule: FlowSchedule
    timestep_density: str = "uniform"      # "uniform" | "logit_normal"
    logit_mean: float = 0.0
    logit_std: float = 1.0

    def p_losses(self, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor, cond: Any = None,
                 learned_logvar: torch.Tensor | None = None,
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(loss, logs) of the velocity target; `learned_logvar` is taken for
        the signature and unused (no per-timestep variance)."""
        sched = self.schedule
        z_t = sched.q_sample(x_start, t, noise)
        model_out = model_fn(z_t, t, cond)
        err = model_out.float() - (noise.float() - x_start.float())
        loss_raw = mean_flat(err**2)
        if self.timestep_density == "logit_normal":
            # the density over the uniform draw: E_t[w] = 1 up to the lattice
            u = torch.clamp(sched.t_cont(t), 1e-5, 1.0 - 1e-5)
            logit = torch.log(u / (1.0 - u))
            m, s = self.logit_mean, self.logit_std
            dens = torch.exp(-((logit - m) ** 2) / (2 * s**2)) / (
                s * np.sqrt(2 * np.pi) * u * (1.0 - u))
            loss_raw = loss_raw * dens
        elif self.timestep_density != "uniform":
            raise ValueError(f"unknown timestep_density {self.timestep_density!r}")
        loss = loss_raw.mean()
        return loss, {"loss": loss, "loss_simple": loss}


@dataclasses.dataclass(frozen=True)
class FlowEulerSampler:
    """Integrate dz/dt = v(z, t) from t = 1 (noise) to 0 (data): "euler"
    (one model call a step) or "midpoint" (two, second order)."""

    schedule: FlowSchedule
    method: str = "euler"

    def _timesteps(self, num_steps: int) -> np.ndarray:
        """Descending integer lattice steps T − 1 → 0, num_steps + 1 of them."""
        T = self.schedule.num_timesteps
        return np.round(np.linspace(T - 1, 0, num_steps + 1)).astype(np.int32)

    def sample(self, model_fn: ModelFn, shape: tuple[int, ...], x_T: torch.Tensor,
               num_steps: int = 28, cond=None, uncond=None,
               guidance_scale: float = 1.0) -> torch.Tensor:
        """num_steps steps from x_T [shape]; with `uncond` and a scale other
        than 1, [uncond; cond] through one batched model call a velocity."""
        if self.method not in ("euler", "midpoint"):
            raise ValueError(f"unknown method {self.method!r}")
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T {tuple(x_T.shape)} != shape {tuple(shape)}")
        device = x_T.device
        ts = self._timesteps(num_steps)
        u_grid = self.schedule.t_cont(torch.from_numpy(ts).to(device))
        b = shape[0]
        both = None if uncond is None or guidance_scale == 1.0 else cat_cond(uncond, cond)

        def velocity(z, t_int):
            t_vec = torch.full((b,), int(t_int), dtype=torch.long, device=device)
            if both is None:
                return model_fn(z, t_vec, cond).float()
            v_u, v_c = model_fn(torch.cat([z, z]), torch.cat([t_vec, t_vec]), both).chunk(2)
            return apply_cfg(v_u.float(), v_c.float(), guidance_scale)

        z = x_T
        for k in range(num_steps):
            du = u_grid[k + 1] - u_grid[k]                 # negative
            v = velocity(z, ts[k])
            if self.method == "midpoint":
                z_mid = (z.float() + 0.5 * du * v).to(z.dtype)
                v = velocity(z_mid, (int(ts[k]) + int(ts[k + 1])) // 2)
            z = (z.float() + du * v).to(z.dtype)
        return z
