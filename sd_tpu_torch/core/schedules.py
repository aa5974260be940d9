"""Diffusion noise schedules and DDIM sub-schedule math.

Counterpart of `sd_tpu/core/schedules.py`: the tables are computed once in
float64 numpy and stored as float32 tensors, so they match the TPU package's
exactly. Ported: the tables and methods of DDIM sampling and of the training
loss (`q_sample`, `get_v`, `lvlb_weights`); the posterior tables of the
ancestral sampler and zero-terminal-SNR rescaling are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Return float64 betas[T] for the named schedule.

    Schedules: "linear" (sqrt-space interpolation, the SD-v1 default),
    "cosine" (Nichol & Dhariwal), "sqrt_linear" (plain linear), "sqrt".
    """
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """Strided DDPM timesteps for a DDIM sub-schedule (int64, ascending).

    'uniform': range(0, T, T//S) + 1; 'quad': quadratic spacing over [0, 0.8T].
    The +1 shift matches the reference so the final step scales to data.
    """
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.arange(0, num_ddpm_timesteps, c)
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, math.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization {ddim_discr_method!r}")
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sigmas, alphas, alphas_prev) for the DDIM update rule (eq.16 of
    arXiv:2010.02502). alphas here are cumulative-product alpha-bars."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([alphacums[:1], alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )
    return sigmas, alphas, alphas_prev


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] reshaped to [B, 1, 1, ...] with `ndim` dims for broadcasting."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1)).float()


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _to(obj, device):
    """A copy of a frozen dataclass of tables with every tensor on `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep tables of a DDPM process: the ones DDIM sampling and the
    training loss read."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    lvlb_weights: torch.Tensor
    num_timesteps: int

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(
            beta_schedule, timesteps, linear_start, linear_end, cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        if parameterization == "eps":
            with np.errstate(divide="ignore"):
                lvlb_weights = betas**2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod))
            # the t = 0 term is singular; the reference copies lvlb_weights[1]
            lvlb_weights[0] = lvlb_weights[1]
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * (1 - alphas_cumprod))
        elif parameterization == "v":
            # the v-space MSE is already SNR+1-weighted: identity reweighting
            lvlb_weights = np.ones_like(betas)
        else:
            raise ValueError(f"unknown parameterization {parameterization!r}")
        return cls(
            betas=_f32(betas),
            alphas_cumprod=_f32(alphas_cumprod),
            alphas_cumprod_prev=_f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
            lvlb_weights=_f32(lvlb_weights),
            num_timesteps=int(betas.shape[0]),
        )

    to = _to

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward diffusion q(x_t | x_0) (DDPM eq. 4), in x_start's dtype."""
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
                ).to(x_start.dtype)

    def get_v(self, x_start: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
        """The v-prediction target √ᾱ_t·ε − √(1−ᾱ_t)·x_0."""
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * noise
                - extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed tables for an S-step DDIM reverse pass.

    `timesteps` are the DDPM t values fed to the model, index 0 = earliest
    (closest to data). The sampler walks indices S-1 .. 0.
    """

    timesteps: torch.Tensor            # int64 [S]
    alphas: torch.Tensor               # alpha-bar at each step   [S]
    alphas_prev: torch.Tensor          # alpha-bar of prev step   [S]
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor
    num_steps: int
    eta: float = 0.0

    @classmethod
    def create(cls, base: DiffusionSchedule, num_steps: int, eta: float = 0.0,
               method: str = "uniform") -> "DDIMSchedule":
        alphacums = base.alphas_cumprod.cpu().numpy().astype(np.float64)
        ts = make_ddim_timesteps(method, num_steps, base.num_timesteps)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(alphacums, ts, eta)
        return cls(
            timesteps=torch.from_numpy(ts.astype(np.int64)),
            alphas=_f32(alphas),
            alphas_prev=_f32(alphas_prev),
            sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas)),
            sigmas=_f32(sigmas),
            num_steps=int(ts.shape[0]),
            eta=float(eta),
        )

    to = _to
