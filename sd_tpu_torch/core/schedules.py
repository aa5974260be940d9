"""Diffusion noise schedules and DDIM sub-schedule math.

Counterpart of `sd_tpu/core/schedules.py`: the tables are computed once in
float64 numpy and stored as float32 tensors, so they match the TPU package's
exactly. Ported: the tables and methods of sampling (DDIM sub-schedules
with uniform / quad / trailing / Karras striding, the x0 / ε / v coordinate
changes, the posterior of the ancestral sampler) and of the training loss
(`q_sample`, `get_v`, `lvlb_weights`), with `given_betas` and the
zero-terminal-SNR rescaling (`rescale_zero_terminal_snr`, which needs the v
or x0 parameterization).
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


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Betas rescaled so the terminal SNR is exactly zero (Lin et al.,
    arXiv:2305.08891 Algorithm 1): √ᾱ shifted and scaled so √ᾱ_T = 0 with
    √ᾱ_1 kept, in float64. ε-prediction is undefined at ᾱ = 0, so
    `DiffusionSchedule.create` takes it only with v or x0."""
    betas = np.asarray(betas, dtype=np.float64)
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    s_0, s_T = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - s_T) * s_0 / (s_0 - s_T)
    abar = abar_sqrt**2
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


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
    elif ddim_discr_method == "trailing":
        # include the final step t = T-1; no +1 shift (t = 0 is the data end)
        ts = np.round(
            np.arange(num_ddpm_timesteps, 0, -num_ddpm_timesteps / num_ddim_timesteps)
        ).astype(int) - 1
        return np.unique(ts)
    else:
        raise NotImplementedError(f"unknown ddim discretization {ddim_discr_method!r}")
    return ddim_timesteps + 1


def make_karras_timesteps(alphas_cumprod: np.ndarray, num_timesteps: int,
                          rho: float = 7.0) -> np.ndarray:
    """Karras ρ-spaced timesteps (arXiv:2206.00364 eq. 5) on the discrete
    DDPM lattice (int64, ascending, strictly increasing): σ(t) =
    sqrt((1-ᾱ)/ᾱ) spaced evenly in σ^(1/ρ) from σ(T-1) down to σ(1), each
    target mapped to the nearest t, collisions pushed up."""
    abar = np.asarray(alphas_cumprod, dtype=np.float64)
    sig = np.sqrt((1.0 - abar) / abar)
    s_min, s_max = sig[1], sig[-1]
    frac = np.arange(num_timesteps, dtype=np.float64) / max(num_timesteps - 1, 1)
    sigmas = (s_max ** (1.0 / rho) + frac * (s_min ** (1.0 / rho) - s_max ** (1.0 / rho))) ** rho
    ts = np.sort(np.abs(sig[None, :] - sigmas[:, None]).argmin(axis=1))
    ts = np.maximum(ts, 1)
    for k in range(1, len(ts)):
        if ts[k] <= ts[k - 1]:
            ts[k] = ts[k - 1] + 1
    if ts[-1] >= len(abar):
        raise ValueError(f"karras striding needs num_timesteps ({num_timesteps}) well "
                         f"below the DDPM T ({len(abar)})")
    return ts


def sub_timesteps(base: "DiffusionSchedule", num_steps: int, method: str) -> np.ndarray:
    """The ascending DDPM timesteps of an S-step sub-schedule ("karras" or a
    `make_ddim_timesteps` method) and ᾱ in float64 (from the fp32 table)."""
    abar = base.alphas_cumprod.cpu().numpy().astype(np.float64)
    if method == "karras":
        return make_karras_timesteps(abar, num_steps), abar
    return make_ddim_timesteps(method, num_steps, base.num_timesteps), abar


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
    """Per-timestep tables of a DDPM process: the ones the samplers and the
    training loss read."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
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
        given_betas: np.ndarray | None = None,
        parameterization: str = "eps",
        zero_terminal_snr: bool = False,
    ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, timesteps, linear_start, linear_end, cosine_s)
        if zero_terminal_snr:
            # ᾱ_T becomes exactly 0, where x0 = (x − σε)/√ᾱ is undefined
            if parameterization == "eps":
                raise ValueError(
                    "zero_terminal_snr requires parameterization='v' (or "
                    "'x0'); eps is undefined at the zero-SNR terminal step")
            betas = rescale_zero_terminal_snr(betas)
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
        with np.errstate(divide="ignore"):
            # inf at a zero-SNR terminal step, whose ε tables the guard excludes
            sqrt_recip = np.sqrt(1.0 / alphas_cumprod)
            sqrt_recipm1 = np.sqrt(1.0 / alphas_cumprod - 1.0)
        return cls(
            betas=_f32(betas),
            alphas_cumprod=_f32(alphas_cumprod),
            alphas_cumprod_prev=_f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=_f32(sqrt_recip),
            sqrt_recipm1_alphas_cumprod=_f32(sqrt_recipm1),
            posterior_variance=_f32(posterior_variance),
            posterior_log_variance_clipped=_f32(np.log(np.maximum(posterior_variance, 1e-20))),
            # Ho et al. eq. 7 (the paper-correct coef2, as the TPU package)
            posterior_mean_coef1=_f32(betas * np.sqrt(alphas_cumprod_prev)
                                      / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=_f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                      / (1.0 - alphas_cumprod)),
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

    # coordinate changes between ε, x0 and v, with x_t = α·x0 + σ·ε,
    # α = √ᾱ_t, σ = √(1−ᾱ_t) and v = α·ε − σ·x0

    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.ndim
        return (extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_eps_from_start(self, x_t, t, x0):
        nd = x_t.ndim
        return ((extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_start_from_v(self, x_t, t, v):
        nd = x_t.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def predict_eps_from_v(self, x_t, t, v):
        nd = x_t.ndim
        return (extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_t
                + extract(self.sqrt_alphas_cumprod, t, nd) * v)

    def q_posterior(self, x_start, x_t, t):
        """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.ndim
        mean = (extract(self.posterior_mean_coef1, t, nd) * x_start
                + extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(self.posterior_variance, t, nd),
                extract(self.posterior_log_variance_clipped, t, nd))


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
        ts, alphacums = sub_timesteps(base, num_steps, method)
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
