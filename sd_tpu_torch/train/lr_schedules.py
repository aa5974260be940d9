"""LR schedules as functions of the step.

Counterpart of `sd_tpu/train/lr_schedules.py`: the multipliers
`lambda_linear_schedule` (the reference's LambdaLinearScheduler, the SD-v1
recipe's), `lambda_warmup_cosine_schedule` and its multi-cycle
`lambda_warmup_cosine_schedule_v2` (LambdaWarmUpCosineScheduler(2)), the
learning rate `cosine_annealing` (torch's CosineAnnealingLR, the
pixel-space DDPM recipe's), computed in fp32 as the TPU package's jnp
versions are; and `reduce_on_plateau`, optax's ReduceLROnPlateau as a small
stateful object: `update(value)` takes the monitored loss and returns the
scale to multiply the update by.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

_F32 = np.float32


def lambda_warmup_cosine_schedule(warm_up_steps: int, lr_min: float, lr_max: float,
                                  lr_start: float, max_decay_steps: int
                                  ) -> Callable[[int], float]:
    """Linear warm-up from lr_start to lr_max over `warm_up_steps`, then a
    cosine decay to lr_min at `max_decay_steps` (held there)."""
    lo, hi, start = _F32(lr_min), _F32(lr_max), _F32(lr_start)
    wu, span = _F32(max(warm_up_steps, 1)), _F32(max(max_decay_steps - warm_up_steps, 1))

    def schedule(step: int) -> float:
        n = _F32(step)
        if n < warm_up_steps:
            return float(start + (hi - start) * n / wu)
        t = np.clip((n - _F32(warm_up_steps)) / span, _F32(0.0), _F32(1.0))
        return float(lo + _F32(0.5) * (hi - lo) * (_F32(1.0) + np.cos(t * _F32(np.pi))))

    return schedule


def _cycle_index(step: int, cum_cycles) -> int:
    """The cycle holding `step`, given the cycles' cumulative boundaries."""
    return int(np.clip(np.searchsorted(cum_cycles, step, side="right") - 1, 0,
                       len(cum_cycles) - 2))


def lambda_warmup_cosine_schedule_v2(warm_up_steps: Sequence[int], f_min: Sequence[float],
                                     f_max: Sequence[float], f_start: Sequence[float],
                                     cycle_lengths: Sequence[int]) -> Callable[[int], float]:
    """Multi-cycle warm-up from f_start to f_max, then a cosine decay to
    f_min over the rest of each cycle."""
    f32 = lambda x: np.asarray(x, _F32)
    cum = np.concatenate([[0], np.cumsum(cycle_lengths)])
    wu, fmin, fmax, fstart = f32(warm_up_steps), f32(f_min), f32(f_max), f32(f_start)
    lengths, cum32, one = f32(cycle_lengths), f32(cum), _F32(1.0)

    def schedule(step: int) -> float:
        c = _cycle_index(step, cum)
        n = _F32(step) - cum32[c]
        if n < wu[c]:
            return float(fstart[c] + (fmax[c] - fstart[c]) * n / max(wu[c], one))
        t = np.clip((n - wu[c]) / max(lengths[c] - wu[c], one), _F32(0.0), one)
        return float(fmin[c] + _F32(0.5) * (fmax[c] - fmin[c]) * (one + np.cos(t * _F32(np.pi))))

    return schedule


def lambda_linear_schedule(
    warm_up_steps: Sequence[int],
    f_min: Sequence[float],
    f_max: Sequence[float],
    f_start: Sequence[float],
    cycle_lengths: Sequence[int],
) -> Callable[[int], float]:
    """Multi-cycle linear warm-up from f_start to f_max, then linear decay
    from f_max towards f_min over the rest of the cycle."""
    f32 = lambda x: np.asarray(x, np.float32)
    cum = np.concatenate([[0], np.cumsum(cycle_lengths)])
    wu, fmin, fmax, fstart = f32(warm_up_steps), f32(f_min), f32(f_max), f32(f_start)
    lengths, cum32 = f32(cycle_lengths), f32(cum)
    one = np.float32(1.0)

    def schedule(step: int) -> float:
        c = _cycle_index(step, cum)
        n = np.float32(step) - cum32[c]
        if n < wu[c]:
            return float(fstart[c] + (fmax[c] - fstart[c]) * n / max(wu[c], one))
        return float(fmin[c] + (fmax[c] - fmin[c]) * (lengths[c] - n) / max(lengths[c], one))

    return schedule


def cosine_annealing(base_lr: float, total_steps: int,
                     eta_min: float = 0.0) -> Callable[[int], float]:
    """The absolute learning rate eta_min + ½(base_lr − eta_min)(1 + cos πt),
    t = step / total_steps clipped to [0, 1]."""
    f32 = np.float32
    half_span, low = f32(0.5 * (base_lr - eta_min)), f32(eta_min)
    total = f32(max(total_steps, 1))

    def schedule(step: int) -> float:
        t = np.clip(f32(step) / total, f32(0.0), f32(1.0))
        return float(low + half_span * (f32(1.0) + np.cos(t * f32(np.pi))))

    return schedule


@dataclasses.dataclass
class ReduceOnPlateau:
    """optax's `contrib.reduce_on_plateau` state and rule (one value per
    update, no absolute tolerance), in fp32: a value below (1 − rtol)·best
    is an improvement; `patience` updates without one multiply the scale by
    `factor` (not below `min_scale`) and start `cooldown` updates in which
    nothing counts."""

    factor: float = 0.5
    patience: int = 10
    rtol: float = 1e-4
    cooldown: int = 0
    min_scale: float = 0.0
    best_value: np.float32 = _F32(np.inf)
    plateau_count: int = 0
    scale: np.float32 = _F32(1.0)
    cooldown_count: int = 0

    def update(self, value: float) -> float:
        """Take the monitored value; the scale for this update."""
        value = _F32(value)
        improved = value < _F32(1.0 - self.rtol) * self.best_value
        if improved:
            self.best_value = value
        count = 0 if improved else self.plateau_count + 1
        if self.cooldown_count > 0:
            self.plateau_count, self.cooldown_count = 0, self.cooldown_count - 1
        else:
            hit = count == self.patience
            self.plateau_count = 0 if hit else count
            if hit:
                self.scale = max(self.scale * _F32(self.factor), _F32(self.min_scale))
            self.cooldown_count = self.cooldown if hit else 0
        return float(self.scale)


def reduce_on_plateau(factor: float = 0.5, patience: int = 10, rtol: float = 1e-4,
                      cooldown: int = 0, min_scale: float = 0.0) -> ReduceOnPlateau:
    """A fresh `ReduceOnPlateau` (torch's ReduceLROnPlateau as optax has
    it): feed it the monitored loss each step, scale the update by what it
    returns."""
    if not 0.0 < factor < 1.0:
        raise ValueError(f"factor must be in (0, 1), got {factor}")
    if not 0.0 < rtol <= 1.0:
        raise ValueError(f"rtol must be in (0, 1], got {rtol}")
    return ReduceOnPlateau(factor, patience, rtol, cooldown, min_scale)
