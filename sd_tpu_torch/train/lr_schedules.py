"""LR schedules as functions of the step.

Counterpart of `sd_tpu/train/lr_schedules.py` `lambda_linear_schedule` (the
reference's LambdaLinearScheduler, the SD-v1 recipe's; a multiplier) and
`cosine_annealing` (torch's CosineAnnealingLR, the pixel-space DDPM
recipe's; the learning rate itself), computed in fp32 as the TPU package's
jnp versions are. The other schedules are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


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
        c = int(np.clip(np.searchsorted(cum, step, side="right") - 1, 0, len(cum) - 2))
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
