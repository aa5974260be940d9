"""LR schedules as `step -> multiplier` functions.

Counterpart of `sd_tpu/train/lr_schedules.py` `lambda_linear_schedule` (the
reference's LambdaLinearScheduler, the SD-v1 recipe's), computed in fp32 as
the TPU package's jnp version is. The other schedules are not ported yet.
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
