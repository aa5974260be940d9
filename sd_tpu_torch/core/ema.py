"""Exponential moving average of parameters.

Counterpart of `sd_tpu/core/ema.py`: init / update / copy_to with the
warm-up decay min(decay, (1 + n) / (10 + n)), or a constant decay without
the warm-up (`use_num_updates=False`, which keeps n at −1). The shadow is
its own set of tensors in `dtype` (fp32 by default; a bf16 shadow for a
fast-moving target such as consistency distillation's) and is updated in
place, where the TPU package returns a new tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: dict[str, torch.Tensor]
    num_updates: int = 0               # −1: no warm-up, the decay is constant
    decay: float = 0.9999


def ema_init(params: dict[str, torch.Tensor], decay: float = 0.9999,
             use_num_updates: bool = True, dtype: torch.dtype = torch.float32) -> EmaState:
    """A shadow copy of `params` in `dtype` (never aliasing them)."""
    shadow = {n: p.detach().to(dtype, copy=True) for n, p in params.items()}
    return EmaState(shadow=shadow, num_updates=0 if use_num_updates else -1, decay=decay)


@torch.no_grad()
def ema_update(state: EmaState, params: dict[str, torch.Tensor]) -> None:
    """shadow ← shadow − ((1 − d)(shadow − params)) in the shadow's dtype,
    in place; d is the warm-up decay (or the constant one at n = −1),
    computed in fp32 as the TPU package does."""
    if state.num_updates >= 0:
        state.num_updates += 1
        n = np.float32(state.num_updates)
        decay = min(np.float32(state.decay), (np.float32(1) + n) / (np.float32(10) + n))
    else:
        decay = np.float32(state.decay)
    one_minus = float(np.float32(1) - decay)
    for name, s in state.shadow.items():
        s.sub_((one_minus * (s - params[name].to(s.dtype))).to(s.dtype))


def ema_copy_to(state: EmaState, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The shadow weights cast to the dtypes of `params`."""
    return {n: s.to(params[n].dtype) for n, s in state.shadow.items()}
