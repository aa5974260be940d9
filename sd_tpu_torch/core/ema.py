"""Exponential moving average of parameters.

Counterpart of `sd_tpu/core/ema.py`: init / update / copy_to with the
warm-up decay min(decay, (1 + n) / (10 + n)). The shadow is its own set of
fp32 tensors (over bf16 parameters) and is updated in place, where the TPU
package returns a new tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: dict[str, torch.Tensor]
    num_updates: int = 0
    decay: float = 0.9999


def ema_init(params: dict[str, torch.Tensor], decay: float = 0.9999) -> EmaState:
    """An fp32 shadow copy of `params` (never aliasing them)."""
    shadow = {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()}
    return EmaState(shadow=shadow, decay=decay)


@torch.no_grad()
def ema_update(state: EmaState, params: dict[str, torch.Tensor]) -> None:
    """shadow ← shadow − (1 − d)(shadow − params), in place, with the
    warm-up decay computed in fp32 as the TPU package does."""
    state.num_updates += 1
    n = np.float32(state.num_updates)
    decay = min(np.float32(state.decay), (np.float32(1) + n) / (np.float32(10) + n))
    one_minus = float(np.float32(1) - decay)
    for name, s in state.shadow.items():
        s.sub_((one_minus * (s - params[name].to(s.dtype))).to(s.dtype))


def ema_copy_to(state: EmaState, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The shadow weights cast to the dtypes of `params`."""
    return {n: s.to(params[n].dtype) for n, s in state.shadow.items()}
