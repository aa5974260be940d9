"""Diffusion training: the train step with gradient accumulation, global-norm
clipping, Adam, EMA and the per-timestep logvar.

Counterpart of `sd_tpu/train/diffusion.py`. The TPU package's step is a pure
function (state, batch, rng) -> (state, logs) that jit compiles with the
state donated; here the step updates the state in place (parameters, Adam
moments, EMA shadow), which is what the donation buys there: no second copy
of the training state.

The optimizer is a small one of plain tensor ops, optax's
`chain(clip_by_global_norm, adam)` with optax's defaults, rather than
`torch.optim.Adam`: under bf16 parameters `float32_moments` keeps the
moments in fp32, computes the whole update in fp32, casts it to the
parameter's dtype and then adds it, as the TPU package's wrapper does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sd_tpu_torch.core.ema import EmaState, ema_init, ema_update
from sd_tpu_torch.kernels.conv2d import training_trace


def cast_floating(tensors: dict[str, torch.Tensor], dtype: torch.dtype | None
                  ) -> dict[str, torch.Tensor]:
    """Floating-point tensors cast to `dtype`, the others as they are."""
    if dtype is None:
        return dict(tensors)
    return {n: t.to(dtype) if t.is_floating_point() else t for n, t in tensors.items()}


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖t‖² accumulated in fp32 (a bf16 sum of squares over 10⁸ values
    loses the norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Adam:
    """Clip by global norm (`grad_clip`; None: no clipping), then Adam,
    then the step size `lr` (a float or a function of the step count).
    `compute_dtype` None computes in each gradient's dtype, as optax does;
    `float32_moments` sets it to fp32."""

    lr: float | Callable[[int], float]
    grad_clip: float | None = 1.0
    compute_dtype: torch.dtype | None = None

    def init(self, params: list[torch.Tensor]) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=self.compute_dtype or p.dtype,
                                      device=p.device)
        return AdamState(count=0, mu=[zeros(p) for p in params],
                         nu=[zeros(p) for p in params])

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdamState) -> None:
        """One step on `params`, in place, from `grads`."""
        gs = [g.to(self.compute_dtype) if self.compute_dtype else g for g in grads]
        if self.grad_clip is not None and self.grad_clip > 0:
            norm = global_norm(gs)   # a select, not a branch: no wait for the card
            gs = [torch.where(norm < self.grad_clip, g, g / norm.to(g.dtype) * self.grad_clip)
                  for g in gs]
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.count += 1
        c1 = 1.0 - B1**state.count
        c2 = 1.0 - B2**state.count
        for p, g, mu, nu in zip(params, gs, state.mu, state.nu):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            p.add_((update * -lr).to(p.dtype))


def ddpm_optimizer(lr: float | Callable[[int], float] = 2e-5,
                   grad_clip: float | None = 1.0) -> Adam:
    """Adam + global-norm clipping: the DDPM/LDM recipe."""
    return Adam(lr=lr, grad_clip=grad_clip)


def float32_moments(opt: Adam) -> Adam:
    """`opt` with fp32 moments and an fp32 update under low-precision
    parameters (the update is cast to the parameter's dtype, then added)."""
    return dataclasses.replace(opt, compute_dtype=torch.float32)


@dataclasses.dataclass
class TrainState:
    """The trained tensors (a module's parameters, by name), the optimizer
    state over them in that order, the EMA and the step count."""

    params: dict[str, torch.Tensor]
    opt_state: AdamState
    ema: EmaState | None
    step: int = 0
    logvar: torch.Tensor | None = None   # per-timestep logvar [T] (zeros) or None


def init_train_state(params: dict[str, torch.Tensor], optimizer: Adam,
                     ema_decay: float | None = 0.9999,
                     num_timesteps: int | None = None) -> TrainState:
    """The training state over `params` (made to require grad), with an
    fp32 EMA shadow and, when `num_timesteps` is given, the [T] logvar
    table the loss reads (zeros, not trained: learning it is not ported)."""
    for p in params.values():
        p.requires_grad_(True)
    device = next(iter(params.values())).device
    logvar = (None if num_timesteps is None
              else torch.zeros(num_timesteps, dtype=torch.float32, device=device))
    return TrainState(
        params=params, opt_state=optimizer.init(list(params.values())),
        ema=ema_init(params, ema_decay) if ema_decay is not None else None,
        logvar=logvar)


def _split(batch: dict, n: int) -> list[dict]:
    """The batch as `n` microbatches along dim 0 (tensors and lists)."""
    size = len(next(iter(batch.values())))
    if size % n:
        raise ValueError(f"batch of {size} does not split into grad_accum={n}")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


def make_diffusion_train_step(
    loss_fn: Callable, optimizer: Adam, grad_accum: int = 1,
) -> Callable[[TrainState, dict, torch.Generator | None], dict]:
    """The train step `step(state, batch, generator) -> logs`, which updates
    `state` IN PLACE: parameters, optimizer moments, EMA shadow and step.

    loss_fn(batch, generator, logvar) -> (loss, logs), e.g. a closure over
    `LatentDiffusion.training_loss`. With grad_accum > 1 the batch is split
    into that many microbatches, run one after the other (one backward each,
    the gradients summed in the parameters' dtype, as the TPU package's scan
    sums them), and averaged into ONE optimizer and EMA update. The logs are
    the microbatches' mean, plus `grad_norm`, the fp32 global norm of the
    averaged gradient before clipping. The whole step runs inside
    `training_trace()`."""

    def step(state: TrainState, batch: dict,
             generator: torch.Generator | None = None) -> dict:
        trained = list(state.params.values())
        sums: dict[str, torch.Tensor] = {}
        with training_trace():
            for mb in (_split(batch, grad_accum) if grad_accum > 1 else [batch]):
                loss, logs = loss_fn(mb, generator, state.logvar)
                loss.backward()
                for k, v in logs.items():
                    sums[k] = sums.get(k, 0.0) + v.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in trained]
        if grad_accum > 1:
            for g in grads:
                g.div_(grad_accum)
        out = {k: v / grad_accum for k, v in sums.items()}
        out["grad_norm"] = global_norm(grads)
        optimizer.update_(trained, grads, state.opt_state)
        for p in trained:
            p.grad = None
        if state.ema is not None:
            ema_update(state.ema, state.params)
        state.step += 1
        return out

    return step
