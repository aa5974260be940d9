"""Diffusion training: the train step with gradient accumulation, global-norm
clipping, Adam(W), EMA and the per-timestep logvar.

Counterpart of `sd_tpu/train/diffusion.py`. The TPU package's step is a pure
function (state, batch, rng) -> (state, logs) that jit compiles with the
state donated; here the step updates the state in place (parameters, Adam
moments, EMA shadow), which is what the donation buys there: no second copy
of the training state.

The optimizer is a small one of plain tensor ops, optax's
`chain(clip_by_global_norm, adam)` (or `adamw` with `weight_decay`: the
decay decoupled, −lr·(m̂/(√v̂ + ε) + wd·p)) with optax's defaults, rather
than `torch.optim.Adam`: under bf16 parameters `float32_moments` keeps the
moments in fp32, computes the whole update in fp32 (the decay's p too),
casts it to the parameter's dtype and then adds it, as the TPU package's
wrapper does.

With `learn_logvar` the [T] logvar table is trained beside the parameters:
the optimizer holds it after them (its gradient clipped with theirs and
counted in `grad_norm`), the EMA does not shadow it, the checkpoint keeps
it (`TrainState.logvar`).
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
    """Clip by global norm (`grad_clip`; None: no clipping), then Adam with
    betas `b1`, `b2`, plus `weight_decay`·p where it is > 0 (optax's
    `adamw`), then the step size `lr` (a float or a function of the step
    count). `compute_dtype` None computes in each gradient's dtype, as
    optax does; `float32_moments` sets it to fp32."""

    lr: float | Callable[[int], float]
    grad_clip: float | None = 1.0
    compute_dtype: torch.dtype | None = None
    b1: float = B1
    b2: float = B2
    weight_decay: float = 0.0

    def init(self, params: list[torch.Tensor]) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=self.compute_dtype or p.dtype,
                                      device=p.device)
        return AdamState(count=0, mu=[zeros(p) for p in params],
                         nu=[zeros(p) for p in params])

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdamState, norm: torch.Tensor | None = None) -> None:
        """One step on `params`, in place, from `grads`; clipped by `norm`,
        the gradients' global norm, where the caller has it (a sharded
        update holds slices, whose own norm is not the global one)."""
        gs = [g.to(self.compute_dtype) if self.compute_dtype else g for g in grads]
        if self.grad_clip is not None and self.grad_clip > 0:
            if norm is None:
                norm = global_norm(gs)   # a select, not a branch: no wait for the card
            gs = [torch.where(norm < self.grad_clip, g, g / norm.to(g.dtype) * self.grad_clip)
                  for g in gs]
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.count += 1
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1**state.count
        c2 = 1.0 - b2**state.count
        for p, g, mu, nu in zip(params, gs, state.mu, state.nu):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            if self.weight_decay > 0:
                update = update + self.weight_decay * p.to(update.dtype)
            p.add_((update * -lr).to(p.dtype))


def ddpm_optimizer(lr: float | Callable[[int], float] = 2e-5,
                   grad_clip: float | None = 1.0, weight_decay: float = 0.0) -> Adam:
    """Adam (AdamW with `weight_decay` > 0) + global-norm clipping: the
    DDPM/LDM recipe."""
    return Adam(lr=lr, grad_clip=grad_clip, weight_decay=float(weight_decay or 0.0))


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
    logvar: torch.Tensor | None = None   # per-timestep logvar [T] (zeros at init) or None


def init_train_state(params: dict[str, torch.Tensor], optimizer: Adam,
                     ema_decay: float | None = 0.9999,
                     num_timesteps: int | None = None,
                     param_dtype: torch.dtype | None = None,
                     ema_dtype: torch.dtype = torch.float32,
                     learn_logvar: bool = False) -> TrainState:
    """The training state over `params` (made to require grad), with an EMA
    shadow in `ema_dtype` and, when `num_timesteps` is given, the [T] fp32
    logvar table the loss reads (zeros). With `learn_logvar` the table
    requires grad and the optimizer's state covers it after the parameters.
    With `param_dtype` the floating parameters are cast to it first (a
    tensor already in that dtype is kept, so a module's own parameters stay
    its own)."""
    params = cast_floating(params, param_dtype)
    for p in params.values():
        p.requires_grad_(True)
    device = next(iter(params.values())).device
    logvar = (None if num_timesteps is None
              else torch.zeros(num_timesteps, dtype=torch.float32, device=device))
    trained = list(params.values())
    if learn_logvar and logvar is not None:
        trained.append(logvar.requires_grad_(True))
    return TrainState(
        params=params, opt_state=optimizer.init(trained),
        ema=ema_init(params, ema_decay, dtype=ema_dtype) if ema_decay is not None else None,
        logvar=logvar)


def _split(batch, n: int) -> list:
    """The batch as `n` microbatches along dim 0: each tensor split by rows,
    dicts and lists of tensors (a conditioning dict) leaf by leaf."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(batch, (list, tuple)):
        parts = [_split(v, n) for v in batch]
        return [[p[i] for p in parts] for i in range(n)]
    if batch.shape[0] % n:
        raise ValueError(f"batch of {batch.shape[0]} does not split into grad_accum={n}")
    return list(batch.chunk(n))


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
    averaged gradient before clipping. A state logvar table that requires
    grad (`init_train_state(learn_logvar=True)`) trains too. Only
    the trained tensors' gradients are read, so a frozen tensor the loss
    runs through keeps no `.grad`. The whole step runs inside
    `training_trace()`."""

    def step(state: TrainState, batch: dict,
             generator: torch.Generator | None = None) -> dict:
        trained = list(state.params.values())
        if state.logvar is not None and state.logvar.requires_grad:
            trained.append(state.logvar)
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
