"""Two-optimizer GAN training of the KL autoencoder and the VQ model.

Counterpart of `sd_tpu/train/gan.py` `GanTrainState` (with the quantizer's
model state), `init_gan_state`, `make_kl_gan_train_step`,
`make_vq_gan_train_step`, `gumbel_temp_schedule` and `gan_adam`. One step is the generator update, then the discriminator update against
the generator pass's reconstruction, detached, with the discriminator's
BatchNorm in batch-stat mode throughout: the generator pass discards its
statistics, the discriminator pass folds real then fake into the running
statistics. As in `train/diffusion.py` the step updates the state in place.

One difference from the TPU package: the step runs ONE generator forward.
The adaptive discriminator weight needs ∂nll/∂W and ∂g/∂W at the decoder's
last kernel W; here two `torch.autograd.grad` pulls from the same forward
give them (retaining the graph), as the reference trainer does. The TPU
package runs a second forward only because `jax.vjp` needs one of its own.
`d_weight` is detached either way, so the numbers are the same. The
launches differ: per mid-block attention (encoder and decoder) this step
runs the flash training forward, dQ and dK/dV kernels once each and no
inference flash kernel, where the TPU package's second forward, outside the
differentiated path, also runs the inference kernel (`_flash_kernel`). The
VQ step keeps this: the TPU package's two passes see the same
reconstruction (its first with `update=False`, both with the same Gumbel
noise), and the EMA codebook's update, from this one forward's assignments
after its lookup, happens once a step as there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.kernels.conv2d import training_trace
from sd_tpu_torch.losses.gan import (GanLossConfig, adopt_weight,
                                     calculate_adaptive_weight, reconstruction_nll,
                                     vq_reconstruction_nll)
from sd_tpu_torch.parallel.mesh import data_mean
from sd_tpu_torch.train.diffusion import Adam, AdamState


@dataclasses.dataclass
class GanTrainState:
    """The generator's trained tensors (the autoencoder's parameters by
    name, and the learned global "logvar"), the discriminator's parameters,
    its BatchNorm running statistics (buffers by name; {} for ActNorm), one
    optimizer state each, the step count, and the generator's state that no
    optimizer sees (its buffers by name: the EMA codebook of the "ema" VQ
    family; {} otherwise). The tensors are the modules' own: an update
    shows in the modules."""

    params_g: dict[str, torch.Tensor]
    params_d: dict[str, torch.Tensor]
    batch_stats_d: dict[str, torch.Tensor]
    opt_state_g: AdamState
    opt_state_d: AdamState
    step: int = 0
    model_state: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def gan_adam(lr: float, b1: float = 0.5, b2: float = 0.9) -> Adam:
    """Adam with the GAN betas of the reference autoencoder trainers, no
    clipping."""
    return Adam(lr=lr, grad_clip=None, b1=b1, b2=b2)


def init_gan_state(model: nn.Module, disc: nn.Module, opt_g: Adam, opt_d: Adam,
                   logvar_init: float = 0.0,
                   param_dtype: torch.dtype | None = None) -> GanTrainState:
    """The training state over `model` and `disc`, made to require grad.
    `param_dtype` (e.g. bf16) stores the generator's AND the
    discriminator's parameters in that dtype (pair it with
    `float32_moments` optimizers); the logvar, the running statistics and
    the generator's buffers (the EMA codebook) stay fp32."""
    if param_dtype is not None:
        for module in (model, disc):
            for p in module.parameters():
                p.data = p.data.to(param_dtype)
    params_g = dict(model.named_parameters())
    params_g["logvar"] = torch.tensor(float(logvar_init), dtype=torch.float32,
                                      device=next(model.parameters()).device)
    params_d = dict(disc.named_parameters())
    for p in (*params_g.values(), *params_d.values()):
        p.requires_grad_(True)
    return GanTrainState(
        params_g=params_g, params_d=params_d, batch_stats_d=dict(disc.named_buffers()),
        opt_state_g=opt_g.init(list(params_g.values())),
        opt_state_d=opt_d.init(list(params_d.values())),
        model_state=dict(model.named_buffers()))


def _d_weight(cfg: GanLossConfig, nll: torch.Tensor, g: torch.Tensor,
              last: torch.Tensor) -> torch.Tensor:
    """The adaptive discriminator weight from two gradient pulls of the one
    generator forward at the decoder's last kernel `last` (the graph kept),
    or the fixed `disc_weight`."""
    if not cfg.use_adaptive_weight:
        return torch.tensor(cfg.disc_weight, device=nll.device)
    (nll_grad,) = torch.autograd.grad(nll, last, retain_graph=True)
    (g_grad,) = torch.autograd.grad(g, last, retain_graph=True)
    # a data-parallel step: the whole batch's gradients (every rank's mean)
    return calculate_adaptive_weight(data_mean(nll_grad), data_mean(g_grad), cfg.disc_weight)


def _generator_update(state: GanTrainState, opt_g: Adam, loss: torch.Tensor,
                      logs: dict) -> dict:
    """One optimizer step of the generator on ∇loss; the logs detached."""
    params_g = list(state.params_g.values())
    grads_g = torch.autograd.grad(loss, params_g)
    logs = {k: v.detach() if torch.is_tensor(v) else v for k, v in logs.items()}
    opt_g.update_(params_g, list(grads_g), state.opt_state_g)
    return logs


def _discriminator_update(state: GanTrainState, disc: nn.Module, opt_d: Adam, d_loss_fn,
                          x: torch.Tensor, recon: torch.Tensor, disc_factor: float) -> dict:
    """One optimizer step of the discriminator on real `x` then the
    detached `recon`, its running statistics threaded; its logs."""
    params_d = list(state.params_d.values())
    disc.requires_grad_(True)
    logits_real = disc(x, update_stats=True)
    logits_fake = disc(recon.detach(), update_stats=True)
    d_loss = disc_factor * d_loss_fn(logits_real.float(), logits_fake.float())
    grads_d = torch.autograd.grad(d_loss, params_d)
    opt_d.update_(params_d, list(grads_d), state.opt_state_d)
    return {"train/disc_loss": d_loss.detach(),
            "train/logits_real": logits_real.detach().float().mean(),
            "train/logits_fake": logits_fake.detach().float().mean()}


def make_kl_gan_train_step(
    ae_apply: Callable, disc: nn.Module, lpips_fn: Callable | None, opt_g: Adam,
    opt_d: Adam, cfg: GanLossConfig, last_layer: str = "decoder.conv_out.weight",
) -> Callable[[GanTrainState, torch.Tensor, torch.Generator | None], dict]:
    """The KL-VAE GAN step `step(state, x, generator) -> logs`, which
    updates `state` IN PLACE.

    ae_apply(x, generator) -> (recon, posterior): the autoencoder called
    with a posterior sample (drawn noise).
    lpips_fn(x, y) -> [B, 1, 1, 1] frozen perceptual distance, or None.
    `last_layer` names the generator parameter the adaptive weight reads.
    The logs have the TPU package's keys (`train/total_loss` ...
    `train/logits_fake`): 0-dim tensors, and `train/disc_factor` a float.
    The whole step runs inside `training_trace()`."""
    d_loss_fn = cfg.d_loss_fn()

    def step(state: GanTrainState, x: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        logvar = state.params_g["logvar"]
        disc_factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        with training_trace():
            # ---- generator: one forward, the discriminator frozen ----------
            disc.requires_grad_(False)
            recon, posterior = ae_apply(x, generator)
            perceptual = lpips_fn(x, recon) if lpips_fn is not None else None
            nll, rec, _ = reconstruction_nll(x, recon, logvar, perceptual, cfg)
            kl = posterior.kl().sum() / x.shape[0]
            g = -disc(recon).float().mean()
            d_weight = _d_weight(cfg, nll, g, state.params_g[last_layer])
            loss = nll + cfg.kl_weight * kl + d_weight * disc_factor * g
            logs = _generator_update(state, opt_g, loss, {
                "train/total_loss": loss, "train/nll_loss": nll, "train/kl_loss": kl,
                "train/g_loss": g, "train/rec_loss": rec, "train/d_weight": d_weight,
                "train/disc_factor": disc_factor, "train/logvar": logvar.detach().clone()})
            logs.update(_discriminator_update(state, disc, opt_d, d_loss_fn, x, recon,
                                              disc_factor))
        state.step += 1
        return logs

    return step


def make_vq_gan_train_step(
    vq_apply: Callable, disc: nn.Module, lpips_fn: Callable | None, opt_g: Adam,
    opt_d: Adam, cfg: GanLossConfig, last_layer: str = "decoder.conv_out.weight",
    temp_fn: Callable[[int], float] | None = None,
) -> Callable[[GanTrainState, torch.Tensor, torch.Generator | None], dict]:
    """The VQ-VAE GAN step `step(state, x, generator) -> logs`, which
    updates `state` IN PLACE (the EMA codebook too, through the model).

    vq_apply(x, generator, temp) -> (recon, codebook_loss, info): the VQ
    model called once per step, its EMA codebook (if any) updated from this
    call's assignments after its lookup, its Gumbel noise (if any) drawn from
    `generator`; `temp` is `temp_fn(step)` (None without it). The nll is the
    MEAN of the reconstruction map (`vq_reconstruction_nll`), the loss
    nll + d_weight·disc_factor·g + codebook_weight·codebook_loss. The logs
    have the TPU package's keys (`train/total_loss` ... `train/logits_fake`,
    `train/quant_loss`, `train/perplexity`). The whole step runs inside
    `training_trace()`."""
    d_loss_fn = cfg.d_loss_fn()

    def step(state: GanTrainState, x: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        logvar = state.params_g["logvar"]
        disc_factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        temp = temp_fn(state.step) if temp_fn is not None else None
        with training_trace():
            # ---- generator: one forward, the discriminator frozen ----------
            disc.requires_grad_(False)
            recon, codebook_loss, info = vq_apply(x, generator, temp)
            perceptual = lpips_fn(x, recon) if lpips_fn is not None else None
            nll, rec = vq_reconstruction_nll(x, recon, logvar, perceptual, cfg)
            g = -disc(recon).float().mean()
            d_weight = _d_weight(cfg, nll, g, state.params_g[last_layer])
            loss = nll + d_weight * disc_factor * g + cfg.codebook_weight * codebook_loss
            logs = _generator_update(state, opt_g, loss, {
                "train/total_loss": loss, "train/nll_loss": nll,
                "train/quant_loss": codebook_loss, "train/g_loss": g, "train/rec_loss": rec,
                "train/d_weight": d_weight, "train/disc_factor": disc_factor,
                "train/perplexity": info[0]})
            logs.update(_discriminator_update(state, disc, opt_d, d_loss_fn, x, recon,
                                              disc_factor))
        state.step += 1
        return logs

    return step


def gumbel_temp_schedule(temp_init: float = 1.0, temp_min: float = 1e-6,
                         anneal_rate: float = 1e-5) -> Callable[[int], float]:
    """The Gumbel temperature at a step, max(temp_min, temp_init·e^(−rate·step)),
    in fp32 (the taming temperature scheduler)."""
    f32 = np.float32
    low, init, rate = f32(temp_min), f32(temp_init), f32(-anneal_rate)

    def fn(step: int) -> float:
        return float(np.maximum(low, init * np.exp(rate * f32(step))))

    return fn
