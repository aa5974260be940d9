"""Two-optimizer GAN training of the KL autoencoder.

Counterpart of `sd_tpu/train/gan.py` `GanTrainState`, `init_gan_state`,
`make_kl_gan_train_step` and `gan_adam` (the VQ step, the Gumbel
temperature schedule and the quantizer's model state are not ported yet).
One step is the generator update, then the discriminator update against
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
differentiated path, also runs the inference kernel (`_flash_kernel`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from sd_tpu_torch.kernels.conv2d import training_trace
from sd_tpu_torch.losses.gan import (GanLossConfig, adopt_weight,
                                     calculate_adaptive_weight, reconstruction_nll)
from sd_tpu_torch.train.diffusion import Adam, AdamState


@dataclasses.dataclass
class GanTrainState:
    """The generator's trained tensors (the autoencoder's parameters by
    name, and the learned global "logvar"), the discriminator's parameters,
    its BatchNorm running statistics (buffers by name; {} for ActNorm), one
    optimizer state each, and the step count. The tensors are the modules'
    own: an update shows in the modules."""

    params_g: dict[str, torch.Tensor]
    params_d: dict[str, torch.Tensor]
    batch_stats_d: dict[str, torch.Tensor]
    opt_state_g: AdamState
    opt_state_d: AdamState
    step: int = 0


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
    `float32_moments` optimizers); the logvar and the running statistics
    stay fp32."""
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
        opt_state_d=opt_d.init(list(params_d.values())))


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
        params_g = list(state.params_g.values())
        params_d = list(state.params_d.values())
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
            if cfg.use_adaptive_weight:
                last = state.params_g[last_layer]
                (nll_grad,) = torch.autograd.grad(nll, last, retain_graph=True)
                (g_grad,) = torch.autograd.grad(g, last, retain_graph=True)
                d_weight = calculate_adaptive_weight(nll_grad, g_grad, cfg.disc_weight)
            else:
                d_weight = torch.tensor(cfg.disc_weight, device=x.device)
            loss = nll + cfg.kl_weight * kl + d_weight * disc_factor * g
            grads_g = torch.autograd.grad(loss, params_g)
            logs = {"train/total_loss": loss, "train/nll_loss": nll, "train/kl_loss": kl,
                    "train/g_loss": g, "train/rec_loss": rec, "train/d_weight": d_weight,
                    "train/disc_factor": disc_factor, "train/logvar": logvar.detach().clone()}
            logs = {k: v.detach() if torch.is_tensor(v) else v for k, v in logs.items()}
            opt_g.update_(params_g, list(grads_g), state.opt_state_g)
            recon = recon.detach()

            # ---- discriminator: real then fake, running statistics threaded
            disc.requires_grad_(True)
            logits_real = disc(x, update_stats=True)
            logits_fake = disc(recon, update_stats=True)
            d_loss = disc_factor * d_loss_fn(logits_real.float(), logits_fake.float())
            grads_d = torch.autograd.grad(d_loss, params_d)
            opt_d.update_(params_d, list(grads_d), state.opt_state_d)
        state.step += 1
        logs.update({"train/disc_loss": d_loss.detach(),
                     "train/logits_real": logits_real.detach().float().mean(),
                     "train/logits_fake": logits_fake.detach().float().mean()})
        return logs

    return step
