"""The ported training slice against the JAX composition, fp32 on the CPU at
the text-to-image slice test's tiny widths (UNet 32 ch × (1, 2), KL 16 ch ×
(1, 2), 32² images → 16² latents): one `make_diffusion_train_step` with
grad_accum = 2 over a batch of 4 — KL encode with the posterior sample,
ε-loss through the UNet, gradient accumulation, clip, Adam, EMA — from the
same parameters on both sides. t, the training noise and the posterior's ε
are carried by the batch, so the microbatch split keeps them with their
images. Loss, grad_norm, the updated parameters and the EMA shadow within
1e-3·max(1, max|ref|). Then: grad_accum = 2 equals the full batch in the
port, and `train_ldm` runs end to end at tiny widths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import SLICE_TOL, assert_close, nprand, port, to_torch
from test_torch_models import TINY_UNET, TINY_VAE, unet_params, vae_params

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion.ddpm import DDPMProcess as JProcess
from sd_tpu.diffusion.latent import LatentDiffusion as JLatentDiffusion
from sd_tpu.diffusion.latent import calibrate_scale_factor as jcalibrate
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.train import diffusion as jtrain
from sd_tpu_torch.core.config import sd512_train_config
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion, calibrate_scale_factor
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.train import diffusion as train
from sd_tpu_torch.train.runners import train_ldm
from sd_tpu_torch.weights import load_flax_params

SCHED = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.012)
SCALE = 0.18215
LR = 1e-3


def _batch():
    return {"image": np.tanh(nprand(4, 32, 32, 3, seed=1)),
            "txt_emb": nprand(4, 16, 32, seed=2),
            "t": np.array([3, 250, 600, 999]),
            "noise": nprand(4, 16, 16, 4, seed=3),
            "enc_noise": nprand(4, 16, 16, 4, seed=4)}


@pytest.fixture(scope="module")
def weights():
    return unet_params(seed=6), vae_params(seed=7)


def _jax_step(uparams, vparams, batch, grad_accum):
    unet, vae = JUNet(**TINY_UNET), JAutoencoderKL(**TINY_VAE)
    ld = JLatentDiffusion(
        process=JProcess(JSchedule.create(**SCHED), clip_denoised=False),
        unet_apply=lambda p, x, t, ctx, y=None: unet.apply({"params": p}, x, t, ctx))

    def loss_fn(p, b, rng, logvar):
        post = vae.apply({"params": vparams}, b["image"], method=JAutoencoderKL.encode)
        z = SCALE * (post.mean + post.std * b["enc_noise"]).astype(post.mean.dtype)
        return ld.p_losses(p, z, {"c_crossattn": [b["txt_emb"]]}, b["t"], b["noise"], logvar)

    opt = jtrain.ddpm_optimizer(LR, 1.0)
    state = jtrain.init_train_state(uparams, opt, 0.9999, num_timesteps=1000)
    step = jtrain.make_diffusion_train_step(loss_fn, opt, grad_accum=grad_accum)
    state, logs = step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    return state, logs


def _port_step(uparams, vparams, batch, grad_accum):
    unet = port(UNetModel(**TINY_UNET, device="cpu"), uparams)
    vae = port(AutoencoderKL(**TINY_VAE, device="cpu"), vparams)
    ld = LatentDiffusion(process=DDPMProcess(DiffusionSchedule.create(**SCHED)),
                         unet_apply=unet, encode_fn=vae.encode, decode_fn=vae.decode,
                         scale_factor=SCALE)
    opt = train.ddpm_optimizer(LR, 1.0)
    state = train.init_train_state(dict(unet.named_parameters()), opt, 0.9999, 1000)
    step = train.make_diffusion_train_step(
        lambda b, g, logvar: ld.training_loss(b, g, logvar), opt, grad_accum=grad_accum)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    logs = step(state, tb)
    return state, logs


def _as_port_tensors(flax_tree):
    """A flax UNet tree in the port's names and layouts."""
    mod = UNetModel(**TINY_UNET, device="cpu")
    load_flax_params(mod, jax.tree.map(np.asarray, flax_tree))
    return dict(mod.named_parameters())


def test_train_step_matches_jax(weights):
    uparams, vparams = weights
    batch = _batch()
    jstate, jlogs = _jax_step(uparams, vparams, batch, grad_accum=2)
    state, logs = _port_step(uparams, vparams, batch, grad_accum=2)
    for k in ("loss", "loss_simple", "loss_vlb", "loss_gamma", "grad_norm"):
        assert_close(logs[k], jlogs[k], SLICE_TOL)
    ref = _as_port_tensors(jstate.params)
    shadow = _as_port_tensors(jstate.ema.shadow)
    for name, p in state.params.items():
        assert_close(p, ref[name].detach(), SLICE_TOL)
        assert_close(state.ema.shadow[name], shadow[name].detach(), SLICE_TOL)
    assert state.ema.num_updates == int(jstate.ema.num_updates) == 1
    assert state.step == int(jstate.step) == 1


def test_grad_accum_equals_the_full_batch(weights):
    uparams, vparams = weights
    batch = _batch()
    full, full_logs = _port_step(uparams, vparams, batch, grad_accum=1)
    accum, accum_logs = _port_step(uparams, vparams, batch, grad_accum=2)
    # the same sums in another order (fp32): the losses and the gradient
    # norm agree to 1e-5; Adam divides each gradient by its own magnitude,
    # which amplifies that for the smallest gradients, so the parameters are
    # held to the slice tolerance
    for k in ("loss", "grad_norm"):
        assert_close(accum_logs[k], full_logs[k], 1e-5)
    for name, p in full.params.items():
        assert_close(accum.params[name], p.detach(), SLICE_TOL)


def test_calibrate_scale_factor():
    z = nprand(2, 8, 8, 4, seed=5, scale=3.0) + 1.0
    np.testing.assert_allclose(calibrate_scale_factor(to_torch(z)),
                               jcalibrate(jnp.asarray(z)), rtol=1e-6)


def test_train_ldm_runs_at_tiny_widths():
    cfg = sd512_train_config()
    cfg["unet"]["params"].update(TINY_UNET)
    cfg["first_stage"]["params"].update(TINY_VAE)
    cfg["cond_stage"]["params"] = dict(vocab_size=1000, hidden_size=32, num_layers=2,
                                       num_heads=4, max_length=16)
    cfg["latent"]["image_size"] = 4
    cfg["train"]["image_size"] = 32
    cfg["train"]["lr_schedule"] = None
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (4, 32, 32, 3)) / 127.5 - 1.0,
                "txt_raw": ["a photo of a cat", "a photo of a dog"] * 2} for _ in range(3)]
    state, history = train_ldm(cfg, batches, max_steps=2, device="cpu")
    assert len(history) == 2 and state.step == 2
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in history)
    assert all(p.dtype == torch.bfloat16 for p in state.params.values())
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu)
    assert all(s.dtype == torch.float32 for s in state.ema.shadow.values())
