"""Latent-diffusion super-resolution: the concat-conditioned SR trainer and
sampler.

Counterpart of `sd_tpu/train/sr.py` (the LDM-SR ×4 recipe): an f4 first
stage puts the low-resolution image at the latent grid, where it is
concatenated with z_t along channels (`conditioning_key: concat`) in front
of the UNet without spatial transformers (self-attention only, no text
context). Where the SR factor differs from the first stage's, the LR image
is resized to the latent grid by `lr_to_latent`: `jax.image.resize(...,
"bilinear")`, the triangle kernel widened by the scale when downsampling
(antialias), its weights normalised over each output pixel's in-bounds
taps. The degradations run on the host in the loader's threads
(`data/datasets.py SRDataset`).

`train_ldm_sr(config, data, out_dir, max_steps, device)` is the TPU
package's trainer on the port's host loop (`train/runners.py _run_loop`):
`scale_factor: auto` calibrated on the run's fixed batch and written to
`calibration.json`, the DDPM loss (x0 unclamped), clip + Adam or AdamW
(`train.weight_decay`), fp32 EMA, `train.learn_logvar`, `train.grad_accum`,
auto-resume, `metrics.jsonl`, and every `train.eval_every` steps the fixed
batch super-resolved under the EMA weights: a grid of the nearest-upsampled
LR inputs, the SR outputs and the HR targets, with `eval_psnr` and
`eval_ssim`. `super_resolve` samples with ddim, dpm, plms or ddpm, x_T and
the stochastic samplers' noise drawn from a generator or handed in.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from sd_tpu_torch.models.conditioners import float_resize

COND_CHANNELS = 3          # the LR RGB image is the conditioning
SR_SAMPLERS = ("ddim", "dpm", "plms", "ddpm")


def _check_sr_config(cfg: dict) -> int:
    """The UNet's input channels of an SR config: latent channels + 3 (the
    config may leave `in_channels` out); any other count raises."""
    ch = cfg["latent"]["channels"]
    want_in = ch + COND_CHANNELS
    got = cfg["unet"].get("params", {}).get("in_channels", want_in)
    if got != want_in:
        raise ValueError(f"SR concat conditioning needs unet.in_channels = latent channels + "
                         f"{COND_CHANNELS} = {want_in}, got {got}")
    target = cfg["unet"].get("target", "UNetModel")
    if target.split(".")[-1] != "UNetModel":
        raise NotImplementedError(f"SR UNet {target!r} is not ported (UNetModel is)")
    return want_in


def build_ldm_sr(cfg: dict, generator: torch.Generator, device=None):
    """The SR latent-diffusion stack of `cfg`, every weight from `generator`
    (the first stage's trained ones from `first_stage.ckpt`): (ld, unet,
    first_stage). The UNet is fp32; the first stage is frozen."""
    from sd_tpu_torch.core.config import resolve_device, split_dtype
    from sd_tpu_torch.diffusion.latent import LatentDiffusion
    from sd_tpu_torch.models.unet_sd import UNetModel
    from sd_tpu_torch.train.runners import build_first_stage, build_process, first_stage_fns
    from sd_tpu_torch.weights import init_params_

    want_in = _check_sr_config(cfg)
    device = resolve_device(device)
    lat = cfg["latent"]
    ucfg, compute = split_dtype(cfg["unet"].get("params", {}))
    unet = UNetModel(**{**ucfg, "in_channels": want_in}, compute_dtype=compute, device=device)
    init_params_(unet, generator)
    vae = build_first_stage(cfg["first_stage"], generator, device=device).requires_grad_(False)
    encode_fn, decode_fn = first_stage_fns(vae)
    ld = LatentDiffusion(
        process=build_process(cfg, device), unet_apply=unet, encode_fn=encode_fn,
        decode_fn=decode_fn, conditioning_key="concat",
        scale_factor=(1.0 if lat.get("scale_factor") == "auto"
                      else lat.get("scale_factor", 1.0)))
    return ld, unet, vae


def lr_to_latent(lr: torch.Tensor, size: int) -> torch.Tensor:
    """The LR conditioning [B, h, w, 3] on the size × size latent grid: as it
    is when it already lies there (the SR factor is the first stage's), else
    resized as `jax.image.resize(lr, ..., "bilinear")` resizes, in fp32."""
    if lr.shape[1] == size and lr.shape[2] == size:
        return lr
    return float_resize(lr, size, size, "bilinear")


def sr_batch(batch: dict, size: int, device) -> dict:
    """A loader batch {'image': HR, 'lr': LR} → the training step's
    {'image', 'concat_cond'}: the LR images on the size × size latent grid."""
    lr = torch.as_tensor(np.asarray(batch["lr"]), dtype=torch.float32).to(device)
    return {"image": torch.as_tensor(np.asarray(batch["image"]),
                                     dtype=torch.float32).to(device),
            "concat_cond": lr_to_latent(lr, size)}


def super_resolve(ld, lr_images, latent_cfg: dict, num_steps: int = 50, eta: float = 0.0,
                  sampler: str = "ddim", *, generator: torch.Generator | None = None,
                  x_T: torch.Tensor | None = None, noise=None) -> np.ndarray:
    """Super-resolve LR images ([-1, 1] NHWC) with a trained SR model `ld`
    (its UNet apply bound to the weights to use) on the device of x_T, else
    of `generator`, else the CPU: the LR images on the latent grid as the
    concat conditioning, `sampler` from x_T (drawn from `generator` unless
    given; ddpm's per-step noise from `generator` or `noise`), then the
    first-stage decode. Returns float32 [-1, 1] numpy."""
    if sampler not in SR_SAMPLERS:
        raise ValueError(f"sampler {sampler!r}: one of {', '.join(SR_SAMPLERS)}")
    size, ch = latent_cfg["image_size"], latent_cfg["channels"]
    device = (x_T.device if x_T is not None
              else generator.device if generator is not None else "cpu")
    lr = torch.as_tensor(np.asarray(lr_images), dtype=torch.float32).to(device)
    shape = (lr.shape[0], size, size, ch)
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=device)
    with torch.no_grad():
        out = ld.sample(shape, x_T, cond={"c_concat": [lr_to_latent(lr, size)]},
                        num_steps=num_steps, eta=eta, sampler=sampler, generator=generator,
                        noise=noise)
    return out.float().cpu().numpy()


def nearest_up(lr: np.ndarray, hr_size: int) -> np.ndarray:
    """LR images repeated to the HR size (the grids' first row)."""
    rep = hr_size // lr.shape[1]
    return np.repeat(np.repeat(lr, rep, axis=1), rep, axis=2)


def _sr_eval_sampler(cfg: dict, batches, ld, unet):
    """Super-resolve the run's fixed batch each eval under the EMA weights:
    the grid stacks the nearest-upsampled LR inputs, the SR outputs and the
    HR targets; the logs are the SR outputs' PSNR and SSIM against HR."""
    from sd_tpu_torch.train.metrics import psnr, ssim
    from sd_tpu_torch.train.runners import ema_eval_params, params_apply

    steps = cfg.get("sample", {}).get("num_steps", 20)
    ref: list = []

    def sampler(state, generator):
        if not ref:
            batch = batches.peek()
            ref.append((np.asarray(batch["image"], np.float32),
                        np.asarray(batch["lr"], np.float32)))
        hr, lr = ref[0]
        model = dataclasses.replace(ld, unet_apply=params_apply(unet, ema_eval_params(state)))
        sr = super_resolve(model, lr, cfg["latent"], num_steps=steps, eta=0.0,
                           generator=generator)
        grid = np.concatenate([nearest_up(lr, hr.shape[1]), sr, hr], axis=0)
        return torch.from_numpy(grid), {"psnr": psnr(sr, hr), "ssim": ssim(sr, hr)}

    return sampler


def train_ldm_sr(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
                 max_steps: int | None = None, device=None):
    """Train the concat-conditioned SR model of `config` on `data` (a
    directory read through `SRDataset`, or an iterable of {'image', 'lr'}
    batches; see `train/runners.py`) for `max_steps` optimizer steps
    (default `train.total_steps`). The config is the ldm task's without a
    cond stage, plus

        data:
          sr: {sf: 4, degradation: bsrgan}   # bicubic | bsrgan |
                                             # bsrgan_light | bsrgan_variant

    Returns (state, history)."""
    from sd_tpu_torch.core.config import resolve_device
    from sd_tpu_torch.train.diffusion import ddpm_optimizer, init_train_state
    from sd_tpu_torch.train.metrics import count_params
    from sd_tpu_torch.train.runners import (_Batches, _load_cfg, _maybe_parallel_step,
                                            _parallel_run, _resume, _run_loop,
                                            auto_scale_factor, make_lr)

    cfg = _load_cfg(config)
    tc, lat = cfg["train"], cfg["latent"]
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    par = _parallel_run(cfg, tc.get("grad_accum", 1))
    ld, unet, _ = build_ldm_sr(cfg, gen, device)
    print(f"[ldm_sr] unet params: {count_params(unet) / 1e6:.1f}M")
    batches = _Batches(data, cfg, par)
    ld = auto_scale_factor(ld, cfg, batches, out_dir, gen, tag="ldm_sr")

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0),
                         weight_decay=tc.get("weight_decay", 0.0))
    learn_logvar = bool(tc.get("learn_logvar", False))
    state, start = _resume(out_dir, lambda: init_train_state(
        dict(unet.named_parameters()), opt, tc.get("ema_decay", 0.9999),
        num_timesteps=ld.schedule.num_timesteps, learn_logvar=learn_logvar))
    step_fn = _maybe_parallel_step(par, lambda b, g, logvar: ld.training_loss(b, g, logvar),
                                   opt, state, tc.get("grad_accum", 1), tp=(unet, ""))
    size = lat["image_size"]
    history = _run_loop(lambda st, b, g: step_fn(st, sr_batch(b, size, device), g), state, cfg,
                        batches, out_dir, start, seed=seed, device=device, max_steps=max_steps,
                        sampler=_sr_eval_sampler(cfg, batches, ld, unet))
    return state, history
