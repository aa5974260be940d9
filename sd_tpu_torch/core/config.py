"""Configurations and device selection.

`sd_v1_config()` is `configs/sd_txt2img.yaml` (the SD-v1 text-to-image
recipe), `sd512_train_config()` is `configs/sd512_catdog.yaml` (the SD-v1
latent-diffusion training recipe at 512² pixels),
`kl_f8_256_train_config()` is `configs/kl_f8_256_catdog.yaml` (the KL-f8
first stage's GAN training at 256²), `ddpm_256_train_config()` is
`configs/ddpm_256_catdog.yaml` (pixel-space DDPM at 256²),
`vq_128_train_config()` and `vq_64_train_config()` are
`configs/vq_128_catdog.yaml` and `configs/vq_64_catdog.yaml` (VQ-VAE GAN
training, argmin and EMA codebooks), and `ddpm_smoke_config()` /
`vq_smoke_config()` the tiny `configs/ddpm_smoke.yaml` / `vq_smoke.yaml`,
and `inpaint_128_config()` is `configs/inpaint_128_catdog.yaml` (the
mask-conditioned inpainting LDM over a KL-f4 first stage) without its
first-stage checkpoint, `lcm512_distill_config()` is
`configs/lcm_512_catdog.yaml` (consistency distillation of the SD-v1
teacher) without its teacher run and first-stage checkpoint,
`distill_smoke_config()` / `flow_smoke_config()` the tiny
`configs/distill_smoke.yaml` / `flow_smoke.yaml`, and
`flow512_train_config()` the SD-v1 training recipe under the flow smoke
config's rectified-flow objective; the fine-tuning configs
`controlnet_32_config()` (`configs/controlnet_32_catdog.yaml` without its
base run and first-stage checkpoint), `ip_smoke_config()`,
`ti_smoke_config()`, `dreambooth_smoke_config()` and
`inpaint_smoke_config()` (their `configs/*_smoke.yaml`), and
`sd512_inpaint_train_config()`, the SD-v1 training recipe as the
SD-inpainting UNet (9 input channels, `hybrid`); the super-resolution
configs `ldm_sr_smoke_config()` and `ldm_sr_catdog_config()`
(`configs/ldm_sr_smoke.yaml`, `ldm_sr_catdog.yaml` without its first-stage
checkpoint) and the first stages `kl_128_catdog_config()`, `kl_f32_config()`
and `vq_gumbel_f8_config()` (`configs/kl_128_catdog.yaml`, `kl_f32.yaml`,
`vq_gumbel_f8.yaml`); the class-conditional cat/dog LDM
`ldm_32_catdog_cond_config()` (`configs/ldm_32_catdog_cond.yaml` without its
first-stage checkpoint) and the tiny text-to-image LDM
`sd_txt2img_smoke_config()` (`configs/sd_txt2img_smoke.yaml`, `bench_serve
--smoke`'s); and two published models that no file of
`configs/` holds, each naming its source: `ldm_kl8g_txt2img_config()`
(CompVis's BERT-conditioned LDM-KL-8-G) and `adm_imagenet256_config()`
(guided diffusion's class-conditional ImageNet 256² UNet); as dicts, so the
port runs where PyYAML is not installed.

`load_config(spec)` takes the name of one of them (`sd_v1`, or
`sd_v1_config`) or the path of a config file: `.json` through the standard
library (JSON is YAML 1.2, so the TPU package's `load_yaml` reads the same
file), `.yaml` through PyYAML where it is installed.
"""

from __future__ import annotations

import json
import os

import torch


def sd_v1_config() -> dict:
    """The SD-v1 text-to-image configuration: linear β 0.00085→0.012 over
    T=1000, latent 64×64×4, UNet 320/(1,2,4,4)/8 heads/context 768, KL-f8
    first stage, CLIP ViT-L/14 text tower."""
    return {
        "task": "ldm",
        "seed": 42,
        "diffusion": {"timesteps": 1000, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012,
                      "parameterization": "eps"},
        "latent": {"image_size": 64, "channels": 4, "scale_factor": 0.18215,
                   "conditioning_key": "crossattn"},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 4, "model_channels": 320,
                            "out_channels": 4, "num_res_blocks": 2,
                            "attention_resolutions": [4, 2, 1],
                            "channel_mult": [1, 2, 4, 4], "num_heads": 8,
                            "use_spatial_transformer": True,
                            "transformer_depth": 1, "context_dim": 768}},
        "first_stage": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                        "params": {"embed_dim": 4, "ch": 128,
                                   "ch_mult": [1, 2, 4, 4],
                                   "num_res_blocks": 2, "attn_resolutions": [],
                                   "resolution": 256, "z_channels": 4}},
        "cond_stage": {"target": "sd_tpu.models.clip_text.ClipTextConfig",
                       "params": {}},
        "train": {"batch_size": 4, "lr": 1.0e-4,
                  "lr_schedule": {"warm_up_steps": [10000], "f_min": [1.0],
                                  "f_max": [10.0], "f_start": [1.0e-6],
                                  "cycle_lengths": [10000000000000]},
                  "ema_decay": 0.9999, "learn_logvar": False,
                  "total_steps": 1000000, "checkpoint_every": 2000},
        "sample": {"num_steps": 50, "guidance_scale": 7.5, "eta": 0.0},
    }


def sd512_train_config() -> dict:
    """`configs/sd512_catdog.yaml` without `first_stage.ckpt` (no trained
    first stage is in the repository): 512² pixels → KL-f8 (fp32, frozen) →
    64²×4 latents → the SD-v1 UNet (859.5M parameters) trained in bf16 with
    fp32 Adam moments and EMA, batch 4 as 4 microbatches of 1, remat "dots",
    ε-loss on the linear β 0.00085→0.012 schedule, 10% caption dropout,
    `scale_factor: auto`."""
    cfg = sd_v1_config()
    cfg["data"] = {"captions": "class", "label_from": "filename_prefix",
                   "template": "a photo of a {}"}
    cfg["latent"]["scale_factor"] = "auto"
    cfg["train"] = {
        "image_size": 512, "batch_size": 4, "param_dtype": "bfloat16",
        "remat": "dots", "grad_accum": 4, "lr": 1.0e-4,
        "lr_schedule": {"warm_up_steps": [200], "f_min": [1.0], "f_max": [1.0],
                        "f_start": [1.0e-6], "cycle_lengths": [10000000000000]},
        "ema_decay": 0.9999, "cond_dropout": 0.1, "total_steps": 3200,
        "eval_every": 400, "checkpoint_every": 1600}
    return cfg


def kl_f8_256_train_config() -> dict:
    """`configs/kl_f8_256_catdog.yaml`: the SD-v1 first stage (KL-f8, embed
    4, ch 128, mult (1,2,4,4), 2 res blocks, no per-level attention) trained
    at 256², batch 4, lr 1e-4, with L1 + LPIPS + KL (1e-6) and a hinge
    PatchGAN (ndf 64, 3 layers, BatchNorm) that starts at step 1500."""
    return {
        "task": "kl_vae",
        "seed": 42,
        "model": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                  "params": {"embed_dim": 4, "ch": 128, "ch_mult": [1, 2, 4, 4],
                             "num_res_blocks": 2, "attn_resolutions": [],
                             "resolution": 256, "z_channels": 4}},
        "loss": {"disc_start": 1500, "kl_weight": 1.0e-6, "disc_weight": 0.5,
                 "perceptual_weight": 1.0, "disc_loss": "hinge"},
        "discriminator": {"ndf": 64, "n_layers": 3, "use_actnorm": False},
        "train": {"image_size": 256, "batch_size": 4, "lr": 1.0e-4, "ema_decay": None,
                  "total_steps": 2600, "eval_every": 250, "checkpoint_every": 1000},
    }


def ddpm_256_train_config() -> dict:
    """`configs/ddpm_256_catdog.yaml`: the reference's pixel-space DDPM at
    256², the 128-channel (1, 1, 2, 2, 4) UNet with attention at level 3
    (32², 256 channels), plain linear β 1e-4 → 1e-2 over T = 1000, batch 6,
    lr 1e-4 on a cosine schedule over 2000 steps, clip 1, EMA 0.999; fp32."""
    return {
        "task": "ddpm",
        "seed": 42,
        "model": {"target": "sd_tpu.models.unet_ddpm.UNetDDPM",
                  "params": {"base_channels": 128, "ch_mult": [1, 1, 2, 2, 4],
                             "attn_levels": [3], "num_res_blocks": 2, "out_channels": 3}},
        "diffusion": {"timesteps": 1000, "beta_schedule": "sqrt_linear",
                      "linear_start": 1.0e-4, "linear_end": 1.0e-2},
        "train": {"image_size": 256, "batch_size": 6, "lr": 1.0e-4, "grad_clip": 1.0,
                  "lr_schedule": "cosine", "total_steps": 2000, "ema_decay": 0.999,
                  "eval_every": 500, "checkpoint_every": 1000},
        "sample": {"num_images": 16},
    }


def ddpm_smoke_config() -> dict:
    """`configs/ddpm_smoke.yaml`: a 16² DDPM, base 16, (1, 2), attention at
    level 1, T = 50, batch 2, constant lr 1e-3."""
    return {
        "task": "ddpm",
        "seed": 0,
        "model": {"target": "sd_tpu.models.unet_ddpm.UNetDDPM",
                  "params": {"base_channels": 16, "ch_mult": [1, 2], "attn_levels": [1],
                             "num_res_blocks": 1, "out_channels": 3}},
        "diffusion": {"timesteps": 50, "beta_schedule": "sqrt_linear",
                      "linear_start": 1.0e-4, "linear_end": 1.0e-2},
        "train": {"image_size": 16, "batch_size": 2, "lr": 1.0e-3, "grad_clip": 1.0,
                  "total_steps": 10, "ema_decay": 0.999, "eval_every": 10,
                  "checkpoint_every": 5},
        "sample": {"num_images": 2},
    }


def _vq_gan_config(model_params: dict, image_size: int) -> dict:
    """The cat/dog VQ-VAE GAN recipe around `model_params`: L1 + LPIPS +
    codebook loss and a hinge PatchGAN (ndf 64, 3 layers, BatchNorm) from
    step 2000, batch 8, lr 1e-4."""
    return {
        "task": "vq",
        "seed": 42,
        "model": {"target": "sd_tpu.models.autoencoder.VQModel", "params": model_params},
        "loss": {"disc_start": 2000, "disc_weight": 0.75, "codebook_weight": 1.0,
                 "perceptual_weight": 1.0, "disc_loss": "hinge"},
        "discriminator": {"ndf": 64, "n_layers": 3, "use_actnorm": False},
        "train": {"image_size": image_size, "batch_size": 8, "lr": 1.0e-4, "ema_decay": None,
                  "total_steps": 3000, "eval_every": 250, "checkpoint_every": 1000},
    }


def vq_128_train_config() -> dict:
    """`configs/vq_128_catdog.yaml`: an f4 VQ model (ch 64, mult (1, 2, 4),
    2 res blocks, embed 3, 1024 argmin codes, legacy β 0.25) at 128², whose
    mid-block attention runs at 32² × 256 channels. fp32 as written; under
    `train.param_dtype: bfloat16` that attention takes the flash training
    kernels at d = 256."""
    return _vq_gan_config({"n_embed": 1024, "embed_dim": 3, "ch": 64, "ch_mult": [1, 2, 4],
                           "num_res_blocks": 2, "attn_resolutions": [], "resolution": 128,
                           "z_channels": 3, "beta": 0.25, "legacy": True}, 128)


def vq_64_train_config() -> dict:
    """`configs/vq_64_catdog.yaml`: an f4 VQ model (ch 32, mult (1, 2, 4),
    embed 3) with a 256-code EMA codebook (decay 0.99) at 64²; fp32."""
    return _vq_gan_config({"quantizer_type": "ema", "n_embed": 256, "embed_dim": 3, "ch": 32,
                           "ch_mult": [1, 2, 4], "num_res_blocks": 2, "attn_resolutions": [],
                           "resolution": 64, "z_channels": 3, "beta": 0.25,
                           "ema_decay": 0.99}, 64)


def vq_smoke_config() -> dict:
    """`configs/vq_smoke.yaml`: a 32² VQ model (ch 16, (1, 2), 64 codes of
    width 4) with an ActNorm PatchGAN (ndf 8, 1 layer) from step 0."""
    return {
        "task": "vq",
        "seed": 0,
        "model": {"target": "sd_tpu.models.autoencoder.VQModel",
                  "params": {"n_embed": 64, "embed_dim": 4, "ch": 16, "ch_mult": [1, 2],
                             "num_res_blocks": 1, "attn_resolutions": [], "resolution": 32,
                             "z_channels": 4}},
        "loss": {"disc_start": 0, "disc_weight": 0.75, "codebook_weight": 1.0,
                 "perceptual_weight": 0.0, "disc_loss": "hinge"},
        "discriminator": {"ndf": 8, "n_layers": 1, "use_actnorm": True},
        "train": {"image_size": 32, "batch_size": 2, "lr": 1.0e-4, "total_steps": 3,
                  "checkpoint_every": 3},
    }


def inpaint_128_config() -> dict:
    """`configs/inpaint_128_catdog.yaml` without `first_stage.ckpt` (the
    trained KL-f4 run it names is not in the repository): 128² images →
    KL-f4 (ch 64 × (1, 2, 4), 3 latent channels) → 32²×3 latents; the UNet
    (128 × (1, 2, 4), attention at 16² and 8², 4 heads) sees [z_t | hole
    mask | E(masked image)], 7 channels, with `hybrid` conditioning on a
    64-wide, 16-token text tower; `scale_factor: auto`."""
    return {
        "task": "ldm_inpaint",
        "seed": 42,
        "diffusion": {"timesteps": 1000, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012},
        "latent": {"image_size": 32, "channels": 3, "scale_factor": "auto",
                   "conditioning_key": "hybrid"},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 7, "model_channels": 128, "out_channels": 3,
                            "num_res_blocks": 2, "attention_resolutions": [2, 4],
                            "channel_mult": [1, 2, 4], "num_heads": 4, "context_dim": 64}},
        "first_stage": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                        "params": {"embed_dim": 3, "ch": 64, "ch_mult": [1, 2, 4],
                                   "num_res_blocks": 2, "attn_resolutions": [],
                                   "resolution": 128, "z_channels": 3}},
        "cond_stage": {"target": "sd_tpu.models.clip_text.ClipTextConfig",
                       "params": {"vocab_size": 8192, "hidden_size": 64, "num_layers": 2,
                                  "num_heads": 4, "max_length": 16}},
        "data": {"inpaint": {"full_prob": 0.15, "max_rects": 3, "max_strokes": 2}},
        "train": {"image_size": 128, "batch_size": 16, "lr": 1.0e-4, "ema_decay": 0.999,
                  "total_steps": 2500, "eval_every": 500, "checkpoint_every": 1250},
        "sample": {"num_steps": 50, "guidance_scale": 1.0},
    }


def lcm512_distill_config() -> dict:
    """`configs/lcm_512_catdog.yaml` without `distill.teacher_run` and
    `first_stage.ckpt`, which a run fills in: consistency distillation of a
    trained 512² SD-v1 teacher (the `sd512_train_config()` model) into a
    4-step student with CFG 7.5 baked in, 50 boundaries, a bf16 target
    network at decay 0.95; bf16 parameters, fp32 Adam moments, remat
    "dots", batch 4 as 4 microbatches of 1, lr 1e-5, clip 1."""
    cfg = sd_v1_config()
    cfg.update(task="distill", seed=7)
    cfg["distill"] = {"num_boundaries": 50, "guidance_scale": 7.5,
                      "target_ema_decay": 0.95, "sample_steps": 4}
    cfg["latent"]["scale_factor"] = "auto"
    cfg["data"] = {"captions": "class", "label_from": "filename_prefix",
                   "template": "a photo of a {}"}
    cfg["train"] = {"image_size": 512, "batch_size": 4, "param_dtype": "bfloat16",
                    "remat": "dots", "grad_accum": 4, "lr": 1.0e-5, "grad_clip": 1.0,
                    "total_steps": 1200, "eval_every": 300, "checkpoint_every": 600}
    del cfg["sample"]
    return cfg


def _smoke_ldm(diffusion: dict) -> dict:
    """The tiny text-to-image LDM of `configs/distill_smoke.yaml` and
    `configs/flow_smoke.yaml`: latent 8²×4, UNet 32 × (1, 2) with attention
    at level 1 and a 32-wide context, a KL f4 first stage (ch 16, (1, 2,
    4)), a 32-wide 2-layer text tower of 16 tokens; 32² images, batch 2."""
    return {
        "seed": 0,
        "diffusion": diffusion,
        "latent": {"image_size": 8, "channels": 4, "scale_factor": 0.18215,
                   "conditioning_key": "crossattn"},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 4, "model_channels": 32, "out_channels": 4,
                            "num_res_blocks": 1, "attention_resolutions": [1],
                            "channel_mult": [1, 2], "num_heads": 4, "context_dim": 32}},
        "first_stage": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                        "params": {"embed_dim": 4, "ch": 16, "ch_mult": [1, 2, 4],
                                   "num_res_blocks": 1, "attn_resolutions": [],
                                   "resolution": 32, "z_channels": 4}},
        "cond_stage": {"target": "sd_tpu.models.clip_text.ClipTextConfig",
                       "params": {"vocab_size": 1000, "hidden_size": 32, "num_layers": 2,
                                  "num_heads": 4, "max_length": 16}},
    }


def distill_smoke_config() -> dict:
    """`configs/distill_smoke.yaml`: consistency distillation of the tiny
    LDM (T = 50) over 10 boundaries, no CFG, target decay 0.9, 2-step eval
    samples; 4 steps at lr 1e-4. `distill.teacher_run` is the YAML's
    placeholder, which a run sets."""
    cfg = _smoke_ldm({"timesteps": 50, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012})
    cfg["task"] = "distill"
    cfg["distill"] = {"teacher_run": "runs/ldm_smoke", "num_boundaries": 10,
                      "guidance_scale": 1.0, "target_ema_decay": 0.9, "sample_steps": 2}
    cfg["train"] = {"image_size": 32, "batch_size": 2, "lr": 1.0e-4, "total_steps": 4,
                    "checkpoint_every": 4, "eval_every": 4}
    return cfg


_FLOW_DIFFUSION = {"type": "flow", "timesteps": 50, "shift": 1.0,
                   "timestep_density": "logit_normal"}


def flow_smoke_config() -> dict:
    """`configs/flow_smoke.yaml`: the tiny LDM under the rectified-flow
    objective (T = 50 lattice, shift 1, logit-normal weights), 4 steps at lr
    1e-3, EMA 0.999; sampled with `flow`, 4 steps, no CFG."""
    cfg = _smoke_ldm(dict(_FLOW_DIFFUSION))
    cfg["task"] = "ldm"
    cfg["train"] = {"image_size": 32, "batch_size": 2, "lr": 1.0e-3, "ema_decay": 0.999,
                    "total_steps": 4, "checkpoint_every": 4}
    cfg["sample"] = {"num_steps": 4, "sampler": "flow", "guidance_scale": 1.0}
    return cfg


def flow512_train_config() -> dict:
    """`sd512_train_config()` (the SD-v1 recipe at 512²) with
    `configs/flow_smoke.yaml`'s `diffusion:` block: the rectified-flow
    objective at SD-v1 width (T = 50 lattice, logit-normal weights)."""
    cfg = sd512_train_config()
    cfg["diffusion"] = dict(_FLOW_DIFFUSION)
    return cfg


_SMOKE_DIFFUSION = {"timesteps": 50, "beta_schedule": "linear", "linear_start": 0.00085,
                    "linear_end": 0.012}


def controlnet_32_config() -> dict:
    """`configs/controlnet_32_catdog.yaml` without `controlnet.base_run` and
    `first_stage.ckpt`, which a run fills in: the canny-hint ControlNet over
    the 32²×3-latent cat/dog LDM (UNet 128 × (1, 2, 4), attention at 16² and
    8², KL-f4 first stage, 64-wide text tower), 128² images, batch 16, lr
    1e-4, `scale_factor: auto` (the base run's calibration)."""
    cfg = inpaint_128_config()
    del cfg["data"]
    cfg.update(task="ldm", controlnet={"hint": "canny"})
    cfg["latent"]["conditioning_key"] = "crossattn"
    cfg["unet"]["params"]["in_channels"] = 3
    cfg["train"].update(total_steps=2000, eval_every=500, checkpoint_every=1000)
    del cfg["sample"]
    return cfg


def _smoke_train(lr: float, ema_decay: float) -> dict:
    return {"image_size": 32, "batch_size": 2, "lr": lr, "ema_decay": ema_decay,
            "total_steps": 4, "checkpoint_every": 4}


def ip_smoke_config() -> dict:
    """`configs/ip_smoke.yaml`: an IP-Adapter (2 tokens, scale 1, image
    dropout 0.5) over the frozen tiny LDM; 4 steps at lr 1e-3."""
    cfg = _smoke_ldm(dict(_SMOKE_DIFFUSION))
    cfg["task"] = "ldm"
    cfg["ip_adapter"] = {"n_tokens": 2, "scale": 1.0, "image_dropout": 0.5}
    cfg["train"] = _smoke_train(1.0e-3, 0.999)
    cfg["sample"] = {"num_steps": 4, "guidance_scale": 3.0, "eta": 0.0}
    return cfg


def ti_smoke_config() -> dict:
    """`configs/ti_smoke.yaml`: textual inversion of "<thing>" as 2 vectors
    from the row of "object", over the frozen tiny LDM; 4 steps at lr 5e-3."""
    cfg = _smoke_ldm(dict(_SMOKE_DIFFUSION))
    cfg["task"] = "textual_inversion"
    cfg["textual_inversion"] = {"placeholder": "<thing>", "num_vectors": 2,
                                "initializer": "object"}
    cfg["train"] = _smoke_train(5.0e-3, 0.99)
    cfg["sample"] = {"num_steps": 4}
    return cfg


def dreambooth_smoke_config() -> dict:
    """`configs/dreambooth_smoke.yaml`: DreamBooth of the tiny LDM's UNet on
    "a photo of sks thing" with prior preservation (2 class images of "a
    photo of a thing" at 2 DDIM steps, weight 1); 4 steps at lr 5e-3."""
    cfg = _smoke_ldm(dict(_SMOKE_DIFFUSION))
    cfg["task"] = "dreambooth"
    cfg["dreambooth"] = {"instance_prompt": "a photo of sks thing",
                         "class_prompt": "a photo of a thing", "prior_weight": 1.0,
                         "num_class_images": 2, "class_num_steps": 2}
    cfg["train"] = _smoke_train(5.0e-3, 0.99)
    cfg["sample"] = {"num_steps": 4}
    return cfg


def inpaint_smoke_config() -> dict:
    """`configs/inpaint_smoke.yaml`: the tiny LDM as a mask-conditioned
    inpainting model (9 input channels, `hybrid`), 15% full masks, 10%
    caption dropout; 4 steps at lr 1e-3."""
    cfg = _smoke_ldm(dict(_SMOKE_DIFFUSION))
    cfg["task"] = "ldm_inpaint"
    cfg["latent"]["conditioning_key"] = "hybrid"
    cfg["unet"]["params"]["in_channels"] = 9
    cfg["data"] = {"inpaint": {"full_prob": 0.15}}
    cfg["train"] = {**_smoke_train(1.0e-3, 0.999), "cond_dropout": 0.1}
    cfg["sample"] = {"num_steps": 4, "guidance_scale": 3.0}
    return cfg


def sd512_inpaint_train_config() -> dict:
    """`sd512_train_config()` as the SD-inpainting UNet: `task: ldm_inpaint`,
    9 input channels ([z_t | hole mask | E(masked image)]), `hybrid`
    conditioning, and `inpaint_128_config()`'s mask menu."""
    cfg = sd512_train_config()
    cfg["task"] = "ldm_inpaint"
    cfg["unet"]["params"]["in_channels"] = 9
    cfg["latent"]["conditioning_key"] = "hybrid"
    cfg["data"]["inpaint"] = dict(inpaint_128_config()["data"]["inpaint"])
    return cfg


def _sr_config(seed: int, timesteps: int, latent: dict, unet: dict, first_stage: dict,
               sr: dict, train: dict, num_steps: int) -> dict:
    """A concat-conditioned super-resolution LDM: the linear schedule over
    `timesteps`, the UNet without spatial transformers (no text context) over
    latent channels + 3 LR channels, the f4 KL first stage."""
    return {
        "task": "ldm_sr",
        "seed": seed,
        "diffusion": {"timesteps": timesteps, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012},
        "latent": latent,
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {**unet, "use_spatial_transformer": False, "context_dim": None}},
        "first_stage": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                        "params": first_stage},
        "data": {"sr": sr},
        "train": train,
        "sample": {"num_steps": num_steps, "eta": 0.0},
    }


def ldm_sr_smoke_config() -> dict:
    """`configs/ldm_sr_smoke.yaml`: 32² HR over a tiny f4 first stage (ch 16,
    mult (1, 2, 4)) → 8² latent, where the bicubic ×4 LR image is
    concatenated; UNet 32 × (1, 2), self-attention at 8² with 4 heads."""
    return _sr_config(
        0, 50, {"image_size": 8, "channels": 4, "scale_factor": "auto"},
        {"in_channels": 7, "model_channels": 32, "out_channels": 4, "num_res_blocks": 1,
         "attention_resolutions": [1], "channel_mult": [1, 2], "num_heads": 4},
        {"embed_dim": 4, "ch": 16, "ch_mult": [1, 2, 4], "num_res_blocks": 1,
         "attn_resolutions": [], "resolution": 32, "z_channels": 4},
        {"sf": 4, "degradation": "bicubic"},
        {"image_size": 32, "batch_size": 2, "lr": 1.0e-3, "ema_decay": 0.999,
         "total_steps": 4, "checkpoint_every": 4}, 4)


def ldm_sr_catdog_config() -> dict:
    """`configs/ldm_sr_catdog.yaml` without its first-stage checkpoint: 128²
    HR over `kl_128_catdog_config()`'s f4 first stage → 32² × 3 latent, the
    BSRGAN-light ×4 LR image concatenated; UNet 128 × (1, 2, 4), 2 res blocks,
    4-head self-attention at 16² and 8² (d = 64, 128); batch 16, lr 1e-4."""
    return _sr_config(
        42, 1000, {"image_size": 32, "channels": 3, "scale_factor": "auto"},
        {"in_channels": 6, "model_channels": 128, "out_channels": 3, "num_res_blocks": 2,
         "attention_resolutions": [2, 4], "channel_mult": [1, 2, 4], "num_heads": 4},
        dict(kl_128_catdog_config()["model"]["params"]),
        {"sf": 4, "degradation": "bsrgan_light"},
        {"image_size": 128, "batch_size": 16, "lr": 1.0e-4, "ema_decay": 0.999,
         "total_steps": 3000, "eval_every": 500, "checkpoint_every": 1000}, 20)


def kl_128_catdog_config() -> dict:
    """`configs/kl_128_catdog.yaml`: an f4 KL first stage (embed 3, ch 64,
    mult (1, 2, 4), 2 res blocks) trained at 128², batch 8, lr 1e-4, with
    the hinge PatchGAN from step 2000."""
    cfg = kl_f8_256_train_config()
    cfg["model"]["params"] = {"embed_dim": 3, "ch": 64, "ch_mult": [1, 2, 4],
                              "num_res_blocks": 2, "attn_resolutions": [], "resolution": 128,
                              "z_channels": 3}
    cfg["loss"]["disc_start"] = 2000
    cfg["train"].update(image_size=128, batch_size=8, total_steps=3000)
    return cfg


def ldm_32_catdog_cond_config() -> dict:
    """`configs/ldm_32_catdog_cond.yaml` without its first-stage checkpoint:
    the class-conditional cat/dog LDM with classifier-free guidance —
    captions "a photo of a {}" from the file names' prefixes, the empty
    prompt trained at 10%; a 32² × 3 latent of `kl_128_catdog_config()`'s f4
    first stage under `scale_factor: auto`; UNet 128 × (1, 2, 4), 2 res
    blocks, 4 heads at 16² and 8², a 64-wide context from a 2-layer CLIP
    tower (vocabulary 8192, 16 tokens); batch 16, lr 1e-4."""
    return {
        "task": "ldm",
        "seed": 42,
        "data": {"captions": "class", "label_from": "filename_prefix",
                 "template": "a photo of a {}"},
        "diffusion": {"timesteps": 1000, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012},
        "latent": {"image_size": 32, "channels": 3, "scale_factor": "auto",
                   "conditioning_key": "crossattn"},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 3, "model_channels": 128, "out_channels": 3,
                            "num_res_blocks": 2, "attention_resolutions": [2, 4],
                            "channel_mult": [1, 2, 4], "num_heads": 4, "context_dim": 64}},
        "first_stage": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                        "params": dict(kl_128_catdog_config()["model"]["params"])},
        "cond_stage": {"target": "sd_tpu.models.clip_text.ClipTextConfig",
                       "params": {"vocab_size": 8192, "hidden_size": 64, "num_layers": 2,
                                  "num_heads": 4, "max_length": 16}},
        "train": {"image_size": 128, "batch_size": 16, "lr": 1.0e-4, "ema_decay": 0.999,
                  "cond_dropout": 0.1, "total_steps": 3500, "eval_every": 500,
                  "checkpoint_every": 1000},
    }


def sd_txt2img_smoke_config() -> dict:
    """`configs/sd_txt2img_smoke.yaml`: the tiny text-to-image LDM of the
    smoke tests — latent 8² × 4 of an f4 first stage (ch 16), UNet 32 × (1,
    2) with attention at 8², a 2-layer 32-wide CLIP tower, 50 timesteps."""
    return {
        "task": "ldm",
        "seed": 0,
        "diffusion": {"timesteps": 50, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012},
        "latent": {"image_size": 8, "channels": 4, "scale_factor": 0.18215,
                   "conditioning_key": "crossattn"},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 4, "model_channels": 32, "out_channels": 4,
                            "num_res_blocks": 1, "attention_resolutions": [1],
                            "channel_mult": [1, 2], "num_heads": 4, "context_dim": 32}},
        "first_stage": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                        "params": {"embed_dim": 4, "ch": 16, "ch_mult": [1, 2, 4],
                                   "num_res_blocks": 1, "attn_resolutions": [],
                                   "resolution": 32, "z_channels": 4}},
        "cond_stage": {"target": "sd_tpu.models.clip_text.ClipTextConfig",
                       "params": {"vocab_size": 1000, "hidden_size": 32, "num_layers": 2,
                                  "num_heads": 4, "max_length": 16}},
        "train": {"image_size": 32, "batch_size": 2, "lr": 1.0e-3, "ema_decay": 0.999,
                  "total_steps": 4, "checkpoint_every": 4},
        "sample": {"num_steps": 4, "guidance_scale": 3.0, "eta": 0.0},
    }


def kl_f32_config() -> dict:
    """`configs/kl_f32.yaml`: the KL-f32 first stage (embed 64, ch 128, mult
    (1, 1, 2, 2, 4, 4), attention at 16² and 8²) at 256², batch 4."""
    return {
        "task": "kl_vae",
        "seed": 42,
        "model": {"target": "sd_tpu.models.autoencoder.AutoencoderKL",
                  "params": {"embed_dim": 64, "ch": 128, "ch_mult": [1, 1, 2, 2, 4, 4],
                             "num_res_blocks": 2, "attn_resolutions": [16, 8],
                             "resolution": 256, "z_channels": 64}},
        "loss": {"disc_start": 50001, "kl_weight": 1.0e-6, "disc_weight": 0.5,
                 "perceptual_weight": 1.0, "disc_loss": "hinge"},
        "discriminator": {"ndf": 64, "n_layers": 3, "use_actnorm": False},
        "train": {"image_size": 256, "batch_size": 4, "lr": 4.5e-6, "ema_decay": None,
                  "total_steps": 200000, "checkpoint_every": 2000},
    }


def vq_gumbel_f8_config() -> dict:
    """`configs/vq_gumbel_f8.yaml`: the Gumbel-VQ f8 model (8192 codes of
    width 256, ch 128, mult (1, 1, 2, 4), attention at 32²) at 256², its
    temperature annealed from 1 to 1/16."""
    return {
        "task": "vq",
        "seed": 42,
        "model": {"target": "sd_tpu.models.autoencoder.VQModel",
                  "params": {"quantizer_type": "gumbel", "n_embed": 8192, "embed_dim": 256,
                             "ch": 128, "ch_mult": [1, 1, 2, 4], "num_res_blocks": 2,
                             "attn_resolutions": [32], "resolution": 256, "z_channels": 256,
                             "kl_weight": 1.0e-8, "temp_init": 1.0}},
        "gumbel_schedule": {"temp_min": 0.0625, "anneal_rate": 1.0e-6},
        "loss": {"disc_start": 30001, "disc_weight": 0.8, "codebook_weight": 1.0,
                 "perceptual_weight": 1.0, "disc_loss": "hinge"},
        "discriminator": {"ndf": 64, "n_layers": 3, "use_actnorm": False},
        "train": {"image_size": 256, "batch_size": 4, "lr": 4.5e-6, "total_steps": 200000,
                  "checkpoint_every": 2000},
    }


def ldm_kl8g_txt2img_config() -> dict:
    """LDM-KL-8-G, the BERT-conditioned text-to-image latent diffusion model
    of Rombach et al. 2022: the SD-v1 UNet widths with a 1280-wide context,
    a 32² latent of the KL-f8 first stage (`sd_v1_config()`'s), and the
    32-layer, 1280-wide `BERTEmbedder` trained with the model."""
    # source: CompVis/latent-diffusion configs/latent-diffusion/txt2img-1p4B-eval.yaml
    return {
        "task": "ldm",
        "seed": 42,
        "diffusion": {"timesteps": 1000, "beta_schedule": "linear",
                      "linear_start": 0.00085, "linear_end": 0.012,
                      "parameterization": "eps"},
        "latent": {"image_size": 32, "channels": 4, "scale_factor": 0.18215,
                   "conditioning_key": "crossattn"},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 4, "model_channels": 320,
                            "out_channels": 4, "num_res_blocks": 2,
                            "attention_resolutions": [4, 2, 1],
                            "channel_mult": [1, 2, 4, 4], "num_heads": 8,
                            "use_spatial_transformer": True,
                            "transformer_depth": 1, "context_dim": 1280}},
        "first_stage": sd_v1_config()["first_stage"],
        "cond_stage": {"target": "sd_tpu.models.conditioners.BERTEmbedder",
                       "params": {"n_embed": 1280, "n_layer": 32}, "trainable": True},
    }


def adm_imagenet256_config() -> dict:
    """The guided-diffusion (ADM) class-conditional ImageNet 256×256 UNet:
    pixel space, 256 channels × (1, 1, 2, 2, 4, 4), self-attention at 32²,
    16² and 8² in heads of 64 channels, scale-shift norm, resblock
    up/down-sampling, 1000 classes, learned σ (6 output channels)."""
    # source: openai/guided-diffusion README.md, "Model flags" of the 256x256
    # class-conditional model (MODEL_FLAGS ... --class_cond True --image_size 256)
    return {
        "task": "adm",
        "image_size": 256,
        "diffusion": {"timesteps": 1000, "noise_schedule": "linear", "learn_sigma": True},
        "unet": {"target": "sd_tpu.models.unet_sd.UNetModel",
                 "params": {"in_channels": 3, "model_channels": 256, "out_channels": 6,
                            "num_res_blocks": 2, "attention_resolutions": [8, 16, 32],
                            "channel_mult": [1, 1, 2, 2, 4, 4], "num_head_channels": 64,
                            "use_spatial_transformer": False, "context_dim": None,
                            "num_classes": 1000, "use_scale_shift_norm": True,
                            "resblock_updown": True}},
    }


def config_functions() -> dict:
    """{name: config function} of every configuration above."""
    fns = (sd_v1_config, sd512_train_config, kl_f8_256_train_config, ddpm_256_train_config,
           ddpm_smoke_config, vq_128_train_config, vq_64_train_config, vq_smoke_config,
           inpaint_128_config, lcm512_distill_config, distill_smoke_config, flow_smoke_config,
           flow512_train_config, controlnet_32_config, ip_smoke_config, ti_smoke_config,
           dreambooth_smoke_config, inpaint_smoke_config, sd512_inpaint_train_config,
           ldm_sr_smoke_config, ldm_sr_catdog_config, kl_128_catdog_config, kl_f32_config,
           vq_gumbel_f8_config, ldm_kl8g_txt2img_config, adm_imagenet256_config,
           ldm_32_catdog_cond_config, sd_txt2img_smoke_config)
    return {fn.__name__[:-len("_config")]: fn for fn in fns}


def load_config(spec: str | os.PathLike) -> dict:
    """The configuration named by `spec`: a config function's name (with or
    without `_config`), a `.json` file, or a `.yaml` file (needs PyYAML)."""
    spec = os.fspath(spec)
    fns = config_functions()
    name = spec[:-len("_config")] if spec.endswith("_config") else spec
    if name in fns:
        return fns[name]()
    ext = os.path.splitext(spec)[1].lower()
    if ext in (".yaml", ".yml"):
        try:
            import yaml
        except ImportError:
            raise RuntimeError(f"{spec}: reading YAML needs PyYAML, which is not installed; "
                               "give the config as .json or by name "
                               f"({', '.join(sorted(fns))})") from None
        with open(spec) as f:
            return yaml.safe_load(f)
    if ext == ".json":
        with open(spec) as f:
            return json.load(f)
    raise ValueError(f"config {spec!r}: not a config name ({', '.join(sorted(fns))}) "
                     "nor a .json / .yaml file")


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; raises when the
    card is wanted and absent (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sd_tpu_torch runs on the GPU unless you pass "
            "device='cpu'")
    return dev


def split_dtype(params: dict) -> tuple[dict, torch.dtype | None]:
    """A model config's params without its `dtype` key, and that key as the
    model's compute dtype (None when the config pins none): the TPU
    package's modules store fp32 parameters and compute in their `dtype`,
    and its trainers let the config pin it over `train.param_dtype`."""
    rest = {k: v for k, v in params.items() if k != "dtype"}
    dt = params.get("dtype")
    return rest, (None if dt is None else getattr(torch, str(dt)))
