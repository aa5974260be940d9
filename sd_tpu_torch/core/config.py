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
first-stage checkpoint, as dicts, so the port runs where PyYAML is not
installed.

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


def config_functions() -> dict:
    """{name: config function} of every configuration above."""
    fns = (sd_v1_config, sd512_train_config, kl_f8_256_train_config, ddpm_256_train_config,
           ddpm_smoke_config, vq_128_train_config, vq_64_train_config, vq_smoke_config,
           inpaint_128_config)
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
