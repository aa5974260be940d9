"""Configurations and device selection.

`sd_v1_config()` is `configs/sd_txt2img.yaml` (the SD-v1 text-to-image
recipe) and `sd512_train_config()` is `configs/sd512_catdog.yaml` (the SD-v1
latent-diffusion training recipe at 512² pixels) as dicts, so the port runs
where PyYAML is not installed.
"""

from __future__ import annotations

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


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; raises when the
    card is wanted and absent (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sd_tpu_torch runs on the GPU unless you pass "
            "device='cpu'")
    return dev
