"""Config-driven latent-diffusion training.

Counterpart of `sd_tpu/train/runners.py` `build_ldm` and `train_ldm` on its
plain-UNet branch (the SD-v1 recipe, `configs/sd512_catdog.yaml`): CLIP
text embedding with caption dropout, KL-f8 encode with a posterior sample,
`scale_factor: auto` calibrated on the first batch, DDPM ε-loss through the
UNet, gradient accumulation, global-norm clip, Adam (fp32 moments under
bf16 parameters), fp32 EMA, remat.

Differences from the TPU package: batches come from the caller as an
iterable of {'image': [B, H, W, 3] in [-1, 1], 'txt_raw': [B captions]}
(its image loaders decode files with PIL or a native loader); every weight
is random from the config's seed (loading a trained first stage,
`first_stage.ckpt`, is not ported); there is no checkpointing, metrics file
or eval sampler. The LoRA, ControlNet, IP-Adapter and trainable-cond-stage
branches are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from typing import Callable, Iterable

import numpy as np
import torch

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion, calibrate_scale_factor
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.train.diffusion import (TrainState, ddpm_optimizer,
                                          float32_moments, init_train_state,
                                          make_diffusion_train_step)
from sd_tpu_torch.train.lr_schedules import lambda_linear_schedule
from sd_tpu_torch.train.remat import remat_apply
from sd_tpu_torch.weights import init_params_


def make_lr(train_cfg: dict) -> float | Callable[[int], float]:
    """The config's learning rate: a constant, or lr · the lambda-linear
    schedule of `lr_schedule`."""
    lr = train_cfg.get("lr", 1e-4)
    sched = train_cfg.get("lr_schedule")
    if sched is None:
        return lr
    if not isinstance(sched, dict):
        raise NotImplementedError(f"lr_schedule {sched!r} is not ported yet")
    lam = lambda_linear_schedule(**sched)
    return lambda step: lr * lam(step)


class TextEmbedder:
    """Frozen text conditioner: captions → [B, 77, C] CLIP embeddings (the
    TPU package's `FrozenClipTextEmbedder`)."""

    def __init__(self, clip: ClipTextTransformer, tokenizer: SimpleHashTokenizer):
        self.clip = clip
        self.tokenizer = tokenizer

    @torch.no_grad()
    def __call__(self, texts: list[str]) -> torch.Tensor:
        device = next(self.clip.parameters()).device
        ids = torch.from_numpy(self.tokenizer(list(texts)).astype(np.int64))
        return self.clip(ids.to(device))


def build_ldm(cfg: dict, generator: torch.Generator,
              param_dtype: torch.dtype = torch.float32, device=None):
    """The text-to-image latent-diffusion stack of `cfg`, every weight from
    `generator`: (ld, unet, vae, embed_texts). The UNet holds its parameters
    in `param_dtype`; the frozen first stage and text tower are fp32."""
    device = resolve_device(device)
    if cfg["first_stage"].get("ckpt"):
        raise NotImplementedError("loading a trained first stage is not ported yet")
    lat = cfg["latent"]
    ucfg = {k: v for k, v in cfg["unet"]["params"].items() if k != "dtype"}
    unet = UNetModel(**ucfg, dtype=param_dtype, device=device)
    vae = AutoencoderKL(**cfg["first_stage"]["params"], device=device).eval()
    clip_cfg = ClipTextConfig(**(cfg.get("cond_stage", {}).get("params") or {}))
    clip = ClipTextTransformer(clip_cfg, device=device).eval()
    for module in (unet, vae, clip):
        init_params_(module, generator)

    diff = dict(cfg.get("diffusion", {}))
    min_snr = diff.pop("min_snr_gamma", None)
    if diff.pop("type", "ddpm") != "ddpm":
        raise NotImplementedError("the flow-matching objective is not ported yet")
    process = DDPMProcess(DiffusionSchedule.create(**diff).to(device),
                          parameterization=diff.get("parameterization", "eps"),
                          min_snr_gamma=min_snr)
    ld = LatentDiffusion(
        process=process, unet_apply=unet, encode_fn=vae.encode,
        decode_fn=vae.decode,
        conditioning_key=lat.get("conditioning_key", "crossattn"),
        # "auto": std-rescaled on the first batch, in train_ldm
        scale_factor=(1.0 if lat.get("scale_factor") == "auto"
                      else lat.get("scale_factor", 0.18215)))
    embed = TextEmbedder(clip, SimpleHashTokenizer(clip_cfg.max_length,
                                                   clip_cfg.vocab_size))
    return ld, unet, vae, embed


def train_ldm(cfg: dict, batches: Iterable[dict], max_steps: int | None = None,
              device=None) -> tuple[TrainState, list[dict]]:
    """Train the UNet of `cfg` on `batches` for `max_steps` optimizer steps
    (default `train.total_steps`, fewer if the batches run out). Returns the
    training state and one dict of floats per step: the step's losses,
    `grad_norm` and `seconds` (host clock, the step's results read back)."""
    cfg = copy.deepcopy(cfg)
    tc = cfg["train"]
    for branch in ("lora", "controlnet", "ip_adapter"):
        if cfg.get(branch):
            raise NotImplementedError(f"{branch} training is not ported yet")
    if cfg.get("cond_stage", {}).get("trainable", tc.get("cond_stage_trainable")):
        raise NotImplementedError("a trainable cond stage is not ported yet")
    for key in ("weight_decay", "noise_offset", "learn_logvar"):
        if tc.get(key):
            raise NotImplementedError(f"train.{key} is not ported yet")
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    param_dtype = getattr(torch, tc.get("param_dtype") or "float32")
    ld, unet, _, embed = build_ldm(cfg, gen, param_dtype, device)

    def image(batch):
        return torch.as_tensor(np.asarray(batch["image"]), dtype=torch.float32).to(device)

    batches = iter(batches)
    first = next(batches)
    batches = itertools.chain([first], batches)
    if cfg["latent"].get("scale_factor") == "auto":
        # std-rescaling on the first batch (the reference's scale_by_std)
        z = ld.encode_first_stage(image(first), generator=gen)
        ld = dataclasses.replace(ld, scale_factor=calibrate_scale_factor(z))

    # classifier-free-guidance training: the empty caption at `cond_dropout`
    cond_dropout = float(tc.get("cond_dropout", 0.0))
    cd_rng = np.random.default_rng((seed, 0xCFD))

    def embed_batch(batch):
        texts = list(batch.get("txt_raw", [""] * len(batch["image"])))
        if cond_dropout > 0.0:
            texts = ["" if cd_rng.random() < cond_dropout else t for t in texts]
        return {"image": image(batch), "txt_emb": embed(texts)}

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0))
    if param_dtype != torch.float32:
        opt = float32_moments(opt)
    if tc.get("remat", "none") != "none":
        ld = dataclasses.replace(ld, unet_apply=remat_apply(ld.unet_apply, tc["remat"]))
    state = init_train_state(dict(unet.named_parameters()), opt,
                             tc.get("ema_decay", 0.9999),
                             num_timesteps=ld.schedule.num_timesteps)
    step_fn = make_diffusion_train_step(
        lambda b, g, logvar: ld.training_loss(b, g, learned_logvar=logvar),
        opt, grad_accum=tc.get("grad_accum", 1))

    total = max_steps if max_steps is not None else tc.get("total_steps", 1000)
    history = []
    for batch in itertools.islice(batches, total):
        t0 = time.perf_counter()
        logs = step_fn(state, embed_batch(batch), gen)
        row = {k: float(v) for k, v in logs.items()}
        row["seconds"] = time.perf_counter() - t0
        history.append(row)
    return state, history
