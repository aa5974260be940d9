"""Config-driven training: latent diffusion, pixel-space DDPM and the KL
and VQ first stages.

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

`train_ddpm` is the TPU package's `train_ddpm` (capability config #1):
the pixel-space UNetDDPM under the DDPM ε-loss, clip + Adam and EMA.
`train_kl_vae` is its `train_kl_vae` (capability config #3): the KL
autoencoder against L1 + LPIPS + KL + a PatchGAN, two Adam optimizers, the
same bf16 parameter policy. `train_vq` is its `train_vq` (capability config
#4): the VQ model (argmin, Gumbel or EMA codebook) against L1 + LPIPS + the
codebook loss + a PatchGAN, under the same policy. Like `train_ldm` they
step over the batches handed to them: the TPU runners' checkpoints, metrics
file and eval samplers (the EMA sampler of `train_ddpm`, the
reconstruction sampler of the codec trainers) are not ported yet. The other
capability runners are not ported yet.
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
from sd_tpu_torch.diffusion.ddpm import DDPMProcess, draw_training_noise
from sd_tpu_torch.diffusion.latent import LatentDiffusion, calibrate_scale_factor
from sd_tpu_torch.losses.gan import GanLossConfig
from sd_tpu_torch.models.autoencoder import AutoencoderKL, VQModel
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.discriminator import NLayerDiscriminator, init_discriminator_
from sd_tpu_torch.models.lpips import make_lpips_fn
from sd_tpu_torch.models.unet_ddpm import UNetDDPM
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.train.diffusion import (TrainState, ddpm_optimizer,
                                          float32_moments, init_train_state,
                                          make_diffusion_train_step)
from sd_tpu_torch.train.gan import (GanTrainState, gan_adam, gumbel_temp_schedule,
                                    init_gan_state, make_kl_gan_train_step,
                                    make_vq_gan_train_step)
from sd_tpu_torch.train.lr_schedules import cosine_annealing, lambda_linear_schedule
from sd_tpu_torch.train.remat import remat_apply
from sd_tpu_torch.weights import init_params_


def make_lr(train_cfg: dict) -> float | Callable[[int], float]:
    """The config's learning rate: a constant, the cosine annealing from lr
    to 0 over `total_steps` (default 10000) for `lr_schedule: cosine`, or
    lr · the lambda-linear schedule of a dict `lr_schedule`."""
    lr = train_cfg.get("lr", 1e-4)
    sched = train_cfg.get("lr_schedule")
    if sched is None:
        return lr
    if sched == "cosine":
        return cosine_annealing(lr, train_cfg.get("total_steps", 10000))
    if not isinstance(sched, dict):
        raise ValueError(f"unknown lr_schedule {sched!r}")
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
    process = DDPMProcess(DiffusionSchedule.create(**diff).to(device), clip_denoised=False,
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


def _resolve_lpips(loss_cfg: GanLossConfig, mode: str, device, tag: str):
    """The perceptual term of `loss.perceptual`: auto (here always the
    fixed-seed random-VGG surrogate: no VGG16 weights are in the
    repository), calibrated, random or none; None when its weight is 0.
    Says which it built."""
    if loss_cfg.perceptual_weight <= 0:
        return None
    fn = make_lpips_fn(mode=mode, device=device)
    if fn is not None:
        kind = "calibrated" if fn.calibrated else "random-VGG surrogate"
        print(f"[{tag}] perceptual loss: {kind} LPIPS (weight={loss_cfg.perceptual_weight})")
    else:
        print(f"[{tag}] perceptual loss disabled (perceptual: none)")
    return fn


def _gan_setup(cfg: dict, model, device, gen, tag: str):
    """The GAN trainers' common part: the discriminator of `cfg` and both
    networks initialised from `gen`, the loss configuration and perceptual
    function (the perceptual weight dropped to 0 with `perceptual: none`),
    the two GAN Adams (fp32 moments under `train.param_dtype`) and the
    training state. Returns (disc, loss_cfg, lpips_fn, opt_g, opt_d, state)."""
    tc = cfg["train"]
    param_dtype = getattr(torch, tc["param_dtype"]) if tc.get("param_dtype") else None
    disc = NLayerDiscriminator(**cfg.get("discriminator", {}), device=device)
    init_params_(model, gen)
    init_discriminator_(disc, gen)
    loss_kwargs = dict(cfg.get("loss", {}))
    lpips_mode = loss_kwargs.pop("perceptual", "auto")
    loss_cfg = GanLossConfig(**loss_kwargs)
    lpips_fn = _resolve_lpips(loss_cfg, lpips_mode, device, tag)
    if lpips_fn is None and loss_cfg.perceptual_weight > 0:
        loss_cfg = dataclasses.replace(loss_cfg, perceptual_weight=0.0)
    opt_g, opt_d = gan_adam(tc.get("lr", 4.5e-6)), gan_adam(tc.get("lr", 4.5e-6))
    if param_dtype not in (None, torch.float32):
        opt_g, opt_d = float32_moments(opt_g), float32_moments(opt_d)
    state = init_gan_state(model, disc, opt_g, opt_d, param_dtype=param_dtype)
    return disc, loss_cfg, lpips_fn, opt_g, opt_d, state


def _run_steps(step_fn, state, batches: Iterable[dict], total: int, device,
               generator: torch.Generator) -> list[dict]:
    """`step_fn(state, image, generator)` over up to `total` batches of
    {'image'}: one dict of floats per step, the step's logs and `seconds`
    (host clock, the step's results read back)."""
    history = []
    for batch in itertools.islice(batches, total):
        t0 = time.perf_counter()
        x = torch.as_tensor(np.asarray(batch["image"]), dtype=torch.float32).to(device)
        logs = step_fn(state, x, generator)
        row = {k: float(v) for k, v in logs.items()}
        row["seconds"] = time.perf_counter() - t0
        history.append(row)
    return history


def make_ddpm_trainer(cfg: dict, model: UNetDDPM):
    """The pixel-space DDPM recipe of `cfg` over `model`: (state, step).
    `state` is the training state over the model's parameters (Adam moments,
    fp32 EMA at `train.ema_decay`); `step(state, batch, generator)` one
    optimizer step on {'image': [B, H, W, 3]}: the ε-loss of
    `DDPMProcess(clip_denoised=True)` on the config's schedule, clip + Adam
    on the config's lr, `train.grad_accum` microbatches; its timesteps
    (uniform in [0, T)) and noise from the batch's `t` and `noise` where it
    has them, else from `generator`."""
    tc = cfg["train"]
    diff = dict(cfg.get("diffusion", {}))
    min_snr = diff.pop("min_snr_gamma", None)
    device = next(model.parameters()).device
    process = DDPMProcess(DiffusionSchedule.create(**diff).to(device), clip_denoised=True,
                          parameterization=diff.get("parameterization", "eps"),
                          min_snr_gamma=min_snr)
    noise_offset = tc.get("noise_offset", 0.0)

    def loss_fn(batch, generator, logvar):
        x = batch["image"]
        t = batch.get("t")
        if t is None:
            t = torch.randint(0, process.schedule.num_timesteps, (x.shape[0],),
                              generator=generator, device=x.device)
        noise = batch.get("noise")
        if noise is None:
            noise = draw_training_noise(tuple(x.shape), noise_offset, generator=generator,
                                        device=x.device)
        return process.p_losses(lambda x_t, t_, _: model(x_t, t_), x, t, noise,
                                learned_logvar=logvar)

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0))
    state = init_train_state(dict(model.named_parameters()), opt, tc.get("ema_decay", 0.9999))
    return state, make_diffusion_train_step(loss_fn, opt, grad_accum=tc.get("grad_accum", 1))


def train_ddpm(cfg: dict, batches: Iterable[dict], max_steps: int | None = None,
               device=None) -> tuple[TrainState, list[dict]]:
    """Train the pixel-space DDPM of `cfg` (e.g. `ddpm_256_train_config()`)
    on `batches` of {'image': [B, H, W, 3] in [-1, 1]} for `max_steps`
    steps (default `train.total_steps`, fewer if the batches run out) with
    `make_ddpm_trainer`. Every weight is random from the config's seed, as
    are each step's timesteps and noise. fp32 parameters; the config's lr is
    a constant or `lr_schedule: cosine`. Returns the training state and one
    dict of floats per step: the step's losses, `grad_norm` and `seconds`
    (host clock, the step's results read back)."""
    cfg = copy.deepcopy(cfg)
    mp = dict(cfg["model"]["params"])
    if mp.pop("dtype", None) is not None:
        raise NotImplementedError(
            "model.params.dtype (fp32 master parameters, bf16 compute) is not ported yet "
            "(ROADMAP Queue 1)")
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(cfg.get("seed", 0))
    model = UNetDDPM(**mp, device=device)
    init_params_(model, gen)
    state, step_fn = make_ddpm_trainer(cfg, model)
    total = max_steps if max_steps is not None else cfg["train"].get("total_steps", 1000)
    history = _run_steps(lambda st, x, g: step_fn(st, {"image": x}, g), state, batches,
                         total, device, gen)
    return state, history


def train_kl_vae(cfg: dict, batches: Iterable[dict], max_steps: int | None = None,
                 device=None) -> tuple[GanTrainState, list[dict]]:
    """Train the KL autoencoder of `cfg` (e.g. `kl_f8_256_train_config()`)
    with its PatchGAN on `batches` of {'image': [B, H, W, 3] in [-1, 1]} for
    `max_steps` steps (default `train.total_steps`, fewer if the batches run
    out). Every weight is random from the config's seed. With
    `train.param_dtype` (e.g. "bfloat16") the generator and discriminator
    parameters are stored in it and the Adam moments are fp32. Returns the
    training state and one dict of floats per step: the step's logs
    (`train/...`) and `seconds` (host clock, the step's results read back).
    Checkpointing, the metrics file and the reconstruction eval sampler of
    the TPU package's runner are not ported yet."""
    cfg = copy.deepcopy(cfg)
    tc = cfg["train"]
    target = cfg["model"].get("target", "")
    if not target.endswith("AutoencoderKL"):
        raise NotImplementedError(f"first stage {target!r} is not ported yet")
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(cfg.get("seed", 0))
    mp = {k: v for k, v in cfg["model"]["params"].items() if k != "dtype"}
    vae = AutoencoderKL(**mp, device=device)
    disc, loss_cfg, lpips_fn, opt_g, opt_d, state = _gan_setup(cfg, vae, device, gen, "kl-vae")

    down = 2 ** (len(mp.get("ch_mult", (1, 2, 4, 4))) - 1)
    embed_dim = mp.get("embed_dim", 4)

    def ae_apply(x, generator):
        b, h, w, _ = x.shape
        noise = torch.randn((b, h // down, w // down, embed_dim), generator=generator,
                            device=x.device)
        return vae(x, noise)

    step_fn = make_kl_gan_train_step(ae_apply, disc, lpips_fn, opt_g, opt_d, loss_cfg)
    total = max_steps if max_steps is not None else tc.get("total_steps", 1000)
    return state, _run_steps(step_fn, state, batches, total, device, gen)


def train_vq(cfg: dict, batches: Iterable[dict], max_steps: int | None = None,
             device=None) -> tuple[GanTrainState, list[dict]]:
    """Train the VQ model of `cfg` (e.g. `vq_128_train_config()`,
    `vq_64_train_config()`) with its PatchGAN on `batches` of {'image':
    [B, H, W, 3] in [-1, 1]} for `max_steps` steps (default
    `train.total_steps`, fewer if the batches run out). Every weight is
    random from the config's seed. `model.params.quantizer_type` picks the
    codebook: "vq" (argmin, trained by its gradient), "gumbel" (its noise
    drawn from the run's generator, its temperature
    `gumbel_temp_schedule(temp_init, **gumbel_schedule)` of the step) or
    "ema" (fp32 buffers updated once a step, never seen by Adam). With
    `train.param_dtype` (e.g. "bfloat16") the generator's and the
    discriminator's parameters are stored in it and the Adam moments are
    fp32. Returns the training state and one dict of floats per step: the
    step's logs (`train/...`) and `seconds` (host clock, the step's results
    read back)."""
    cfg = copy.deepcopy(cfg)
    tc = cfg["train"]
    target = cfg["model"].get("target", "")
    if not target.endswith("VQModel"):
        raise NotImplementedError(f"first stage {target!r} is not a VQ model")
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(cfg.get("seed", 0))
    mp = {k: v for k, v in cfg["model"]["params"].items() if k != "dtype"}
    vq = VQModel(**mp, device=device)
    disc, loss_cfg, lpips_fn, opt_g, opt_d, state = _gan_setup(cfg, vq, device, gen, "vq")

    temp_fn = None
    if vq.quantizer_type == "gumbel":
        temp_fn = gumbel_temp_schedule(temp_init=mp.get("temp_init", 1.0),
                                       **cfg.get("gumbel_schedule", {}))

    def vq_apply(x, generator, temp):
        return vq(x, temp=temp, update=True, deterministic=False, generator=generator)

    step_fn = make_vq_gan_train_step(vq_apply, disc, lpips_fn, opt_g, opt_d, loss_cfg,
                                     temp_fn=temp_fn)
    total = max_steps if max_steps is not None else tc.get("total_steps", 1000)
    return state, _run_steps(step_fn, state, batches, total, device, gen)
