"""Consistency distillation: a trained latent-diffusion teacher compressed
into a few-step student (LCM, arXiv:2310.04378; LCM-LoRA, arXiv:2311.05556).

Counterpart of `sd_tpu/train/distill.py`: `load_teacher_params`,
`make_consistency_train_step` and `distill_ldm`. The student has the
teacher's architecture and starts from the teacher's EMA weights (a copy:
the teacher never trains); each step runs, without gradients, the first
stage's encode, the draw of a boundary pair and the teacher's (CFG-guided)
DDIM step on the whole batch, then per microbatch the target network's
forward (no grad) and the student's forward and backward; the gradients
are summed in the parameters' dtype, averaged, clipped into one Adam update,
and the target network, the training state's own EMA shadow (decay ~0.95,
warm-up min(d, (1 + n) / (10 + n)), bf16 under the bf16 policy), follows
the new parameters. The loss reads the target from before the update.

With `distill.lora_rank` the student is the teacher plus rank-r factors
over the attention projections (LCM-LoRA): only the factors train (the
target is the EMA of the factors), the merged weights are applied with
`torch.func.functional_call`, and at step 0 (b = 0) the student is exactly
the teacher; the run ends with `lora.safetensors` in the run directory,
which `Text2ImagePipeline.load_lora` merges into the teacher for
`generate(sampler="lcm")`. A full-parameter run serves through
`Text2ImagePipeline.from_run`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable

import torch

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.diffusion.consistency import ConsistencyDistiller
from sd_tpu_torch.diffusion.latent import apply_conditioned
from sd_tpu_torch.train.checkpoint import restore_tree, trained_weights
from sd_tpu_torch.train.diffusion import (Adam, TrainState, ddpm_optimizer, float32_moments,
                                          init_train_state, make_diffusion_train_step)
from sd_tpu_torch.train.lora import (count_lora_params, flat_lora, init_lora, merged_kernels,
                                     nest_lora, save_lora_safetensors)
from sd_tpu_torch.train.metrics import count_params
from sd_tpu_torch.train.remat import remat_apply
from sd_tpu_torch.train.runners import (_Batches, _image, _load_cfg, _resume, _run_loop,
                                        apply_calibration, build_ldm, copy_named_,
                                        ema_eval_params, make_lr, params_apply)


def load_teacher_params(cfg: dict, teacher_run: str,
                        template: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The UNet weights of a finished `train_ldm` run: its latest
    checkpoint's EMA shadow (else its parameters), read on the CPU from the
    mapped file as `Text2ImagePipeline.from_run` reads them, each checked
    against `template` and copied to its dtype and device (new tensors)."""
    ckpt = os.path.join(teacher_run, "ckpt")
    loaded = trained_weights(restore_tree(ckpt))
    out = {n: torch.empty_like(t) for n, t in template.items()}
    copy_named_(out, loaded, f"teacher UNet of {ckpt}")
    return out


def make_consistency_train_step(loss_fn: Callable, optimizer: Adam,
                                prep_fn: Callable | None = None, grad_accum: int = 1
                                ) -> Callable[[TrainState, dict, torch.Generator | None], dict]:
    """The distillation step `step(state, batch, generator) -> logs`, which
    updates `state` IN PLACE. `prep_fn(batch, generator) -> prepped` runs
    the gradient-free work on the whole batch (outside `training_trace`);
    without it `prepped` is the batch. Then `make_diffusion_train_step` on
    the prepped tree: `loss_fn(params, target, prepped, generator) ->
    (loss, logs)` per microbatch, reading the target network,
    `state.ema.shadow`, as it is before this step; one optimizer update;
    one EMA update of the target with the new parameters; `grad_norm` in
    the logs."""

    def step(state: TrainState, batch: dict,
             generator: torch.Generator | None = None) -> dict:
        prepped = prep_fn(batch, generator) if prep_fn is not None else batch
        inner = make_diffusion_train_step(
            lambda mb, g, _logvar: loss_fn(state.params, state.ema.shadow, mb, g),
            optimizer, grad_accum)
        return inner(state, prepped, generator)

    return step


def unet_fn(unet: torch.nn.Module, params: dict[str, torch.Tensor],
            conditioning_key: str = "crossattn", lora: bool = False,
            remat: str = "none") -> Callable:
    """(x, t, cond) → the UNet's output with `params`: its own parameters
    (the module as it is), another full set (the teacher's copy, the target
    network), or, with `lora`, LoRA factors by name (`flat_lora`) merged
    into its own weights, differentiably. `remat` recomputes the forward in
    the backward under that policy."""
    if lora:
        params = merged_kernels(unet, nest_lora(params))
    apply = remat_apply(params_apply(unet, params), remat)
    return lambda x, t, c: apply_conditioned(apply, x, t, c, conditioning_key)


def consistency_loss_fn(distiller: ConsistencyDistiller, unet: torch.nn.Module,
                        conditioning_key: str = "crossattn", lora: bool = False,
                        remat: str = "none") -> Callable:
    """The distillation step's `loss_fn(params, target, prepped, generator)`:
    the student (`params`: the UNet's own parameters, or LoRA factors) under
    `remat` against the target network (the EMA shadow, no grad) on a
    prepped pair {z_hi, z_lo, t_hi, t_lo, cond}."""

    def loss_fn(params, target, prepped, generator=None):
        return distiller.student_loss(
            unet_fn(unet, params, conditioning_key, lora, remat),
            unet_fn(unet, target, conditioning_key, lora), prepped["z_hi"], prepped["z_lo"],
            prepped["t_hi"], prepped["t_lo"], prepped["cond"])

    return loss_fn


def distill_ldm(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
                max_steps: int | None = None, device=None) -> tuple[TrainState, list[dict]]:
    """Distill a finished `train_ldm` run (`distill.teacher_run`) into a
    few-step consistency student on `data` (see `train/runners.py`). The
    config is the teacher's LDM config plus a `distill:` block:
    `teacher_run`, `num_boundaries` (50), `guidance_scale` (1.0; > 1 bakes
    CFG into the student), `sigma_data` (0.5), `timestep_scaling` (10.0),
    `target_ema_decay` (0.95: the state's EMA is the target network, not an
    eval shadow; `train.ema_decay` is not read), `target_ema_dtype`
    (default `train.param_dtype`), `sample_steps` (2, the eval grid's
    budget), `lora_rank` (null; set for LCM-LoRA) and `lora_targets`. Each
    step's draws come from the step's generator: the posterior noise, the
    boundary index and the pair's noise (a batch may carry them as
    `enc_noise`, `i` and `noise`). With `scale_factor: auto` the teacher's
    `calibration.json` is required, and copied into `out_dir` so that
    `from_run` decodes the student at the teacher's scale. The eval grid is
    `sample_steps`-step consistency sampling of 4 empty-prompt images under
    the target weights."""
    cfg = _load_cfg(config)
    tc, dc = cfg["train"], cfg["distill"]
    if cfg.get("diffusion", {}).get("type", "ddpm") == "flow":
        raise ValueError("consistency distillation needs a DDPM-schedule teacher "
                         "(diffusion.type: ddpm), not a flow model")
    teacher_run = dc["teacher_run"]
    auto = cfg["latent"].get("scale_factor") == "auto"
    if auto and not os.path.exists(os.path.join(teacher_run, "calibration.json")):
        raise ValueError(f"teacher run {teacher_run} has no calibration.json — "
                         "finish train_ldm first")
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    # bf16 policy: teacher, student and the target network in bf16, Adam
    # moments fp32 (the target drops to bf16: it moves fast, and a second
    # fp32 copy of the student would not fit beside the teacher)
    param_dtype = getattr(torch, tc["param_dtype"]) if tc.get("param_dtype") else None
    ema_dtype = (getattr(torch, dc.get("target_ema_dtype", tc["param_dtype"]))
                 if param_dtype is not None else torch.float32)
    ld, unet, _, embed = build_ldm(cfg, gen, param_dtype or torch.float32, device)
    ld = apply_calibration(ld, cfg, os.path.join(teacher_run, "ckpt"))
    if auto and out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "calibration.json"), "w") as f:
            json.dump({"scale_factor": float(ld.scale_factor)}, f)

    own = dict(unet.named_parameters())
    teacher = load_teacher_params(cfg, teacher_run, own)
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(teacher[n])
    lora_rank = dc.get("lora_rank")
    if lora_rank:
        # the module keeps the teacher's weights, frozen; the student is
        # them plus the factors (b = 0: step 0 is exactly the teacher)
        teacher = own
        unet.requires_grad_(False)
        student_params = flat_lora(init_lora(
            unet, int(lora_rank), torch.Generator(device).manual_seed(seed ^ 0x1C31),
            dc.get("lora_targets")))
        print(f"[distill] LCM-LoRA rank {lora_rank}: "
              f"{count_lora_params(nest_lora(student_params)) / 1e3:.1f}K trainable factors "
              f"over frozen {count_params(unet) / 1e6:.1f}M teacher")
    else:
        # the module's parameters are the student, the teacher is a copy
        student_params = own
        print(f"[distill] student params: {count_params(unet) / 1e6:.1f}M "
              f"(init from {teacher_run} EMA)")

    distiller = ConsistencyDistiller(
        schedule=ld.schedule, parameterization=ld.process.parameterization,
        sigma_data=float(dc.get("sigma_data", 0.5)),
        timestep_scaling=float(dc.get("timestep_scaling", 10.0)),
        num_boundaries=int(dc.get("num_boundaries", 50)))
    w = float(dc.get("guidance_scale", 1.0))
    uncond_emb = embed([""]) if w != 1.0 else None
    remat = tc.get("remat", "none")

    key = ld.conditioning_key
    teacher_fn = unet_fn(unet, teacher, key)

    def prep_fn(batch, generator):
        """encode → boundary pair → the teacher's one solver step, no grad."""
        z0, cond = ld.get_input(batch, generator)
        uncond = (None if uncond_emb is None else
                  {"c_crossattn": [uncond_emb.expand(z0.shape[0], -1, -1)]})
        z_hi, z_lo, t_hi, t_lo = distiller.draw_pair(
            teacher_fn, z0, cond=cond, uncond=uncond, guidance_scale=w, generator=generator,
            i=batch.get("i"), noise=batch.get("noise"))
        return {"z_hi": z_hi, "z_lo": z_lo, "t_hi": t_hi, "t_lo": t_lo, "cond": cond}

    def embed_batch(batch):
        out = {"image": _image(batch, device),
               "txt_emb": embed(list(batch.get("txt_raw", [""] * len(batch["image"]))))}
        out.update({k: batch[k] for k in ("enc_noise", "i", "noise") if k in batch})
        return out

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0),
                         weight_decay=tc.get("weight_decay", 0.0))
    if param_dtype not in (None, torch.float32):
        opt = float32_moments(opt)
    state, start = _resume(out_dir, lambda: init_train_state(
        student_params, opt, float(dc.get("target_ema_decay", 0.95)),
        param_dtype=param_dtype, ema_dtype=ema_dtype))
    loss_fn = consistency_loss_fn(distiller, unet, key, bool(lora_rank), remat)
    step_fn = make_consistency_train_step(loss_fn, opt, prep_fn=prep_fn,
                                          grad_accum=tc.get("grad_accum", 1))

    lat = cfg["latent"]
    eval_shape = (4, lat["image_size"], lat["image_size"], lat["channels"])

    def sampler(st, generator):
        x_T = torch.randn(eval_shape, generator=generator, device=device)
        z = distiller.sample(unet_fn(unet, ema_eval_params(st), key, bool(lora_rank)),
                             eval_shape, x_T,
                             num_steps=int(dc.get("sample_steps", 2)),
                             cond={"c_crossattn": [embed([""] * 4)]}, generator=generator)
        return ld.decode_first_stage(z)

    history = _run_loop(lambda st, b, g: step_fn(st, embed_batch(b), g), state, cfg,
                        _Batches(data, cfg), out_dir, start, seed=seed, device=device,
                        max_steps=max_steps, sampler=sampler)
    if lora_rank and out_dir:
        # the portable acceleration module
        save_lora_safetensors(os.path.join(out_dir, "lora.safetensors"),
                              nest_lora(ema_eval_params(state)),
                              metadata={"rank": str(lora_rank), "kind": "lcm-lora",
                                        "teacher_run": str(teacher_run)})
    return state, history
