"""DreamBooth fine-tuning: bind a subject to a rare token with a
prior-preservation loss (arXiv:2208.12242).

Counterpart of `sd_tpu/train/dreambooth.py`. The whole UNet trains on
(instance image, instance prompt) pairs while (class image, class prompt)
pairs keep the class prior: `loss = L_instance + prior_weight · L_prior`,
both terms in the logs (`instance_loss`, `prior_loss`; `loss` is the
instance term, as the TPU package logs it). The class images are sampled
from the frozen starting model before training (`_generate_class_images`,
written as PNG) unless `class_data_dir` names a folder of them. Each step
zips a batch of instance images with one of class images; the class loader
starts a new epoch when it runs out. fp32, as the TPU package trains it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import numpy as np
import torch

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.data.image_io import write_png
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.train.diffusion import (TrainState, ddpm_optimizer, init_train_state,
                                          make_diffusion_train_step)
from sd_tpu_torch.train.metrics import count_params
from sd_tpu_torch.train.runners import (TextEmbedder, _Batches, _build_loader, _image, _load_cfg,
                                        _resume, _run_loop, build_ldm, ema_eval_params, make_lr,
                                        params_apply, step_generator)

CLASS_IMAGES_KEY = 0xDB        # the class images' generators, (seed, 0xDB, index)


@torch.no_grad()
def _generate_class_images(ld: LatentDiffusion, embed: TextEmbedder, lat: dict, prompt: str,
                           n: int, out_dir: str, num_steps: int, seed: int,
                           device) -> str:
    """Sample `n` class images of `prompt` from the model as it is (DDIM,
    `num_steps`, no CFG) into `out_dir` as `class_<i>.png`, 4 at a time, the
    batch from index i's x_T drawn from the generator of (seed, 0xDB, i);
    images already there count. Returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    existing = [f for f in os.listdir(out_dir) if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    done = len(existing)
    if done >= n:
        return out_dir
    emb = embed([prompt] * min(n, 4))
    while done < n:
        b = min(4, n - done)
        g = step_generator(device, seed, CLASS_IMAGES_KEY, done)
        shape = (b, lat["image_size"], lat["image_size"], lat["channels"])
        x_T = torch.randn(shape, generator=g, device=device)
        z = ld.sample(shape, x_T, cond={"c_crossattn": [emb[:b]]}, num_steps=num_steps,
                      generator=g, decode=False)
        imgs = ld.decode_first_stage(z).float().cpu().numpy()
        imgs = np.clip((imgs + 1.0) * 127.5, 0, 255).astype(np.uint8)
        for i in range(b):
            write_png(os.path.join(out_dir, f"class_{done + i:04d}.png"), imgs[i])
        done += b
    return out_dir


def dreambooth_loss(ld: LatentDiffusion, inst_emb: torch.Tensor, prior_emb: torch.Tensor,
                    prior_weight: float):
    """The step's `loss_fn(batch, generator, logvar)` over {"instance":
    {"image", ...}, "prior": {"image", ...}} (each side may carry its `t`,
    `noise` and `enc_noise`): the LDM loss of each side with its fixed
    prompt embedding, li + prior_weight · lp."""

    def side(batch, emb, generator, logvar):
        b = batch["image"].shape[0]
        return ld.training_loss({**batch, "txt_emb": emb.expand(b, -1, -1)}, generator, logvar)

    def loss_fn(batch, generator, logvar):
        li, logs = side(batch["instance"], inst_emb, generator, logvar)
        lp, _ = side(batch["prior"], prior_emb, generator, logvar)
        logs = {**logs, "prior_loss": lp, "instance_loss": li}
        return li + prior_weight * lp, logs

    return loss_fn


def train_dreambooth(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
                     max_steps: int | None = None, device=None) -> tuple[TrainState, list[dict]]:
    """Fine-tune the UNet on the instance images of `data` (see
    `train/runners.py`) with prior preservation. The config is an LDM
    config (`task: dreambooth`, a fixed scale factor) with a block

        dreambooth:
          instance_prompt: "a photo of sks dog"
          class_prompt: "a photo of a dog"
          prior_weight: 1.0
          num_class_images: 16
          class_data_dir: null     # optional: skip the generation
          class_num_steps: 20      # DDIM steps of the generated class images
          eval_prompts: [...]      # optional, default 4 × the instance prompt

    The class images are generated into `out_dir/class_images` (or read from
    `class_data_dir`, which a run without `out_dir` needs). AdamW with
    `train.weight_decay`, no learned logvar. The eval samples the eval
    prompts under the EMA weights (DDIM, `sample.num_steps`, default 20). Returns (state, history)."""
    cfg = _load_cfg(config)
    tc, db = cfg["train"], cfg["dreambooth"]
    prior_w = float(db.get("prior_weight", 1.0))
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    ld, unet, _, embed = build_ldm(cfg, torch.Generator(device).manual_seed(seed),
                                   device=device)
    if cfg["latent"].get("scale_factor") == "auto":
        raise ValueError("dreambooth needs a fixed scale_factor "
                         "(run the base LDM training first)")
    lat = cfg["latent"]
    print(f"[dreambooth] unet params: {count_params(unet) / 1e6:.1f}M, "
          f"prior_weight={prior_w}")

    class_dir = db.get("class_data_dir")
    if not class_dir:
        if not out_dir:
            raise ValueError("dreambooth without out_dir needs dreambooth.class_data_dir")
        class_dir = _generate_class_images(
            ld, embed, lat, db["class_prompt"], int(db.get("num_class_images", 16)),
            os.path.join(out_dir, "class_images"), int(db.get("class_num_steps", 20)),
            seed, device)
        print(f"[dreambooth] class prior set generated at {class_dir}")
    prior_loader = _build_loader(class_dir, cfg, tc.get("batch_size", 2))
    prior_iter = [iter(prior_loader)]

    # the conditioning is fixed per side: both embeddings once
    inst_emb, prior_emb = embed([db["instance_prompt"]]), embed([db["class_prompt"]])
    loss_fn = dreambooth_loss(ld, inst_emb, prior_emb, prior_w)

    def embed_batch(batch):
        try:
            pb = next(prior_iter[0])
        except StopIteration:
            prior_iter[0] = iter(prior_loader)
            pb = next(prior_iter[0])
        return {"instance": {"image": _image(batch, device)},
                "prior": {"image": _image(pb, device)}}

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0),
                         weight_decay=tc.get("weight_decay", 0.0))
    state, start = _resume(out_dir, lambda: init_train_state(
        dict(unet.named_parameters()), opt, tc.get("ema_decay", 0.9999)))
    step_fn = make_diffusion_train_step(loss_fn, opt)
    eval_prompts = db.get("eval_prompts", [db["instance_prompt"]] * 4)

    def sampler(st, generator):
        model = dataclasses.replace(ld, unet_apply=params_apply(unet, ema_eval_params(st)))
        shape = (len(eval_prompts), lat["image_size"], lat["image_size"], lat["channels"])
        x_T = torch.randn(shape, generator=generator, device=device)
        z = model.sample(shape, x_T, cond={"c_crossattn": [embed(eval_prompts)]},
                         num_steps=cfg.get("sample", {}).get("num_steps", 20),
                         generator=generator, decode=False)
        return ld.decode_first_stage(z)

    try:
        history = _run_loop(lambda st, b, g: step_fn(st, embed_batch(b), g), state, cfg,
                            _Batches(data, cfg), out_dir, start, seed=seed, device=device,
                            max_steps=max_steps, sampler=sampler)
    finally:
        prior_iter[0].close()      # the class loader's prefetch thread
    return state, history
