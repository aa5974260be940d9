"""The mask-conditioned inpainting model's conditioning.

Counterpart of `sd_tpu/train/inpaint.py` `mask_to_latent` and
`inpaint_concat_cond` (the SD-inpainting layout: the UNet sees
[z_t | hole mask↓ | E(x·(1 − hole))], `conditioning_key: hybrid`), the
synthetic mask menu (`random_inpaint_masks`, host numpy, the TPU package's
draws), and the trainer `train_ldm_inpaint` with its eval sampler. Inside,
mask 1 means hole; the pipeline's `inpaint` keeps white/1 = keep and inverts
at its boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sd_tpu_torch.parallel.mesh import global_draw


def _nearest_rows(n_in: int, n_out: int, device) -> torch.Tensor:
    # jax.image.resize's "nearest": source ⌊(i + ½)·in/out⌋, computed in fp32
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def mask_to_latent(mask: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    """A pixel hole mask [B, H, W, 1] nearest-downsampled to the latent grid
    by the TPU package's rule (half-pixel centres, not
    `F.interpolate(mode="nearest")`'s ⌊i·in/out⌋)."""
    if mask.shape[1] == lh and mask.shape[2] == lw:
        return mask
    rows = _nearest_rows(mask.shape[1], lh, mask.device)
    cols = _nearest_rows(mask.shape[2], lw, mask.device)
    return mask[:, rows][:, :, cols]


def inpaint_concat_cond(ld, image: torch.Tensor, mask: torch.Tensor, lh: int, lw: int,
                        noise: torch.Tensor | None = None,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """[mask↓ | E(x·(1 − mask))·scale] [B, lh, lw, 1 + z] for the pixel hole
    mask [B, H, W, 1] (1 = hole): the masked image's posterior sample
    (`noise`, else drawn from `generator`) in fp32."""
    masked = image * (1.0 - mask)
    mz = ld.get_first_stage_encoding(ld.encode_first_stage(masked, noise, generator).float())
    return torch.cat([mask_to_latent(mask, lh, lw).to(mz.dtype), mz], dim=-1)


# -- host-side mask synthesis ---------------------------------------------------------

MASK_KEY = 0x1A5C              # the training masks' stream (seed, MASK_KEY); the eval's seed


def random_inpaint_masks(rng: np.random.Generator, batch: int, height: int, width: int,
                         full_prob: float = 0.1, max_rects: int = 3,
                         max_strokes: int = 2) -> np.ndarray:
    """Training hole masks [B, H, W, 1] float32 in {0, 1}, 1 = hole: 1 to
    `max_rects` rectangles and 0 to `max_strokes` thick random-walk brush
    strokes, or with probability `full_prob` the whole image. The TPU
    package's draws in its order, so one generator gives the same masks."""
    masks = np.zeros((batch, height, width, 1), np.float32)
    for i in range(batch):
        if rng.random() < full_prob:
            masks[i] = 1.0
            continue
        for _ in range(int(rng.integers(1, max_rects + 1))):
            rh = int(rng.integers(max(1, height // 8), max(2, height // 2)))
            rw = int(rng.integers(max(1, width // 8), max(2, width // 2)))
            y0 = int(rng.integers(0, height - rh + 1))
            x0 = int(rng.integers(0, width - rw + 1))
            masks[i, y0:y0 + rh, x0:x0 + rw, 0] = 1.0
        for _ in range(int(rng.integers(0, max_strokes + 1))):
            # a stroke: a sequence of stamped discs
            y = float(rng.integers(0, height))
            x = float(rng.integers(0, width))
            r = max(2, int(min(height, width) * float(rng.uniform(0.04, 0.1))))
            ang = float(rng.uniform(0, 2 * np.pi))
            yy, xx = np.mgrid[:height, :width]
            for _ in range(int(rng.integers(4, 12))):
                disc = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
                masks[i, disc, 0] = 1.0
                ang += float(rng.uniform(-0.8, 0.8))
                step = r * float(rng.uniform(1.0, 2.5))
                y = float(np.clip(y + step * np.sin(ang), 0, height - 1))
                x = float(np.clip(x + step * np.cos(ang), 0, width - 1))
    return masks


# -- the trainer ----------------------------------------------------------------------


def _check_inpaint_config(cfg: dict) -> None:
    lat = cfg["latent"]
    ch = lat["channels"]
    want_in = 2 * ch + 1
    got = cfg["unet"].get("params", {}).get("in_channels", ch)
    if got != want_in:
        raise ValueError(f"inpainting conditioning needs unet.in_channels = 2·latent "
                         f"channels + 1 = {want_in}, got {got}")
    if lat.get("conditioning_key", "crossattn") != "hybrid":
        raise ValueError("ldm_inpaint needs latent.conditioning_key: hybrid")


def inpaint_loss(ld, lh: int, lw: int):
    """The step's `loss_fn(batch, generator, logvar)` over {image, mask,
    txt_emb, ...}: the concat conditioning of the batch's masks (the masked
    image's posterior noise `concat_enc_noise`, else drawn), then the LDM
    loss with it."""

    def loss_fn(batch, generator, logvar):
        cc = inpaint_concat_cond(ld, batch["image"], batch["mask"], lh, lw,
                                 batch.get("concat_enc_noise"), generator)
        return ld.training_loss({**batch, "concat_cond": cc}, generator, logvar)

    return loss_fn


def _inpaint_eval_sampler(cfg: dict, batches, ld, unet, embed, device):
    """Inpaint the run's fixed batch with fixed masks (seed 0x1A5C, no full
    masks) each eval, under the EMA weights: the grid stacks the masked
    inputs (holes black), the generated holes composited into the
    originals, and the originals."""
    from sd_tpu_torch.train.runners import _image, ema_eval_params, params_apply

    lat = cfg["latent"]
    lh = lw = lat["image_size"]
    scfg = cfg.get("sample", {})
    steps, gs = scfg.get("num_steps", 20), scfg.get("guidance_scale", 1.0)
    ref: list = []

    def sampler(state, generator):
        if not ref:
            batch = batches.peek()
            img = _image(batch, device)
            m = torch.from_numpy(random_inpaint_masks(
                np.random.default_rng(MASK_KEY), img.shape[0], img.shape[1], img.shape[2],
                full_prob=0.0)).to(device)
            texts = list(batch.get("txt_raw", [""] * len(img)))
            ref.append((img, m, embed(texts), embed([""] * len(img))))
        img, m, emb, uemb = ref[0]
        model = dataclasses.replace(ld, unet_apply=params_apply(unet, ema_eval_params(state)))
        cc = inpaint_concat_cond(model, img, m, lh, lw, generator=generator)
        cond = {"c_crossattn": [emb], "c_concat": [cc]}
        uncond = {"c_crossattn": [uemb], "c_concat": [cc]}
        shape = (img.shape[0], lh, lw, lat["channels"])
        x_T = torch.randn(shape, generator=generator, device=device)
        out = model.sample(shape, x_T, cond=cond, uncond=uncond if gs > 1.0 else None,
                           guidance_scale=gs, num_steps=steps, eta=0.0,
                           generator=generator).float()
        # the generated hole composited into the original (serving's rule)
        comp = out * m + img * (1.0 - m)
        masked_vis = img * (1.0 - m) + (-1.0) * m
        return torch.cat([masked_vis, comp, img], dim=0)

    return sampler


def train_ldm_inpaint(config: dict | str, data, out_dir: str | None = None,
                      max_steps: int | None = None, device=None):
    """Train the mask-conditioned inpainting LDM on `data` (see
    `train/runners.py`). The config is the ldm task's with
    `latent.conditioning_key: hybrid` and `unet.params.in_channels` =
    2·latent channels + 1, and an optional

        data:
          inpaint: {full_prob: 0.1, max_rects: 3, max_strokes: 2}

    Each step's masks come from `random_inpaint_masks` on the (seed,
    0x1A5C) numpy stream, which the caption dropout (`train.cond_dropout`)
    draws from first; the UNet trains in fp32 (AdamW with
    `train.weight_decay`, `train.learn_logvar`, `train.grad_accum`), and
    `scale_factor: auto` calibrates as `train_ldm` does. Returns (state,
    history)."""
    from sd_tpu_torch.core.config import resolve_device
    from sd_tpu_torch.train.diffusion import ddpm_optimizer, init_train_state
    from sd_tpu_torch.train.metrics import count_params
    from sd_tpu_torch.train.runners import (_Batches, _image, _load_cfg, _maybe_parallel_step,
                                            _parallel_run, _resume, _run_loop,
                                            auto_scale_factor, build_ldm, make_lr)

    cfg = _load_cfg(config)
    _check_inpaint_config(cfg)
    tc, lat = cfg["train"], cfg["latent"]
    lh = lw = lat["image_size"]
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    par = _parallel_run(cfg, tc.get("grad_accum", 1))
    ld, unet, _, embed = build_ldm(cfg, gen, device=device)
    print(f"[ldm_inpaint] unet params: {count_params(unet) / 1e6:.1f}M")
    batches = _Batches(data, cfg, par)
    ld = auto_scale_factor(ld, cfg, batches, out_dir, gen, tag="ldm_inpaint")

    mk = dict(cfg.get("data", {}).get("inpaint", {}) or {})
    cond_dropout = float(tc.get("cond_dropout", 0.0))
    host_rng = np.random.default_rng((seed, MASK_KEY))

    def embed_batch(batch):
        img = np.asarray(batch["image"], np.float32)
        texts = list(batch.get("txt_raw", [""] * len(img)))
        if cond_dropout > 0.0:
            draws = global_draw(lambda n: [host_rng.random() for _ in range(n)], len(texts))
            texts = ["" if u < cond_dropout else t for u, t in zip(draws, texts)]
        mask = global_draw(lambda n: random_inpaint_masks(host_rng, n, img.shape[1],
                                                          img.shape[2], **mk), img.shape[0])
        return {"image": _image(batch, device), "txt_emb": embed(texts),
                "mask": torch.from_numpy(mask).to(device)}

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0),
                         weight_decay=tc.get("weight_decay", 0.0))
    learn_logvar = bool(tc.get("learn_logvar", False))
    state, start = _resume(out_dir, lambda: init_train_state(
        dict(unet.named_parameters()), opt, tc.get("ema_decay", 0.9999),
        num_timesteps=ld.schedule.num_timesteps, learn_logvar=learn_logvar))
    step_fn = _maybe_parallel_step(par, inpaint_loss(ld, lh, lw), opt, state,
                                   tc.get("grad_accum", 1), tp=(unet, ""))
    history = _run_loop(lambda st, b, g: step_fn(st, embed_batch(b), g), state, cfg, batches,
                        out_dir, start, seed=seed, device=device, max_steps=max_steps,
                        sampler=_inpaint_eval_sampler(cfg, batches, ld, unet, embed, device))
    return state, history
