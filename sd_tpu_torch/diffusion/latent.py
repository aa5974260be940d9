"""Latent diffusion glue: conditioning dispatch, the frozen first stage, the
training loss, sampling and the scale-factor calibration.

Counterpart of `sd_tpu/diffusion/latent.py`: `apply_conditioned` with the
`crossattn`, `concat`, `hybrid` and `adm` keys and the unconditional None,
`get_input`, `training_loss` / `p_losses`, `LatentDiffusion.sample` with its
sampler dispatch (ddim, dpm, dpm_sde, unipc, plms, euler, euler_a, heun,
ddpm and `guidance_rescale`; lcm, the consistency student's sampler; flow
and flow_midpoint, a flow model's only samplers and its default) followed by
the decode, `calibrate_scale_factor`, and the overlapping-tile apply
(`patched_apply`: sliding windows, the apply on every tile as one batch,
border-weighted overlap-add in fp32) that tiles the first stage's decode and
encode; a conditioning dict's `c_control` (ControlNet's hint) reaches the
UNet apply as `control=`, its `c_ip` (IP-Adapter's image embedding) as
`ip_embed=`; `sag_scale` > 0 takes DDIM's Self-Attention Guidance through
the probe apply `unet_apply_probs` (diffusion/sag.py); `get_input` for every
conditioning key (`crossattn`, `concat`, `hybrid`, `adm` and None, the
unconditional model: a batch's `txt_emb`, or its `txt_raw` through the
conditioner `cond_fn`, the `c_crossattn` entry, its `concat_cond` the
`c_concat` entry, its `class_label` the `c_adm` entry that reaches the UNet
as its labels `y`, its `hint` the `c_control` entry, its `ip_embed` the
`c_ip` entry), and the noise offset of the training noise;
`decode_first_stage` (no gradient) beside `differentiable_decode_first_stage`;
and the coordinates-bbox patched apply (`patched_apply_bbox`: every window
re-conditioned on its own crop box, `bbox_patch_limits`, all windows as one
batched UNet apply in patch-major order, the same overlap-add).

Randomness: where the TPU package splits a PRNG key, the port draws from a
`torch.Generator`; a batch may carry the draws instead (`t`, `noise`, and
`enc_noise` for the posterior sample), so a test can hand both packages the
same numbers and a microbatch split keeps them with their images.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.consistency import ConsistencyDistiller
from sd_tpu_torch.diffusion.ddim import DDIMSampler
from sd_tpu_torch.diffusion.ddpm import DDPMProcess, draw_training_noise
from sd_tpu_torch.diffusion.dpm_solver import DPMSolverSampler
from sd_tpu_torch.diffusion.flow import FlowEulerSampler, FlowProcess, FlowSchedule
from sd_tpu_torch.diffusion.guidance import NoiseFn
from sd_tpu_torch.diffusion.k_samplers import KDiffusionSampler
from sd_tpu_torch.diffusion.plms import PLMSSampler
from sd_tpu_torch.diffusion.unipc import UniPCSampler
from sd_tpu_torch.parallel.mesh import global_draw


def apply_conditioned(unet_apply: Callable, x: torch.Tensor, t: torch.Tensor,
                      cond: dict | None, conditioning_key: str | None) -> torch.Tensor:
    """Route conditioning into the UNet: `crossattn` concatenates the
    `c_crossattn` list along tokens and passes it as the context, `concat`
    the `c_concat` list to the latent along channels (no context), `hybrid`
    both, `adm` passes `c_adm` as the class labels `y`; with the key None or
    no cond the UNet runs unconditioned. A `c_control` entry goes to the
    apply as `control=`, a `c_ip` entry as `ip_embed=`."""
    if conditioning_key not in (None, "crossattn", "concat", "hybrid", "adm"):
        raise ValueError(f"unknown conditioning key {conditioning_key!r}")
    kw = {"control": cond["c_control"]} if cond is not None and "c_control" in cond else {}
    if cond is not None and "c_ip" in cond:
        kw["ip_embed"] = cond["c_ip"]
    if conditioning_key is None or cond is None:
        return unet_apply(x, t, None, **kw)
    if conditioning_key == "adm":
        return unet_apply(x, t, None, y=cond["c_adm"], **kw)
    if conditioning_key in ("concat", "hybrid"):
        x = torch.cat([x, *(c.to(x.dtype) for c in cond["c_concat"])], dim=-1)
    ctx = (None if conditioning_key == "concat"
           else torch.cat(list(cond["c_crossattn"]), dim=1))
    return unet_apply(x, t, ctx, **kw)


@dataclasses.dataclass(frozen=True)
class LatentDiffusion:
    """unet_apply(x, t, context, y=None) -> prediction; encode_fn(image) ->
    DiagonalGaussian posterior, or the latent itself (frozen); decode_fn(z)
    -> image (takes the unscaled latent); unet_apply_probs(x, t, context)
    -> (prediction, SAG salience mask), the probe Self-Attention Guidance
    needs (`sag.make_probs_apply`). `noise_offset` > 0 adds offset·ε_c,
    one ε_c per (sample, channel), to the drawn training noise.
    cond_fn(raw conditioning) -> the conditioning tensor (a text
    conditioner on token ids, a class embedder on labels); whether it
    trains follows from its parameters' `requires_grad`."""

    process: DDPMProcess | FlowProcess
    unet_apply: Callable
    encode_fn: Callable | None = None
    decode_fn: Callable | None = None
    conditioning_key: str | None = "crossattn"
    scale_factor: float = 0.18215
    unet_apply_probs: Callable | None = None
    noise_offset: float = 0.0
    cond_fn: Callable | None = None

    @property
    def schedule(self) -> DiffusionSchedule | FlowSchedule:
        return self.process.schedule

    def apply_model(self, x, t, cond):
        return apply_conditioned(self.unet_apply, x, t, cond,
                                 self.conditioning_key)

    def model_probs_fn(self) -> Callable:
        """(x, t, cond) -> (prediction, SAG salience mask): the probe apply
        with the conditioning routed."""
        if self.unet_apply_probs is None:
            raise ValueError("SAG needs unet_apply_probs — attach "
                             "sag.make_probs_apply(unet) to this LatentDiffusion")
        return lambda x, t, cond: apply_conditioned(self.unet_apply_probs, x, t, cond,
                                                    self.conditioning_key)

    # -- first stage and training loss ------------------------------------

    def get_first_stage_encoding(self, z: torch.Tensor) -> torch.Tensor:
        return self.scale_factor * z

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        """A posterior sample of the frozen first stage (before the scale
        factor), with `noise` or a draw from `generator`; a first stage whose
        encode gives a tensor (a VQ model's latent before quantization) is
        taken as it is."""
        posterior: DiagonalGaussian | torch.Tensor = self.encode_fn(x)
        if torch.is_tensor(posterior):
            return posterior
        if noise is None:
            shape = posterior.mean.shape
            noise = global_draw(lambda n: torch.randn((n, *shape[1:]), generator=generator,
                                                      device=posterior.mean.device), shape[0])
        return posterior.sample(noise)

    def get_learned_conditioning(self, raw_cond) -> torch.Tensor:
        """`cond_fn(raw_cond)`: the conditioning of raw text tokens or labels."""
        if self.cond_fn is None:
            raise ValueError("get_learned_conditioning needs a cond_fn")
        return self.cond_fn(raw_cond)

    def get_input(self, batch: dict, generator: torch.Generator | None = None):
        """batch {'image': [B, H, W, 3], 'txt_emb': [B, L, C] or 'txt_raw'
        (`cond_fn`'s input; `crossattn`, `hybrid`), 'concat_cond': [B, h,
        w, c] (`concat`, `hybrid`), 'class_label': [B] (`adm`), optional
        'enc_noise', 'hint' (ControlNet's pixel-space control image) and
        'ip_embed' (IP-Adapter's image embedding)} → (z, cond), z scaled by
        the scale factor; cond is None for the unconditional key None
        without a hint or an image embedding."""
        key = self.conditioning_key
        if key not in (None, "crossattn", "concat", "hybrid", "adm"):
            raise ValueError(f"unknown conditioning key {key!r}")
        z = self.scale_factor * self.encode_first_stage(
            batch["image"], batch.get("enc_noise"), generator)
        cond = {}
        if key in ("crossattn", "hybrid"):
            cond["c_crossattn"] = [batch["txt_emb"] if "txt_emb" in batch
                                   else self.get_learned_conditioning(batch["txt_raw"])]
        if key in ("concat", "hybrid"):
            cond["c_concat"] = [batch["concat_cond"]]
        if key == "adm":
            cond["c_adm"] = batch["class_label"]
        if "hint" in batch:
            cond["c_control"] = batch["hint"]
        if "ip_embed" in batch:
            cond["c_ip"] = batch["ip_embed"]
        return z, (cond or None) if key is None else cond

    def p_losses(self, z: torch.Tensor, cond: dict, t: torch.Tensor,
                 noise: torch.Tensor, learned_logvar: torch.Tensor | None = None):
        return self.process.p_losses(self.apply_model, z, t, noise, cond,
                                     learned_logvar)

    def training_loss(self, batch: dict, generator: torch.Generator | None = None,
                      learned_logvar: torch.Tensor | None = None):
        """encode → t → noise → q_sample → UNet → loss: (loss, logs). t and
        the noise come from the batch (`t`, `noise`) where it has them, else
        from `generator` (the noise with the noise offset)."""
        z, cond = self.get_input(batch, generator)
        t = batch.get("t")
        if t is None:
            t = global_draw(lambda n: torch.randint(0, self.schedule.num_timesteps, (n,),
                                                    generator=generator, device=z.device),
                            z.shape[0])
        noise = batch.get("noise")
        if noise is None:
            noise = draw_training_noise(tuple(z.shape), self.noise_offset,
                                        generator=generator, device=z.device)
        return self.p_losses(z, cond, t, noise, learned_logvar)

    # -- sampling -------------------------------------------------------------

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """The frozen first stage's decode of z / scale factor, no gradient."""
        return self.decode_fn(z / self.scale_factor)

    def differentiable_decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """The decode of z / scale factor with its gradient to z (the first
        stage's own parameters stay as their `requires_grad` says)."""
        return self.decode_fn(z / self.scale_factor)

    def sample(self, shape: tuple[int, ...], x_T: torch.Tensor, cond: dict,
               uncond: dict | None = None, guidance_scale: float = 1.0,
               num_steps: int = 50, eta: float = 0.0,
               generator: torch.Generator | None = None, sampler: str | None = None,
               guidance_rescale: float = 0.0, sag_scale: float = 0.0,
               noise: NoiseFn | None = None, decode: bool = True, **kw) -> torch.Tensor:
        """Sampling from x_T with `sampler` (default "flow" for a flow model,
        else "ddim"; the CFG branches go through one batched model call;
        `eta` reaches DDIM only, `guidance_rescale` the CFG samplers; the
        stochastic ones, lcm's re-noising among them, draw from `generator`
        or `noise`), then the first-stage decode. A flow model takes only
        "flow" / "flow_midpoint", and those only a flow model; "lcm" (or
        "consistency") has no CFG branch, and takes `sigma_data`,
        `timestep_scaling` and `num_boundaries` (defaults 0.5, 10, 50)."""
        param = self.process.parameterization
        is_flow = isinstance(self.process, FlowProcess)
        if is_flow:
            sampler = sampler or "flow"
            if sampler not in ("flow", "flow_midpoint"):
                raise ValueError(f"a flow-matching model needs sampler='flow' or "
                                 f"'flow_midpoint', got {sampler!r}")
        sampler = sampler or "ddim"
        kw_cfg = dict(num_steps=num_steps, cond=cond, uncond=uncond,
                      guidance_scale=guidance_scale, guidance_rescale=guidance_rescale)
        sag = {}
        if sag_scale > 0.0:
            if sampler != "ddim":
                raise ValueError(f"sag_scale is only supported by the ddim sampler, "
                                 f"got sampler={sampler!r}")
            sag = dict(sag_scale=sag_scale, sag_probs_fn=self.model_probs_fn())
        if sampler not in ("lcm", "consistency") and kw:
            raise TypeError(f"sampler {sampler!r} got unexpected arguments {sorted(kw)}")
        if sampler in ("flow", "flow_midpoint"):
            if not is_flow:
                raise ValueError("sampler='flow' needs a FlowProcess model "
                                 "(diffusion.type: flow)")
            z = FlowEulerSampler(self.schedule, method=(
                "midpoint" if sampler == "flow_midpoint" else "euler")).sample(
                self.apply_model, shape, x_T, num_steps=num_steps, cond=cond, uncond=uncond,
                guidance_scale=guidance_scale)
        elif sampler in ("euler", "euler_a", "heun"):
            z = KDiffusionSampler(self.schedule, order=sampler, parameterization=param).sample(
                self.apply_model, shape, x_T, generator=generator, noise=noise, **kw_cfg)
        elif sampler in ("dpm", "dpm_sde"):
            z = DPMSolverSampler(self.schedule, parameterization=param,
                                 sde=sampler == "dpm_sde").sample(
                self.apply_model, shape, x_T, generator=generator, noise=noise, **kw_cfg)
        elif sampler == "unipc":
            z = UniPCSampler(self.schedule, parameterization=param).sample(
                self.apply_model, shape, x_T, **kw_cfg)
        elif sampler in ("lcm", "consistency"):
            # a consistency-distilled student: guidance was baked in
            if uncond is not None and guidance_scale != 1.0:
                raise ValueError("lcm sampling has no CFG branch — guidance was baked "
                                 "in at distillation (distill.guidance_scale)")
            z = ConsistencyDistiller(
                self.schedule, parameterization=param,
                sigma_data=kw.pop("sigma_data", 0.5),
                timestep_scaling=kw.pop("timestep_scaling", 10.0),
                num_boundaries=kw.pop("num_boundaries", 50)).sample(
                self.apply_model, shape, x_T, num_steps=num_steps, cond=cond,
                generator=generator, noise=noise, **kw)
        elif sampler == "plms":
            z = PLMSSampler(self.schedule, parameterization=param).sample(
                self.apply_model, shape, x_T, **kw_cfg)
        elif sampler == "ddim":
            z = DDIMSampler(self.schedule, parameterization=param).sample(
                self.apply_model, shape, x_T, eta=eta, generator=generator, noise=noise,
                **kw_cfg, **sag)
        else:
            # ancestral sampling has no CFG path
            z = self.process.p_sample_loop(self.apply_model, shape, x_T, cond,
                                           generator=generator, noise=noise)
        return self.decode_first_stage(z) if decode else z


# -- overlapping tiles --------------------------------------------------------------


def _tie_breaker_weights(ks: int, sigma_scale: float = 0.5, device=None) -> torch.Tensor:
    """[ks, ks] border-falloff weights of the overlap-add: a Gaussian of
    the centred coordinate over ks, clipped to [0.01, 1], in fp32."""
    r = (torch.arange(ks, dtype=torch.float32, device=device) - (ks - 1) / 2) / ks
    g = torch.exp(-(r**2) / (2 * sigma_scale**2))
    return torch.clamp(g[:, None] * g[None, :], 0.01, 1.0)


def extract_patches(x: torch.Tensor, ks: int, stride: int) -> torch.Tensor:
    """[B, H, W, C] → [B, nH, nW, ks, ks, C] sliding windows (a view)."""
    return x.unfold(1, ks, stride).unfold(2, ks, stride).permute(0, 1, 2, 4, 5, 3)


def fold_patches(patches: torch.Tensor, out_hw: tuple[int, int], stride: int,
                 weights: torch.Tensor) -> torch.Tensor:
    """Weighted overlap-add of [B, nH, nW, ks, ks, C] back to fp32 [B, H, W,
    C], tile by tile in row-major order, normalized by the summed weights
    (pixels no tile covers come out 0)."""
    B, nh, nw, ks, _, C = patches.shape
    H, W = out_hw
    w = weights.to(patches.device)[None, :, :, None]
    out = torch.zeros((B, H, W, C), dtype=torch.float32, device=patches.device)
    norm = torch.zeros((1, H, W, 1), dtype=torch.float32, device=patches.device)
    for ih in range(nh):
        for iw in range(nw):
            y, x = ih * stride, iw * stride
            out[:, y:y + ks, x:x + ks] += patches[:, ih, iw].float() * w
            norm[:, y:y + ks, x:x + ks] += w
    return out / torch.clamp(norm, min=1e-8)


def patched_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, ks: int,
                  stride: int, scale: int | None = None) -> torch.Tensor:
    """`fn` on every ks×ks window of x [B, H, W, C] at `stride`, as one batch
    of B·nH·nW tiles (flattened [B, nH, nW]), overlap-added back in fp32 and
    returned in fn's dtype. `scale`, where given, is fn's spatial scaling
    (the decoder's VAE factor), checked against its output; without it any
    exact rational rescale is taken, downscaling too (the tiled encode)."""
    B, H, W, C = x.shape
    patches = extract_patches(x, ks, stride)
    nh, nw = patches.shape[1], patches.shape[2]
    out = fn(patches.reshape(B * nh * nw, ks, ks, C))
    oks = out.shape[1]
    if scale is not None and oks != ks * scale:
        raise ValueError(f"fn changed patch size {ks}->{oks}, scale={scale}")
    if (H * oks) % ks or (W * oks) % ks or (stride * oks) % ks:
        raise ValueError(f"patched_apply: output patch {oks} does not evenly rescale "
                         f"H={H}, W={W}, stride={stride} from ks={ks}")
    out = out.reshape(B, nh, nw, oks, oks, out.shape[-1])
    folded = fold_patches(out, (H * oks // ks, W * oks // ks), stride * oks // ks,
                          _tie_breaker_weights(oks))
    return folded.to(out.dtype)


def calibrate_scale_factor(z: torch.Tensor) -> float:
    """1 / std of the first batch of latents (the reference's std-rescaling,
    computed once at the start of training)."""
    return float(1.0 / z.float().std(unbiased=False))


def bbox_patch_limits(hw: tuple[int, int], ks: int, stride: int,
                      original_image_size: tuple[int, int],
                      rescale_latent: int) -> list[tuple[float, float, float, float]]:
    """The normalized crop box (x_t1, y_t1, w_frac, h_frac) of every window,
    row-major: its top-left corner rescaled from the latent to fractions of
    the original image."""
    h, w = hw
    n_row = (w - ks) // stride + 1
    n_col = (h - ks) // stride + 1
    full_h, full_w = original_image_size
    return [(rescale_latent * stride * (pn % n_row) / full_w,
             rescale_latent * stride * (pn // n_row) / full_h,
             rescale_latent * ks / full_w, rescale_latent * ks / full_h)
            for pn in range(n_row * n_col)]


def patched_apply_bbox(ld: LatentDiffusion, x: torch.Tensor, t: torch.Tensor,
                       cond_tokens: torch.Tensor, *, ks: int, stride: int,
                       original_image_size: tuple[int, int], rescale_latent: int,
                       crop_encoder: Callable[[tuple[float, float, float, float]], Sequence[int]],
                       encode_tokens: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The coordinates-bbox patched apply of x [B, H, W, C] at t [B]: every
    ks×ks window at `stride` re-conditioned on its own crop box — the base
    conditioning tokens [B, n] lose their last two, the window's box
    tokens (`crop_encoder(box)`) are appended, and the cond stage
    (`encode_tokens`: [L·B, n'] ids → [L·B, M, D]) encodes them — then all
    L windows as one UNet apply of L·B rows in patch-major order, folded
    back by the weighted overlap-add of `patched_apply`, in x's dtype."""
    B, H, W, C = x.shape
    patches = extract_patches(x, ks, stride)                # [B, nh, nw, ks, ks, C]
    nh, nw = patches.shape[1], patches.shape[2]
    L = nh * nw
    limits = bbox_patch_limits((H, W), ks, stride, original_image_size, rescale_latent)
    coords = torch.as_tensor(np.stack([np.asarray(crop_encoder(b), np.int64) for b in limits]),
                             dtype=cond_tokens.dtype, device=cond_tokens.device)   # [L, n_coord]
    cut = cond_tokens[:, :-2]
    adapted = torch.cat([cut[None].expand(L, B, cut.shape[1]),
                         coords[:, None].expand(L, B, coords.shape[1])], dim=-1)
    ctx = encode_tokens(adapted.reshape(L * B, -1))
    flat = patches.permute(1, 2, 0, 3, 4, 5).reshape(L * B, ks, ks, C)
    out = ld.apply_model(flat, t[None].expand(L, B).reshape(-1), {"c_crossattn": [ctx]})
    out = out.reshape(nh, nw, B, ks, ks, out.shape[-1]).permute(2, 0, 1, 3, 4, 5)
    return fold_patches(out, (H, W), stride, _tie_breaker_weights(ks)).to(x.dtype)
