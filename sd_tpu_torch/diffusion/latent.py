"""Latent diffusion glue: conditioning dispatch, the frozen first stage, the
training loss, sampling and the scale-factor calibration.

Counterpart of `sd_tpu/diffusion/latent.py` on the text-to-image and
image-editing paths: `apply_conditioned` with the `crossattn`, `concat` and
`hybrid` keys, `get_input`, `training_loss` / `p_losses`,
`LatentDiffusion.sample` with its sampler dispatch (ddim, dpm, dpm_sde,
unipc, plms, euler, euler_a, heun, ddpm and `guidance_rescale`; the same
errors for lcm / flow on an ε-model) followed by the decode,
`calibrate_scale_factor`, and the overlapping-tile apply (`patched_apply`:
sliding windows, the apply on every tile as one batch, border-weighted
overlap-add in fp32) that tiles the first stage's decode and encode.
Self-attention guidance (`sag_scale`), the consistency sampler, flow models,
the `adm` key, `get_input` for any key but `crossattn` and the
coordinates-bbox patched apply are not ported yet.

Randomness: where the TPU package splits a PRNG key, the port draws from a
`torch.Generator`; a batch may carry the draws instead (`t`, `noise`, and
`enc_noise` for the posterior sample), so a test can hand both packages the
same numbers and a microbatch split keeps them with their images.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddim import DDIMSampler
from sd_tpu_torch.diffusion.ddpm import DDPMProcess, draw_training_noise
from sd_tpu_torch.diffusion.dpm_solver import DPMSolverSampler
from sd_tpu_torch.diffusion.guidance import NoiseFn
from sd_tpu_torch.diffusion.k_samplers import KDiffusionSampler
from sd_tpu_torch.diffusion.plms import PLMSSampler
from sd_tpu_torch.diffusion.unipc import UniPCSampler


def apply_conditioned(unet_apply: Callable, x: torch.Tensor, t: torch.Tensor,
                      cond: dict, conditioning_key: str) -> torch.Tensor:
    """Route conditioning into the UNet: `crossattn` concatenates the
    `c_crossattn` list along tokens and passes it as the context, `concat`
    the `c_concat` list to the latent along channels (no context), `hybrid`
    both."""
    if conditioning_key not in ("crossattn", "concat", "hybrid"):
        raise NotImplementedError(
            f"conditioning key {conditioning_key!r} is not ported yet")
    if conditioning_key in ("concat", "hybrid"):
        x = torch.cat([x, *(c.to(x.dtype) for c in cond["c_concat"])], dim=-1)
    ctx = (None if conditioning_key == "concat"
           else torch.cat(list(cond["c_crossattn"]), dim=1))
    return unet_apply(x, t, ctx)


@dataclasses.dataclass(frozen=True)
class LatentDiffusion:
    """unet_apply(x, t, context) -> prediction; encode_fn(image) ->
    DiagonalGaussian posterior, or the latent itself (frozen); decode_fn(z)
    -> image (takes the unscaled latent)."""

    process: DDPMProcess
    unet_apply: Callable
    encode_fn: Callable | None = None
    decode_fn: Callable | None = None
    conditioning_key: str = "crossattn"
    scale_factor: float = 0.18215

    @property
    def schedule(self) -> DiffusionSchedule:
        return self.process.schedule

    def apply_model(self, x, t, cond):
        return apply_conditioned(self.unet_apply, x, t, cond,
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
            noise = torch.randn(posterior.mean.shape, generator=generator,
                                device=posterior.mean.device)
        return posterior.sample(noise)

    def get_input(self, batch: dict, generator: torch.Generator | None = None):
        """batch {'image': [B, H, W, 3], 'txt_emb': [B, L, C], optional
        'enc_noise'} → (z, cond), z scaled by the scale factor."""
        if self.conditioning_key != "crossattn":
            raise NotImplementedError(
                f"conditioning key {self.conditioning_key!r} is not ported yet")
        z = self.scale_factor * self.encode_first_stage(
            batch["image"], batch.get("enc_noise"), generator)
        return z, {"c_crossattn": [batch["txt_emb"]]}

    def p_losses(self, z: torch.Tensor, cond: dict, t: torch.Tensor,
                 noise: torch.Tensor, learned_logvar: torch.Tensor | None = None):
        return self.process.p_losses(self.apply_model, z, t, noise, cond,
                                     learned_logvar)

    def training_loss(self, batch: dict, generator: torch.Generator | None = None,
                      learned_logvar: torch.Tensor | None = None):
        """encode → t → noise → q_sample → UNet → loss: (loss, logs). t and
        the noise come from the batch (`t`, `noise`) where it has them, else
        from `generator`."""
        z, cond = self.get_input(batch, generator)
        t = batch.get("t")
        if t is None:
            t = torch.randint(0, self.schedule.num_timesteps, (z.shape[0],),
                              generator=generator, device=z.device)
        noise = batch.get("noise")
        if noise is None:
            noise = draw_training_noise(tuple(z.shape), generator=generator,
                                        device=z.device)
        return self.p_losses(z, cond, t, noise, learned_logvar)

    # -- sampling -------------------------------------------------------------

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode_fn(z / self.scale_factor)

    def sample(self, shape: tuple[int, ...], x_T: torch.Tensor, cond: dict,
               uncond: dict | None = None, guidance_scale: float = 1.0,
               num_steps: int = 50, eta: float = 0.0,
               generator: torch.Generator | None = None, sampler: str = "ddim",
               guidance_rescale: float = 0.0, sag_scale: float = 0.0,
               noise: NoiseFn | None = None, decode: bool = True) -> torch.Tensor:
        """Sampling from x_T with `sampler` (the CFG branches go through one
        batched model call; `eta` reaches DDIM only, `guidance_rescale` the
        CFG samplers; the stochastic ones draw from `generator` or
        `noise`), then the first-stage decode."""
        param = self.process.parameterization
        kw = dict(num_steps=num_steps, cond=cond, uncond=uncond,
                  guidance_scale=guidance_scale, guidance_rescale=guidance_rescale)
        if sag_scale > 0.0:
            if sampler != "ddim":
                raise ValueError(f"sag_scale is only supported by the ddim sampler, "
                                 f"got sampler={sampler!r}")
            raise NotImplementedError("SAG is not ported yet (diffusion/sag.py, "
                                      "nn/attn_probe.py)")
        if sampler in ("flow", "flow_midpoint"):
            raise ValueError("sampler='flow' needs a FlowProcess model "
                             "(diffusion.type: flow)")
        if sampler in ("euler", "euler_a", "heun"):
            z = KDiffusionSampler(self.schedule, order=sampler, parameterization=param).sample(
                self.apply_model, shape, x_T, generator=generator, noise=noise, **kw)
        elif sampler in ("dpm", "dpm_sde"):
            z = DPMSolverSampler(self.schedule, parameterization=param,
                                 sde=sampler == "dpm_sde").sample(
                self.apply_model, shape, x_T, generator=generator, noise=noise, **kw)
        elif sampler == "unipc":
            z = UniPCSampler(self.schedule, parameterization=param).sample(
                self.apply_model, shape, x_T, **kw)
        elif sampler in ("lcm", "consistency"):
            if uncond is not None and guidance_scale != 1.0:
                raise ValueError("lcm sampling has no CFG branch — guidance was baked "
                                 "in at distillation (distill.guidance_scale)")
            raise NotImplementedError("the consistency sampler is not ported yet "
                                      "(diffusion/consistency.py)")
        elif sampler == "plms":
            z = PLMSSampler(self.schedule, parameterization=param).sample(
                self.apply_model, shape, x_T, **kw)
        elif sampler == "ddim":
            z = DDIMSampler(self.schedule, parameterization=param).sample(
                self.apply_model, shape, x_T, eta=eta, generator=generator, noise=noise, **kw)
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
