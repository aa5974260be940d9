"""Latent diffusion glue: conditioning dispatch, the frozen first stage, the
training loss, DDIM sampling and the scale-factor calibration.

Counterpart of `sd_tpu/diffusion/latent.py` on the text-to-image path:
`apply_conditioned` with the `crossattn` key, `get_input`,
`training_loss` / `p_losses`, the `sampler="ddim"` branch of
`LatentDiffusion.sample` followed by the decode, and
`calibrate_scale_factor`. The other conditioning keys, the other samplers
and the patched (fold/unfold) paths are not ported yet.

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


def apply_conditioned(unet_apply: Callable, x: torch.Tensor, t: torch.Tensor,
                      cond: dict, conditioning_key: str) -> torch.Tensor:
    """Route conditioning into the UNet: `crossattn` concatenates the
    `c_crossattn` list along tokens and passes it as the context."""
    if conditioning_key != "crossattn":
        raise NotImplementedError(
            f"conditioning key {conditioning_key!r} is not ported yet")
    return unet_apply(x, t, torch.cat(list(cond["c_crossattn"]), dim=1))


@dataclasses.dataclass(frozen=True)
class LatentDiffusion:
    """unet_apply(x, t, context) -> prediction; encode_fn(image) ->
    DiagonalGaussian posterior (frozen); decode_fn(z) -> image (takes the
    unscaled latent)."""

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

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        """A posterior sample of the frozen first stage (before the scale
        factor), with `noise` or a draw from `generator`."""
        posterior: DiagonalGaussian = self.encode_fn(x)
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
               generator: torch.Generator | None = None) -> torch.Tensor:
        """DDIM sampling from x_T (the CFG branches go through one batched
        model call), then the first-stage decode."""
        if self.process.parameterization != "eps":
            raise NotImplementedError("DDIM sampling of x0/v models is not ported yet")
        z = DDIMSampler(self.schedule).sample(
            self.apply_model, shape, x_T, num_steps=num_steps, cond=cond,
            uncond=uncond, guidance_scale=guidance_scale, eta=eta,
            generator=generator)
        return self.decode_first_stage(z)


def calibrate_scale_factor(z: torch.Tensor) -> float:
    """1 / std of the first batch of latents (the reference's std-rescaling,
    computed once at the start of training)."""
    return float(1.0 / z.float().std(unbiased=False))
