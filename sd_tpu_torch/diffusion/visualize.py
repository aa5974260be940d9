"""Visual diagnostics of a latent-diffusion model: the forward-diffusion
strip, the denoising strip, the `log_images` dictionary with its
inpainting / outpainting demos, and the progressive-generation grid.

Counterpart of `sd_tpu/diffusion/visualize.py`. The TPU package splits one
key into every draw; here each draw is a tensor the caller may hand in
(`enc_noise`, `row_noise`, `x_T`, `inpaint_x_T`, `mask_noise`), else drawn
from `generator`, so a test can give both packages the same noise. The
model is `ld.unet_apply` with its weights bound, as the port's samplers take
it. Every value returned is float NHWC in [-1, 1] on the host (numpy).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from sd_tpu_torch.diffusion.ddim import DDIMSampler
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.train.metrics import log_txt_as_img


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _randn(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    gen = generator or torch.Generator(device).manual_seed(0)
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def diffusion_row(ld: LatentDiffusion, z: torch.Tensor,
                  noises: Sequence[torch.Tensor] | None = None, n_steps: int = 8,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """q_sample(z, t) at `n_steps` timesteps spread over [0, T) (fp32
    linspace, truncated), each with its noise (`noises[i]`, else a draw):
    [S, B, ...] latents."""
    T = ld.schedule.num_timesteps
    ts = np.linspace(0, T - 1, n_steps).astype(np.float32).astype(np.int32)
    rows = []
    for i, t in enumerate(ts):
        noise = noises[i] if noises is not None else _randn(z.shape, generator, z.device)
        tb = torch.full((z.shape[0],), int(t), dtype=torch.long, device=z.device)
        rows.append(ld.schedule.to(z.device).q_sample(z, tb, noise.to(z.device)))
    return torch.stack(rows)


def denoise_row(ld: LatentDiffusion, shape: tuple, x_T: torch.Tensor,
                cond: dict | None = None, num_steps: int = 50, n_keep: int = 8
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """DDIM from x_T (η = 0): (the sample, the predicted x0 at `n_keep`
    evenly spaced steps [n_keep, *shape])."""
    sampler = DDIMSampler(ld.schedule, parameterization=ld.process.parameterization)
    z, pred_x0s = sampler.sample(ld.apply_model, shape, x_T, num_steps=num_steps, cond=cond,
                                 return_pred_x0=True)
    idx = np.linspace(0, num_steps - 1, n_keep).astype(int)
    return z, pred_x0s[torch.as_tensor(idx, device=pred_x0s.device)]


def log_images(ld: LatentDiffusion, batch: dict, n_rows: int = 4, sample_steps: int = 50,
               guidance_scale: float = 1.0, uncond: dict | None = None, inpaint: bool = True,
               *, generator: torch.Generator | None = None,
               enc_noise: torch.Tensor | None = None,
               row_noise: Sequence[torch.Tensor] | None = None,
               x_T: torch.Tensor | None = None, inpaint_x_T: torch.Tensor | None = None,
               mask_noise: Callable | None = None) -> dict[str, np.ndarray]:
    """The reference's visual log of a batch: inputs, reconstruction,
    conditioning (the captions `txt_raw` drawn as text), diffusion_row,
    samples, denoise_row and, with `inpaint`, the inpainting (the latent's
    left half kept, the right regenerated) and outpainting (the converse)
    demos, both from `inpaint_x_T` with the per-step mask noise
    `mask_noise(index, shape)`. The conditioning is `batch['txt_emb']` for a
    cross-attention model. The images go to the device of the schedule's
    tables."""
    device = ld.schedule.sqrt_alphas_cumprod.device
    x = torch.as_tensor(np.asarray(batch["image"][:n_rows])).to(device)
    out: dict[str, np.ndarray] = {"inputs": _host(x)}
    z = ld.get_first_stage_encoding(ld.encode_first_stage(x, enc_noise, generator))
    out["reconstruction"] = _host(ld.decode_first_stage(z))
    if "txt_raw" in batch:
        out["conditioning"] = log_txt_as_img((x.shape[1], x.shape[2]),
                                             list(batch["txt_raw"][:n_rows]))
    cond = None
    if ld.conditioning_key == "crossattn" and "txt_emb" in batch:
        cond = {"c_crossattn": [torch.as_tensor(np.asarray(batch["txt_emb"][:n_rows]),
                                                device=device)]}
    with torch.no_grad():
        drow = diffusion_row(ld, z, row_noise, generator=generator)
        out["diffusion_row"] = np.stack([_host(ld.decode_first_stage(d)) for d in drow])
        x_T = x_T if x_T is not None else _randn(z.shape, generator, device)
        zs, pred_rows = denoise_row(ld, tuple(z.shape), x_T.to(device), cond,
                                    num_steps=sample_steps)
        out["samples"] = _host(ld.decode_first_stage(zs))
        out["denoise_row"] = np.stack([_host(ld.decode_first_stage(p)) for p in pred_rows])
        if inpaint:
            mask = torch.ones(z.shape, device=device)
            mask[:, :, z.shape[2] // 2:, :] = 0.0          # regenerate the right half
            sampler = DDIMSampler(ld.schedule, parameterization=ld.process.parameterization)
            start = inpaint_x_T if inpaint_x_T is not None else _randn(z.shape, generator,
                                                                         device)
            kw = dict(num_steps=sample_steps, cond=cond, uncond=uncond,
                      guidance_scale=guidance_scale, x0=z, generator=generator,
                      mask_noise=mask_noise)
            for key, m in (("inpainting", mask), ("outpainting", 1.0 - mask)):
                zi = sampler.sample(ld.apply_model, tuple(z.shape), start.to(device), mask=m,
                                    **kw)
                out[key] = _host(ld.decode_first_stage(zi))
    return out


def progressive_denoising_grid(ld: LatentDiffusion, shape: tuple, x_T: torch.Tensor,
                               cond: dict | None = None, num_steps: int = 50,
                               n_keep: int = 8) -> np.ndarray:
    """The decoded predicted-x0 strip of a DDIM run from x_T: [n_keep, B,
    ...]."""
    with torch.no_grad():
        _, rows = denoise_row(ld, shape, x_T, cond, num_steps, n_keep)
        return np.stack([_host(ld.decode_first_stage(r)) for r in rows])
