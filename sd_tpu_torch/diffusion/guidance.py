"""Classifier-free-guidance combination (counterpart of
`sd_tpu/diffusion/guidance.py`): the plain combine and the std-rescale of
Lin et al. (arXiv:2305.08891 §3.4), which pulls the combined prediction's
per-sample std back toward the conditional branch's."""

from __future__ import annotations

from typing import Any, Callable

import torch

# model_fn(x, t, cond) -> prediction (ε, x0 or v by parameterization)
ModelFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
# noise(index, shape) -> fp32 N(0, 1) draws of a stochastic sampler's step
NoiseFn = Callable[[int, tuple], torch.Tensor]


def apply_cfg(e_uncond: torch.Tensor, e_cond: torch.Tensor,
              guidance_scale: float, guidance_rescale: float = 0.0) -> torch.Tensor:
    """e_uncond + s·(e_cond − e_uncond), in the inputs' dtype; with
    `guidance_rescale` r > 0, r·e·(std(e_cond) / std(e)) + (1 − r)·e, the
    population stds per sample over every non-batch dim in fp32."""
    e = e_uncond + guidance_scale * (e_cond - e_uncond)
    if guidance_rescale == 0.0:
        return e
    dims = tuple(range(1, e.ndim))
    std_cond = e_cond.float().std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = e.float().std(dim=dims, keepdim=True, unbiased=False)
    rescaled = e * (std_cond / torch.clamp(std_cfg, min=1e-12)).to(e.dtype)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * e


def cat_cond(uncond, cond):
    """[uncond; cond] along the batch: tensors, or dicts of tensors and
    tensor lists (the latent-diffusion conditioning)."""
    if isinstance(cond, dict):
        return {key: cat_cond(uncond[key], cond[key]) for key in cond}
    if isinstance(cond, (list, tuple)):
        return [torch.cat([u, c]) for u, c in zip(uncond, cond)]
    return torch.cat([uncond, cond])


def guided(model_fn: ModelFn, cond=None, uncond=None, guidance_scale: float = 1.0,
           guidance_rescale: float = 0.0) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(x, t) -> the model output, with classifier-free guidance when
    `uncond` is given and the scale is not 1: [uncond; cond] through one
    batched model call (the concat built once), combined on the raw output."""
    if uncond is None or guidance_scale == 1.0:
        return lambda x, t: model_fn(x, t, cond)
    both = cat_cond(uncond, cond)

    def out(x, t):
        o_u, o_c = model_fn(torch.cat([x, x]), torch.cat([t, t]), both).chunk(2)
        return apply_cfg(o_u, o_c, guidance_scale, guidance_rescale)
    return out


def gaussian_noise(generator: torch.Generator | None, device) -> NoiseFn:
    """The default noise source: fp32 N(0, 1) draws from `generator` (the
    whole batch's, this rank's rows kept, inside `parallel.mesh.batch_rows`)."""
    from sd_tpu_torch.parallel.mesh import global_draw

    return lambda index, shape: global_draw(
        lambda n: torch.randn((n, *shape[1:]), generator=generator, device=device,
                              dtype=torch.float32), shape[0])
