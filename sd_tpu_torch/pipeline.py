"""Text2ImagePipeline — prompts to images with the SD-v1 stack.

Counterpart of `sd_tpu/pipeline.py` `Text2ImagePipeline.generate` on its
main path: CLIP text encode of [negative; prompt] in one batched call →
DDIM with batched classifier-free guidance through the UNet → KL-f8
decode. Dtype policy (the TPU benchmark's): UNet, VAE and CLIP parameters
and compute in bf16, the latent cast to bf16 at each UNet call, the DDIM
state and update in fp32, z / scale_factor cast to bf16 before decode.

Weights are random from a seed (`init_params_`); loading a real SD
checkpoint, img2img/inpainting, prompt weighting and the other samplers
are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.weights import init_params_

_WEIGHTING_CHARS = "()[]\\"


class Text2ImagePipeline:
    def __init__(self, cfg: dict, device=None,
                 param_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = param_dtype
        kw = dict(dtype=param_dtype, device=self.device)
        ucfg = {k: v for k, v in cfg["unet"]["params"].items() if k != "dtype"}
        self.unet = UNetModel(**ucfg, **kw).eval()
        self.vae = AutoencoderKL(**cfg["first_stage"]["params"], **kw).eval()
        self.clip_cfg = ClipTextConfig(**(cfg.get("cond_stage", {})
                                          .get("params") or {}))
        self.clip = ClipTextTransformer(self.clip_cfg, **kw).eval()
        gen = torch.Generator(self.device).manual_seed(cfg.get("seed", 0))
        for module in (self.unet, self.vae, self.clip):
            init_params_(module, gen)
        self.tokenizer = SimpleHashTokenizer(self.clip_cfg.max_length,
                                             self.clip_cfg.vocab_size)
        diff = dict(cfg.get("diffusion", {}))
        lat = cfg["latent"]
        self.ld = LatentDiffusion(
            process=DDPMProcess(DiffusionSchedule.create(**diff),
                                parameterization=diff.get("parameterization", "eps")),
            unet_apply=lambda x, t, ctx: self.unet(x.to(self.dtype), t, ctx),
            decode_fn=lambda z: self.vae.decode(z.to(self.dtype)),
            conditioning_key=lat.get("conditioning_key", "crossattn"),
            scale_factor=lat.get("scale_factor", 0.18215),
        )

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        lat = self.cfg["latent"]
        return lat["image_size"], lat["image_size"], lat["channels"]

    def _tokens(self, texts: list[str]) -> torch.Tensor:
        if any(c in t for t in texts for c in _WEIGHTING_CHARS):
            raise NotImplementedError(
                "prompt weighting syntax ((), [], \\) is not ported yet")
        return torch.from_numpy(self.tokenizer(texts).astype(np.int64)).to(self.device)

    @torch.no_grad()
    def encode_prompts(self, prompts: Sequence[str],
                       negative_prompt: str | Sequence[str] = ""):
        """(cond, uncond) text embeddings from one batched CLIP call over
        [negative; prompt]."""
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompts)
        elif len(negative_prompt) != len(prompts):
            raise ValueError("negative_prompt list must match prompts length")
        ids = self._tokens(list(negative_prompt) + list(prompts))
        uc, c = self.clip(ids).to(self.dtype).chunk(2)
        return c, uc

    @torch.no_grad()
    def sample(self, prompts: Sequence[str], x_T: torch.Tensor,
               negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
               guidance_scale: float = 7.5, eta: float = 0.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Prompts and initial noise x_T [B, h, w, 4] → decoded images
        [B, 8h, 8w, 3] in the model dtype, range about [-1, 1]."""
        c, uc = self.encode_prompts(prompts, negative_prompt)
        return self.ld.sample(
            tuple(x_T.shape), x_T.float(), cond={"c_crossattn": [c]},
            uncond={"c_crossattn": [uc]}, guidance_scale=guidance_scale,
            num_steps=num_steps, eta=eta, generator=generator)

    def generate(self, prompts: Sequence[str],
                 negative_prompt: str | Sequence[str] = "",
                 num_steps: int = 50, guidance_scale: float = 7.5,
                 eta: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompts → uint8 images [B, H, W, 3]."""
        gen = torch.Generator(self.device).manual_seed(seed)
        x_T = torch.randn((len(prompts),) + self.latent_shape, generator=gen,
                          device=self.device, dtype=torch.float32)
        img = self.sample(prompts, x_T, negative_prompt, num_steps,
                          guidance_scale, eta, generator=gen)
        return to_uint8(img)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """[-1, 1] float images → uint8 (truncating, as the TPU package does)."""
    x = img.float().cpu().numpy()
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)
