"""Text2ImagePipeline — prompts to images with the SD-v1 stack.

Counterpart of `sd_tpu/pipeline.py` `Text2ImagePipeline.generate`: CLIP
text encode of [negative; prompt] in one batched call (attention-weighting
syntax, per-call `clip_skip`) → the requested sampler with batched
classifier-free guidance (and `guidance_rescale`) through the UNet at the
requested size → KL-f8 decode → uint8, optionally watermarked. Dtype policy
(the TPU benchmark's): UNet, VAE and CLIP parameters and compute in bf16,
the latent cast to bf16 at each UNet call, the sampler state and update in
fp32, z / scale_factor cast to bf16 before decode.

Weights are random from a seed (`init_params_`), the first stage's trained
where the config's `first_stage.ckpt` names a KL or VQ run's checkpoint;
`from_run` loads a `train_ldm` run (`sd_tpu/pipeline.py from_run`).
Loading a real SD checkpoint, img2img/inpainting, tiled decode, ControlNet,
IP-Adapter and self-attention guidance are not ported yet.
"""

from __future__ import annotations

import copy
import os
from typing import Sequence

import numpy as np
import torch

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.utils.prompt_weights import (apply_prompt_weights, parse_weighted_prompt,
                                               tokenize_weighted)
from sd_tpu_torch.train.runners import build_first_stage, first_stage_fns
from sd_tpu_torch.utils.watermark import embed_watermark, str_to_bits
from sd_tpu_torch.weights import init_params_


class Text2ImagePipeline:
    def __init__(self, cfg: dict, device=None,
                 param_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = param_dtype
        kw = dict(dtype=param_dtype, device=self.device)
        gen = torch.Generator(self.device).manual_seed(cfg.get("seed", 0))
        ucfg = {k: v for k, v in cfg["unet"]["params"].items() if k != "dtype"}
        self.unet = UNetModel(**ucfg, **kw).eval()
        init_params_(self.unet, gen)
        # the config's first stage (AutoencoderKL or VQModel), trained
        # weights from `first_stage.ckpt` where it names a run's checkpoint
        self.vae = build_first_stage(cfg["first_stage"], gen, **kw)
        self.clip_cfg = ClipTextConfig(**(cfg.get("cond_stage", {})
                                          .get("params") or {}))
        self.clip = ClipTextTransformer(self.clip_cfg, **kw).eval()
        init_params_(self.clip, gen)
        _, decode = first_stage_fns(self.vae)
        self.tokenizer = SimpleHashTokenizer(self.clip_cfg.max_length,
                                             self.clip_cfg.vocab_size)
        diff = dict(cfg.get("diffusion", {}))
        lat = cfg["latent"]
        self.ld = LatentDiffusion(
            # x0 unclamped, as sd_tpu's pipeline process (`build_ldm`)
            process=DDPMProcess(DiffusionSchedule.create(**diff), clip_denoised=False,
                                parameterization=diff.get("parameterization", "eps")),
            unet_apply=lambda x, t, ctx: self.unet(x.to(self.dtype), t, ctx),
            decode_fn=lambda z: decode(z.to(self.dtype)),
            conditioning_key=lat.get("conditioning_key", "crossattn"),
            # "auto": the factor a training run calibrated (`from_run` reads it)
            scale_factor=(1.0 if lat.get("scale_factor") == "auto"
                          else lat.get("scale_factor", 0.18215)),
        )

    @classmethod
    def from_run(cls, config: dict | str, run_dir: str,
                 param_dtype: torch.dtype | None = torch.bfloat16,
                 device=None) -> "Text2ImagePipeline":
        """The pipeline of a `train_ldm` run (`python -m sd_tpu_torch.train`'s
        output directory): the UNet's EMA weights (else its parameters) from
        the run's latest checkpoint, read on the CPU from the mapped file,
        the first stage from the config's `first_stage.ckpt`, and the
        `calibration.json` scale factor under `scale_factor: auto`; every
        weight in `param_dtype` (None: fp32). The TPU package builds the
        pipeline in fp32 and casts it; the port builds it in `param_dtype`
        (its random draws are fp32, rounded once), which gives the same bits."""
        from sd_tpu_torch.core.config import load_config
        from sd_tpu_torch.train.checkpoint import restore_tree
        from sd_tpu_torch.train.runners import apply_calibration, copy_named_

        cfg = copy.deepcopy(config) if isinstance(config, dict) else load_config(config)
        pipe = cls(cfg, device=device, param_dtype=param_dtype or torch.float32)
        ckpt_dir = os.path.join(run_dir, "ckpt")
        tree = restore_tree(ckpt_dir)
        ema = tree.get("ema")
        weights = (ema["shadow"] if isinstance(ema, dict) and ema.get("shadow") is not None
                   else tree["params"])
        copy_named_(dict(pipe.unet.named_parameters()), weights, f"UNet of {ckpt_dir}")
        pipe.ld = apply_calibration(pipe.ld, cfg, ckpt_dir)
        return pipe

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        lat = self.cfg["latent"]
        return lat["image_size"], lat["image_size"], lat["channels"]

    def latent_hw(self, height: int | None, width: int | None) -> tuple[int, int]:
        """Pixel height/width → the latent grid, checked against the model's
        total downsampling (VAE factor × UNet levels); the config's square
        size where neither is given."""
        lat = self.cfg["latent"]
        if height is None and width is None:
            return lat["image_size"], lat["image_size"]
        f_vae = 2 ** (len(self.cfg["first_stage"]["params"].get("ch_mult", (1, 2, 4, 4))) - 1)
        f_unet = 2 ** (len(self.cfg["unet"]["params"].get("channel_mult", (1, 2, 4, 4))) - 1)
        f = f_vae * f_unet
        height = height if height is not None else lat["image_size"] * f_vae
        width = width if width is not None else lat["image_size"] * f_vae
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of {f} "
                             f"(VAE f{f_vae} × UNet {f_unet}-level downsampling)")
        return height // f_vae, width // f_vae

    def _tokenize_weighted(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray | None]:
        """ids [B, L] and per-token weights (None when no prompt carries
        emphasis: the plain tokenizer, so plain prompts stay bit-identical)."""
        parsed = [parse_weighted_prompt(t) for t in texts]
        if all(len(p) == 1 and p[0][1] == 1.0 for p in parsed):
            return self.tokenizer(texts), None
        tok = self.tokenizer
        return tokenize_weighted(texts, tok.encode_chunk, self.clip_cfg.max_length,
                                 tok.bos_token_id, tok.eos_token_id)

    @torch.no_grad()
    def encode_prompts(self, prompts: Sequence[str],
                       negative_prompt: str | Sequence[str] = "",
                       clip_skip: int | None = None):
        """(cond, uncond) text embeddings from one batched CLIP call over
        [negative; prompt], prompt weights applied to the CLIP output."""
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompts)
        elif len(negative_prompt) != len(prompts):
            raise ValueError("negative_prompt list must match prompts length")
        parts = [self._tokenize_weighted(list(t)) for t in (negative_prompt, prompts)]
        ids = torch.from_numpy(np.concatenate([i for i, _ in parts]).astype(np.int64))
        emb = self.clip(ids.to(self.device), clip_skip=clip_skip)
        if any(w is not None for _, w in parts):
            wts = np.concatenate([np.ones(i.shape, np.float32) if w is None else w
                                  for i, w in parts])
            emb = apply_prompt_weights(emb, torch.from_numpy(wts).to(self.device))
        uc, c = emb.to(self.dtype).chunk(2)
        return c, uc

    @torch.no_grad()
    def sample(self, prompts: Sequence[str], x_T: torch.Tensor,
               negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
               guidance_scale: float = 7.5, eta: float = 0.0,
               generator: torch.Generator | None = None, sampler: str = "ddim",
               guidance_rescale: float = 0.0, clip_skip: int | None = None,
               sag_scale: float = 0.0, noise=None) -> torch.Tensor:
        """Prompts and initial noise x_T [B, h, w, 4] → decoded images
        [B, 8h, 8w, 3] in the model dtype, range about [-1, 1]."""
        c, uc = self.encode_prompts(prompts, negative_prompt, clip_skip)
        return self.ld.sample(
            tuple(x_T.shape), x_T.float(), cond={"c_crossattn": [c]},
            uncond={"c_crossattn": [uc]}, guidance_scale=guidance_scale,
            num_steps=num_steps, eta=eta, generator=generator, sampler=sampler,
            guidance_rescale=guidance_rescale, sag_scale=sag_scale, noise=noise)

    def generate(self, prompts: Sequence[str],
                 negative_prompt: str | Sequence[str] = "",
                 num_steps: int = 50, guidance_scale: float = 7.5,
                 eta: float = 0.0, seed: int = 0, sampler: str = "ddim",
                 guidance_rescale: float = 0.0, height: int | None = None,
                 width: int | None = None, clip_skip: int | None = None,
                 decode_tile: int | None = None, control_image=None,
                 sag_scale: float = 0.0, ip_image=None, watermark: str | None = None,
                 watermark_bits: int = 48, watermark_key: int = 0) -> np.ndarray:
        """prompts → uint8 images [B, H, W, 3]. `sampler`: ddim, dpm,
        dpm_sde, unipc, plms, euler, euler_a, heun or ddpm; `height` /
        `width` in pixels (multiples of 64 for SD-v1; default the config's
        square size); `clip_skip` conditions on an earlier CLIP hidden state;
        prompts may carry `(emphasis)` / `(word:1.3)` / `[de-emphasis]`;
        `watermark` embeds a blind DCT mark (utils/watermark.py) in every
        image. The noise x_T and every stochastic sampler's draws come from
        one torch.Generator seeded with `seed`."""
        for name, value, module in (("decode_tile", decode_tile, "diffusion/latent.py patched_apply"),
                                    ("control_image", control_image, "models/controlnet.py"),
                                    ("ip_image", ip_image, "models/ip_adapter.py")):
            if value is not None:
                raise NotImplementedError(f"{name}: {module} is not ported yet")
        h, w = self.latent_hw(height, width)
        gen = torch.Generator(self.device).manual_seed(seed)
        x_T = torch.randn((len(prompts), h, w, self.cfg["latent"]["channels"]),
                          generator=gen, device=self.device, dtype=torch.float32)
        img = self.sample(prompts, x_T, negative_prompt, num_steps, guidance_scale, eta,
                          generator=gen, sampler=sampler, guidance_rescale=guidance_rescale,
                          clip_skip=clip_skip, sag_scale=sag_scale)
        out = to_uint8(img)
        if watermark is not None:
            bits = str_to_bits(watermark, watermark_bits)
            out = np.stack([embed_watermark(o, bits, key=watermark_key) for o in out])
        return out


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """[-1, 1] float images → uint8 (truncating, as the TPU package does)."""
    x = img.float().cpu().numpy()
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)
