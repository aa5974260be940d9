"""Text2ImagePipeline — prompts (and images) to images with the SD stack.

Counterpart of `sd_tpu/pipeline.py` `Text2ImagePipeline`:
  * `generate`: CLIP text encode of [negative; prompt] in one batched call
    (attention-weighting syntax, per-call `clip_skip`, textual-inversion
    placeholders expanded) → the requested sampler with batched
    classifier-free guidance (and `guidance_rescale`) through the UNet at
    the requested size → first-stage decode, whole or in overlapping tiles
    (`decode_tile`) → uint8, optionally watermarked;
  * `img2img`: the init image's latent (a posterior sample, optionally
    encoded in tiles) forward-diffused to `strength`·steps, then the DDIM
    decode; with a keep-mask the DDIM inpainting blend instead;
  * `inpaint`: with a mask-conditioned model (`conditioning_key: hybrid`,
    `unet.in_channels` = 2·z + 1) the UNet sees [z_t | mask | E(masked
    image)] and the kept pixels are composited back bit for bit; otherwise
    the blend of `img2img` at strength 1;
  * `generate_hires`: a base pass, a host-side upscale, an img2img pass;
  * `set_unet_options` (ToMe, FreeU) and `load_textual_inversion`.
Dtype policy (the TPU benchmark's): UNet, VAE and CLIP parameters and
compute in bf16, the latent cast to bf16 at each UNet call, the sampler
state and update in fp32, z / scale_factor cast to bf16 before decode, the
image cast to bf16 before encode and the latent taken back in fp32.

Random draws come from one `torch.Generator` seeded with `seed`; each draw
can be handed in instead (`noise=`, `x_T`, `enc_noise`, ...), so a test can
give the port and the TPU package the same numbers.

Weights are random from a seed (`init_params_`), the first stage's trained
where the config's `first_stage.ckpt` names a KL or VQ run's checkpoint;
`from_run` loads a `train_ldm` run (`sd_tpu/pipeline.py from_run`).
Loading a real SD checkpoint, ControlNet, IP-Adapter and self-attention
guidance are not ported yet.
"""

from __future__ import annotations

import copy
import os
from typing import Sequence

import numpy as np
import torch

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.data.image_io import resize
from sd_tpu_torch.diffusion.ddim import DDIMSampler
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.guidance import NoiseFn
from sd_tpu_torch.diffusion.latent import LatentDiffusion, patched_apply
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.utils.prompt_weights import (apply_prompt_weights, parse_weighted_prompt,
                                               tokenize_weighted)
from sd_tpu_torch.train.runners import build_first_stage, first_stage_fns
from sd_tpu_torch.train.textual_inversion import (expand_placeholder, patch_embedding_rows,
                                                  placeholder_ids)
from sd_tpu_torch.utils.safetensors_io import load_safetensors
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
        encode, decode = first_stage_fns(self.vae)
        self.tokenizer = SimpleHashTokenizer(self.clip_cfg.max_length,
                                             self.clip_cfg.vocab_size)
        self._ti_expansions: dict[str, str] = {}      # load_textual_inversion
        diff = dict(cfg.get("diffusion", {}))
        lat = cfg["latent"]
        self.ld = LatentDiffusion(
            # x0 unclamped, as sd_tpu's pipeline process (`build_ldm`)
            process=DDPMProcess(DiffusionSchedule.create(**diff), clip_denoised=False,
                                parameterization=diff.get("parameterization", "eps")),
            unet_apply=lambda x, t, ctx: self.unet(x.to(self.dtype), t, ctx),
            encode_fn=lambda x: encode(x.to(self.dtype)),
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

    def _vae_factor(self) -> int:
        return 2 ** (len(self.cfg["first_stage"]["params"].get("ch_mult", (1, 2, 4, 4))) - 1)

    # -- options, adapters ----------------------------------------------------------

    def set_unet_options(self, **updates) -> None:
        """Swap the UNet's parameter-free serving options: `tome_ratio`,
        `tome_min_tokens` (ToMe, `nn/tome.py`) and `freeu` ((b1, b2, s1,
        s2), arXiv:2309.11497; None turns it off). The weights are untouched;
        the next call runs with the options.

            pipe.set_unet_options(tome_ratio=0.5, freeu=(1.2, 1.4, 0.9, 0.2))
        """
        self.unet.set_options(**updates)

    def load_textual_inversion(self, path: str) -> list[str]:
        """Learned concept embeddings (textual inversion, arXiv:2208.01618)
        from a `.safetensors` file {placeholder: [num_vectors, hidden]}: each
        placeholder's token rows are written into the text encoder, and a
        multi-vector placeholder expands into its words in every later
        prompt. Returns the placeholders loaded."""
        loaded = []
        for token, vec in load_safetensors(path).items():
            vec = vec.float().numpy()
            if vec.ndim == 1:
                vec = vec[None]
            ids = placeholder_ids(self.tokenizer, token, vec.shape[0])
            if vec.shape[1] != self.clip_cfg.hidden_size:
                raise ValueError(f"{token}: embedding dim {vec.shape[1]} != text encoder "
                                 f"hidden size {self.clip_cfg.hidden_size}")
            patch_embedding_rows(self.clip, ids, vec)
            self._ti_expansions[token] = " ".join(expand_placeholder(token, vec.shape[0]))
            loaded.append(token)
        return loaded

    # -- text ----------------------------------------------------------------------

    def _tokenize_weighted(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray | None]:
        """ids [B, L] and per-token weights (None when no prompt carries
        emphasis: the plain tokenizer, so plain prompts stay bit-identical);
        textual-inversion placeholders expanded first."""
        for token, phrase in self._ti_expansions.items():
            texts = [t.replace(token, phrase) for t in texts]
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

    # -- the first stage -------------------------------------------------------------

    @staticmethod
    def _cover_stride(ks: int, H: int, W: int, step: int = 1) -> int:
        """The largest stride ≤ 3·ks/4 (a multiple of `step`) whose windows
        cover both dims exactly; ks where none does."""
        for s in range((min(3 * ks // 4, ks - 1) // step) * step, 0, -step):
            if (H - ks) % s == 0 and (W - ks) % s == 0:
                return s
        return ks

    @torch.no_grad()
    def _decode(self, z: torch.Tensor, tile: int | None = None) -> torch.Tensor:
        """The first stage's decode of the unscaled latent z [B, h, w, C];
        with `tile` (latent units) below the latent's size, tile×tile
        windows decoded as one batch and overlap-added with border weights
        (per-tile GroupNorm statistics differ a little from the whole
        image's; the weights hide the seams)."""
        B, H, W, C = z.shape
        if tile is None or (H <= tile and W <= tile):
            return self.ld.decode_fn(z)
        ks = min(tile, H, W)
        return patched_apply(self.ld.decode_fn, z, ks=ks, stride=self._cover_stride(ks, H, W),
                             scale=self._vae_factor())

    @torch.no_grad()
    def _encode_raw(self, x: torch.Tensor, tile: int | None = None,
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """The first stage's encode (before the scale factor) of images x
        [B, H, W, 3]: a posterior sample (`noise`, else drawn from
        `generator`; a VQ first stage's latent before quantization as it
        is), in fp32. With `tile` (pixels) below the image's size, tile×tile
        windows, the stride a multiple of the VAE factor, encoded as one
        batch of B·nH·nW tiles (`noise` then has that batch) and
        overlap-added at the latent grid."""
        B, H, W, C = x.shape
        enc = lambda xp: self.ld.encode_first_stage(xp, noise, generator).float()
        if tile is None or (H <= tile and W <= tile):
            return enc(x)
        f = self._vae_factor()
        ks = max(f, (min(tile, H, W) // f) * f)
        return patched_apply(enc, x, ks=ks, stride=self._cover_stride(ks, H, W, step=f))

    # -- text to image ---------------------------------------------------------------

    @torch.no_grad()
    def sample(self, prompts: Sequence[str], x_T: torch.Tensor,
               negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
               guidance_scale: float = 7.5, eta: float = 0.0,
               generator: torch.Generator | None = None, sampler: str = "ddim",
               guidance_rescale: float = 0.0, clip_skip: int | None = None,
               sag_scale: float = 0.0, noise=None,
               decode_tile: int | None = None) -> torch.Tensor:
        """Prompts and initial noise x_T [B, h, w, 4] → decoded images
        [B, 8h, 8w, 3] in the model dtype, range about [-1, 1];
        `decode_tile` in latent units (`_decode`)."""
        c, uc = self.encode_prompts(prompts, negative_prompt, clip_skip)
        z = self.ld.sample(
            tuple(x_T.shape), x_T.float(), cond={"c_crossattn": [c]},
            uncond={"c_crossattn": [uc]}, guidance_scale=guidance_scale,
            num_steps=num_steps, eta=eta, generator=generator, sampler=sampler,
            guidance_rescale=guidance_rescale, sag_scale=sag_scale, noise=noise,
            decode=False)
        return self._decode(z / self.ld.scale_factor, decode_tile)

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
        `decode_tile` (pixels, e.g. 512) decodes in overlapping tiles,
        bounding the decoder's memory at any size; `watermark` embeds a
        blind DCT mark (utils/watermark.py) in every image. The noise x_T
        and every stochastic sampler's draws come from one torch.Generator
        seeded with `seed`."""
        for name, value, module in (("control_image", control_image, "models/controlnet.py"),
                                    ("ip_image", ip_image, "models/ip_adapter.py")):
            if value is not None:
                raise NotImplementedError(f"{name}: {module} is not ported yet")
        h, w = self.latent_hw(height, width)
        gen = torch.Generator(self.device).manual_seed(seed)
        x_T = torch.randn((len(prompts), h, w, self.cfg["latent"]["channels"]),
                          generator=gen, device=self.device, dtype=torch.float32)
        img = self.sample(prompts, x_T, negative_prompt, num_steps, guidance_scale, eta,
                          generator=gen, sampler=sampler, guidance_rescale=guidance_rescale,
                          clip_skip=clip_skip, sag_scale=sag_scale,
                          decode_tile=self._latent_tile(decode_tile))
        out = to_uint8(img)
        if watermark is not None:
            bits = str_to_bits(watermark, watermark_bits)
            out = np.stack([embed_watermark(o, bits, key=watermark_key) for o in out])
        return out

    def _latent_tile(self, pixels: int | None) -> int | None:
        return None if pixels is None else max(1, pixels // self._vae_factor())

    def generate_hires(self, prompts: Sequence[str], hires_scale: float = 2.0,
                       denoising_strength: float = 0.7, num_steps: int = 50,
                       hires_steps: int | None = None,
                       negative_prompt: str | Sequence[str] = "",
                       guidance_scale: float = 7.5, seed: int = 0,
                       height: int | None = None, width: int | None = None,
                       clip_skip: int | None = None, guidance_rescale: float = 0.0,
                       upscale: str = "bicubic") -> np.ndarray:
        """The two-stage "highres fix": `generate` at the base size, each
        image upscaled `hires_scale`× on the host (`upscale`: bicubic,
        nearest or lanczos, PIL's resamplers in numpy) to the nearest
        multiple of the model's downsampling, then `img2img` there at
        `denoising_strength` with `hires_steps` (default `num_steps`) and
        seed + 1."""
        base = self.generate(prompts, negative_prompt=negative_prompt, num_steps=num_steps,
                             guidance_scale=guidance_scale, seed=seed, height=height,
                             width=width, clip_skip=clip_skip,
                             guidance_rescale=guidance_rescale)
        up = self.upscale(base, hires_scale, upscale)
        return self.img2img(prompts, up, strength=denoising_strength,
                            negative_prompt=negative_prompt,
                            num_steps=hires_steps or num_steps,
                            guidance_scale=guidance_scale, seed=seed + 1,
                            clip_skip=clip_skip, guidance_rescale=guidance_rescale)

    def upscale(self, images: np.ndarray, scale: float, method: str = "bicubic") -> np.ndarray:
        """uint8 [B, H, W, 3] resized on the host by `scale`, snapped to the
        model's total downsampling (`generate_hires`' middle stage)."""
        f = self._vae_factor() * 2 ** (
            len(self.cfg["unet"]["params"].get("channel_mult", (1, 2, 4, 4))) - 1)
        h2 = max(f, round(images.shape[1] * scale / f) * f)
        w2 = max(f, round(images.shape[2] * scale / f) * f)
        return np.stack([resize(im, h2, w2, method) for im in images])

    # -- image to image, inpainting ---------------------------------------------------

    @staticmethod
    def _to_model_range(images) -> np.ndarray:
        """uint8 [0, 255] or float [-1, 1] NHWC → float32 [-1, 1]."""
        x = np.asarray(images)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 127.5 - 1.0
        return np.asarray(x, np.float32)

    def _latent_keep_mask(self, mask) -> np.ndarray:
        """A keep-mask (white / 1 = keep) at image or latent resolution →
        float32 {0, 1} [B or 1, h, w, 1] at the config's latent size. The
        TPU package's rule, kept as it is: an image-resolution mask is
        subsampled by m[:, ::sy, ::sx] (sy = H // h), and the latent size is
        the config's, whatever the init image's."""
        lat = self.cfg["latent"]
        lh = lw = lat["image_size"]
        m = np.asarray(mask, np.float32)
        if m.ndim == 2:
            m = m[None]
        if m.ndim == 3:
            m = m[..., None]
        if m.max() > 1.0:
            m = m / 255.0
        if m.shape[1:3] != (lh, lw):
            sy, sx = m.shape[1] // lh, m.shape[2] // lw
            m = m[:, ::sy, ::sx][:, :lh, :lw]
        return (m > 0.5).astype(np.float32)

    @torch.no_grad()
    def img2img_sample(self, prompts: Sequence[str], x: torch.Tensor, t_start: int,
                       negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
                       guidance_scale: float = 7.5, mask: torch.Tensor | None = None,
                       guidance_rescale: float = 0.0, clip_skip: int | None = None,
                       encode_tile: int | None = None, decode_tile: int | None = None,
                       generator: torch.Generator | None = None,
                       enc_noise: torch.Tensor | None = None,
                       latent_noise: torch.Tensor | None = None,
                       mask_noise: NoiseFn | None = None) -> torch.Tensor:
        """img2img on float images x [B, H, W, 3] in [-1, 1] → decoded
        images. The latent z (a posterior sample with `enc_noise`) is
        forward-diffused to DDIM index t_start − 1 (`latent_noise`); without
        `mask` the DDIM decode runs t_start steps down from there (CFG
        without rescale, as the TPU package's `decode`); with a latent keep
        `mask` [B or 1, h, w, 1] the DDIM sample with the inpainting blend
        runs all `num_steps` from that latent (the TPU package's rule, kept:
        the latent was noised only to t_start − 1), each step's blend noise
        from `mask_noise`. Draws not given come from `generator`, in that
        order. `encode_tile` in pixels, `decode_tile` in latent units."""
        c, uc = self.encode_prompts(prompts, negative_prompt, clip_skip)
        cond, uncond = {"c_crossattn": [c]}, {"c_crossattn": [uc]}
        sampler = DDIMSampler(self.ld.schedule, parameterization=self.ld.process.parameterization)
        dd = sampler.make_schedule(num_steps)
        z = self.ld.get_first_stage_encoding(
            self._encode_raw(x.to(self.device), encode_tile, enc_noise, generator))
        if latent_noise is None:
            latent_noise = torch.randn(z.shape, generator=generator, device=z.device)
        z_noisy = sampler.stochastic_encode(z, t_start - 1, dd, latent_noise)
        if mask is not None:
            z_out = sampler.sample(self.ld.apply_model, tuple(z.shape), z_noisy,
                                   num_steps=num_steps, cond=cond, uncond=uncond,
                                   guidance_scale=guidance_scale, dd=dd,
                                   guidance_rescale=guidance_rescale, generator=generator,
                                   mask=mask.to(z.device), x0=z, mask_noise=mask_noise)
        else:
            z_out = sampler.decode(self.ld.apply_model, z_noisy, t_start, cond=cond,
                                   uncond=uncond, guidance_scale=guidance_scale, dd=dd,
                                   generator=generator)
        return self._decode(z_out / self.ld.scale_factor, decode_tile)

    def img2img(self, prompts: Sequence[str], init_images, strength: float = 0.75,
                negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
                guidance_scale: float = 7.5, seed: int = 0, mask=None,
                guidance_rescale: float = 0.0, clip_skip: int | None = None,
                encode_tile: int | None = None,
                decode_tile: int | None = None) -> np.ndarray:
        """Guided image-to-image: the init images' latent re-noised to
        `strength`·`num_steps`, then the CFG DDIM decode → uint8 [B, H, W,
        3]. With `mask` (white / 1 = keep; image or latent resolution) the
        DDIM inpainting blend instead. `init_images`: [B, H, W, 3] uint8 or
        float in [-1, 1]. `encode_tile` / `decode_tile` (pixels): the first
        stage in overlapping tiles, bounding its memory at any size."""
        x = torch.from_numpy(self._to_model_range(init_images))
        if len(prompts) != x.shape[0]:
            raise ValueError(f"{len(prompts)} prompts for {x.shape[0]} init images")
        t_start = max(1, min(int(strength * num_steps), num_steps))
        m = None if mask is None else torch.from_numpy(self._latent_keep_mask(mask))
        gen = torch.Generator(self.device).manual_seed(seed)
        img = self.img2img_sample(prompts, x, t_start, negative_prompt, num_steps,
                                  guidance_scale, mask=m, guidance_rescale=guidance_rescale,
                                  clip_skip=clip_skip, encode_tile=encode_tile,
                                  decode_tile=self._latent_tile(decode_tile), generator=gen)
        return to_uint8(img)

    def inpaint(self, prompts: Sequence[str], init_images, mask, **kw) -> np.ndarray:
        """Inpainting: white / 1 mask pixels are kept, the rest regenerated
        under the prompt. A mask-conditioned model (`_is_inpaint_model`)
        sees [z_t | hole mask↓ | E(masked image)] at every step, and the
        result is composited into the original at pixel level; any other
        model takes `img2img`'s blend at strength 1 (unless `strength` is
        given)."""
        if self._is_inpaint_model():
            return self._inpaint_conditioned(prompts, init_images, mask, **kw)
        kw.setdefault("strength", 1.0)
        return self.img2img(prompts, init_images, mask=mask, **kw)

    def _is_inpaint_model(self) -> bool:
        lat = self.cfg["latent"]
        got = self.cfg["unet"].get("params", {}).get("in_channels", lat["channels"])
        return lat.get("conditioning_key") == "hybrid" and got == 2 * lat["channels"] + 1

    @staticmethod
    def _normalize_keep_mask(mask, b: int, h: int, w: int) -> np.ndarray:
        """A keep-mask (white / 1 = keep) → the image-resolution hole mask
        float32 [B, H, W, 1] in {0, 1} (1 = regenerate)."""
        m = np.asarray(mask, np.float32)
        if m.ndim == 2:
            m = m[None]
        if m.ndim == 3:
            m = m[..., None]
        if m.shape[0] == 1 and b > 1:
            m = np.broadcast_to(m, (b,) + m.shape[1:])
        if m.max() > 1.0:
            m = m / 255.0
        if m.shape[1:3] != (h, w):
            raise ValueError(f"mask must be image-resolution {(h, w)}, got {m.shape[1:3]}")
        return (m <= 0.5).astype(np.float32)

    @torch.no_grad()
    def inpaint_sample(self, prompts: Sequence[str], x: torch.Tensor, hole: torch.Tensor,
                       negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
                       guidance_scale: float = 7.5, eta: float = 0.0, sampler: str = "ddim",
                       guidance_rescale: float = 0.0, clip_skip: int | None = None,
                       generator: torch.Generator | None = None,
                       enc_noise: torch.Tensor | None = None,
                       x_T: torch.Tensor | None = None, noise: NoiseFn | None = None
                       ) -> torch.Tensor:
        """The mask-conditioned model's sampling on float images x [B, H, W,
        3] in [-1, 1] with the hole mask [B, H, W, 1] (1 = regenerate): the
        concat conditioning [hole↓ | E(x·(1 − hole))·scale] (posterior noise
        `enc_noise`) rides both CFG branches (no CFG at guidance ≤ 1), the
        sampler runs from `x_T` (its draws `noise`), the decode is blended
        into x outside the hole. Draws not given come from `generator`, in
        that order."""
        from sd_tpu_torch.train.inpaint import inpaint_concat_cond

        b, h, w = x.shape[:3]
        f = self._vae_factor()
        lh, lw = h // f, w // f
        x, hole = x.to(self.device), hole.to(self.device)
        c, uc = self.encode_prompts(prompts, negative_prompt, clip_skip)
        cc = inpaint_concat_cond(self.ld, x, hole, lh, lw, enc_noise, generator)
        cond = {"c_crossattn": [c], "c_concat": [cc]}
        uncond = {"c_crossattn": [uc], "c_concat": [cc]} if guidance_scale > 1.0 else None
        shape = (b, lh, lw, self.cfg["latent"]["channels"])
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=self.device)
        z = self.ld.sample(shape, x_T.float(), cond, uncond, guidance_scale=guidance_scale,
                           num_steps=num_steps, eta=eta, generator=generator, sampler=sampler,
                           guidance_rescale=guidance_rescale, noise=noise, decode=False)
        img = self._decode(z / self.ld.scale_factor)
        return img * hole + x * (1.0 - hole)

    def _inpaint_conditioned(self, prompts: Sequence[str], init_images, mask,
                             negative_prompt: str | Sequence[str] = "", num_steps: int = 50,
                             guidance_scale: float = 7.5, eta: float = 0.0, seed: int = 0,
                             sampler: str = "ddim", guidance_rescale: float = 0.0,
                             clip_skip: int | None = None) -> np.ndarray:
        x = self._to_model_range(init_images)
        b, h, w = x.shape[:3]
        if len(prompts) != b:
            raise ValueError(f"{len(prompts)} prompts for {b} init images")
        f = self._vae_factor()
        if h % f or w % f:
            raise ValueError(f"init image size must be a multiple of {f}")
        hole = self._normalize_keep_mask(mask, b, h, w)
        gen = torch.Generator(self.device).manual_seed(seed)
        img = self.inpaint_sample(prompts, torch.from_numpy(x), torch.from_numpy(hole),
                                  negative_prompt, num_steps, guidance_scale, eta, sampler,
                                  guidance_rescale, clip_skip, generator=gen)
        out = to_uint8(img)
        # the uint8 composite keeps the kept pixels bit for bit: the [-1, 1]
        # round trip and truncating cast alone move them by ±1; rint recovers
        # the original exactly (its round-trip error is below 0.5)
        orig = np.clip(np.rint((x + 1.0) * 127.5), 0, 255).astype(np.uint8)
        keep = ~hole.astype(bool)
        return np.where(np.broadcast_to(keep, out.shape), orig, out)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """[-1, 1] float images → uint8 (truncating, as the TPU package does)."""
    x = img.float().cpu().numpy()
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)
