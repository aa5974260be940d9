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
  * `set_unet_options` (ToMe, FreeU) and `load_textual_inversion`;
  * `shard_for_serving(mesh)`: serving over the ranks of a process group
    (`parallel/mesh.py`): `generate` gives each rank of the "data" axis its
    rows of the prompt batch (every draw the whole batch's, its rows kept)
    and gathers the images on every rank; a "model" axis splits the UNet's
    attention and feed-forward by `TP_RULES_UNET`. Every rank calls
    `generate` with the same arguments (`serve.py --shard` broadcasts them);
    the first stage and the text encoder are whole on every rank;
  * weights in and out: `from_sd_checkpoint` (an SD-v1 `.ckpt` or
    `.safetensors`: UNet and first stage), `to_sd_checkpoint`, `from_run`
    (a `train_ldm` run, a flow model's included, or a consistency-distilled
    student, served with `sampler="lcm"`);
  * adapters: `load_lora` (merged into the UNet), `load_controlnet` and
    `generate(control_image=…)`, `load_ip_adapter` and
    `generate(ip_image=…)`; `generate(sag_scale=…)` (Self-Attention
    Guidance, DDIM only). The TPU package's combination rules hold:
    `sag_scale` or `ip_image` with `control_image` raise ValueError;
    `sag_scale` with `ip_image`, which the TPU package fails inside its
    probe pass, raises ValueError before any work.
Dtype policy (the TPU benchmark's): UNet, VAE and CLIP parameters and
compute in bf16, the latent cast to bf16 at each UNet call, the sampler
state and update in fp32, z / scale_factor cast to bf16 before decode, the
image cast to bf16 before encode and the latent taken back in fp32.

Random draws come from one `torch.Generator` seeded with `seed`; each draw
can be handed in instead (`noise=`, `x_T`, `enc_noise`, ...), so a test can
give the port and the TPU package the same numbers.

Weights are random from a seed (`init_params_`), the first stage's trained
where the config's `first_stage.ckpt` names a KL or VQ run's checkpoint;
`from_run` loads a `train_ldm` run and `from_sd_checkpoint` an SD-v1
checkpoint. No state of the pipeline depends on the weights beyond the
modules themselves, so loading an adapter needs no cache reset.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from sd_tpu_torch.core.config import resolve_device, split_dtype
from sd_tpu_torch.data.image_io import resize
from sd_tpu_torch.diffusion.ddim import DDIMSampler
from sd_tpu_torch.diffusion.guidance import NoiseFn
from sd_tpu_torch.diffusion.latent import LatentDiffusion, patched_apply
from sd_tpu_torch.diffusion.sag import make_probs_apply
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.conditioners import FrozenClipImageEmbedder
from sd_tpu_torch.models.controlnet import controlled_apply_fn, controlnet_from_unet_config
from sd_tpu_torch.models.ip_adapter import ip_apply_fn, nest_ip
from sd_tpu_torch.models.sd_export import export_sd_unet, export_sd_vae, save_sd_checkpoint
from sd_tpu_torch.models.sd_import import import_sd_unet, import_sd_vae, load_sd_checkpoint
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.utils.prompt_weights import (apply_prompt_weights, parse_weighted_prompt,
                                               tokenize_weighted)
from sd_tpu_torch.train import checkpoint
from sd_tpu_torch.train.checkpoint import trained_weights
from sd_tpu_torch.train.lora import load_lora_safetensors, merge_lora, nest_lora
from sd_tpu_torch.train.runners import (build_first_stage, build_process, copy_named_,
                                        first_stage_factor, first_stage_fns)
from sd_tpu_torch.train.textual_inversion import (expand_placeholder, patch_embedding_rows,
                                                  placeholder_ids)
from sd_tpu_torch.utils.safetensors_io import load_safetensors
from sd_tpu_torch.utils.watermark import embed_watermark, str_to_bits
from sd_tpu_torch.weights import init_params_, load_flax_params


def load_weights_(module: torch.nn.Module, tree: dict, what: str) -> None:
    """Fill `module` from `tree`, in place and strictly: a flat {parameter
    name: tensor} (the port's checkpoints), else a param tree in the TPU
    package's flax layout (nested dicts, `kernel`s [in, out])."""
    own = dict(module.named_parameters())
    if set(tree) == set(own):
        copy_named_(own, tree, what)
    else:
        load_flax_params(module, tree)


def _tree_to(tree, dtype: torch.dtype, device):
    """Every floating tensor (or array) of a nested dict in `dtype` on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dtype, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device, dtype) if t.is_floating_point() else t.to(device)


class Text2ImagePipeline:
    def __init__(self, cfg: dict, device=None,
                 param_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = param_dtype
        kw = dict(dtype=param_dtype, device=self.device)
        gen = torch.Generator(self.device).manual_seed(cfg.get("seed", 0))
        # the config's pinned `dtype` is the UNet's compute dtype, as in the
        # TPU package (none pins one: it computes in `param_dtype`)
        ucfg, compute = split_dtype(cfg["unet"]["params"])
        self.unet = UNetModel(**ucfg, compute_dtype=compute, **kw).eval()
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
        self.controlnet, self.control_scale = None, 1.0           # load_controlnet
        self.ip_params, self.ip_scale, self.ip_embedder = None, 1.0, None  # load_ip_adapter
        self.mesh, self._unet_split = None, {}                    # shard_for_serving
        lat = cfg["latent"]
        self.ld = LatentDiffusion(
            # the process `build_ldm` builds (a DDPM schedule, x0 unclamped,
            # or the rectified-flow objective)
            process=build_process(cfg),
            unet_apply=self._in_dtype(self.unet),
            unet_apply_probs=self._in_dtype(make_probs_apply(self.unet)),
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
        """The pipeline of a `train_ldm` or `distill_ldm` run (`python -m
        sd_tpu_torch.train`'s output directory; a distill run's EMA is the
        student's target network): the UNet's EMA weights (else its parameters) from
        the run's latest checkpoint, read on the CPU from the mapped file,
        the first stage from the config's `first_stage.ckpt`, and the
        `calibration.json` scale factor under `scale_factor: auto`; every
        weight in `param_dtype` (None: fp32). A run that trained the text
        encoder with the UNet ({unet, cond}) is refused, as the TPU
        package cannot serve it either. The TPU package builds the
        pipeline in fp32 and casts it; the port builds it in `param_dtype`
        (its random draws are fp32, rounded once), which gives the same bits."""
        from sd_tpu_torch.core.config import load_config
        from sd_tpu_torch.train.runners import apply_calibration

        cfg = copy.deepcopy(config) if isinstance(config, dict) else load_config(config)
        ckpt_dir = os.path.join(run_dir, "ckpt")
        weights = trained_weights(checkpoint.restore_tree(ckpt_dir))
        if any(n.startswith("cond.") for n in weights):
            # the TPU package's from_run cannot serve this tree either
            raise ValueError(f"{ckpt_dir} holds a {{unet, cond}} tree (the text encoder was "
                             "trained with the UNet, cond_stage.trainable); from_run serves "
                             "a run that trained the UNet alone")
        pipe = cls(cfg, device=device, param_dtype=param_dtype or torch.float32)
        copy_named_(dict(pipe.unet.named_parameters()), weights, f"UNet of {ckpt_dir}")
        pipe.ld = apply_calibration(pipe.ld, cfg, ckpt_dir)
        return pipe

    @classmethod
    def from_sd_checkpoint(cls, config: dict | str, ckpt_path: str,
                           param_dtype: torch.dtype | None = torch.bfloat16,
                           device=None) -> "Text2ImagePipeline":
        """The pipeline of `config` with its UNet and first stage from a
        Stable-Diffusion v1 `.ckpt` or `.safetensors` (`models/sd_import.py`;
        the config must match the checkpoint), read on the CPU in fp32 and
        copied into weights of `param_dtype` (None: fp32). The text encoder
        stays as built: its Hugging Face weights load apart
        (`models/clip_text.py import_torch_clip_text`)."""
        from sd_tpu_torch.core.config import load_config

        cfg = copy.deepcopy(config) if isinstance(config, dict) else load_config(config)
        pipe = cls(cfg, device=device, param_dtype=param_dtype or torch.float32)
        sd = load_sd_checkpoint(ckpt_path)
        import_sd_unet(pipe.unet, sd, **pipe._unet_walk())
        import_sd_vae(pipe.vae, sd, **pipe._vae_walk())
        return pipe

    def _unet_walk(self) -> dict:
        u = self.unet
        return dict(channel_mult=u.channel_mult, num_res_blocks=u.num_res_blocks,
                    attention_resolutions=u.attention_resolutions,
                    transformer_depth=u.transformer_depth)

    def _vae_walk(self) -> dict:
        v = self.vae
        return dict(ch_mult=v.ch_mult, num_res_blocks=v.num_res_blocks,
                    attn_resolutions=v.attn_resolutions, resolution=v.resolution)

    def to_sd_checkpoint(self, path: str, half: bool = False) -> None:
        """The UNet and first stage as a Stable-Diffusion v1 checkpoint
        (`.safetensors`, else a torch `.ckpt` {"state_dict": ...}; fp16 with
        `half`): the inverse of `from_sd_checkpoint`."""
        sd = export_sd_unet(self.unet, **self._unet_walk())
        sd.update(export_sd_vae(self.vae, **self._vae_walk()))
        save_sd_checkpoint(path, sd, half=half)

    def _in_dtype(self, apply):
        """A UNet apply that sees the latent in the weights' dtype."""
        return lambda x, t, ctx, **kw: apply(x.to(self.dtype), t, ctx, **kw)

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
        f_vae = self._vae_factor()
        f_unet = 2 ** (len(self.cfg["unet"]["params"].get("channel_mult", (1, 2, 4, 4))) - 1)
        f = f_vae * f_unet
        height = height if height is not None else lat["image_size"] * f_vae
        width = width if width is not None else lat["image_size"] * f_vae
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of {f} "
                             f"(VAE f{f_vae} × UNet {f_unet}-level downsampling)")
        return height // f_vae, width // f_vae

    def _vae_factor(self) -> int:
        return first_stage_factor(self.cfg["first_stage"])

    # -- options, adapters ----------------------------------------------------------

    def set_unet_options(self, **updates) -> None:
        """Swap the UNet's parameter-free serving options: `tome_ratio`,
        `tome_min_tokens` (ToMe, `nn/tome.py`) and `freeu` ((b1, b2, s1,
        s2), arXiv:2309.11497; None turns it off). The weights are untouched;
        the next call runs with the options.

            pipe.set_unet_options(tome_ratio=0.5, freeu=(1.2, 1.4, 0.9, 0.2))
        """
        self.unet.set_options(**updates)

    def load_lora(self, lora, scale: float = 1.0) -> None:
        """LoRA factors merged into the UNet's weights, in place
        (`train/lora.py`): a factor tree, a `.safetensors` LoRA file, or a
        checkpoint directory (its EMA shadow where it keeps one). The
        factors are cast to the weights' dtype first, as the TPU package
        casts them."""
        if isinstance(lora, str) and lora.endswith(".safetensors"):
            lora = load_lora_safetensors(lora)
        elif isinstance(lora, str):
            lora = nest_lora(trained_weights(checkpoint.restore_tree(lora)))
        merged = merge_lora(self.unet, _tree_to(lora, self.dtype, self.device), scale)
        with torch.no_grad():
            for name, p in self.unet.named_parameters():
                if merged[name] is not p:
                    p.copy_(merged[name])

    def load_controlnet(self, source, control_scale: float = 1.0) -> None:
        """A ControlNet branch (`models/controlnet.py`, arXiv:2302.05543) for
        `generate(control_image=…)`: `source` is a run directory (its
        `ckpt/`), a checkpoint directory (EMA weights preferred), or a tree
        — the branch's parameters by name, or the TPU package's flax tree.
        Calls without a control image are unchanged."""
        f_vae = self._vae_factor()
        cn = controlnet_from_unet_config(self.cfg["unet"]["params"],
                                         hint_downsamples=f_vae.bit_length() - 1,
                                         dtype=self.dtype, device=self.device).eval()
        what = "ControlNet"
        if isinstance(source, str):
            if os.path.isdir(os.path.join(source, "ckpt")):
                source = os.path.join(source, "ckpt")
            what = f"ControlNet of {source}"
            source = trained_weights(checkpoint.restore_tree(source))
        load_weights_(cn, source, what)
        self.controlnet, self.control_scale = cn, float(control_scale)

    def load_ip_adapter(self, run_dir: str, ip_scale: float = 1.0) -> None:
        """An IP-Adapter (`models/ip_adapter.py`, arXiv:2308.06721) for
        `generate(ip_image=…)`: the adapter tree from `run_dir/ckpt` (EMA
        preferred) in the weights' dtype, and the frozen image embedder
        (`FrozenClipImageEmbedder`, fp32) from `run_dir/ip_embedder`, by
        parameter name or as the TPU package's flax tree. Calls without an
        image are unchanged."""
        ip = nest_ip(trained_weights(checkpoint.restore_tree(os.path.join(run_dir, "ckpt"))))
        embedder = FrozenClipImageEmbedder(device=self.device).eval()
        load_weights_(embedder, checkpoint.restore_tree(os.path.join(run_dir, "ip_embedder")),
                      f"image embedder of {run_dir}")
        self.ip_params = _tree_to(ip, self.dtype, self.device)
        self.ip_scale, self.ip_embedder = float(ip_scale), embedder

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

    # -- serving over a process group ----------------------------------------------

    def shard_for_serving(self, mesh=None) -> None:
        """Serve over a mesh of the process group's ranks (default every
        rank on "data"): `generate`'s prompt batch splits by rows over the
        "data" axis (a batch must divide it), and a "model" axis of more than
        one rank splits the UNet in place by `TP_RULES_UNET` (`shard_module_`:
        each rank keeps its piece of the attention and feed-forward weights
        and attends over its heads). The text encoder and the first stage stay
        whole on every rank, as the TPU package replicates them; a textual
        inversion loaded later patches every rank's encoder, which is its
        reload there. A split UNet cannot be split again."""
        from sd_tpu_torch.parallel import mesh as pm

        if self._unet_split:
            raise ValueError("shard_for_serving: the UNet is already split over a model axis; "
                             "build a new pipeline for another mesh")
        self.mesh = mesh if mesh is not None else pm.make_mesh()
        self._unet_split = pm.shard_module_(self.unet, self.mesh, pm.TP_RULES_UNET)

    def _data_rows(self, batch: int) -> np.ndarray | None:
        """This rank's rows of a prompt batch over the mesh's "data" axis
        (None without a mesh); raises where the batch does not divide it."""
        if self.mesh is None:
            return None
        n = self.mesh.size("data")
        if batch % n:
            raise ValueError(f"batch {batch} must divide the data axis ({n})")
        per, r = batch // n, self.mesh.index("data")
        return np.arange(r * per, (r + 1) * per)

    def _gather_rows(self, images: np.ndarray) -> np.ndarray:
        """Every data rank's uint8 images, in row order, on every rank."""
        from sd_tpu_torch.parallel.mesh import all_gather_flat

        t = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        every = all_gather_flat(t.reshape(-1), self.mesh.group("data"))
        return every.view(-1, *images.shape[1:]).cpu().numpy()

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
               decode_tile: int | None = None, control: torch.Tensor | None = None,
               ip_embed: torch.Tensor | None = None) -> torch.Tensor:
        """Prompts and initial noise x_T [B, h, w, 4] → decoded images
        [B, 8h, 8w, 3] in the model dtype, range about [-1, 1];
        `decode_tile` in latent units (`_decode`). `control`: ControlNet's
        hint [B, H, W, C] (`control_hint`), on both CFG branches; `ip_embed`:
        the image embedding [B, 512] (`embed_ip_image`), the unconditional
        branch taking zeros (the adapter's image-free state)."""
        c, uc = self.encode_prompts(prompts, negative_prompt, clip_skip)
        cond, uncond = {"c_crossattn": [c]}, {"c_crossattn": [uc]}
        ld = self.ld
        if control is not None:
            ld = dataclasses.replace(ld, unet_apply=self._in_dtype(
                controlled_apply_fn(self.unet, self.controlnet, self.control_scale)))
            cond["c_control"] = uncond["c_control"] = control.to(self.device)
        if ip_embed is not None:
            ld = dataclasses.replace(ld, unet_apply=self._in_dtype(
                ip_apply_fn(self.unet, self.ip_params, self.ip_scale)))
            cond["c_ip"] = ip_embed.to(self.device)
            uncond["c_ip"] = torch.zeros_like(cond["c_ip"])
        z = ld.sample(
            tuple(x_T.shape), x_T.float(), cond=cond, uncond=uncond,
            guidance_scale=guidance_scale, num_steps=num_steps, eta=eta, generator=generator,
            sampler=sampler, guidance_rescale=guidance_rescale, sag_scale=sag_scale,
            noise=noise, decode=False)
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
        dpm_sde, unipc, plms, euler, euler_a, heun or ddpm; lcm for a
        consistency-distilled student (2–4 steps, `guidance_scale` 1: the
        guidance was baked in at distillation); flow or flow_midpoint for a
        flow model, which takes no other; `height` /
        `width` in pixels (multiples of 64 for SD-v1; default the config's
        square size); `clip_skip` conditions on an earlier CLIP hidden state;
        prompts may carry `(emphasis)` / `(word:1.3)` / `[de-emphasis]`;
        `decode_tile` (pixels, e.g. 512) decodes in overlapping tiles,
        bounding the decoder's memory at any size; `watermark` embeds a
        blind DCT mark (utils/watermark.py) in every image. The noise x_T
        and every stochastic sampler's draws come from one torch.Generator
        seeded with `seed`. `control_image` (after `load_controlnet`): the
        hint at the output's pixel size, [B or none, H, W, C] uint8 or float
        in [0, 1] (e.g. `data/hints.py edge_hint`); `ip_image` (after
        `load_ip_adapter`): the image prompt, uint8 or float in [-1, 1];
        `sag_scale`: Self-Attention Guidance (typical 0.5–0.75; one more UNet
        call a step; ddim only)."""
        if sag_scale > 0.0 and control_image is not None:
            raise ValueError("sag_scale and control_image cannot combine: "
                             "the SAG probe pass has no control branch")
        if ip_image is not None and control_image is not None:
            raise ValueError("ip_image and control_image cannot combine "
                             "(one params wrapper each); pick one")
        if sag_scale > 0.0 and ip_image is not None:
            raise ValueError("sag_scale and ip_image cannot combine: "
                             "the SAG probe pass has no IP-Adapter payload")
        rows = self._data_rows(len(prompts))
        if self._unet_split and sag_scale > 0.0:
            raise ValueError("sag_scale over a split UNet: its probe reads every head")
        ip_embed = None if ip_image is None else self.embed_ip_image(ip_image, len(prompts))
        hint = (None if control_image is None
                else self.control_hint(control_image, len(prompts), height, width))
        h, w = self.latent_hw(height, width)
        gen = torch.Generator(self.device).manual_seed(seed)
        x_T = torch.randn((len(prompts), h, w, self.cfg["latent"]["channels"]),
                          generator=gen, device=self.device, dtype=torch.float32)
        batch_rows = contextlib.nullcontext()
        if rows is not None:
            # this rank's rows; the sampler's draws the whole batch's, these rows kept
            from sd_tpu_torch.parallel.mesh import batch_rows as rows_context

            if not isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt[i] for i in rows]
            prompts, x_T = [prompts[i] for i in rows], x_T[rows[0]:rows[-1] + 1]
            if hint is not None and hint.shape[0] > 1:
                hint = hint[rows[0]:rows[-1] + 1]
            ip_embed = None if ip_embed is None else ip_embed[rows[0]:rows[-1] + 1]
            batch_rows = rows_context(rows, len(rows) * self.mesh.size("data"))
        with batch_rows:
            img = self.sample(prompts, x_T, negative_prompt, num_steps, guidance_scale, eta,
                              generator=gen, sampler=sampler, guidance_rescale=guidance_rescale,
                              clip_skip=clip_skip, sag_scale=sag_scale,
                              decode_tile=self._latent_tile(decode_tile), control=hint,
                              ip_embed=ip_embed)
        out = to_uint8(img)
        if rows is not None:
            out = self._gather_rows(out)
        if watermark is not None:
            bits = str_to_bits(watermark, watermark_bits)
            out = np.stack([embed_watermark(o, bits, key=watermark_key) for o in out])
        return out

    @torch.no_grad()
    def embed_ip_image(self, ip_image, batch: int) -> torch.Tensor:
        """The loaded image embedder's embedding [batch, 512] of an image
        prompt ([H, W, 3] or [1 or batch, H, W, 3], uint8 or float in [-1,
        1]), in the weights' dtype."""
        if self.ip_params is None:
            raise ValueError("call load_ip_adapter() before passing ip_image")
        x = self._to_model_range(ip_image)
        if x.ndim == 3:
            x = x[None]
        if x.shape[0] == 1 and batch > 1:
            x = np.broadcast_to(x, (batch,) + x.shape[1:])
        return self.ip_embedder(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                                ).to(self.dtype)

    def control_hint(self, control_image, batch: int, height: int | None = None,
                     width: int | None = None) -> torch.Tensor:
        """A control image as ControlNet's hint: float32 [batch, H, W, C] on the
        device (uint8 / 255; one image broadcast over the batch), checked
        against the output's pixel size."""
        if self.controlnet is None:
            raise ValueError("call load_controlnet() before passing control_image")
        hint = np.asarray(control_image)
        hint = (hint.astype(np.float32) / 255.0 if hint.dtype == np.uint8
                else hint.astype(np.float32))
        if hint.ndim == 3:
            hint = np.broadcast_to(hint[None], (batch,) + hint.shape)
        lh, lw = self.latent_hw(height, width)
        f = self._vae_factor()
        if hint.shape[1:3] != (lh * f, lw * f):
            raise ValueError(f"control_image must be {(lh * f, lw * f)} pixels, "
                             f"got {hint.shape[1:3]}")
        return torch.from_numpy(np.ascontiguousarray(hint)).to(self.device)

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
