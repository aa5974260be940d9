"""Textual inversion's embedding files and the text encoder's rows.

Counterpart of the helpers of `sd_tpu/train/textual_inversion.py`
(arXiv:2208.01618): a learned concept is `num_vectors` rows of the text
encoder's token-embedding table, assigned to a placeholder token whose
expansion words ('<ph>', '<ph>#1', ...) each map to one token id. The
embedding file is `.safetensors`, {placeholder: [num_vectors, hidden]}
(`save_embedding`); `Text2ImagePipeline.load_textual_inversion` reads it.

`train_textual_inversion` learns the vectors on a folder of the concept's
images: everything but them is frozen (the UNet, the first stage, every
other row of the text encoder), the captions are templates filled with the
placeholder's words (drawn from the (seed, 0x7E11) numpy stream), and the
loss runs the text encoder on a copy of its table with the rows replaced
(`embed_with_rows`, which carries gradients to the vectors, as the TPU
package's `.at[ids].set` does). fp32, as the TPU package trains it.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np
import torch

from sd_tpu_torch.utils.safetensors_io import save_safetensors

# the concept-learning prompt templates of the textual-inversion paper's
# "object" set (trimmed): cycled per image so the vectors, not the prose,
# absorb the concept
DEFAULT_TEMPLATES = (
    "a photo of a {}",
    "a rendering of a {}",
    "a cropped photo of the {}",
    "the photo of a {}",
    "a photo of a clean {}",
    "a dark photo of the {}",
    "a photo of a cool {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a good photo of the {}",
)
TEMPLATE_KEY = 0x7E11          # the template stream, (seed, TEMPLATE_KEY)
VECTOR_KEY = 0x7E57            # the vectors' init without an initializer word


def expand_placeholder(token: str, num_vectors: int) -> list[str]:
    """'<ph>' → ['<ph>', '<ph>#1', ...]: one word per vector."""
    return [token if i == 0 else f"{token}#{i}" for i in range(num_vectors)]


def placeholder_ids(tokenizer, token: str, num_vectors: int) -> np.ndarray:
    """The token id of each expansion word; each word must be one token,
    and the ids distinct."""
    if not hasattr(tokenizer, "encode_chunk"):
        raise ValueError("tokenizer must expose encode_chunk for textual inversion")
    ids = []
    for w in expand_placeholder(token, num_vectors):
        got = list(tokenizer.encode_chunk(w))
        if len(got) != 1:
            raise ValueError(f"placeholder word {w!r} tokenizes to {len(got)} ids; textual "
                             "inversion needs exactly one (use a single-token placeholder "
                             "or the hash tokenizer)")
        ids.append(got[0])
    if len(set(ids)) != len(ids):
        raise ValueError(f"placeholder expansion ids collide: {ids}")
    return np.asarray(ids, np.int64)


@torch.no_grad()
def patch_embedding_rows(clip: torch.nn.Module, ids, vectors) -> None:
    """Set rows `ids` of the text encoder's token-embedding table to
    `vectors` [len(ids), hidden], in place, in the table's dtype."""
    table = clip.token_embedding.weight
    rows = torch.as_tensor(np.asarray(ids, np.int64), device=table.device)
    table[rows] = torch.as_tensor(np.asarray(vectors, np.float32)).to(table)


def save_embedding(path: str, token: str, vectors) -> None:
    """Write {token: vectors} (fp32) as the TPU package's embedding file."""
    vectors = np.asarray(vectors, np.float32)
    save_safetensors(path, {token: vectors},
                     metadata={"sd_tpu": "textual_inversion",
                               "num_vectors": str(vectors.shape[0])})


def embed_with_rows(clip: torch.nn.Module, ids, vectors: torch.Tensor,
                    input_ids: torch.Tensor) -> torch.Tensor:
    """The text encoder's embedding of `input_ids` with rows `ids` of its
    token-embedding table set to `vectors` (cast to the table's dtype) in a
    new table, so gradients reach the vectors; the module's own table is not
    touched (`patch_embedding_rows` writes it, for serving)."""
    table = clip.token_embedding.weight
    rows = torch.as_tensor(np.asarray(ids, np.int64), device=table.device)
    patched = table.detach().index_put((rows,), vectors.to(table.dtype))
    return torch.func.functional_call(clip, {"token_embedding.weight": patched}, (input_ids,))


def textual_inversion_loss(ld, clip: torch.nn.Module, ids, params: dict):
    """The step's `loss_fn(batch, generator, logvar)` over {image, txt_ids,
    ...}: the captions embedded with the rows `ids` set to
    `params["vectors"]`, then the LDM loss with them."""

    def loss_fn(batch, generator, logvar):
        emb = embed_with_rows(clip, ids, params["vectors"], batch["txt_ids"])
        return ld.training_loss({**batch, "txt_emb": emb}, generator, logvar)

    return loss_fn


def template_captioner(templates, phrase: str, seed: int):
    """captions(n): n templates filled with `phrase`, each drawn from the
    (seed, TEMPLATE_KEY) numpy stream."""
    rng = np.random.default_rng((seed, TEMPLATE_KEY))
    return lambda n: [templates[rng.integers(len(templates))].format(phrase) for _ in range(n)]


def train_textual_inversion(config: dict | str, data: str | Iterable[dict],
                            out_dir: str | None = None, max_steps: int | None = None,
                            device=None):
    """Learn placeholder vectors on `data` (see `train/runners.py`). The
    config is an LDM config (`task: textual_inversion`, a fixed scale
    factor) with a block

        textual_inversion:
          placeholder: "<my-cat>"
          num_vectors: 1
          initializer: "cat"        # optional: every vector from this word's row
          templates: [...]          # optional prompt templates
          eval_prompts: [...]       # optional, default 4 × "a photo of a <placeholder>"

    Without an initializer the vectors are 0.01·N(0, 1) from the generator
    of (seed, 0x7E57). The run ends with `embedding.safetensors` (the EMA
    vectors) and `ti.json` ({placeholder, num_vectors, ids}) in `out_dir`.
    The eval samples the eval prompts with the EMA vectors (DDIM,
    `sample.num_steps`, default 20). Returns (state, history)."""
    from sd_tpu_torch.core.config import resolve_device
    from sd_tpu_torch.train.diffusion import (ddpm_optimizer, init_train_state,
                                              make_diffusion_train_step)
    from sd_tpu_torch.train.metrics import count_params
    from sd_tpu_torch.train.runners import (_Batches, _image, _load_cfg, _resume, _run_loop,
                                            build_ldm, ema_eval_params, make_lr,
                                            step_generator)

    cfg = _load_cfg(config)
    tc, ti = cfg["train"], cfg["textual_inversion"]
    token = ti["placeholder"]
    nvec = int(ti.get("num_vectors", 1))
    templates = tuple(ti.get("templates", DEFAULT_TEMPLATES))
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    ld, unet, _, embed = build_ldm(cfg, torch.Generator(device).manual_seed(seed),
                                   device=device)
    if cfg["latent"].get("scale_factor") == "auto":
        raise ValueError("textual_inversion needs a fixed scale_factor "
                         "(run the base LDM training first)")
    unet.requires_grad_(False)
    clip, tokenizer = embed.clip, embed.tokenizer
    ids = placeholder_ids(tokenizer, token, nvec)
    table = clip.token_embedding.weight.detach()
    init_word = ti.get("initializer")
    if init_word:
        (iid,) = placeholder_ids(tokenizer, init_word, 1)
        vecs = table[int(iid)][None].float().repeat(nvec, 1)
    else:
        vecs = 0.01 * torch.randn((nvec, table.shape[1]), device=device,
                                  generator=step_generator(device, seed, VECTOR_KEY))
    params = {"vectors": vecs.clone()}
    phrase = " ".join(expand_placeholder(token, nvec))
    print(f"[ti] {token} x{nvec} vectors ({table.shape[1]}d); frozen: unet "
          f"{count_params(unet) / 1e6:.1f}M + clip {count_params(clip) / 1e6:.1f}M")

    loss_fn = textual_inversion_loss(ld, clip, ids, params)
    captions = template_captioner(templates, phrase, seed)

    def embed_batch(batch):
        ids_ = tokenizer(captions(len(batch["image"]))).astype(np.int64)
        return {"image": _image(batch, device), "txt_ids": torch.from_numpy(ids_).to(device)}

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0))
    state, start = _resume(out_dir, lambda: init_train_state(params, opt,
                                                             tc.get("ema_decay", 0.9999)))
    step_fn = make_diffusion_train_step(loss_fn, opt)
    lat = cfg["latent"]
    eval_prompts = [t.replace(token, phrase) for t in
                    ti.get("eval_prompts", [f"a photo of a {token}"] * 4)]

    def sampler(st, generator):
        etexts = torch.from_numpy(tokenizer(eval_prompts).astype(np.int64)).to(device)
        emb = embed_with_rows(clip, ids, ema_eval_params(st)["vectors"], etexts)
        shape = (len(eval_prompts), lat["image_size"], lat["image_size"], lat["channels"])
        x_T = torch.randn(shape, generator=generator, device=device)
        z = ld.sample(shape, x_T, cond={"c_crossattn": [emb]},
                      num_steps=cfg.get("sample", {}).get("num_steps", 20),
                      generator=generator, decode=False)
        return ld.decode_first_stage(z)

    history = _run_loop(lambda st, b, g: step_fn(st, embed_batch(b), g), state, cfg,
                        _Batches(data, cfg), out_dir, start, seed=seed, device=device,
                        max_steps=max_steps, sampler=sampler)
    if out_dir:
        final = ema_eval_params(state)["vectors"].detach().float().cpu().numpy()
        save_embedding(os.path.join(out_dir, "embedding.safetensors"), token, final)
        with open(os.path.join(out_dir, "ti.json"), "w") as f:
            json.dump({"placeholder": token, "num_vectors": nvec, "ids": ids.tolist()}, f)
    return state, history
