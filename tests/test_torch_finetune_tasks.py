"""Textual inversion, DreamBooth and the inpainting trainer against the JAX
package's, on the CPU in fp32 at the smoke configs' widths
(`tests/test_torch_finetune.py` has the helpers and tolerances).

* One step of each task's loss (`textual_inversion_loss`, `dreambooth_loss`,
  `inpaint_loss`: the closures the trainers run) against the same step
  built from `sd_tpu`'s pieces: `patch_embedding_rows` and the text tower
  in the loss; the instance and prior losses summed with the prior weight,
  AdamW; the inpainting model's concat conditioning (`mask_to_latent`, the
  masked image's latent, `get_input` under `hybrid`) with AdamW and the
  learned logvar. t, the noise and the posterior noises injected (the
  masked image's as `concat_enc_noise`), `TOL` / `UPDATE_TOL` as there; each
  JAX program compiles while the next case builds. The UNet and every row of the
  text tower keep their bits and get no `.grad` in the textual-inversion
  step (the placeholder's rows are the trained vectors), the first stage
  and the tower in the others.
* The template captions come from the (seed, 0x7E11) numpy stream, as the
  TPU package draws them.
* Each new config function equals its YAML.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_finetune import (B, as_port, assert_frozen, assert_step_matches, draws,
                                 jax_ld, jax_loss, jax_weights, lower_jax_step, port_stack,
                                 port_step, build_and_run, unet_kwargs, _frozen)
from test_torch_helpers import nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.models.clip_text import ClipTextConfig as JClipConfig
from sd_tpu.models.clip_text import ClipTextTransformer as JClip
from sd_tpu.models.clip_text import SimpleHashTokenizer as JTokenizer
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.train import inpaint as jinpaint
from sd_tpu.train import textual_inversion as jti
from sd_tpu_torch.core import config as port_config
from sd_tpu_torch.models.clip_text import SimpleHashTokenizer
from sd_tpu_torch.train import dreambooth, inpaint, textual_inversion

REPO = Path(__file__).resolve().parent.parent


# -- one step against the JAX package's ---------------------------------------------


def _ti_case():
    cfg = port_config.ti_smoke_config()
    ti = cfg["textual_inversion"]
    ld, unet, vae, embed = port_stack(cfg)
    unet.requires_grad_(False)
    ids = textual_inversion.placeholder_ids(embed.tokenizer, ti["placeholder"], 2)
    (iid,) = textual_inversion.placeholder_ids(embed.tokenizer, ti["initializer"], 1)
    table = embed.clip.token_embedding.weight.detach().clone()
    params = {"vectors": table[int(iid)][None].repeat(2, 1)
              + to_torch(np.random.default_rng(7).normal(0, 0.1, (2, 32)).astype(np.float32))}
    phrase = " ".join(textual_inversion.expand_placeholder(ti["placeholder"], 2))
    texts = textual_inversion.template_captioner(textual_inversion.DEFAULT_TEMPLATES, phrase,
                                                 0)(B)
    txt_ids = torch.from_numpy(embed.tokenizer(texts).astype(np.int64))
    d = draws(5)
    batch = {"image": to_torch(np.random.default_rng(8).uniform(-1, 1, (B, 32, 32, 3))
                               .astype(np.float32)), "txt_ids": txt_ids,
             **{k: to_torch(v) for k, v in d.items()}}
    with torch.no_grad():
        z = ld.encode_first_stage(batch["image"], batch["enc_noise"])
    frozen = _frozen(unet, vae, embed.clip)
    loss_fn = textual_inversion.textual_inversion_loss(ld, embed.clip, ids, params)
    port = port_step(params, loss_fn, batch)
    assert_frozen(frozen, unet, vae, embed.clip)

    uparams, cparams = jax.tree.map(jnp.asarray, jax_weights())
    junet = JUNet(**unet_kwargs(cfg))
    jclip = JClip(JClipConfig(**cfg["cond_stage"]["params"]))
    jld = jax_ld(lambda p, x, t, ctx, y=None: junet.apply({"params": uparams}, x, t, ctx))

    def batch_of(p, b):
        cparams_ = jti.patch_embedding_rows(cparams, ids.astype(np.int32), p["vectors"])
        return {**b, "txt_emb": jclip.apply({"params": cparams_}, b["txt_ids"])}

    jb = {"image": z.numpy(), "txt_ids": txt_ids.numpy().astype(np.int32),
          "t": d["t"].astype(np.int32), "noise": d["noise"]}
    lowered = lower_jax_step(jax_loss(jld, batch_of=batch_of),
                             {"vectors": port[2]["vectors"].numpy()}, jb)
    return port, lowered, {"texts": texts}


def _dreambooth_case():
    cfg = port_config.dreambooth_smoke_config()
    ld, unet, vae, embed = port_stack(cfg)
    db = cfg["dreambooth"]
    inst, prior = embed([db["instance_prompt"]]), embed([db["class_prompt"]])
    rng = np.random.default_rng(9)
    sides = {}
    for k, (name, seed) in enumerate((("instance", 11), ("prior", 21))):
        d = draws(seed)
        d["t"] = np.array([7, 30][::1 - 2 * k], np.int64)
        image = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
        sides[name] = {"image": to_torch(image), **{k_: to_torch(v) for k_, v in d.items()}}
    frozen = _frozen(vae, embed.clip)
    port = port_step(dict(unet.named_parameters()),
                     dreambooth.dreambooth_loss(ld, inst, prior, 0.5), sides,
                     weight_decay=1e-2)
    assert_frozen(frozen, vae, embed.clip)

    junet = JUNet(**unet_kwargs(cfg))
    # both sides call the UNet at the same shapes: one trace serves them
    japply = jax.jit(lambda p, x, t, ctx: junet.apply({"params": p}, x, t, ctx))
    jld = jax_ld(lambda p, x, t, ctx, y=None: japply(p, x, t, ctx))
    side_loss = jax_loss(jld)
    tile = lambda e: jnp.tile(jnp.asarray(e.numpy()), (B, 1, 1))

    def loss_fn(p, b, rng_, logvar):        # sd_tpu/train/dreambooth.py's loss
        li, logs = side_loss(p, {**b["instance"], "txt_emb": tile(inst)}, rng_, logvar)
        lp, _ = side_loss(p, {**b["prior"], "txt_emb": tile(prior)}, rng_, logvar)
        logs = dict(logs)
        logs["prior_loss"] = lp
        logs["instance_loss"] = li
        return li + 0.5 * lp, logs

    jb = {}
    for name, side in sides.items():
        with torch.no_grad():
            z = ld.encode_first_stage(side["image"], side["enc_noise"])
        jb[name] = {"image": z.numpy(), "t": side["t"].numpy().astype(np.int32),
                    "noise": side["noise"].numpy()}
    lowered = lower_jax_step(loss_fn, jax_weights()[0], jb, weight_decay=1e-2)
    return port, lowered, {}


def _inpaint_case():
    cfg = port_config.inpaint_smoke_config()
    ld, unet, vae, embed = port_stack(cfg)
    rng = np.random.default_rng(3)
    image = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    mask = inpaint.random_inpaint_masks(rng, B, 32, 32, full_prob=0.0)
    d = {**draws(4), "concat_enc_noise": nprand(B, 8, 8, 4, seed=9)}
    batch = {"image": to_torch(image), "mask": to_torch(mask),
             "txt_emb": embed(["a photo of a cat", ""]), **{k: to_torch(v) for k, v in d.items()}}
    with torch.no_grad():
        z = ld.encode_first_stage(batch["image"], batch["enc_noise"])
        mz = ld.encode_first_stage(batch["image"] * (1 - batch["mask"]),
                                   batch["concat_enc_noise"])
    frozen = _frozen(vae, embed.clip)
    port = port_step(dict(unet.named_parameters()), inpaint.inpaint_loss(ld, 8, 8), batch,
                     weight_decay=1e-2, learn_logvar=True)
    assert_frozen(frozen, vae, embed.clip)

    junet = JUNet(**unet_kwargs(cfg))
    jld = jax_ld(lambda p, x, t, ctx, y=None: junet.apply({"params": p}, x, t, ctx),
                 key="hybrid")

    def with_concat(p, b):                # sd_tpu/train/inpaint.py inpaint_concat_cond
        mz_ = jld.get_first_stage_encoding(b["masked_z"])
        mlat = jinpaint.mask_to_latent(b["mask"], 8, 8).astype(mz_.dtype)
        return {**b, "concat_cond": jnp.concatenate([mlat, mz_], axis=-1)}

    jb = {"image": z.numpy(), "masked_z": mz.numpy(), "mask": mask,
          "txt_emb": batch["txt_emb"].numpy(), "t": d["t"].astype(np.int32), "noise": d["noise"]}
    lowered = lower_jax_step(jax_loss(jld, batch_of=with_concat), jax_weights(9)[0], jb,
                             weight_decay=1e-2, learn_logvar=True)
    return port, lowered, {}


@pytest.fixture(scope="module")
def steps():
    """Each task's port step and its JAX counterpart, the three JAX programs
    each compiled while the next builds: {name: (port, jax, checks)}."""
    return build_and_run({"dreambooth": _dreambooth_case, "inpaint": _inpaint_case,
                          "ti": _ti_case})


def test_textual_inversion_step_matches(steps):
    port, jout, _ = steps["ti"]
    assert_step_matches(port, jout, lambda tree: {"vectors": np.asarray(tree["vectors"])})


def test_dreambooth_step_matches(steps):
    port, jout, _ = steps["dreambooth"]
    assert set(port[1]) >= {"prior_loss", "instance_loss"}
    assert_step_matches(port, jout, as_port, weight_decay=1e-2)


def test_inpaint_step_matches(steps):
    port, jout, _ = steps["inpaint"]
    assert_step_matches(port, jout, as_port, weight_decay=1e-2, learn_logvar=True)


def test_templates_are_the_numpy_stream(steps):
    """The captions of the template stream: the TPU package's draws from
    (seed, 0x7E11) over its template list, filled with the placeholder's
    words."""
    _, _, checks = steps["ti"]
    assert textual_inversion.DEFAULT_TEMPLATES == jti.DEFAULT_TEMPLATES
    rng = np.random.default_rng((0, 0x7E11))
    phrase = " ".join(jti.expand_placeholder("<thing>", 2))
    want = [jti.DEFAULT_TEMPLATES[rng.integers(len(jti.DEFAULT_TEMPLATES))].format(phrase)
            for _ in range(B)]
    assert checks["texts"] == want
    cap = textual_inversion.template_captioner(jti.DEFAULT_TEMPLATES, phrase, 0)
    rng = np.random.default_rng((0, 0x7E11))
    cap(B)
    assert cap(3) == [jti.DEFAULT_TEMPLATES[rng.integers(10)].format(phrase)
                      for _ in range(B + 3)][B:]
    ids = textual_inversion.placeholder_ids(SimpleHashTokenizer(16, 1000), "<thing>", 2)
    assert ids.tolist() == jti.placeholder_ids(JTokenizer(16, 1000), "<thing>", 2).tolist()


@pytest.mark.parametrize("name,drop", [
    ("controlnet_32_catdog", ("controlnet.base_run", "first_stage.ckpt")),
    ("ip_smoke", ()), ("ti_smoke", ()), ("dreambooth_smoke", ()), ("inpaint_smoke", ())])
def test_fine_tune_configs_are_the_yaml(name, drop):
    """Each config function is its YAML less what a run fills in (the base
    run, the trained first stage); `sd512_inpaint_train_config()` is the
    SD-v1 recipe as the SD-inpainting UNet."""
    with open(REPO / "configs" / f"{name}.yaml") as f:
        want = yaml.safe_load(f)
    for key in drop:
        block, leaf = key.split(".")
        del want[block][leaf]
    fn = {"controlnet_32_catdog": port_config.controlnet_32_config}.get(
        name, getattr(port_config, f"{name}_config", None))
    assert fn() == want
    if name == "inpaint_smoke":
        cfg = port_config.sd512_inpaint_train_config()
        base = port_config.sd512_train_config()
        assert cfg["unet"]["params"] == {**base["unet"]["params"], "in_channels": 9}
        assert (cfg["task"], cfg["latent"]["conditioning_key"]) == ("ldm_inpaint", "hybrid")
        assert cfg["data"]["inpaint"] == port_config.inpaint_128_config()["data"]["inpaint"]
        assert cfg["train"] == base["train"]
