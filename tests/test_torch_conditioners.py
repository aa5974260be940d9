"""The port's class, text and spatial conditioners
(`sd_tpu_torch/models/conditioners.py`) and the BERT-conditioned slice
against the JAX package's, on the CPU in fp32 at tiny widths.

Modules (the same seeded inputs, every parameter random and carried over by
`load_flax_params`), within 1e-5·max(1, max|ref|) (`TOL`): `ClassEmbedder`
(labels and a batch dict), `TransformerEmbedder`, `BERTEmbedder` (32 wide,
2 layers), `SpatialRescaler` under each method (nearest, bilinear, bicubic;
down, up and two stages; with the 1×1 channel mapper), `HybridConditioner`,
and `resize_weights("nearest")` against `jax.image.resize`. The hash
tokenizer's ids are the JAX package's bit for bit, with the JAX package's
tokenizer on its hash path. The BERT slice: tokens → `BERTEmbedder` →
`LatentDiffusion(crossattn, cond_fn)` → 4 DDIM steps with CFG 5.0 against
the embedding of "" → KL decode, within 1e-4·max|ref| (`SLICE_TOL`); and
`get_input`'s `txt_raw` branch through `cond_fn`. (Four steps: with T =
1000 the "uniform" striding of three steps would index t = 1000, past the
table, in both packages.)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import (COMPILE_OPTIONS, assert_close, flax_init, init_shapes, nprand,
                                port, to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_VAE

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion import ddpm as jddpm
from sd_tpu.diffusion.latent import LatentDiffusion as JLatentDiffusion
from sd_tpu.models import conditioners as jcond
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.models import conditioners as cond
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.unet_sd import UNetModel

TOL = 1e-5
SLICE_TOL = 1e-4
BERT = dict(n_embed=32, n_layer=2, max_seq_len=16)
UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4, context_dim=32)
PROMPTS = ["a painting of a virus monster playing guitar", "a red cube"]


def run_both(jmod, tmod, *args, seed: int = 0):
    """(port output, JAX output) of the modules on numpy args with the same
    random weights (a module without parameters has none)."""
    jargs = [jnp.asarray(a) for a in args]
    has = "params" in init_shapes(jmod, *jargs)
    params = flax_init(jmod, *jargs, seed=seed) if has else {}
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, *jargs)
    with torch.no_grad():
        got = port(tmod, params)(*[torch.from_numpy(np.asarray(a)) for a in args])
    return got, ref


# -- the conditioners -------------------------------------------------------------------


def test_class_embedder_matches():
    labels = np.array([[3], [999], [0]], np.int32)
    tmod = cond.ClassEmbedder(16, device="cpu")
    got, ref = run_both(jcond.ClassEmbedder(embed_dim=16), tmod, labels, seed=1)
    assert got.shape == (3, 16)
    assert_close(got, ref, TOL)
    with torch.no_grad():
        assert torch.equal(tmod({"class_label": torch.from_numpy(labels)}), got)


@pytest.mark.parametrize("kind", ["transformer", "bert"])
def test_text_embedders_match(kind):
    tokens = np.random.default_rng(2).integers(0, 100, (2, 16)).astype(np.int32)
    if kind == "transformer":
        jmod = jcond.TransformerEmbedder(n_embed=32, n_layer=2, vocab_size=100, max_seq_len=16)
        tmod = cond.TransformerEmbedder(32, 2, 100, 16, device="cpu")
    else:
        jmod = jcond.BERTEmbedder(vocab_size=100, **BERT)
        tmod = cond.BERTEmbedder(vocab_size=100, **BERT, device="cpu")
    got, ref = run_both(jmod, tmod, tokens, seed=3)
    assert got.shape == (2, 16, 32)
    assert_close(got, ref, TOL)


def test_hash_tokenizer_ids_are_the_jax_packages():
    texts = [*PROMPTS, "", "A  Mixed-CASE prompt, with punctuation!",
             " ".join(f"w{i}" for i in range(40))]
    jtok = jcond.BERTTokenizerHost(max_length=16)
    assert jtok._tok is None, "the JAX package's tokenizer took the Hugging Face path"
    tok = cond.BERTTokenizerHost(max_length=16)
    assert tok._tok is None
    ids = tok.tokenize(texts)
    np.testing.assert_array_equal(ids, jtok.tokenize(texts))
    assert ids.dtype == np.int32 and ids.shape == (5, 16)
    assert ids[2, 0] == 101 and ids[2, 1] == 102 and not ids[2, 2:].any()
    assert ids[4, -1] == 102                               # truncated to max_length
    _, _, (_, _, via_call) = tok(texts)
    np.testing.assert_array_equal(via_call, ids)
    np.testing.assert_array_equal(cond.BERTTokenizerHost(16, vq_interface=False)(texts), ids)


RESCALES = {
    "nearest_down": dict(method="nearest", multiplier=0.5),
    "nearest_up": dict(method="nearest", multiplier=1.5),
    "bilinear_two_stages": dict(method="bilinear", n_stages=2, multiplier=0.6),
    "bicubic_mapped": dict(method="bicubic", multiplier=0.75, out_channels=5, bias=True),
}


@pytest.mark.parametrize("case", list(RESCALES))
def test_spatial_rescaler_matches(case):
    x = nprand(2, 12, 10, 3, seed=4)
    opts = RESCALES[case]
    got, ref = run_both(jcond.SpatialRescaler(**opts),
                        cond.SpatialRescaler(**opts, device="cpu"), x, seed=5)
    assert_close(got, ref, TOL)


def test_nearest_resize_weights_pick_jax_pixels():
    x = nprand(1, 7, 13, 2, seed=6)
    for h, w in ((3, 5), (11, 20), (7, 6)):
        ref = jax.image.resize(jnp.asarray(x), (1, h, w, 2), "nearest")
        np.testing.assert_array_equal(cond.float_resize(to_torch(x), h, w, "nearest").numpy(),
                                      np.asarray(ref))
    with pytest.raises(ValueError, match="resize method"):
        cond.SpatialRescaler(method="area", device="cpu")


def test_hybrid_conditioner_matches():
    x = nprand(2, 8, 8, 3, seed=7)
    labels = np.array([1, 4], np.int32)
    jmod = jcond.HybridConditioner(jcond.SpatialRescaler(out_channels=4),
                                   jcond.ClassEmbedder(embed_dim=8, n_classes=6))
    tmod = cond.HybridConditioner(cond.SpatialRescaler(out_channels=4, device="cpu"),
                                  cond.ClassEmbedder(8, 6, device="cpu"))
    params = flax_init(jmod, jnp.asarray(x), jnp.asarray(labels), seed=8)
    ref = jax.jit(lambda p, a, b: jmod.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(labels))
    with torch.no_grad():
        got = port(tmod, params)(to_torch(x), torch.from_numpy(labels))
    assert sorted(got) == sorted(ref) == ["c_concat", "c_crossattn"]
    for key in got:
        assert_close(got[key][0], ref[key][0], TOL)


# -- the BERT-conditioned slice -----------------------------------------------------------


def _bert_stack():
    """The JAX package's tiny BERT, UNet (context 32) and KL first stage with
    random weights, and the port's with the same."""
    bert, unet = jcond.BERTEmbedder(**BERT), JUNet(**UNET)
    vae = JAutoencoderKL(**TINY_VAE)
    trees = (flax_init(bert, jnp.zeros((1, 16), jnp.int32), seed=10),
             flax_init(unet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 16, 32)), seed=11),
             flax_init(vae, jnp.zeros((1, 16, 16, 3)), seed=12))
    mods = (port(cond.BERTEmbedder(**BERT, device="cpu"), trees[0]),
            port(UNetModel(**UNET, device="cpu"), trees[1]),
            port(AutoencoderKL(**TINY_VAE, device="cpu"), trees[2]))
    return (bert, unet, vae), trees, mods


def test_bert_conditioned_slice_matches():
    (jbert, junet, jvae), (btree, utree, vtree), (bert, unet, vae) = _bert_stack()
    tok = cond.BERTTokenizerHost(max_length=16)
    tokens, empty = tok.tokenize(PROMPTS), tok.tokenize([""] * 2)
    x_T = nprand(2, 8, 8, 4, seed=13)

    jld = JLatentDiffusion(
        process=jddpm.DDPMProcess(JSchedule.create(1000, "linear", 0.00085, 0.012)),
        unet_apply=lambda p, x, t, ctx, y=None: junet.apply({"params": p}, x, t, ctx),
        decode_fn=lambda z: jvae.apply({"params": vtree}, z, method=JAutoencoderKL.decode),
        cond_fn=lambda t: jbert.apply({"params": btree}, t), conditioning_key="crossattn")

    def jax_sample(p, tk, em, xt):
        c = {"c_crossattn": [jld.get_learned_conditioning(tk)]}
        uc = {"c_crossattn": [jld.get_learned_conditioning(em)]}
        return jld.sample(p, jax.random.PRNGKey(0), x_T.shape, cond=c, uncond=uc,
                          guidance_scale=5.0, num_steps=4, eta=0.0, sampler="ddim", x_T=xt)

    args = (utree, jnp.asarray(tokens), jnp.asarray(empty), jnp.asarray(x_T))
    ref = np.asarray(jax.jit(jax_sample).lower(*args).compile(
        compiler_options=COMPILE_OPTIONS)(*args))

    ld = LatentDiffusion(
        process=DDPMProcess(DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)),
        unet_apply=unet, decode_fn=vae.decode, cond_fn=bert, conditioning_key="crossattn")
    with torch.no_grad():
        c = {"c_crossattn": [ld.get_learned_conditioning(torch.from_numpy(tokens))]}
        uc = {"c_crossattn": [ld.get_learned_conditioning(torch.from_numpy(empty))]}
        got = ld.sample(x_T.shape, to_torch(x_T), c, uc, guidance_scale=5.0, num_steps=4)
    assert got.shape == ref.shape == (2, 16, 16, 3)
    assert float(np.max(np.abs(got.numpy() - ref))) <= SLICE_TOL * float(np.max(np.abs(ref)))

    # get_input's txt_raw branch: the conditioner on the raw tokens (frozen: no gradient)
    image = nprand(2, 8, 8, 4, seed=14)
    ld_enc = dataclasses.replace(ld, encode_fn=lambda x: x)
    jld_enc = dataclasses.replace(jld, encode_fn=lambda x, r: x)
    jz, jc = jax.jit(lambda b: jld_enc.get_input(b, jax.random.PRNGKey(0)))(
        {"image": jnp.asarray(image), "txt_raw": jnp.asarray(tokens)})
    raw = {"image": to_torch(image), "txt_raw": torch.from_numpy(tokens)}
    with torch.enable_grad():
        z, c = ld_enc.get_input(raw)
    assert not c["c_crossattn"][0].requires_grad
    assert_close(z, jz, TOL)
    assert_close(c["c_crossattn"][0], jc["c_crossattn"][0], TOL)
    with pytest.raises(ValueError, match="cond_fn"):
        dataclasses.replace(ld, cond_fn=None).get_learned_conditioning(raw["txt_raw"])
