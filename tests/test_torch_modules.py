"""Each ported module against its JAX counterpart, in fp32 on the CPU.

Schedules and token ids must match exactly; modules within
1e-4·max(1, max|ref|), with every parameter random and carried across by
`load_flax_params`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import assert_close, flax_init, nprand, port, to_torch

from sd_tpu.core import distributions as jdist
from sd_tpu.core import schedules as jsched
from sd_tpu.diffusion import ddim as jddim
from sd_tpu.diffusion import guidance as jguid
from sd_tpu.models import clip_text as jclip
from sd_tpu.nn import attention as jattn
from sd_tpu.nn import layers as jlayers
from sd_tpu.nn import resnet as jresnet
from sd_tpu.nn import updown as jupdown
from sd_tpu_torch.core import distributions, schedules
from sd_tpu_torch.diffusion import ddim, guidance, latent
from sd_tpu_torch.models import clip_text
from sd_tpu_torch.nn import attention, layers, resnet, updown


def _run(flax_mod, torch_mod, *args, seed=0, **kw):
    """Init flax_mod on args, carry random params to torch_mod, return both
    outputs (flax, torch)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    params = flax_init(flax_mod, *jargs, seed=seed, **kw)
    # jitted over the array arguments (one compile, not one per eager op)
    arrays = {i: a for i, a in enumerate(jargs) if isinstance(a, jax.Array)}
    ref = jax.jit(lambda p, arr: flax_mod.apply(
        {"params": p}, *(arr.get(i, a) for i, a in enumerate(jargs)), **kw))(params, arrays)
    tmod = port(torch_mod, params)
    with torch.no_grad():
        got = tmod(*(to_torch(a) if isinstance(a, np.ndarray) else a for a in args))
    return got, ref


# -- schedules -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_exact(kind):
    np.testing.assert_array_equal(schedules.make_beta_schedule(kind, 1000, 0.00085, 0.012),
                                  jsched.make_beta_schedule(kind, 1000, 0.00085, 0.012))


@pytest.mark.parametrize("method,steps", [("uniform", 50), ("uniform", 4), ("quad", 20)])
def test_ddim_timesteps_exact(method, steps):
    np.testing.assert_array_equal(schedules.make_ddim_timesteps(method, steps, 1000),
                                  jsched.make_ddim_timesteps(method, steps, 1000))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_schedule_tables_exact(eta):
    kw = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
              linear_end=0.012)
    base, jbase = schedules.DiffusionSchedule.create(**kw), jsched.DiffusionSchedule.create(**kw)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(base, name).numpy(),
                                      np.asarray(getattr(jbase, name)))
    dd, jdd = schedules.DDIMSchedule.create(base, 50, eta), jsched.DDIMSchedule.create(jbase, 50, eta)
    for name in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(dd, name).numpy(),
                                      np.asarray(getattr(jdd, name)))
    t = np.array([3, 999, 0])
    np.testing.assert_array_equal(
        schedules.extract(base.alphas_cumprod, torch.from_numpy(t), 4).numpy(),
        np.asarray(jsched.extract(jbase.alphas_cumprod, jnp.asarray(t), 4)))


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
def test_training_schedule_tables_and_methods(param):
    kw = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
              linear_end=0.012, parameterization=param)
    base, jbase = schedules.DiffusionSchedule.create(**kw), jsched.DiffusionSchedule.create(**kw)
    np.testing.assert_array_equal(base.lvlb_weights.numpy(), np.asarray(jbase.lvlb_weights))
    x0, noise = nprand(3, 4, 4, 2, seed=1), nprand(3, 4, 4, 2, seed=2)
    t = np.array([0, 417, 999])
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    assert_close(base.q_sample(to_torch(x0), tt, to_torch(noise)),
                 jbase.q_sample(jnp.asarray(x0), jt, jnp.asarray(noise)))
    assert_close(base.get_v(to_torch(x0), to_torch(noise), tt),
                 jbase.get_v(jnp.asarray(x0), jnp.asarray(noise), jt))


def test_diagonal_gaussian():
    moments = nprand(2, 4, 4, 8, scale=30.0)      # logvar past both clamps
    other = nprand(2, 4, 4, 8, seed=1)
    eps = nprand(2, 4, 4, 4, seed=2)
    g = distributions.DiagonalGaussian.from_moments(to_torch(moments))
    jg = jdist.DiagonalGaussian.from_moments(jnp.asarray(moments))
    go = distributions.DiagonalGaussian.from_moments(to_torch(other))
    jgo = jdist.DiagonalGaussian.from_moments(jnp.asarray(other))
    assert_close(g.logvar, jg.logvar)
    assert_close(g.mode(), jg.mode())
    assert_close(g.sample(to_torch(eps)), jg.mean + jg.std * jnp.asarray(eps))
    assert_close(go.kl(), jgo.kl())
    assert_close(go.kl(g), jgo.kl(jg), 1e-3)      # var ratios up to e^50: fp32 sums


# -- nn/layers ---------------------------------------------------------------------


@pytest.mark.parametrize("c,eps", [(64, 1e-5), (24, 1e-6), (32, 1e-6)])
def test_group_norm(c, eps):
    x = nprand(2, 5, 6, c, scale=3.0) + 1.0
    got, ref = _run(jlayers.GroupNorm32(32, epsilon=eps),
                    layers.GroupNorm32(c, 32, eps=eps), x)
    assert_close(got, ref)


@pytest.mark.parametrize("dim,flip", [(320, True), (33, True), (64, False)])
def test_timestep_embedding(dim, flip):
    t = np.array([0, 1, 500, 999], np.int32)
    assert_close(layers.timestep_embedding(torch.from_numpy(t), dim, flip_sin_to_cos=flip),
                 jlayers.timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip))


def test_conv3x3():
    got, ref = _run(jlayers.Conv3x3(24), layers.Conv3x3(16, 24), nprand(2, 9, 7, 16))
    assert_close(got, ref)


def test_downsample():
    got, ref = _run(jupdown.Downsample(with_conv=True), updown.Downsample(8),
                    nprand(2, 8, 8, 8))
    assert_close(got, ref)


@pytest.mark.parametrize("hw", [(8, 8), (7, 10)])
def test_downsample_asymmetric_padding(hw):
    got, ref = _run(jupdown.Downsample(with_conv=True, asymmetric_padding=True),
                    updown.Downsample(8, asymmetric_padding=True), nprand(2, *hw, 8))
    assert_close(got, ref)


def test_upsample_conv_matches_phase_conv():
    got, ref = _run(jupdown.Upsample(with_conv=True), updown.Upsample(8),
                    nprand(2, 5, 6, 8))
    assert_close(got, ref)


# -- nn/resnet ---------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 64)])
def test_resnet_block(cin, cout):
    flax_mod = jresnet.ResnetBlock(out_channels=cout)
    x = nprand(2, 6, 6, cin)
    params = flax_init(flax_mod, jnp.asarray(x), None)
    ref = flax_mod.apply({"params": params}, jnp.asarray(x), None)
    with torch.no_grad():
        got = port(resnet.ResnetBlock(cin, cout), params)(to_torch(x))
    assert_close(got, ref)


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 64)])
def test_resblock_sd(cin, cout):
    x, emb = nprand(2, 6, 6, cin), nprand(2, 48, seed=1)
    got, ref = _run(jresnet.ResBlockSD(out_channels=cout),
                    resnet.ResBlockSD(cin, 48, cout), x, emb)
    assert_close(got, ref)


# -- nn/attention ------------------------------------------------------------------


def test_layer_norm32():
    got, ref = _run(jattn.LayerNorm32(), attention.LayerNorm32(40),
                    nprand(2, 7, 40, scale=2.0) + 0.5)
    assert_close(got, ref)


def test_attn_block():
    got, ref = _run(jattn.AttnBlock(), attention.AttnBlock(64), nprand(2, 4, 5, 64))
    assert_close(got, ref)


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(cross):
    x = nprand(2, 16, 32)
    ctx = nprand(2, 7, 24, seed=1) if cross else None
    args = (x, ctx) if cross else (x,)
    got, ref = _run(jattn.CrossAttention(heads=4, dim_head=8),
                    attention.CrossAttention(32, 24 if cross else None, 4, 8), *args)
    assert_close(got, ref)


def test_feed_forward_geglu():
    got, ref = _run(jattn.FeedForwardGEGLU(), attention.FeedForwardGEGLU(32),
                    nprand(2, 16, 32))
    assert_close(got, ref)


def test_basic_transformer_block():
    x, ctx = nprand(2, 16, 32), nprand(2, 7, 24, seed=1)
    got, ref = _run(jattn.BasicTransformerBlock(4, 8),
                    attention.BasicTransformerBlock(32, 4, 8, 24), x, ctx)
    assert_close(got, ref)


def test_spatial_transformer():
    x, ctx = nprand(2, 4, 4, 64), nprand(2, 7, 24, seed=1)
    got, ref = _run(jattn.SpatialTransformer(heads=4, dim_head=8, depth=2),
                    attention.SpatialTransformer(64, 4, 8, 2, 24), x, ctx)
    assert_close(got, ref)


# -- CLIP ----------------------------------------------------------------------------

TINY_CLIP = dict(vocab_size=1000, hidden_size=32, num_layers=3, num_heads=4,
                 max_length=16)


def test_clip_encoder_layer():
    cfg = jclip.ClipTextConfig(**TINY_CLIP)
    mask = np.triu(np.full((16, 16), -1e9, np.float32), 1)[None, None]
    got, ref = _run(jclip.ClipEncoderLayer(cfg),
                    clip_text.ClipEncoderLayer(clip_text.ClipTextConfig(**TINY_CLIP)),
                    nprand(2, 16, 32), mask)
    assert_close(got, ref)


@pytest.mark.parametrize("skip", [1, 2])
def test_clip_text_transformer(skip):
    tok = jclip.SimpleHashTokenizer(16, 1000)
    ids = tok(["a photograph of an astronaut riding a horse", ""])
    flax_mod = jclip.ClipTextTransformer(jclip.ClipTextConfig(**TINY_CLIP))
    params = flax_init(flax_mod, jnp.asarray(ids))
    ref = flax_mod.apply({"params": params}, jnp.asarray(ids), clip_skip=skip)
    mod = port(clip_text.ClipTextTransformer(clip_text.ClipTextConfig(**TINY_CLIP),
                                             device="cpu"), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(ids.astype(np.int64)), clip_skip=skip)
    assert_close(got, ref)


def test_tokenizer_ids_exact():
    texts = ["A cat, sitting", "", "word " * 100]
    for max_length, vocab in ((77, 49408), (16, 1000)):
        np.testing.assert_array_equal(
            clip_text.SimpleHashTokenizer(max_length, vocab)(texts),
            jclip.SimpleHashTokenizer(max_length, vocab)(texts))


# -- diffusion -------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 7.5])
def test_apply_cfg(scale):
    u, c = nprand(2, 4, 4, 3), nprand(2, 4, 4, 3, seed=1)
    assert_close(guidance.apply_cfg(to_torch(u), to_torch(c), scale),
                 jguid.apply_cfg(jnp.asarray(u), jnp.asarray(c), scale))


def _toy_eps(lib):
    """The same toy ε-model written for both frameworks: depends on x, t and
    the conditioning, so CFG and the step tables all show in the result."""
    def fn(x, t, c):
        tt = lib.reshape(t, (-1, 1, 1, 1)).astype("float32") if lib is jnp else \
            t.reshape(-1, 1, 1, 1).float()
        return lib.sin(x * 0.7) * 0.5 + tt / 1000.0 + c
    return fn


def test_ddim_sample_with_cfg_and_injected_noise():
    shape = (2, 4, 4, 3)
    x_T = nprand(*shape, seed=3)
    cond, uncond = nprand(2, 1, 1, 3, seed=4) * 0.1, nprand(2, 1, 1, 3, seed=5) * 0.1
    jbase = jsched.DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    ref = jddim.DDIMSampler(jbase).sample(
        _toy_eps(jnp), jax.random.PRNGKey(0), shape, num_steps=10,
        cond=jnp.asarray(cond), uncond=jnp.asarray(uncond), guidance_scale=7.5,
        x_T=jnp.asarray(x_T))
    base = schedules.DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    got = ddim.DDIMSampler(base).sample(
        _toy_eps(torch), shape, to_torch(x_T), num_steps=10, cond=to_torch(cond),
        uncond=to_torch(uncond), guidance_scale=7.5)
    assert_close(got, ref)


def test_apply_conditioned_crossattn_concatenates_tokens():
    """`crossattn` concatenates the context along tokens; `concat` the
    latent's conditioning along channels (no context); `hybrid` both (the
    inpainting model); `adm` is not ported yet."""
    seen = {}

    def unet(x, t, ctx):
        seen["x"], seen["ctx"] = x, ctx
        return x

    a, b = torch.randn(2, 3, 8), torch.randn(2, 5, 8)
    latent.apply_conditioned(unet, torch.zeros(2), torch.zeros(2),
                             {"c_crossattn": [a, b]}, "crossattn")
    assert torch.equal(seen["ctx"], torch.cat([a, b], dim=1))
    x, m, z = torch.randn(2, 4, 4, 3), torch.randn(2, 4, 4, 1), torch.randn(2, 4, 4, 3)
    latent.apply_conditioned(unet, x, torch.zeros(2), {"c_concat": [m, z]}, "concat")
    assert torch.equal(seen["x"], torch.cat([x, m, z], dim=-1)) and seen["ctx"] is None
    latent.apply_conditioned(unet, x, torch.zeros(2),
                             {"c_concat": [m], "c_crossattn": [a]}, "hybrid")
    assert torch.equal(seen["x"], torch.cat([x, m], dim=-1)) and torch.equal(seen["ctx"], a)
    with pytest.raises(NotImplementedError):
        latent.apply_conditioned(unet, x, torch.zeros(2), {"c_adm": a}, "adm")
