"""The guided-diffusion (ADM) UNet options, class conditioning, the CompVis
codec UNet and the `adm` slice against the JAX package's, on the CPU in fp32
at tiny widths.

The same seeded numpy inputs go through both, the weights carried over by
`load_flax_params` with every parameter random, each JAX apply jitted once.
Modules, within 1e-5·max(1, max|ref|) (`TOL`): `Upsample` / `Downsample`
without their conv (nearest ×2, 2×2 average pool); `ResBlockSD` plain, with
scale-shift norm, with built-in up- and down-sampling and with the 3×3 skip;
the class-conditional ADM UNet (`num_classes`, scale-shift, `resblock_updown`,
self-attention in heads of `num_head_channels`) driven through the ControlNet
apply with a class-conditional scale-shift control branch;
`conv_resample=False` with the codebook head (`n_embed`); `AttentionPool2d`;
`UNetCompVis` with vanilla and linear attention (the latter without
resampling convs; held at 1e-4·max|ref|, `LINEAR_TOL`, where the JAX
package's own fp32 output is farther from float64 than 1e-5). The `adm`
slice: class labels → `LatentDiffusion(adm)` → 4 DDIM steps with CFG 3.0
against a null label → KL decode, within 1e-4·max|ref| (`SLICE_TOL`), its
`get_input` and the unconditional key None. Also the errors (a labelled UNet without labels, an unknown
conditioning key), the seeded initialisation of the new leaves, and the two
published configurations' sources.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flow import scan_as_loop
from test_torch_helpers import (assert_close, flax_init, init_shapes, nprand, port,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_VAE

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion import ddpm as jddpm
from sd_tpu.diffusion.latent import LatentDiffusion as JLatentDiffusion
from sd_tpu.models import controlnet as jcontrolnet
from sd_tpu.models import unet_compvis as jcompvis
from sd_tpu.models import unet_sd as junet
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.nn import resnet as jresnet
from sd_tpu.nn import updown as jupdown
from sd_tpu_torch.core.config import (adm_imagenet256_config, ldm_kl8g_txt2img_config,
                                      load_config, sd_v1_config)
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion, apply_conditioned
from sd_tpu_torch.models import controlnet
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.unet_compvis import UNetCompVis
from sd_tpu_torch.models.unet_sd import AttentionPool2d, UNetModel
from sd_tpu_torch.nn.resnet import ResBlockSD
from sd_tpu_torch.nn.updown import Downsample, Upsample
from sd_tpu_torch.weights import init_params_

TOL = 1e-5
LINEAR_TOL = 1e-4
SLICE_TOL = 1e-4
ADM = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
           attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_head_channels=8,
           use_spatial_transformer=False, context_dim=None, num_classes=10,
           use_scale_shift_norm=True, resblock_updown=True)
CODEBOOK = dict(in_channels=4, model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_heads=4, context_dim=16, conv_resample=False,
                n_embed=12)
SCHED = (1000, "linear", 0.00085, 0.012)


def jit_apply(jmod, params, *args, **kw):
    return jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kw))(
        params, *[None if a is None else jnp.asarray(a) for a in args])


def run_both(jmod, tmod, *args, seed: int = 0):
    """(port output, JAX output) of the modules on numpy args (None passes
    through) with the same random weights (a module without parameters has
    none)."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    has = "params" in init_shapes(jmod, *jargs)
    params = flax_init(jmod, *jargs, seed=seed) if has else {}
    ref = jit_apply(jmod, params, *args)
    with torch.no_grad():
        got = port(tmod, params)(*[None if a is None else torch.from_numpy(np.asarray(a))
                                   for a in args])
    return got, ref


# -- resampling and the resblock ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["up", "down"])
def test_resampling_without_conv_matches(kind):
    x = nprand(2, 5, 7, 6, seed=1)
    jmod, tmod = ((jupdown.Upsample(with_conv=False), Upsample(6, with_conv=False))
                  if kind == "up" else
                  (jupdown.Downsample(with_conv=False), Downsample(6, with_conv=False)))
    got, ref = run_both(jmod, tmod, x)
    assert got.shape == ((2, 10, 14, 6) if kind == "up" else (2, 2, 3, 6))
    assert_close(got, ref, TOL)
    assert not list(tmod.parameters())


RESBLOCKS = {
    "plain": dict(),
    "scale_shift": dict(use_scale_shift_norm=True),
    "up": dict(up=True, use_scale_shift_norm=True),
    "down": dict(down=True),
    "conv_skip": dict(out_channels=48, use_conv_skip=True, use_scale_shift_norm=True),
}


@pytest.mark.parametrize("case", list(RESBLOCKS))
def test_resblock_options_match(case):
    opts = dict(RESBLOCKS[case])
    x, emb = nprand(2, 6, 6, 32, seed=2), nprand(2, 64, seed=3)
    out = opts.pop("out_channels", None)
    got, ref = run_both(jresnet.ResBlockSD(out_channels=out, **opts),
                        ResBlockSD(32, 64, out, **opts, device="cpu"), x, emb, seed=4)
    assert_close(got, ref, TOL)


# -- the UNet options -----------------------------------------------------------------------


def test_class_conditional_adm_unet_with_a_control_branch_matches():
    """The ADM UNet and a class-conditional, scale-shift ControlNet over it
    through the controlled apply, with and without the hint."""
    x, hint = nprand(2, 8, 8, 4, seed=5), nprand(2, 16, 16, 3, seed=6)
    t, y = np.array([981, 7], np.int32), np.array([3, 9], np.int32)
    ju, jcn = junet.UNetModel(**ADM), jcontrolnet.controlnet_from_unet_config(
        ADM, hint_downsamples=1)
    uparams = flax_init(ju, jnp.asarray(x), jnp.asarray(t), None, jnp.asarray(y), seed=7)
    cparams = flax_init(jcn, jnp.asarray(x), jnp.asarray(hint), jnp.asarray(t), None,
                        jnp.asarray(y), seed=8)
    apply = jcontrolnet.controlled_apply_fn(ju, jcn)
    ref = jax.jit(lambda p, *a: (apply(p, *a[:3], a[3]), apply(p, *a[:3], a[3], control=a[4])))(
        {"unet": uparams, "controlnet": cparams}, jnp.asarray(x), jnp.asarray(t), None,
        jnp.asarray(y), jnp.asarray(hint))

    unet = port(UNetModel(**ADM, device="cpu"), uparams)
    cn = port(controlnet.controlnet_from_unet_config(ADM, hint_downsamples=1, device="cpu"),
              cparams)
    assert "label_emb.weight" in dict(cn.named_parameters())
    fn = controlnet.controlled_apply_fn(unet, cn)
    with torch.no_grad():
        args = (to_torch(x), torch.from_numpy(t), None, torch.from_numpy(y))
        got = (fn(*args), fn(*args, control=to_torch(hint)))
    for g, r in zip(got, ref):
        assert_close(g, r, TOL)
    assert type(unet.in_0_down).__name__ == "ResBlockSD" and unet.in_0_down.resample is not None
    with pytest.raises(ValueError, match="needs labels"):
        unet(to_torch(x), torch.from_numpy(t))
    with pytest.raises(AssertionError, match="needs labels"):
        ju.apply({"params": uparams}, jnp.asarray(x), jnp.asarray(t))


def test_codebook_head_without_resampling_convs_matches():
    x, ctx = nprand(2, 8, 8, 4, seed=9), nprand(2, 5, 16, seed=10)
    t = np.array([500, 3], np.int32)
    unet = UNetModel(**CODEBOOK, device="cpu")
    got, ref = run_both(junet.UNetModel(**CODEBOOK), unet, x, t, ctx, seed=11)
    assert got.shape == (2, 8, 8, 12)
    assert_close(got, ref, TOL)
    assert unet.in_0_down.conv is None and unet.out_1_up.conv is None
    assert not hasattr(unet, "out_conv") and unet.id_out.weight.shape[:2] == (12, 32)


def test_attention_pool_matches():
    x = nprand(2, 4, 4, 32, seed=12)
    pool = AttentionPool2d(16, 32, 4, output_dim=24, device="cpu")
    got, ref = run_both(junet.AttentionPool2d(num_heads=4, output_dim=24), pool, x, seed=13)
    assert got.shape == (2, 24)
    assert_close(got, ref, TOL)
    init_params_(pool, torch.Generator().manual_seed(0))
    assert 0.13 < float(pool.positional_embedding.std()) < 0.22      # N(0, 1/C)


@pytest.mark.parametrize("attn_type", ["vanilla", "linear"])
def test_compvis_unet_matches(attn_type):
    """Linear attention (k softmaxed over the tokens, then GroupNorms) makes
    this tiny network ill-conditioned in fp32 for both packages: measured,
    the JAX package's output is 6.4e-5 from a float64 run of the port (max
    |ref| 3.2), the port's 4.8e-5. So the linear case is held at
    LINEAR_TOL·max|ref| against the JAX package, and its distance from
    float64 at most the JAX package's (×1.5); the vanilla case at TOL."""
    opts = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                resolution=16, attn_type=attn_type, resamp_with_conv=attn_type == "vanilla")
    x, t = nprand(2, 16, 16, 3, seed=14), np.array([10, 900], np.int32)
    unet = UNetCompVis(**opts, device="cpu")
    got, ref = run_both(jcompvis.UNetCompVis(**opts), unet, x, t, seed=15)
    if attn_type == "vanilla":
        assert_close(got, ref, TOL)
    else:
        assert_close(got, ref, LINEAR_TOL)
        with torch.no_grad():
            f64 = unet.double()(to_torch(x).double(), torch.from_numpy(t)).numpy()
        assert np.abs(got.numpy() - f64).max() <= 1.5 * np.abs(np.asarray(ref) - f64).max()
    prefix = "AttnBlock_" if attn_type == "vanilla" else "LinearAttention_"
    # the 8² level's down block, the mid block, the 8² level's two up blocks
    assert sorted(unet.attn_names.values()) == [f"{prefix}{k}" for k in range(4)]
    with pytest.raises(ValueError, match="timesteps"):
        unet(to_torch(x))


# -- the adm slice --------------------------------------------------------------------------


def test_adm_slice_matches():
    ju, jvae = junet.UNetModel(**ADM), JAutoencoderKL(**TINY_VAE)
    x_T, y = nprand(2, 8, 8, 4, seed=16), np.array([3, 8], np.int32)
    null = np.zeros(2, np.int32)
    uparams = flax_init(ju, jnp.asarray(x_T), jnp.zeros((2,), jnp.int32), None,
                        jnp.asarray(y), seed=17)
    vparams = flax_init(jvae, jnp.zeros((1, 16, 16, 3)), seed=18)
    # the sampler's scan as a Python loop around the jitted UNet and decoder:
    # two small compiles instead of one of the whole loop
    jld = JLatentDiffusion(
        process=jddpm.DDPMProcess(JSchedule.create(*SCHED)),
        unet_apply=jax.jit(lambda p, x, t, ctx, y=None: ju.apply({"params": p}, x, t, ctx, y)),
        decode_fn=jax.jit(lambda z: jvae.apply({"params": vparams}, z,
                                               method=JAutoencoderKL.decode)),
        conditioning_key="adm")
    with scan_as_loop():
        ref = np.asarray(jld.sample(
            uparams, jax.random.PRNGKey(0), x_T.shape, cond={"c_adm": jnp.asarray(y)},
            uncond={"c_adm": jnp.asarray(null)}, guidance_scale=3.0, num_steps=4, eta=0.0,
            sampler="ddim", x_T=jnp.asarray(x_T)))

    unet = port(UNetModel(**ADM, device="cpu"), uparams)
    vae = port(AutoencoderKL(**TINY_VAE, device="cpu"), vparams)
    ld = LatentDiffusion(process=DDPMProcess(DiffusionSchedule.create(*SCHED)),
                         unet_apply=unet, decode_fn=vae.decode, conditioning_key="adm")
    with torch.no_grad():
        got = ld.sample(x_T.shape, to_torch(x_T), {"c_adm": torch.from_numpy(y)},
                        {"c_adm": torch.from_numpy(null)}, guidance_scale=3.0, num_steps=4)
    assert got.shape == ref.shape == (2, 16, 16, 3)
    assert float(np.max(np.abs(got.numpy() - ref))) <= SLICE_TOL * float(np.max(np.abs(ref)))

    # get_input: class_label → c_adm; the key None gives no cond and an
    # unconditioned call
    batch = {"image": to_torch(x_T), "class_label": torch.from_numpy(y)}
    enc = dataclasses.replace(ld, encode_fn=lambda im: im, scale_factor=1.0)
    z, cond = enc.get_input(batch)
    assert torch.equal(z, batch["image"]) and cond == {"c_adm": batch["class_label"]}
    none = dataclasses.replace(enc, conditioning_key=None)
    assert none.get_input(batch)[1] is None
    seen = {}

    def spy(x, t, ctx, **kw):
        seen.update(ctx=ctx, **kw)
        return x

    t = torch.tensor([400, 20])
    assert apply_conditioned(spy, batch["image"], t, None, None) is batch["image"]
    assert seen == {"ctx": None}
    for bad in (lambda: dataclasses.replace(enc, conditioning_key="class").get_input(batch),
                lambda: apply_conditioned(unet, to_torch(x_T), t,
                                          {"c_adm": batch["class_label"]}, "class")):
        with pytest.raises(ValueError, match="conditioning key"):
            bad()


# -- the published configurations ---------------------------------------------------------


def test_published_configs_name_their_models():
    ldm, adm = ldm_kl8g_txt2img_config(), adm_imagenet256_config()
    assert load_config("ldm_kl8g_txt2img") == ldm and load_config("adm_imagenet256") == adm
    assert ldm["first_stage"] == sd_v1_config()["first_stage"]
    assert ldm["unet"]["params"]["context_dim"] == ldm["cond_stage"]["params"]["n_embed"] == 1280
    assert ldm["cond_stage"]["params"]["n_layer"] == 32 and ldm["latent"]["image_size"] == 32
    p = adm["unet"]["params"]
    assert (p["model_channels"], p["channel_mult"], p["num_head_channels"], p["num_classes"],
            p["out_channels"]) == (256, [1, 1, 2, 2, 4, 4], 64, 1000, 6)
    # ds 8, 16, 32 of a 256² image: the 32², 16² and 8² levels
    assert [adm["image_size"] // ds for ds in p["attention_resolutions"]] == [32, 16, 8]
