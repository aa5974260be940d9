"""The port's GAN pieces against the JAX package, fp32 on the CPU, the same
(carried-across) weights and inputs, within 1e-4·max(1, max|ref|): every
function of `losses/gan.py`; `NLayerDiscriminator` with BatchNorm (logits
and the updated running statistics against flax's `mutable=
["batch_stats"]`, and on the running statistics) and with ActNorm, and the
dtype its convs run in under bf16 weights; `LPIPS` at 32² and the
`make_lpips_fn` modes, the calibrated one from a torchvision-layout
checkpoint; and `AutoencoderKL` called with injected posterior noise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_helpers import assert_close, flax_init, nprand, port, to_torch

from sd_tpu.losses import gan as jgan
from sd_tpu.models import discriminator as jdisc
from sd_tpu.models import lpips as jlpips
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu_torch.losses import gan
from sd_tpu_torch.models import discriminator as disc
from sd_tpu_torch.models import lpips
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.weights import load_flax_batch_stats

# the JAX modules compiled once each (op by op they take longer to run here)
_jlpips = jax.jit(lambda p, a, b: jlpips.LPIPS().apply({"params": p}, a, b))


# -- losses/gan.py ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_d_losses(name):
    real, fake = nprand(2, 6, 6, 1, seed=1, scale=2.0), nprand(2, 6, 6, 1, seed=2, scale=2.0)
    assert_close(getattr(gan, name)(to_torch(real), to_torch(fake)),
                 getattr(jgan, name)(jnp.asarray(real), jnp.asarray(fake)))


@pytest.mark.parametrize("step,threshold", [(0, 0), (3, 5), (5, 5), (9, 5)])
def test_adopt_weight(step, threshold):
    want = float(jgan.adopt_weight(0.7, jnp.asarray(step), threshold, value=0.1))
    assert gan.adopt_weight(0.7, step, threshold, value=0.1) == pytest.approx(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calculate_adaptive_weight(dtype):
    a, b = nprand(3, 8, 3, 3, seed=3), nprand(3, 8, 3, 3, seed=4, scale=0.01)
    got = gan.calculate_adaptive_weight(to_torch(a).to(getattr(torch, dtype)),
                                        to_torch(b).to(getattr(torch, dtype)), 0.5)
    want = jgan.calculate_adaptive_weight(jnp.asarray(a, dtype), jnp.asarray(b, dtype), 0.5)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)   # the gradients' own dtype
    assert not got.requires_grad
    assert_close(got.float(), np.asarray(want, np.float32), 1e-4 if dtype == "float32" else 1e-2)
    big = gan.calculate_adaptive_weight(to_torch(a), torch.zeros(3, 8, 3, 3))
    assert float(big) == float(jgan.calculate_adaptive_weight(jnp.asarray(a), jnp.zeros((3, 8, 3, 3))))


def test_gan_loss_config_matches():
    assert ([(f.name, f.default) for f in dataclasses.fields(gan.GanLossConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jgan.GanLossConfig)])
    assert gan.GanLossConfig(disc_loss="vanilla").d_loss_fn() is gan.vanilla_d_loss
    assert gan.GanLossConfig().d_loss_fn() is gan.hinge_d_loss


@pytest.mark.parametrize("perceptual,weight", [(True, 1.0), (False, 1.0), (True, 0.0)])
def test_reconstruction_nll(perceptual, weight):
    x, r = nprand(2, 8, 8, 3, seed=5), nprand(2, 8, 8, 3, seed=6)
    p = np.abs(nprand(2, 1, 1, 1, seed=7)) if perceptual else None
    logvar = np.float32(0.3)
    cfg = dict(perceptual_weight=weight, pixelloss_weight=0.8)
    got = gan.reconstruction_nll(to_torch(x), to_torch(r), torch.tensor(logvar),
                                 None if p is None else to_torch(p), gan.GanLossConfig(**cfg))
    want = jgan.reconstruction_nll(jnp.asarray(x), jnp.asarray(r), jnp.asarray(logvar),
                                   None if p is None else jnp.asarray(p),
                                   jgan.GanLossConfig(**cfg))
    for g, w in zip(got, want):
        assert_close(g, w)


# -- the discriminator --------------------------------------------------------------


def _disc_pair(use_actnorm: bool, seed: int = 0):
    """The JAX discriminator with random params (and random running
    statistics) and the port's with the same."""
    jd = jdisc.NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=use_actnorm)
    x0 = jnp.zeros((1, 32, 32, 3))
    params = flax_init(jd, x0, seed=seed)
    variables = {"params": params}
    td = disc.NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=use_actnorm, device="cpu")
    port(td, params)
    if not use_actnorm:
        stats = jax.eval_shape(jd.init, jax.random.PRNGKey(0), x0)["batch_stats"]
        rng = np.random.default_rng(seed + 1)
        stats = {n: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                     "var": (1 + np.abs(rng.standard_normal(s["var"].shape))).astype(np.float32)}
                 for n, s in stats.items()}
        variables["batch_stats"] = stats
        load_flax_batch_stats(td, stats)
    return jd, variables, td


def test_discriminator_batchnorm_logits_and_running_stats():
    jd, variables, td = _disc_pair(use_actnorm=False)
    x = nprand(2, 32, 32, 3, seed=8, scale=2.0) + 0.3
    want, mut = jax.jit(lambda v, x: jd.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got = td(to_torch(x), update_stats=True)
    assert_close(got, want)
    assert got.shape == (2, 6, 6, 1)
    buffers = dict(td.named_buffers())
    for norm, stats in mut["batch_stats"].items():
        for key, val in stats.items():
            assert buffers[f"{norm}.{key}"].dtype == torch.float32
            assert_close(buffers[f"{norm}.{key}"], val)
    # on the running statistics (eval mode) the logits follow them
    want_eval = jax.jit(lambda v, x: jd.apply(v, x, train=False))(
        {**variables, **mut}, jnp.asarray(x))
    assert_close(td(to_torch(x), train=False), want_eval)


def test_discriminator_leaves_running_stats_unless_asked():
    _, _, td = _disc_pair(use_actnorm=False)
    before = {n: b.clone() for n, b in td.named_buffers()}
    td(to_torch(nprand(2, 32, 32, 3, seed=9)))
    assert all(torch.equal(before[n], b) for n, b in td.named_buffers())


def test_discriminator_actnorm():
    jd, variables, td = _disc_pair(use_actnorm=True, seed=3)
    x = nprand(2, 32, 32, 3, seed=10)
    assert_close(td(to_torch(x)), jax.jit(jd.apply)(variables, jnp.asarray(x)))
    assert list(td.named_buffers()) == []
    # data-dependent init: scale·(x + loc) has zero mean, unit std per channel
    batch = nprand(4, 6, 6, 16, seed=11, scale=3.0) + 1.0
    jp = jdisc.actnorm_ddi({"loc": jnp.zeros(16), "scale": jnp.ones(16)}, jnp.asarray(batch))
    norm = disc.ActNorm(16, device="cpu")
    disc.actnorm_ddi(norm, to_torch(batch))
    assert_close(norm.loc, jp["loc"])
    assert_close(norm.weight, jp["scale"])
    h = jdisc.ActNorm().apply({"params": jp}, jnp.asarray(batch))
    got = norm(to_torch(batch).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, h)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_discriminator_convs_follow_flax_promotion(x_dtype):
    """With bf16 weights a conv runs in result_type(input, weight): fp32
    images through fp32 convs, a bf16 reconstruction through bf16 convs."""
    w = nprand(16, 3, 4, 4, seed=12, scale=0.2)
    x = nprand(2, 8, 8, 3, seed=13)
    jconv = fnn.Conv(16, (4, 4), strides=(2, 2), padding=[(1, 1), (1, 1)])
    jparams = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0), jnp.bfloat16),
               "bias": jnp.zeros(16, jnp.bfloat16)}
    want = jconv.apply({"params": jparams}, jnp.asarray(x, x_dtype))
    conv = disc.PromotingConv(3, 16, 2, dtype=torch.bfloat16, device="cpu")
    port(conv, {"kernel": w.transpose(2, 3, 1, 0), "bias": np.zeros(16, np.float32)})
    got = conv(to_torch(x).to(getattr(torch, x_dtype)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == x_dtype
    assert_close(got.float(), np.asarray(want, np.float32), 1e-4 if x_dtype == "float32" else 2e-2)


# -- LPIPS ------------------------------------------------------------------------------


def _lpips_pair(seed: int = 0):
    x0 = jnp.zeros((1, 32, 32, 3))
    params = flax_init(jlpips.LPIPS(), x0, x0, seed=seed)
    return params, port(lpips.LPIPS(device="cpu"), params)


def test_lpips_matches():
    params, tl = _lpips_pair()
    x, y = nprand(2, 32, 32, 3, seed=14), nprand(2, 32, 32, 3, seed=15)
    want = _jlpips(params, jnp.asarray(x), jnp.asarray(y))
    got = tl(to_torch(x), to_torch(y))
    assert got.shape == (2, 1, 1, 1)
    assert_close(got, want)
    assert_close(tl(to_torch(x), to_torch(x)), np.zeros((2, 1, 1, 1)))


def test_lpips_gradient_flows_to_the_input_only():
    _, tl = _lpips_pair()
    tl.requires_grad_(False)
    y = to_torch(nprand(1, 32, 32, 3, seed=16)).requires_grad_()
    tl(to_torch(nprand(1, 32, 32, 3, seed=17)), y).sum().backward()
    assert y.grad is not None and y.grad.abs().sum() > 0
    assert all(p.grad is None for p in tl.parameters())


def test_make_lpips_fn_modes(tmp_path):
    assert lpips.make_lpips_fn(mode="none") is None
    assert jlpips.make_lpips_fn(mode="none") is None
    rand = lpips.make_lpips_fn(mode="random", device="cpu")
    assert not rand.calibrated and not lpips.make_lpips_fn(device="cpu").calibrated
    assert all(not p.requires_grad for p in rand.model.parameters())
    assert all(bool((getattr(rand.model, f"lin{i}").weight == 1).all()) for i in range(5))
    x = to_torch(nprand(1, 32, 32, 3, seed=18))
    assert torch.equal(rand(x, -x), lpips.make_lpips_fn(mode="random", device="cpu")(x, -x))
    with pytest.raises(FileNotFoundError):
        lpips.make_lpips_fn(mode="calibrated", device="cpu")
    # a torchvision-layout VGG16 checkpoint and LPIPS heads: the port's
    # calibrated mode loads them as the JAX package's importers do
    rng = np.random.default_rng(19)
    vgg = {}
    c_in = 3
    for idx, c in zip(lpips._VGG_TORCH_IDX, [w for ws in lpips._VGG_PLAN for w in ws]):
        vgg[f"features.{idx}.weight"] = (rng.standard_normal((c, c_in, 3, 3))
                                         / np.sqrt(9 * c_in)).astype(np.float32)
        vgg[f"features.{idx}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        c_in = c
    lins = {f"lins.{i}.model.1.weight": np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32)
            for i, c in enumerate(lpips.LPIPS_CHANNELS)}
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, tmp_path / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lins.items()}, tmp_path / "lins.pth")
    cal = lpips.make_lpips_fn(mode="auto", device="cpu", vgg_ckpt=str(tmp_path / "vgg16.pth"),
                              lin_ckpt=str(tmp_path / "lins.pth"))
    assert cal.calibrated
    x0 = jnp.zeros((1, 32, 32, 3))
    jparams = flax_init(jlpips.LPIPS(), x0, x0)
    jparams["vgg"] = jlpips.import_torch_vgg16(jparams["vgg"], vgg)
    jparams = jlpips.import_torch_lpips_lins(jparams, lins)
    y = to_torch(nprand(1, 32, 32, 3, seed=20))
    assert_close(cal(x, y), _jlpips(jparams, jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))


# -- AutoencoderKL called: encode → sample → decode --------------------------------------


TINY_AE = dict(embed_dim=4, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
_JVAE = JAutoencoderKL(**TINY_AE, resolution=32)
_jencode = jax.jit(lambda p, x: _JVAE.apply({"params": p}, x, method=JAutoencoderKL.encode))
_jdecode = jax.jit(lambda p, z: _JVAE.apply({"params": p}, z, method=JAutoencoderKL.decode))


@pytest.mark.parametrize("mode", ["sample", "no_noise", "mode"])
def test_autoencoder_call_returns_recon_and_posterior(mode):
    params = flax_init(_JVAE, jnp.zeros((1, 32, 32, 3)))
    vae = port(AutoencoderKL(**TINY_AE, resolution=32, device="cpu"), params)
    x, noise = nprand(2, 32, 32, 3, seed=21), nprand(2, 16, 16, 4, seed=22)
    post = _jencode(params, jnp.asarray(x))
    z = post.mean + post.std * jnp.asarray(noise) if mode == "sample" else post.mode()
    want = _jdecode(params, z)
    if mode == "no_noise":       # the TPU package's call without an rng takes the mode
        jrecon, _ = jax.jit(lambda p, x: _JVAE.apply({"params": p}, x, None))(params, jnp.asarray(x))
        assert_close(jrecon, want)
    kw = {"sample": dict(noise=to_torch(noise)), "no_noise": {},
          "mode": dict(noise=to_torch(noise), sample_posterior=False)}[mode]
    recon, posterior = vae(to_torch(x), **kw)
    assert_close(recon, want)
    assert_close(posterior.mean, post.mean)
    assert_close(posterior.logvar, post.logvar)
    assert_close(posterior.kl(), post.kl())
