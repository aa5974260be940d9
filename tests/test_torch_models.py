"""The ported models against the JAX package at the tiny widths of the TPU
benchmark's self-test (`bench.py` smoke: UNet 32 ch × (1, 2), VAE 16 ch ×
(1, 2), latent 16²), fp32 on the CPU, every parameter random, within
1e-4·max(1, max|ref|): the UNet, the KL decoder, the encoder and the
posterior moments of `AutoencoderKL.encode`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_helpers import assert_close, flax_init, nprand, port, to_torch

from sd_tpu.models import autoencoder as jae
from sd_tpu.models import codec as jcodec
from sd_tpu.models import unet_sd as junet
from sd_tpu_torch.models import autoencoder, codec, unet_sd

TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4,
                 num_res_blocks=1, attention_resolutions=(2,),
                 channel_mult=(1, 2), num_heads=4, context_dim=32)
TINY_VAE = dict(embed_dim=4, ch=16, ch_mult=(1, 2), num_res_blocks=1,
                resolution=32, z_channels=4)


def unet_params(seed=0):
    return flax_init(junet.UNetModel(**TINY_UNET), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 32)), seed=seed)


def vae_params(seed=0):
    """The whole KL tree (encoder, decoder, quant_conv, post_quant_conv)."""
    return flax_init(jae.AutoencoderKL(**TINY_VAE), jnp.zeros((1, 32, 32, 3)),
                     seed=seed)


def test_unet():
    params = unet_params()
    x, ctx = nprand(2, 16, 16, 4, seed=1), nprand(2, 16, 32, seed=2)
    t = np.array([981, 1], np.int32)
    # jitted: one compile (eager flax compiles one program per op)
    ref = jax.jit(junet.UNetModel(**TINY_UNET).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    mod = port(unet_sd.UNetModel(**TINY_UNET, device="cpu"), params)
    with torch.no_grad():
        got = mod(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert_close(got, ref)


def test_autoencoder_decode():
    params = vae_params()
    z = nprand(2, 16, 16, 4, seed=1)
    ref = jax.jit(lambda p, z: jae.AutoencoderKL(**TINY_VAE).apply(
        {"params": p}, z, method=jae.AutoencoderKL.decode))(params, jnp.asarray(z))
    mod = port(autoencoder.AutoencoderKL(**TINY_VAE, device="cpu"), params)
    with torch.no_grad():
        got = mod.decode(to_torch(z))
    assert got.shape == (2, 32, 32, 3)
    assert_close(got, ref)


def test_encoder():
    params = vae_params(seed=2)["encoder"]
    x = nprand(2, 32, 32, 3, seed=1)
    ref = jax.jit(jcodec.Encoder(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
                                 z_channels=4).apply)({"params": params}, jnp.asarray(x))
    mod = port(codec.Encoder(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4), params)
    with torch.no_grad():
        got = mod(to_torch(x))
    assert got.shape == (2, 16, 16, 8)
    assert_close(got, ref)


def test_autoencoder_encode():
    params = vae_params(seed=3)
    x = nprand(2, 32, 32, 3, seed=1)
    def moments(p, x):
        post = jae.AutoencoderKL(**TINY_VAE).apply({"params": p}, x,
                                                  method=jae.AutoencoderKL.encode)
        return post.mean, post.logvar

    ref_mean, ref_logvar = jax.jit(moments)(params, jnp.asarray(x))
    mod = port(autoencoder.AutoencoderKL(**TINY_VAE, device="cpu"), params)
    with torch.no_grad():
        got = mod.encode(to_torch(x))
    assert_close(got.mean, ref_mean)
    assert_close(got.logvar, ref_logvar)
