"""The codec's auxiliary heads and the codec's dropout against the JAX
package, fp32 on the CPU at tiny widths (8–16 channels, 8²–16² maps):
`SimpleDecoder`, `UpsampleDecoder`, `LatentRescaler` (up and down by a
factor: the bilinear resize with antialias), `MergedRescaleEncoder`,
`MergedRescaleDecoder`, `Upsampler`, `Resize` (with and without its conv)
and `FirstStagePostProcessor`, each within 1e-5·max(1, max|ref|) (`TOL`)
from the JAX tree through `load_flax_params`; and the KL autoencoder with
dropout 0.1 in a training forward (both packages' masks injected at the
resblocks' flax paths), its eval form bit for bit the deterministic one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import (assert_close, flax_init, injected_dropout, nprand, port,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.models import codec as jcodec
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu_torch.models import codec
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.nn.layers import dropout_rng

TOL = 1e-5
SMALL = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=16)

# (name, JAX module, port module, input shape)
HEADS = [
    ("simple_decoder", jcodec.SimpleDecoder(out_channels=3),
     lambda: codec.SimpleDecoder(8, 3), (2, 8, 8, 8)),
    ("upsample_decoder", jcodec.UpsampleDecoder(out_channels=3, ch=8, num_res_blocks=1,
                                                ch_mult=(1, 2)),
     lambda: codec.UpsampleDecoder(4, 3, ch=8, num_res_blocks=1, ch_mult=(1, 2)),
     (1, 8, 8, 4)),
    ("rescaler_up", jcodec.LatentRescaler(factor=2.0, mid_channels=8, out_channels=4, depth=1),
     lambda: codec.LatentRescaler(2.0, 4, 8, 4, 1), (1, 5, 6, 4)),
    ("rescaler_down", jcodec.LatentRescaler(factor=0.5, mid_channels=8, out_channels=4),
     lambda: codec.LatentRescaler(0.5, 4, 8, 4, 2), (1, 8, 8, 4)),
    ("merged_encoder", jcodec.MergedRescaleEncoder(**SMALL, rescale_factor=0.5, out_ch=4),
     lambda: codec.MergedRescaleEncoder(**SMALL, rescale_factor=0.5, out_ch=4), (1, 16, 16, 3)),
    ("merged_decoder", jcodec.MergedRescaleDecoder(z_channels=4, **SMALL, rescale_factor=2.0),
     lambda: codec.MergedRescaleDecoder(z_channels=4, **SMALL, rescale_factor=2.0),
     (1, 4, 4, 4)),
    ("upsampler", jcodec.Upsampler(in_size=8, out_size=16, in_channels=4, out_channels=3),
     lambda: codec.Upsampler(8, 16, 4, 3), (1, 8, 8, 4)),
    ("resize_conv", jcodec.Resize(scale_factor=1.5, with_conv=True),
     lambda: codec.Resize(1.5, True, 4), (1, 8, 8, 4)),
    ("resize", jcodec.Resize(scale_factor=0.5), lambda: codec.Resize(0.5), (1, 8, 6, 4)),
    ("post_processor", jcodec.FirstStagePostProcessor(ch_mult=(1, 2), in_channels=4,
                                                      proj_channels=8,
                                                      reshape_to_sequence=True),
     lambda: codec.FirstStagePostProcessor((1, 2), 4, 8, reshape_to_sequence=True),
     (2, 8, 8, 4)),
]


@pytest.mark.parametrize("name,jmod,make,shape", HEADS, ids=[h[0] for h in HEADS])
def test_codec_head_matches(name, jmod, make, shape):
    x = nprand(*shape, seed=len(name))
    params = {} if name == "resize" else flax_init(jmod, jnp.asarray(x), seed=3)
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    mod = port(make(), params)
    with torch.no_grad():
        assert_close(mod(to_torch(x)), ref, TOL)


def test_autoencoder_kl_dropout_matches():
    mp = dict(embed_dim=4, ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
              resolution=16)
    x = np.tanh(nprand(1, 16, 16, 3, seed=4))
    jvae = JAutoencoderKL(**mp, dropout=0.1)
    params = flax_init(jvae, jnp.asarray(x), jax.random.PRNGKey(0), seed=5)
    vae = port(AutoencoderKL(**mp, dropout=0.1, device="cpu"), params).train()
    fwd = lambda det: jax.jit(lambda p, x: jvae.apply(
        {"params": p}, x, jax.random.PRNGKey(0), sample_posterior=False, deterministic=det,
        rngs={"dropout": jax.random.PRNGKey(1)})[0])(params, jnp.asarray(x))
    with torch.no_grad():
        det = vae(to_torch(x), sample_posterior=False)[0]
        assert_close(det, fwd(True), TOL)
        with injected_dropout(vae):
            ref = fwd(False)
            with dropout_rng(torch.Generator().manual_seed(0)):
                assert_close(vae(to_torch(x), sample_posterior=False)[0], ref, TOL)
                assert torch.equal(vae.eval()(to_torch(x), sample_posterior=False)[0], det)
    assert not np.allclose(np.asarray(ref), det.numpy())
