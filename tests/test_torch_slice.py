"""The ported text-to-image slice against the JAX composition, fp32 on the
CPU at the TPU benchmark's self-test widths: CLIP over [negative; prompt]
→ DDIM (4 steps, CFG 7.5, eta 0, the same injected x_T) through the UNet
→ KL decode, within 1e-3·max(1, max|ref|). (Four steps: with T = 1000 the
"uniform" striding of three steps would index t = 1000, past the table, in
both packages.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import SLICE_TOL, assert_close, flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_UNET, TINY_VAE, unet_params, vae_params

from sd_tpu.core.schedules import DiffusionSchedule
from sd_tpu.diffusion.ddim import DDIMSampler
from sd_tpu.models.autoencoder import AutoencoderKL
from sd_tpu.models.clip_text import ClipTextConfig, ClipTextTransformer, SimpleHashTokenizer
from sd_tpu.models.unet_sd import UNetModel
from sd_tpu_torch.core.config import sd_v1_config
from sd_tpu_torch.pipeline import Text2ImagePipeline, to_uint8

TINY_CLIP = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                 max_length=16)
PROMPTS = ["a photograph of an astronaut riding a horse", "a red cube"]


def tiny_config() -> dict:
    cfg = sd_v1_config()
    cfg["unet"]["params"].update(TINY_UNET)
    cfg["first_stage"]["params"].update(TINY_VAE)
    cfg["cond_stage"]["params"] = dict(TINY_CLIP)
    cfg["latent"]["image_size"] = 16
    return cfg


@pytest.fixture(scope="module")
def weights():
    clip = ClipTextTransformer(ClipTextConfig(**TINY_CLIP))
    cparams = flax_init(clip, jnp.zeros((1, 16), jnp.int32), seed=3)
    return clip, cparams, unet_params(seed=4), vae_params(seed=5)


def test_text_to_image_slice(weights):
    clip, cparams, uparams, vparams = weights
    x_T = nprand(2, 16, 16, 4, seed=6)

    tok = SimpleHashTokenizer(16, 1000)
    emb = jax.jit(clip.apply)({"params": cparams},
                              jnp.concatenate([tok([""] * 2), tok(PROMPTS)], axis=0))
    uc, c = jnp.split(emb, 2, axis=0)
    unet = UNetModel(**TINY_UNET)
    sched = DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    z = DDIMSampler(sched).sample(
        lambda x, t, ctx: unet.apply({"params": uparams}, x, t, ctx),
        jax.random.PRNGKey(0), x_T.shape, num_steps=4, cond=c, uncond=uc,
        guidance_scale=7.5, eta=0.0, x_T=jnp.asarray(x_T))
    ref = jax.jit(lambda p, z: AutoencoderKL(**TINY_VAE).apply(
        {"params": p}, z, method=AutoencoderKL.decode))(vparams, z / 0.18215)

    pipe = Text2ImagePipeline(tiny_config(), device="cpu", param_dtype=torch.float32)
    port(pipe.clip, cparams)
    port(pipe.unet, uparams)
    port(pipe.vae, vparams)
    got = pipe.sample(PROMPTS, to_torch(x_T), num_steps=4, guidance_scale=7.5, eta=0.0)
    assert_close(got, ref, SLICE_TOL)


def test_generate_returns_uint8_images(weights):
    pipe = Text2ImagePipeline(tiny_config(), device="cpu", param_dtype=torch.float32)
    out = pipe.generate(PROMPTS, num_steps=4, seed=1)
    assert out.shape == (2, 32, 32, 3) and out.dtype == np.uint8
    # generate() is sample() on noise from a seeded torch.Generator
    g = torch.Generator().manual_seed(1)
    x_T = torch.randn((2, 16, 16, 4), generator=g)
    np.testing.assert_array_equal(out, to_uint8(pipe.sample(PROMPTS, x_T, num_steps=4)))


def test_weighting_syntax_is_refused(weights):
    """Weighting syntax is ported now: a weighted prompt runs and its emphasis
    changes the image. What `generate` still refuses is a control image or
    an image prompt before its adapter is loaded (ValueError, as the TPU
    package); self-attention guidance runs and changes the image; the tiled
    decode is ported, and a tile no smaller than the image is the whole
    decode. (The JAX package's weights: the port's own initialisation
    zeroes the transformer blocks' output projections, so the text would not
    reach the image.)"""
    clip, cparams, uparams, vparams = weights
    pipe = Text2ImagePipeline(tiny_config(), device="cpu", param_dtype=torch.float32)
    port(pipe.clip, cparams)
    port(pipe.unet, uparams)
    port(pipe.vae, vparams)
    weighted = pipe.generate(["a (very:1.3) red cube"], num_steps=4)
    plain = pipe.generate(["a very red cube"], num_steps=4)
    assert weighted.shape == plain.shape == (1, 32, 32, 3)
    assert not np.array_equal(weighted, plain)
    np.testing.assert_array_equal(pipe.generate(["a very red cube"], num_steps=4,
                                                decode_tile=32), plain)
    for option, loader in ((dict(control_image=np.zeros((32, 32, 3))), "load_controlnet"),
                           (dict(ip_image=np.zeros((32, 32, 3))), "load_ip_adapter")):
        with pytest.raises(ValueError, match=loader):
            pipe.generate(["a red cube"], num_steps=4, **option)
    sag = pipe.generate(["a very red cube"], num_steps=4, sag_scale=0.5)
    assert sag.shape == plain.shape and not np.array_equal(sag, plain)
