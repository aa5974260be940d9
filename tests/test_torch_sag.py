"""Self-Attention Guidance in the port against the JAX package, fp32 on the
CPU: `gaussian_blur_2d`, `sag_mask_from_probs` (the same mask),
`degrade_pred_x0`, the probe (`make_probs_apply`: the UNet's output, and the
mid-block salience mask at the input's grid), one DDIM SAG step with and
without CFG on a linear model, and `generate(sag_scale=0.75)` over 4 DDIM
steps at the tiny widths of `tests/test_torch_slice.py` (uint8 images within
1 level); the collector raises when nothing was captured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import (MODULE_TOL, assert_close, jax_pipeline, nprand, port_pipeline,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_image_edit import _normal, _split, assert_within_a_level
from test_torch_models import TINY_UNET
from test_torch_samplers import jax_model, schedules, torch_model
from test_torch_slice import PROMPTS, tiny_config

from sd_tpu.diffusion import ddim as jddim
from sd_tpu.diffusion import sag as jsag
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu_torch.diffusion import ddim, sag
from sd_tpu_torch.nn import attn_probe
from sd_tpu_torch.pipeline import to_uint8


@pytest.fixture(scope="module")
def pipes():
    cfg = tiny_config()
    jpipe = jax_pipeline(cfg, seed=41)
    return jpipe, port_pipeline(cfg, jpipe)


@pytest.mark.parametrize("kernel,sigma", [(9, 1.0), (5, 2.5)])
def test_gaussian_blur_matches(kernel, sigma):
    x = nprand(2, 12, 10, 4, seed=kernel)
    ref = jax.jit(lambda a: jsag.gaussian_blur_2d(a, kernel, sigma))(jnp.asarray(x))
    assert_close(sag.gaussian_blur_2d(to_torch(x), kernel, sigma), ref, 1e-6)
    with pytest.raises(ValueError, match="odd"):
        sag.gaussian_blur_2d(to_torch(x), 4)


def test_mask_and_degrade_match():
    """Random attention maps (every column mass well away from 1.0): the
    same {0, 1} mask; the degradation within 1e-6."""
    logits = nprand(2, 4, 64, 64, seed=2, scale=2.0)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ref = np.asarray(jsag.sag_mask_from_probs(jnp.asarray(probs), 8, 8))
    got = sag.sag_mask_from_probs(to_torch(probs), 8, 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1
    x0 = nprand(2, 8, 8, 4, seed=3)
    assert_close(sag.degrade_pred_x0(to_torch(x0), got), jsag.degrade_pred_x0(x0, ref), 1e-6)
    with pytest.raises(ValueError, match="expected 8x4"):
        sag.sag_mask_from_probs(to_torch(probs), 8, 4)


def test_probe_matches(pipes):
    """`make_probs_apply` on the tiny UNet at 14² (the odd grid's ceil
    division; `generate` below takes 16²): the output as the plain UNet's,
    within MODULE_TOL of the JAX package's, and the same mask."""
    jpipe, pipe = pipes
    x, ctx, t = nprand(2, 14, 14, 4, seed=14), nprand(2, 16, 32, seed=5), np.array([10, 900])
    ref_out, ref_mask = jax.jit(jsag.make_probs_apply(JUNet(**TINY_UNET)))(
        jpipe.unet_params, x, t.astype(np.int32), ctx)
    args = (to_torch(x), torch.from_numpy(t), to_torch(ctx))
    with torch.no_grad():
        out, mask = sag.make_probs_apply(pipe.unet)(*args)
        assert torch.equal(out, pipe.unet(*args))
    assert_close(out, ref_out, MODULE_TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert 0 < float(mask.mean()) < 1


def test_collector_raises_without_a_capture(pipes):
    _, pipe = pipes
    with attn_probe.capture_self_attention(pipe.unet, "mid_attn", max_tokens=16) as probs:
        with torch.no_grad():
            pipe.unet(to_torch(nprand(1, 16, 16, 4)), torch.zeros(1), to_torch(nprand(1, 16, 32)))
    assert probs == {}      # 64 mid-block tokens, above max_tokens
    with pytest.raises(ValueError, match="no captured attention"):
        attn_probe.collect_sown_probs(probs)
    # a path part both attentions of a block share: only the self-attention records
    with attn_probe.capture_self_attention(pipe.unet, "block_0", max_tokens=256) as probs:
        with torch.no_grad():
            pipe.unet(to_torch(nprand(1, 16, 16, 4)), torch.zeros(1), to_torch(nprand(1, 16, 32)))
    assert probs and all(path.endswith("/attn1") for path in probs), sorted(probs)


@pytest.mark.parametrize("cfg_scale", [1.0, 5.0])
def test_ddim_sag_step_matches(cfg_scale):
    """One SAG step (DDIM table index 3 of 5) on the linear model with a fixed
    mask, with and without CFG, and the whole 5-step sample with SAG."""
    js, ts = schedules()
    shape = (2, 4, 4, 3)
    x, cond, uncond = nprand(*shape, seed=1), nprand(2, 1, 1, 3, seed=2), nprand(2, 1, 1, 3, seed=3)
    mask = (np.random.default_rng(4).random((4, 4, 4, 1)) > 0.5).astype(np.float32)
    jprobs = lambda x_, t_, c_: (jax_model(x_, t_, c_), jnp.asarray(mask[:x_.shape[0]]))
    tprobs = lambda x_, t_, c_: (torch_model(x_, t_, c_), to_torch(mask[:x_.shape[0]]))
    jsam, tsam = jddim.DDIMSampler(js), ddim.DDIMSampler(ts)
    jdd, tdd = jsam.make_schedule(5), tsam.make_schedule(5)
    t = np.full((2,), int(np.asarray(jdd.timesteps)[3]), np.int32)
    ref = jax.jit(lambda a, c, u: jsam.p_sample_ddim_sag(
        jax_model, jprobs, a, jnp.asarray(t), jnp.asarray(3), jdd, None, cond=c, uncond=u,
        guidance_scale=cfg_scale, sag_scale=0.75))(*map(jnp.asarray, (x, cond, uncond)))
    got = tsam.p_sample_ddim_sag(torch_model, tprobs, to_torch(x), torch.from_numpy(t), 3, tdd,
                                 cond=to_torch(cond), uncond=to_torch(uncond),
                                 guidance_scale=cfg_scale, sag_scale=0.75)
    for g, r in zip(got, ref):
        assert_close(g, r, MODULE_TOL)
    ref = jax.jit(lambda a, c, u: jsam.sample(
        jax_model, jax.random.PRNGKey(0), shape, num_steps=5, cond=c, uncond=u,
        guidance_scale=cfg_scale, x_T=a, sag_scale=0.75, sag_probs_fn=jprobs))(
        *map(jnp.asarray, (x, cond, uncond)))
    got = tsam.sample(torch_model, shape, to_torch(x), num_steps=5, cond=to_torch(cond),
                      uncond=to_torch(uncond), guidance_scale=cfg_scale, sag_scale=0.75,
                      sag_probs_fn=tprobs)
    assert_close(got, ref, MODULE_TOL)
    with pytest.raises(ValueError, match="sag_probs_fn"):
        tsam.sample(torch_model, shape, to_torch(x), num_steps=5, sag_scale=0.75)


def test_generate_with_sag_matches(pipes):
    """`generate(sag_scale=0.75)`, 4 DDIM steps, CFG 5: the JAX pipeline's
    images against the port's `sample` on its x_T."""
    jpipe, pipe = pipes
    ref = jpipe.generate(PROMPTS, num_steps=4, guidance_scale=5.0, seed=4, sag_scale=0.75)
    x_T = _normal(_split(jax.random.PRNGKey(4), 2)[1], (2, 16, 16, 4))
    img = pipe.sample(PROMPTS, x_T, num_steps=4, guidance_scale=5.0, sag_scale=0.75)
    assert_within_a_level(to_uint8(img), ref)
    plain = to_uint8(pipe.sample(PROMPTS, x_T, num_steps=4, guidance_scale=5.0))
    assert not np.array_equal(to_uint8(img), plain)
