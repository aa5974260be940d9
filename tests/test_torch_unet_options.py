"""The UNet's parameter-free serving options against the JAX package, fp32
on the CPU at the tiny widths of `tests/test_torch_models.py`:

* ToMe (`nn/tome.py`): `_dst_grid` and `merge_count` at the SD-v1 grids and
  the rounding cases; the matching itself (merge of one-hot tokens: each
  destination's group, exact) and merge / unmerge of random tokens, within
  1e-4·max(1, max|ref|); a UNet call with ToMe at the 16² level (256 tokens:
  128 merged);
* FreeU: `_fourier_filter` at even and odd sizes, and a UNet call with the
  SD-v1 paper's (1.2, 1.4, 0.9, 0.2);
* `Text2ImagePipeline.set_unet_options`: the options take effect on the
  next call, a ratio of 0 and `freeu=None` give plain `generate` bit for
  bit, other fields are refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import MODULE_TOL, assert_close, nprand, port, to_torch
from test_torch_models import TINY_UNET, unet_params
from test_torch_slice import PROMPTS, tiny_config

from sd_tpu.models import unet_sd as junet
from sd_tpu.nn import tome as jtome
from sd_tpu_torch.models import unet_sd
from sd_tpu_torch.nn import tome
from sd_tpu_torch.pipeline import Text2ImagePipeline

FREEU = (1.2, 1.4, 0.9, 0.2)


@pytest.mark.parametrize("n,ratio", [(4096, 0.5), (1024, 0.5), (256, 0.5), (4096, 0.3),
                                     (1024, 0.05), (64, 0.5), (16384, 0.6), (4096, 0.0)])
def test_merge_count_and_grid_match(n, ratio):
    side = int(n ** 0.5)
    src, dst = tome._dst_grid(side, side)
    jsrc, jdst = jtome._dst_grid(side, side)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    assert tome.merge_count(n, len(src), ratio) == jtome.merge_count(n, len(jsrc), ratio)


def test_merge_counts_at_sd_v1_512():
    """At 512² with ratio 0.5 the 64² level keeps 2048 tokens and the 32²
    level 512, both multiples of 128 (the flash gate's q tile)."""
    for side, kept in ((64, 2048), (32, 512)):
        n = side * side
        assert n - tome.merge_count(n, n - n // 4, 0.5) == kept


def _jax_tome(x, tokens, H, W, ratio):
    def run(x, t):
        merge, unmerge, _ = jtome.build_tome(x, H, W, ratio)
        m = merge(t)
        return m, unmerge(m)
    return jax.jit(run)(jnp.asarray(x), jnp.asarray(tokens))


def test_tome_matching_and_merge_unmerge_match():
    """The matching first: one-hot tokens merge into each destination's
    group (1/count at its members' positions), the same in both packages;
    then random tokens through merge and unmerge."""
    H = W = 16
    N = H * W
    x = nprand(2, N, 64, seed=3)
    merge, unmerge, r = tome.build_tome(to_torch(x), H, W, 0.5)
    assert r == 128
    eye = np.broadcast_to(np.eye(N, dtype=np.float32), (2, N, N))
    ref_m, _ = _jax_tome(x, eye, H, W, 0.5)
    np.testing.assert_array_equal(merge(to_torch(eye.copy())).numpy(), np.asarray(ref_m))
    tokens = nprand(2, N, 48, seed=4)
    ref_m, ref_u = _jax_tome(x, tokens, H, W, 0.5)
    m = merge(to_torch(tokens))
    assert m.shape == (2, N - r, 48)
    assert_close(m, ref_m, MODULE_TOL)
    assert_close(unmerge(m), ref_u, MODULE_TOL)


def test_tome_ties_rank_toward_the_lower_index():
    """Equal similarities (repeated tokens) rank by index, as `lax.top_k`."""
    x = np.tile(nprand(1, 1, 8, seed=1), (1, 256, 1))
    merge, _, _ = tome.build_tome(to_torch(x), 16, 16, 0.5)
    eye = np.eye(256, dtype=np.float32)[None]
    ref_m, _ = _jax_tome(x, eye, 16, 16, 0.5)
    np.testing.assert_array_equal(merge(to_torch(eye)).numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 7, 5, 3), (2, 2, 2, 4)])
def test_fourier_filter_matches(shape):
    x = nprand(*shape, seed=2)
    ref = jax.jit(lambda a: junet._fourier_filter(a, 1, 0.9))(jnp.asarray(x))
    assert_close(unet_sd._fourier_filter(to_torch(x), 1, 0.9), ref, MODULE_TOL)


@pytest.mark.parametrize("option", ["tome", "freeu"])
def test_unet_call_with_the_option_matches(option):
    """A UNet call at latent 32²: ToMe on the 16² level (tome_min_tokens
    256), or FreeU; the port's options set after construction."""
    opts = (dict(tome_ratio=0.5, tome_min_tokens=256) if option == "tome"
            else dict(freeu=FREEU))
    params = unet_params(seed=5)
    x, ctx = nprand(2, 32, 32, 4, seed=1), nprand(2, 16, 32, seed=2)
    t = np.array([981, 1], np.int32)
    ref = jax.jit(lambda p, *a: junet.UNetModel(**TINY_UNET, **opts).apply({"params": p}, *a))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    mod = port(unet_sd.UNetModel(**TINY_UNET, device="cpu"), params)
    with torch.no_grad():
        plain = mod(to_torch(x), torch.from_numpy(t), to_torch(ctx))
        mod.set_options(**opts)
        got = mod(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert_close(got, ref, MODULE_TOL)
    assert float((got - plain).abs().max()) > 1e-3


def test_set_unet_options_take_effect_and_reset():
    cfg = tiny_config()
    cfg["unet"]["params"]["attention_resolutions"] = (1,)   # ToMe's 16² grid
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():                  # every weight random: no zero-init output
        for p in pipe.unet.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    kw = dict(num_steps=4, seed=2)
    plain = pipe.generate(PROMPTS, **kw)
    pipe.set_unet_options(tome_ratio=0.0, freeu=None)
    np.testing.assert_array_equal(pipe.generate(PROMPTS, **kw), plain)
    for opts in (dict(tome_ratio=0.5, tome_min_tokens=256), dict(freeu=FREEU)):
        pipe.set_unet_options(**opts)
        assert not np.array_equal(pipe.generate(PROMPTS, **kw), plain), opts
        pipe.set_unet_options(tome_ratio=0.0, freeu=None)
    np.testing.assert_array_equal(pipe.generate(PROMPTS, **kw), plain)
    with pytest.raises(TypeError, match="parameter-free"):
        pipe.set_unet_options(model_channels=64)
