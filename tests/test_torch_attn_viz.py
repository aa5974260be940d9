"""The cross-attention heatmaps in the port (`sd_tpu_torch/utils/attn_viz.py`
over the cross capture of `nn/attn_probe.py`) against the JAX package's,
fp32 on the CPU.

`cross_attention_maps` on a two-level UNet (cross-attention at both levels
and in the middle, weights carried across) at a non-square 16×12 latent:
the captured paths equal the JAX package's sown paths (7: two input blocks,
the middle one, four output blocks), every row sums to 1,
the probabilities within 1e-5·max|ref|, and the UNet's output is the plain
forward's (the capture computes what the other routes compute); a path
filter and `max_tokens` select as the JAX package's do, and the self
capture (SAG's) records no cross-attention. `token_heatmaps` on the same
random maps at non-square latent grids (ceil halving, a map on no grid
skipped), resized up and left at the latent size, with and without the
min-max scaling, within 1e-5·max|ref|: `jax.image.resize`'s bilinear
weights, edges included. `overlay_heatmap_grid` within 1 uint8 level (its
truncation may flip where the fp32 resizes differ in the last bit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_UNET

from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.utils import attn_viz as jviz
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.nn import attn_probe
from sd_tpu_torch.utils import attn_viz

TOL = 1e-5
UNET = {**TINY_UNET, "attention_resolutions": (1, 2)}


def close(got, ref, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, bound = np.abs(got - ref).max(), tol * np.abs(ref).max()
    assert err <= bound, f"max|Δ| = {err:.3g} > {bound:.3g}"


@pytest.fixture(scope="module")
def unets():
    params = flax_init(JUNet(**UNET), jnp.zeros((1, 16, 12, 4)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 16, 32)), seed=11)
    return params, port(UNetModel(**UNET, device="cpu"), params)


def test_cross_attention_maps_match(unets):
    params, unet = unets
    x, ctx = nprand(2, 16, 12, 4, seed=12), nprand(2, 7, 32, seed=13)
    t = np.array([3, 700], np.int32)
    maps_fn = jax.jit(lambda p, *a: jviz.cross_attention_maps(JUNet(**UNET), p, *a))
    ref = maps_fn(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = attn_viz.cross_attention_maps(unet, to_torch(x), torch.from_numpy(t), to_torch(ctx))
    # 2 input blocks, the middle one, 4 output blocks
    assert sorted(got) == sorted(ref) and len(got) == 7, sorted(got)
    assert all(path.endswith("/attn2") for path in got)
    for path, probs in got.items():
        assert probs.dtype == torch.float32 and probs.shape[-1] == 7
        assert float((probs.sum(-1) - 1).abs().max()) <= 1e-5
        close(probs, ref[path])
    # the captured forward is the plain one
    with torch.no_grad():
        plain = unet(to_torch(x), torch.from_numpy(t), to_torch(ctx))
        with attn_probe.capture_attention(unet, "", kind="cross") as probs:
            captured = unet(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    close(captured, plain, 1e-6)
    # a path filter, max_tokens, and the self capture
    some = attn_viz.cross_attention_maps(unet, to_torch(x), torch.from_numpy(t), to_torch(ctx),
                                         path_substr="out", max_tokens=48)
    # the JAX package's rule: a path part containing the filter, N ≤ max_tokens
    assert sorted(some) == sorted(k for k, v in ref.items()
                                  if any("out" in part for part in k.split("/"))
                                  and v.shape[2] <= 48) != []
    with torch.no_grad(), attn_probe.capture_self_attention(unet, "", 4096) as probs:
        unet(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert probs and all(path.endswith("/attn1") for path in probs), sorted(probs)
    with pytest.raises(ValueError, match="self/cross/any"):
        with attn_probe.capture_attention(unet, kind="both"):
            pass


def _maps(b, grids, m, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(grids):
        logits = rng.standard_normal((b, 2, n, m)).astype(np.float32)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        out[f"block_{i}/attn2"] = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return out


@pytest.mark.parametrize("latent,grids,out_hw", [
    ((12, 10), (120, 30, 9, 7), (40, 24)),      # 12×10 → 6×5 → 3×3; 7 tokens: no grid
    ((9, 14), (126, 35, 12), None),             # 9×14 → 5×7 → 3×4
    ((5, 3), (15, 4, 1), (7, 11))])             # 5×3 → 3×2 → 2×1 → 1×1
@pytest.mark.parametrize("normalize", [True, False])
def test_token_heatmaps_match(latent, grids, out_hw, normalize):
    maps = _maps(2, grids, 5, seed=sum(latent))
    ref = jviz.token_heatmaps({k: jnp.asarray(v) for k, v in maps.items()}, latent, out_hw,
                              normalize)
    got = attn_viz.token_heatmaps({k: to_torch(v) for k, v in maps.items()}, latent, out_hw,
                                  normalize)
    assert got.dtype == np.float32 and got.shape == (2, *(out_hw or latent), 5)
    close(got, ref)
    with pytest.raises(ValueError, match="no captured map"):
        attn_viz.token_heatmaps({"x": to_torch(maps["block_0/attn2"])}, (7, 7))


def test_overlay_heatmap_grid_within_a_level():
    rng = np.random.default_rng(14)
    image = rng.integers(0, 256, (20, 16, 3), dtype=np.uint8)
    heat = rng.random((5, 4, 3)).astype(np.float32)
    got = attn_viz.overlay_heatmap_grid(image, heat, ["a", "b", "c"], alpha=0.7)
    ref = jviz.overlay_heatmap_grid(image, heat, ["a", "b", "c"], alpha=0.7)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (20, 48, 3)
    assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1
