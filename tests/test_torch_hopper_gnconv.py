"""The fused GroupNorm → SiLU → 3×3 conv's Hopper kernel
(`csrc/conv2d_gn_sm90.cu`), on the CPU: its plain versions against the TPU
package, its shape rule and its counters.

`_conv_window_ref` with `prologue` repeats the kernel's window arithmetic
(each landed window transformed once per value, zeros outside the image) and
`_gn_stats_tiled_ref` the statistics pass's order of fp32 sums. Held against
`sd_tpu`'s `gn_silu_conv3x3` (the Pallas kernel in interpret mode) within
1e-4·max(1, max|ref|), as `tests/test_torch_optin.py` holds the plain
version, at shapes that put the halo on all four edges of a tile, with a
partial row tile (H odd) and a partial pixel tile (W past 128, not a multiple
of it); the statistics against `sd_tpu`'s `_gn_stats_affine` at rtol 1e-5
(atol 1e-5·max|ref|: c = bias − mean·a may cancel to near 0). The kernel
itself runs only on the card (`tests/test_torch_cuda.py -m cuda -k gn_silu`).
"""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch
from test_torch_helpers import assert_close, nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

import chip_smoke
from sd_tpu.kernels import conv2d as jconv
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import conv2d


def _gn_conv_inputs(B, H, W, C, O):
    x = nprand(B, H, W, C, scale=2.0) + 0.5
    s, sb = 1 + nprand(C, seed=1, scale=0.1), nprand(C, seed=2, scale=0.1)
    w, cb = nprand(3, 3, C, O, seed=3, scale=(9 * C) ** -0.5), nprand(O, seed=4, scale=0.1)
    return x, s, sb, w, cb


# [B, H, W, C, O], the window tile (rows, pixels), eps: the kernel's tile with
# H odd and W = 131 (a partial row tile and a partial pixel tile), small tiles
# with several tiles each way, O over several 8-channel boxes of output
GN_WINDOW_CASES = [((1, 5, 131, 32, 32), conv2d.CONV_TILE, 1e-6),
                   ((2, 7, 9, 32, 64), (2, 4), 1e-5),
                   ((1, 3, 133, 32, 64), conv2d.CONV_TILE, 1e-5)]


@pytest.mark.parametrize("shape,tile,eps", GN_WINDOW_CASES)
def test_gn_conv_window_ref_matches_pallas(shape, tile, eps):
    x, s, sb, w, cb = _gn_conv_inputs(*shape)
    ref = jconv.gn_silu_conv3x3(*(jnp.asarray(a) for a in (x, s, sb, w, cb)), groups=8,
                                eps=eps, interpret=True)
    tx, ts, tsb, tw, tcb = (to_torch(x), to_torch(s), to_torch(sb),
                            to_torch(w.transpose(3, 2, 0, 1)), to_torch(cb))
    ac = conv2d._gn_stats_tiled_ref(tx, ts, tsb, 8, eps)
    got = conv2d._conv_window_ref(tx, tw, tcb, tile, prologue=ac)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_close(got, ref)
    assert_close(got, conv2d._gn_silu_conv_xla(tx, ts, tsb, tw, tcb, 8, eps))


def test_gn_conv_window_ref_zeroes_the_halo():
    """With a = 0 and c = 1 every value inside the image becomes silu(1) and
    every halo position 0: a 3×3 all-ones conv then counts each output's
    neighbours inside the image."""
    B, H, W, C, O = 1, 3, 133, 8, 8
    x = torch.randn(B, H, W, C)
    a, c = torch.zeros(B, C), torch.ones(B, C)
    out = conv2d._conv_window_ref(x, torch.ones(O, C, 3, 3), torch.zeros(O), prologue=(a, c))
    rows = torch.tensor([2.0, 3.0, 2.0])[:, None]
    cols = torch.full((W,), 3.0)
    cols[0] = cols[-1] = 2.0
    want = (rows * cols)[None, :, :, None] * C * torch.nn.functional.silu(torch.tensor(1.0))
    torch.testing.assert_close(out, want.expand(B, H, W, O), rtol=1e-6, atol=1e-5)


# [B, H, W, C], groups, eps: one statistics block and several (40 at C = 256:
# blocks strided over the finalize warp's lanes), 64, 8, 32, 21 and 16 pixel
# lanes, one group and 32; bf16 inputs as the kernel takes them
GN_STATS_CASES = [((2, 5, 131, 32), 8, 1e-6, torch.float32),
                  ((1, 100, 100, 256), 32, 1e-5, torch.float32),
                  ((1, 37, 50, 64), 32, 1e-6, torch.bfloat16),
                  ((2, 7, 9, 96), 32, 1e-6, torch.bfloat16),
                  ((1, 33, 65, 128), 1, 1e-5, torch.bfloat16)]


@pytest.mark.parametrize("shape,groups,eps,dtype", GN_STATS_CASES)
def test_gn_stats_tiled_ref_matches_tpu(shape, groups, eps, dtype):
    B, H, W, C = shape
    x = to_torch(nprand(*shape, scale=2.0) + 0.5).to(dtype)
    s, sb = to_torch(1 + nprand(C, seed=1, scale=0.1)), to_torch(nprand(C, seed=2, scale=0.1))
    a, c = conv2d._gn_stats_tiled_ref(x, s, sb, groups, eps)
    ja, jc = jconv._gn_stats_affine(jnp.asarray(x.float().numpy()), jnp.asarray(s.numpy()),
                                    jnp.asarray(sb.numpy()), groups, eps)
    for got, ref in ((a, ja), (c, jc)):
        ref = to_torch(ref)
        assert got.shape == (B, C) and got.dtype == torch.float32
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("hw,c,lanes,blocks", [
    (128 * 128, 512, 4, 128), (256 * 256, 256, 8, 256), (512 * 512, 128, 16, 512),
    (1850, 64, 32, 2), (63, 96, 21, 1), (100, 4096, 1, 4)])
def test_gn_stats_plan(hw, c, lanes, blocks):
    """Each block's threads cover a pixel's 8-channel vectors (at most 256 of
    them) and pixel lanes of 32 pixels each: about 128 KB of x a block up to
    C = 2048."""
    p = conv2d.gn_stats_plan(hw, c, 32)
    assert (p.lanes, p.blocks) == (lanes, blocks)
    assert p.vpl == min(c // 8, conv2d.GN_STATS_THREADS) and p.lanes * p.vpl <= 256
    assert p.pixels == 32 * p.lanes and (p.blocks - 1) * p.pixels < hw <= p.blocks * p.pixels


@pytest.mark.parametrize("C,O,groups", [(48, 128, 8), (64, 64, 8), (64, 128, 24), (64, 0, 8),
                                        (32, 128, 0)])
def test_gn_conv_refuses_what_the_kernel_cannot_take(C, O, groups):
    with pytest.raises(ValueError):
        conv2d.gn_conv_plan((1, 8, 8, C), O, groups)
    x = torch.zeros(1, 8, 8, C, dtype=torch.bfloat16)
    p = torch.zeros(C, dtype=torch.bfloat16)
    w, b = torch.zeros(max(O, 1), C, 3, 3, dtype=torch.bfloat16), torch.zeros(max(O, 1))
    with pytest.raises(ValueError):   # the launch's checks run before any CUDA call
        conv2d._launch_gn_silu_conv(x, p, p, w[:O], b[:O], groups, 1e-6)


@pytest.mark.parametrize("shape", [(1, 8, 8, 32, 128), (2, 37, 50, 64, 256),
                                   (1, 75, 200, 512, 256)])
def test_gn_conv_plan_takes_the_kernels_shapes(shape):
    B, H, W, C, O = shape
    assert conv2d.gn_conv_plan((B, H, W, C), O, 32) == conv2d.gn_stats_plan(H * W, C, 32)


def test_gn_conv_counters_and_chip_smoke_cases():
    assert {"gn_silu_conv3x3", "gn_silu_conv_sm90"} <= set(kernels.LAUNCHES) & set(
        chip_smoke.KERNELS)
    assert chip_smoke.KERNEL_ROUTE_COUNTER["gn_silu_conv3x3"] == "gn_silu_conv_sm90"
    # every end-to-end phase expects no launch of the fused form
    for want in (chip_smoke.EXPECTED_LAUNCHES, chip_smoke.EXPECTED_LAUNCHES_OPTIN,
                 chip_smoke.EXPECTED_SERVE_LAUNCHES, chip_smoke.EXPECTED_TRAIN_LAUNCHES,
                 chip_smoke.EXPECTED_KLVAE_LAUNCHES):
        assert want["gn_silu_conv3x3"] == want["gn_silu_conv_sm90"] == 0
    # the second ragged case (C = 512, H odd, W past one tile) has inputs of its own
    B, H, W, C, O = chip_smoke.GN_CONV_RAGGED[1]
    assert C == 512 and H % 2 and W % 128 and W > 128 and O > 128
    assert chip_smoke.OWN_STREAMS[chip_smoke.GN_CONV_RAGGED[1]] != chip_smoke.OWN_STREAMS[
        chip_smoke.SERVE_PIPE_SHAPE]


def test_gn_conv_cost_counts_the_statistics_read():
    flops, nbytes = chip_smoke.gn_silu_conv_cost(2, 256, 256, 512, 256)
    assert (flops, nbytes) == (chip_smoke.conv3x3_cost(2, 256, 256, 512, 256)[0],
                               chip_smoke.conv3x3_cost(2, 256, 256, 512, 256)[1] + 4 * 512
                               + 2 * 2 * 256 * 256 * 512)
    assert chip_smoke.bound_ms(*chip_smoke.gn_stats_cost(2, 256, 256, 512))[:2] == (
        pytest.approx(0.0401, abs=1e-4), "bytes")
