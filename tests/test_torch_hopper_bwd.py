"""The Hopper flash backward's route, rows and tiling, on the CPU, before the card.

The dQ and dK/dV kernels run `flash_attention_bwd_sm90.cu` up to head dim
128 and `flash_attention_bwd_wide_sm90.cu` from 129 to 512, decided by
`bwd_route` from the shape alone: on a CPU tensor exactly as on the card.
Each Hopper launch counts under its route counter (`flash_bwd_dq_sm90`,
`flash_bwd_dkv_sm90`; `flash_bwd_dq_wide_sm90`, `flash_bwd_dkv_wide_sm90`)
beside the wrapper's, and `chip_smoke.py` expects 40 of each d ≤ 128 one
per `train_ldm` step and 2 of each wide one per `train_kl_vae` step.
`bwd_rows` picks the rows per block (128 at head dims up to 48 where that
grid fills a wave of the H100, else 64) from the shape alone.

`_flash_bwd_tiled_ref` repeats the Hopper kernels' tiling (blocks of own
rows, 64-row tiles of the other side in order, the head dim padded to 16,
zero rows past Sq and Skv, the index masks, P and dS rounded to the
operands' dtype, fp32 sums); it is held in fp32 against `jax.vjp` of the TPU
package's Pallas backward in interpret mode and against the plain backward
at ragged sizes, within 1e-4·max(1, max|ref|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import assert_close, nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

import chip_smoke
from sd_tpu.kernels import flash_attention as jfa
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build, flash_attention as fa

# the source of each route, as PERF.md's kernel table names it (rows 5 and 6),
# and the suffix of its C entry points
BWD_SOURCE = {"sm90": "flash_attention_bwd_sm90", "wide": "flash_attention_bwd_wide_sm90"}
BWD_SUFFIX = {"sm90": "_sm90", "wide": "_wide_sm90"}


def _want_route(d: int) -> str:
    return "sm90" if d <= 128 else "wide"


@pytest.mark.parametrize("shape", chip_smoke.TRAIN_KERNEL_SHAPES)
def test_bwd_route_at_the_training_shapes(shape):
    d = shape[-1]
    route = fa.bwd_route(d)
    assert route == _want_route(d)
    for kind in ("dq", "dkv"):
        assert fa._BWD_ENTRY[kind, route][0] == BWD_SOURCE[route]


@pytest.mark.parametrize("d", [16, 40, 80, 128, 136, 512])
def test_bwd_route_at_head_dims(d):
    route = fa.bwd_route(d)
    assert route == _want_route(d)
    assert fa._BWD_ENTRY["dq", route] == (BWD_SOURCE[route], "sd_flash_bwd_dq"
                                          + BWD_SUFFIX[route])
    assert BWD_SOURCE[route] in _build.SOURCES
    assert (_build.CSRC / f"{BWD_SOURCE[route]}.cu").is_file()
    # the yardstick at every head dim is flash_attention_bwd.cu
    assert fa._BWD_ENTRY["dkv", "template"][0] == "flash_attention_bwd"


@pytest.mark.parametrize("d", [520, 1024])
def test_bwd_route_refuses_heads_past_512(d):
    with pytest.raises(ValueError):
        fa.bwd_route(d)
    q = torch.zeros(1, 8, 1, d)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError):   # on a CPU tensor too, before any plain version
        fa.flash_bwd_dq(q, q, q, q, lse, q, d**-0.5)
    with pytest.raises(ValueError):
        fa.flash_bwd_dkv(q, q, q, q, lse, lse, d**-0.5)


@pytest.mark.parametrize("d", [40, 136])
def test_bwd_route_is_decided_on_the_cpu(monkeypatch, d):
    seen = []
    rule = fa.bwd_route
    monkeypatch.setattr(fa, "bwd_route", lambda dd: seen.append(rule(dd)) or seen[-1])
    q, k, v, do = (to_torch(nprand(1, s, 2, d, seed=i)) for i, s in enumerate((16, 24, 24, 16)))
    o, lse = fa._flash_lse_ref(q, k, v, d**-0.5)
    kernels.reset_launches()
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, d**-0.5)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, d**-0.5)
    assert seen == [_want_route(d)] * 2
    assert not any(kernels.LAUNCHES.values())   # the CPU launches nothing
    for got, want in zip((dq, dk, dv, delta), fa._flash_bwd_ref(q, k, v, o, lse, do, d**-0.5)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# [B, S, H, D] of the two main-path shapes (train_ldm's UNet levels 0 and 1;
# Sq = Skv, so the dQ and dK/dV grids are the same) and the rows a block
# takes: 32 · 8 = 256 blocks of 128 rows fill a wave at level 0; at level 1,
# d = 80 has no 128-row form (and 8 · 8 = 64 blocks would leave half the SMs
# idle), so 128 blocks of 64
@pytest.mark.parametrize("b,s,h,d,rows,blocks", [(1, 4096, 8, 40, 128, 256),
                                                 (1, 1024, 8, 80, 64, 128)])
def test_bwd_rows_at_the_main_path_shapes(b, s, h, d, rows, blocks):
    assert fa.bwd_rows(b, s, h, d) == rows
    assert -(-s // rows) * b * h == blocks
    assert (-(-s // 128) * b * h >= fa.H100_SMS) == (rows == 128)


@pytest.mark.parametrize("b,s,h,d,rows", [(1, 1000, 8, 40, 64), (4, 4096, 8, 40, 128),
                                          (1, 16896, 1, 48, 128), (1, 16768, 1, 40, 64),
                                          (2, 200, 3, 16, 64), (4, 1024, 8, 80, 64),
                                          (4, 4096, 8, 56, 64), (4, 4096, 8, 128, 64)])
def test_bwd_rows_rule(b, s, h, d, rows):
    """128 rows exactly where the head dim is at most `BWD_ROWS_128_MAX_D`
    (48) and a 128-row grid has at least one block per SM."""
    assert fa.BWD_ROWS_128_MAX_D == 48
    assert fa.bwd_rows(b, s, h, d) == rows
    fills = -(-s // 128) * b * h >= fa.H100_SMS
    assert (rows == 128) == (fills and d <= fa.BWD_ROWS_128_MAX_D)


def test_training_launches_carry_the_bwd_routes():
    train, klvae = chip_smoke.EXPECTED_TRAIN_LAUNCHES, chip_smoke.EXPECTED_KLVAE_LAUNCHES
    assert (train["flash_bwd_dq_sm90"], train["flash_bwd_dkv_sm90"]) == (40, 40)
    assert (klvae["flash_bwd_dq_sm90"], klvae["flash_bwd_dkv_sm90"]) == (0, 0)
    assert (train["flash_bwd_dq_wide_sm90"], train["flash_bwd_dkv_wide_sm90"]) == (0, 0)
    assert (klvae["flash_bwd_dq_wide_sm90"], klvae["flash_bwd_dkv_wide_sm90"]) == (2, 2)
    # every wrapper launch counts under exactly one route on each path
    for path in (train, klvae):
        for kind in ("dq", "dkv"):
            assert path[f"flash_bwd_{kind}"] == sum(
                path[c] for (k, _), c in fa.BWD_ROUTE_COUNTERS.items() if k == kind)
    counters = set(fa.BWD_ROUTE_COUNTERS.values())
    assert counters == {"flash_bwd_dq_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_wide_sm90",
                        "flash_bwd_dkv_wide_sm90"}
    assert counters <= set(kernels.LAUNCHES) & set(chip_smoke.KERNELS)
    assert fa.BWD_ROUTE_COUNTERS == chip_smoke.BWD_ROUTE_COUNTER
    # the attention-switch phase's training cases (d = 40) move both d ≤ 128
    # counters, the chunked one neither, and none the wide ones
    sm90 = {c for (_, route), c in fa.BWD_ROUTE_COUNTERS.items() if route == "sm90"}
    for env, call, want in chip_smoke.ATTN_SWITCH_CASES:
        if call == "train":
            moved = {want.get(c, 0) for c in sm90}
            assert moved == ({0} if env.get("SD_TPU_FLASH_BWD") == "chunked"
                             or env.get("SD_TPU_ATTN_IMPL") == "xla" else {1}), env
            assert all(want.get(c, 0) == 0 for c in counters - sm90), env


def _inputs(b, sq, skv, h, d):
    return [nprand(b, s, h, d, seed=i) for i, s in enumerate((sq, skv, skv, sq))]


# fp32 against the Pallas backward in interpret mode: the head dims of the
# UNet and ragged q and kv lengths past a 64-row tile
@pytest.mark.parametrize("b,sq,skv,h,d,rows", [(1, 100, 130, 2, 40, (64, 64)),
                                               (1, 128, 200, 1, 80, (128, 64))])
def test_tiled_ref_matches_the_pallas_backward(b, sq, skv, h, d, rows):
    q, k, v, do = _inputs(b, sq, skv, h, d)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True),
                     *(jnp.asarray(t) for t in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (to_torch(t) for t in (q, k, v, do))
    o, lse = fa._flash_lse_ref(tq, tk, tv, d**-0.5)
    got = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, d**-0.5, rows)
    for g, want in zip(got[:3], ref_grads):
        assert_close(g, want)


@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 100, 130, 2, 40), (1, 100, 130, 2, 80),
                                          (2, 70, 65, 1, 80), (1, 64, 256, 3, 16)])
@pytest.mark.parametrize("rows", [(64, 64), (128, 128)])
def test_tiled_ref_matches_the_plain_backward(b, sq, skv, h, d, rows):
    tq, tk, tv, tdo = (to_torch(t) for t in _inputs(b, sq, skv, h, d))
    o, lse = fa._flash_lse_ref(tq, tk, tv, d**-0.5)
    got = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, d**-0.5, rows)
    for g, want in zip(got, fa._flash_bwd_ref(tq, tk, tv, o, lse, tdo, d**-0.5)):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert_close(g, want)


def test_tiled_ref_rounds_p_and_ds_to_the_operand_dtype():
    """bf16 inputs: P and dS round to bf16 before the second products, as on
    the card and in the plain version, whose every sum is fp32 too."""
    tq, tk, tv, tdo = (to_torch(t).bfloat16() for t in _inputs(1, 100, 130, 2, 40))
    o, lse = fa._flash_lse_ref(tq, tk, tv, 40**-0.5)
    got = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 40**-0.5, (64, 128))
    want = fa._flash_bwd_ref(tq, tk, tv, o, lse, tdo, 40**-0.5)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16
        # at most one bf16 rounding step apart: the sums run in another order
        assert_close(g.float(), w.float(), 2**-7)


def test_dropping_the_masks_changes_the_result():
    """A padded q column reads lse2 = NEG_INF: without the index mask its p is
    inf, and inf times its zero row of dO and Q poisons dK and dV. dQ's
    padded kv columns meet zero rows of K and add nothing, masked or not."""
    tq, tk, tv, tdo = (to_torch(t) for t in _inputs(1, 100, 130, 2, 40))
    o, lse = fa._flash_lse_ref(tq, tk, tv, 40**-0.5)
    masked = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 40**-0.5)
    bare = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 40**-0.5, masks=False)
    assert all(bool(torch.isfinite(t).all()) for t in masked)
    assert not torch.isfinite(bare[1]).all() and not torch.isfinite(bare[2]).all()
    torch.testing.assert_close(bare[0], masked[0], rtol=0, atol=0)
    # with Sq a whole number of tiles there is no padded column: no change
    tq, tk, tv, tdo = (to_torch(t) for t in _inputs(1, 128, 130, 2, 40))
    o, lse = fa._flash_lse_ref(tq, tk, tv, 40**-0.5)
    for a, b in zip(fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 40**-0.5),
                    fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 40**-0.5, masks=False)):
        assert np.array_equal(a.numpy(), b.numpy())
