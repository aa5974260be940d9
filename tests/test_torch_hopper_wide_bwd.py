"""The wide Hopper flash backward (head dims 129-512) on the CPU, before the
card, and the int8 PV's accuracy contract as `sd_tpu` states it.

Above head dim 128 the dQ and dK/dV kernels run
`flash_attention_bwd_wide_sm90.cu`, decided by `bwd_route` from the shape
alone: on a CPU tensor exactly as on the card. Each launch counts under
`flash_bwd_dq_wide_sm90` / `flash_bwd_dkv_wide_sm90` beside the wrapper's
own, and `chip_smoke.py` expects 2 + 2 of them per `train_kl_vae` step and
none per `train_ldm` step. `bwd_wide_split` says over how many blocks of a
cluster a 64-row slab's head dim is split (2 at padded head dim 512, 1 at
256), from the shape alone.

`_flash_bwd_tiled_ref` with `tile` 32 and `split` is the plain model of the
new arithmetic order: 64-row slabs, 32-row tiles of the other side in
order, the head dim padded to 256 or 512 and cut into `split` parts whose
partial S, dP and delta are added in rank order, P and dS rounded to the
operands' dtype. It is held in fp32 against `jax.vjp` of the TPU package's
Pallas backward in interpret mode at d = 256 and 512 and against the plain
backward at ragged sizes, within 1e-4·max(1, max|ref|), and in bf16 within
one rounding step.

The int8 PV (`pv_quant="int8"`): on 3 seeds at the TPU package's contract
shape [1, 256, 2, 40] with 128-row blocks, the port's plain int8 sweep has
`sd_tpu`'s worst and mean error against exact attention, to within fp32
rounding: the contract the card's kernel is held to is "faithful to
`sd_tpu`". Run as a script, this file prints the spread of both over 32
seeds:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hopper_wide_bwd.py
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

WIDE_COUNTERS = {"dq": "flash_bwd_dq_wide_sm90", "dkv": "flash_bwd_dkv_wide_sm90"}


@pytest.mark.parametrize("d", [136, 256, 512])
def test_wide_route_and_counters_at_head_dims(d):
    assert fa.bwd_route(d) == "wide"
    for kind in ("dq", "dkv"):
        assert fa._BWD_ENTRY[kind, "wide"] == ("flash_attention_bwd_wide_sm90",
                                               f"sd_flash_bwd_{kind}_wide_sm90")
        assert fa.BWD_ROUTE_COUNTERS[kind, "wide"] == WIDE_COUNTERS[kind]
        # the yardstick at every head dim is flash_attention_bwd.cu
        assert fa._BWD_ENTRY[kind, "template"] == ("flash_attention_bwd", f"sd_flash_bwd_{kind}")
    assert "flash_attention_bwd_wide_sm90" in _build.SOURCES
    assert (_build.CSRC / "flash_attention_bwd_wide_sm90.cu").is_file()


@pytest.mark.parametrize("d", [136, 256, 512])
def test_wide_route_and_split_are_decided_on_the_cpu(monkeypatch, d):
    """The wrappers decide the route on a CPU tensor as on the card, launch
    nothing there and return the plain version's bits."""
    seen = []
    rule = fa.bwd_route
    monkeypatch.setattr(fa, "bwd_route", lambda dd: seen.append(rule(dd)) or seen[-1])
    q, k, v, do = (to_torch(nprand(1, s, 1, d, seed=i)) for i, s in enumerate((16, 24, 24, 16)))
    o, lse = fa._flash_lse_ref(q, k, v, d**-0.5)
    kernels.reset_launches()
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, d**-0.5)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, d**-0.5)
    assert seen == ["wide"] * 2
    assert not any(kernels.LAUNCHES.values())   # the CPU launches nothing
    for got, want in zip((dq, dk, dv, delta), fa._flash_bwd_ref(q, k, v, o, lse, do, d**-0.5)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fa.bwd_wide_split(d) == (2 if d > 256 else 1)


# [B, S, H, D] (S own rows), the blocks a 64-row slab (2 at padded head dim
# 512: dK and dV of 512 columns would fill an SM's registers; 1 at 256) and
# the blocks of the grid: train_kl_vae's [4, 1024, 1, 512] and a 512² codec's
# [1, 4096, 1, 512] fill 128 of the H100's 132 SMs, train_ddpm's
# [6, 1024, 1, 256] 96
@pytest.mark.parametrize("b,s,h,d,split,blocks", [(4, 1024, 1, 512, 2, 128),
                                                  (1, 4096, 1, 512, 2, 128),
                                                  (1, 1300, 1, 512, 2, 42),
                                                  (2, 256, 3, 264, 2, 48),
                                                  (6, 1024, 1, 256, 1, 96),
                                                  (1, 1024, 1, 256, 1, 16),
                                                  (4, 1024, 2, 200, 1, 128),
                                                  (1, 1000, 2, 136, 1, 32)])
def test_wide_split_rule(b, s, h, d, split, blocks):
    assert fa.bwd_wide_split(d) == split
    assert split * -(-s // 64) * b * h == blocks
    assert split * 256 == fa._padded_dim(d)


@pytest.mark.parametrize("d", [40, 128, 520])
def test_wide_split_refuses_other_routes(d):
    with pytest.raises(ValueError):
        fa.bwd_wide_split(d)


def test_klvae_launches_carry_the_wide_counters():
    train, klvae = chip_smoke.EXPECTED_TRAIN_LAUNCHES, chip_smoke.EXPECTED_KLVAE_LAUNCHES
    vq = chip_smoke.EXPECTED_VQ_LAUNCHES
    for kind, counter in WIDE_COUNTERS.items():
        assert klvae[counter] == klvae[f"flash_bwd_{kind}"] == 2
        assert vq[counter] == vq[f"flash_bwd_{kind}"] == 2
        assert train[counter] == 0
    assert set(WIDE_COUNTERS.values()) <= set(kernels.LAUNCHES) & set(chip_smoke.KERNELS)
    # the kernel phase holds the new kernels at the codec's shapes, at a
    # bf16 train_ddpm's d = 256 and at train_vq's, each added last
    wide = [sh for sh in chip_smoke.TRAIN_KERNEL_SHAPES if fa.bwd_route(sh[-1]) == "wide"]
    assert wide == [(4, 1024, 1024, 1, 512), (1, 4096, 4096, 1, 512), (1, 1000, 1300, 1, 512),
                    (6, 1024, 1024, 1, 256), (8, 1024, 1024, 1, 256)]
    assert chip_smoke.TRAIN_KERNEL_SHAPES[-2:] == ((6, 1024, 1024, 1, 256),
                                                   chip_smoke.VQ_ATTN_SHAPE)


def _inputs(b, sq, skv, h, d):
    return [nprand(b, s, h, d, seed=i) for i, s in enumerate((sq, skv, skv, sq))]


# fp32 against the Pallas backward in interpret mode at the wide head dims,
# ragged q and kv lengths past a 32-row tile, the split the kernels take
@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 100, 130, 1, 256), (1, 70, 65, 1, 512)])
def test_wide_tiled_ref_matches_the_pallas_backward(b, sq, skv, h, d):
    q, k, v, do = _inputs(b, sq, skv, h, d)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True),
                     *(jnp.asarray(t) for t in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (to_torch(t) for t in (q, k, v, do))
    o, lse = fa._flash_lse_ref(tq, tk, tv, d**-0.5)
    got = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, d**-0.5, tile=32,
                                  split=fa.bwd_wide_split(d))
    for g, want in zip(got[:3], ref_grads):
        assert_close(g, want)


# ragged sizes, the split the kernels take at each head dim
@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 100, 130, 2, 136), (2, 70, 65, 1, 256),
                                          (1, 33, 97, 1, 512), (1, 64, 64, 2, 384),
                                          (2, 40, 90, 1, 264), (1, 97, 33, 2, 200)])
def test_wide_tiled_ref_matches_the_plain_backward(b, sq, skv, h, d):
    tq, tk, tv, tdo = (to_torch(t) for t in _inputs(b, sq, skv, h, d))
    o, lse = fa._flash_lse_ref(tq, tk, tv, d**-0.5)
    got = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, d**-0.5, tile=32,
                                  split=fa.bwd_wide_split(d))
    for g, want in zip(got, fa._flash_bwd_ref(tq, tk, tv, o, lse, tdo, d**-0.5)):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert_close(g, want)


def test_wide_tiled_ref_adds_the_parts_in_rank_order():
    """The split changes only the order of the fp32 sums: S, dP and delta
    as two partials added, not one chain. The results differ from the
    unsplit model's by fp32 rounding, and are not its bits."""
    tq, tk, tv, tdo = (to_torch(t) for t in _inputs(1, 100, 130, 1, 512))
    o, lse = fa._flash_lse_ref(tq, tk, tv, 512**-0.5)
    one = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 512**-0.5, tile=32, split=1)
    two = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 512**-0.5, tile=32, split=2)
    for a, b in zip(one, two):
        assert_close(a, b, 1e-5)
    assert any(not torch.equal(a, b) for a, b in zip(one, two))


def test_wide_tiled_ref_rounds_p_and_ds_to_the_operand_dtype():
    """bf16 inputs: P and dS round to bf16 before the second products, as on
    the card and in the plain version, whose every sum is fp32 too."""
    tq, tk, tv, tdo = (to_torch(t).bfloat16() for t in _inputs(1, 100, 130, 1, 512))
    o, lse = fa._flash_lse_ref(tq, tk, tv, 512**-0.5)
    got = fa._flash_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, 512**-0.5, tile=32, split=2)
    want = fa._flash_bwd_ref(tq, tk, tv, o, lse, tdo, 512**-0.5)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16
        # at most one bf16 rounding step apart: the sums run in another order
        assert_close(g.float(), w.float(), 2**-7)


# -- the int8 PV's contract at the TPU package's shape -----------------------------------

CONTRACT = (1, 256, 2, 40)   # [B, S, H, D], tests/test_flash_attention.py:206


def int8_contract_errors(seed: int) -> dict:
    """Worst and mean |Δ| / max|exact| against exact fp32 attention at the
    contract shape, 128-row blocks, of `sd_tpu`'s int8-PV flash kernel
    (Pallas, interpret mode) and of the port's plain int8 sweep, on the same
    normal inputs drawn from `seed`."""
    b, s, h, d = CONTRACT
    q, k, v = (nprand(b, s, h, d, seed=3 * seed + i) for i in range(3))
    tq, tk, tv = (to_torch(t) for t in (q, k, v))
    exact = fa._xla_ref(tq, tk, tv, d**-0.5)
    top = float(exact.abs().max())
    jax_out = to_torch(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           block_q=128, block_k=128, interpret=True,
                                           pv_quant="int8"))
    port_out = fa._flash_tiled_ref(tq, tk, tv, d**-0.5, 128, pv_quant="int8")
    out = {}
    for name, got in (("sd_tpu", jax_out), ("port", port_out)):
        err = (got - exact).abs() / top
        out[name] = (float(err.max()), float(err.mean()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_pv_plain_sweep_is_faithful_to_sd_tpu(seed):
    errs = int8_contract_errors(seed)
    for i in range(2):   # worst, mean: the same to within fp32 rounding
        assert abs(errs["port"][i] - errs["sd_tpu"][i]) <= 1e-5, errs


def main() -> None:
    """The spread of the int8 PV's worst and mean error over 32 seeds."""
    rows = [(seed, int8_contract_errors(seed)) for seed in range(32)]
    for seed, e in rows:
        print(f"seed {seed:2d}  sd_tpu max {e['sd_tpu'][0]:.4f} mean {e['sd_tpu'][1]:.5f}  "
              f"port max {e['port'][0]:.4f} mean {e['port'][1]:.5f}")
    for name in ("sd_tpu", "port"):
        worst = np.array([e[name][0] for _, e in rows])
        mean = np.array([e[name][1] for _, e in rows])
        print(f"{name}: worst min {worst.min():.4f} median {np.median(worst):.4f} "
              f"max {worst.max():.4f}, above 8e-2 on {int((worst > 8e-2).sum())} of 32; "
              f"mean max {mean.max():.5f}")
    diff = max(abs(e["port"][i] - e["sd_tpu"][i]) for _, e in rows for i in range(2))
    print(f"largest |port - sd_tpu| over both figures and all seeds: {diff:.3g}")


if __name__ == "__main__":
    main()
