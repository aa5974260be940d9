"""The training forward's route rule and the Hopper 3×3 conv's tiling, on the
CPU, before the card.

The training forward (`flash_attention_lse`) runs the `LSE` epilogue of
`flash_attention_sm90.cu` up to head dim 128 and of `flash_attention_wide.cu`
from 129 to 512, decided by `lse_route` from the shape alone: on a CPU tensor
exactly as on the card. Each launch counts under its route counter
(`flash_lse_sm90`, `flash_lse_wide`) beside `flash_attention_lse`, and
`chip_smoke.py` expects 80 and 2 of them per `train_ldm` and `train_kl_vae`
step.

The decoder of a 512² `generate` launches the conv 18 times over the five
shapes `chip_smoke.DECODER_CONVS` times at (6, 1, 5, 1, 5): counted here on
`meta` tensors at full width.

`_conv_window_ref` repeats the Hopper conv's index arithmetic (the zero-filled
TMA window of each block, each tap's A rows at a flat offset into it, fp32
sums per 8-channel box, the bias in fp32, one rounding); it is held, in fp32
at ragged H and W and several boxes of channels, against the TPU package's
Pallas conv in interpret mode within 1e-4·max(1, max|ref|) and against the
plain conv.
"""

from __future__ import annotations

from collections import Counter

import jax.numpy as jnp
import pytest
import torch
from test_torch_helpers import assert_close, nprand, to_torch

import chip_smoke
from sd_tpu.kernels import conv2d as jconv
from sd_tpu_torch import kernels
from sd_tpu_torch.core.config import sd_v1_config
from sd_tpu_torch.kernels import conv2d, flash_attention as fa
from sd_tpu_torch.models.autoencoder import AutoencoderKL

# the source of each route, as PERF.md's kernel table names it (row 4)
LSE_SOURCE = {"sm90": "flash_attention_sm90", "wide": "flash_attention_wide"}


def _want_route(d: int) -> str:
    return "sm90" if d <= 128 else "wide"


@pytest.mark.parametrize("shape", chip_smoke.TRAIN_KERNEL_SHAPES)
def test_lse_route_at_the_training_shapes(shape):
    d = shape[-1]
    route = fa.lse_route(d)
    assert route == _want_route(d)
    assert fa._LSE_ENTRY[route][0] == LSE_SOURCE[route]
    assert fa.LSE_ROUTE_COUNTERS[route] == f"flash_lse_{route}"


@pytest.mark.parametrize("d,source", [(16, "flash_attention_sm90"), (128, "flash_attention_sm90"),
                                      (136, "flash_attention_wide"), (256, "flash_attention_wide"),
                                      (512, "flash_attention_wide")])
def test_lse_route_at_head_dims(d, source):
    assert fa._LSE_ENTRY[fa.lse_route(d)][0] == source


@pytest.mark.parametrize("d", [520, 1024])
def test_lse_route_refuses_heads_past_512(d):
    with pytest.raises(ValueError):
        fa.lse_route(d)
    q = torch.zeros(1, 8, 1, d)
    with pytest.raises(ValueError):   # on a CPU tensor too, before any plain version
        fa.flash_attention_lse(q, q, q, d**-0.5)


@pytest.mark.parametrize("d", [40, 136])
def test_lse_route_is_decided_on_the_cpu(monkeypatch, d):
    seen = []
    rule = fa.lse_route
    monkeypatch.setattr(fa, "lse_route", lambda dd: seen.append(rule(dd)) or seen[-1])
    q, k, v = (to_torch(nprand(1, s, 2, d, seed=i)) for i, s in enumerate((16, 24, 24)))
    kernels.reset_launches()
    out, lse = fa.flash_attention_lse(q, k, v, d**-0.5)
    assert seen == [_want_route(d)]
    assert not any(kernels.LAUNCHES.values())   # the CPU launches nothing
    want = fa._flash_lse_ref(q, k, v, d**-0.5)
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    torch.testing.assert_close(lse, want[1], rtol=0, atol=0)


def test_training_launches_carry_the_lse_routes():
    train, klvae = chip_smoke.EXPECTED_TRAIN_LAUNCHES, chip_smoke.EXPECTED_KLVAE_LAUNCHES
    assert (train["flash_lse_sm90"], train["flash_lse_wide"]) == (80, 0)
    assert (klvae["flash_lse_sm90"], klvae["flash_lse_wide"]) == (0, 2)
    for want in (train, klvae):
        assert want["flash_lse_sm90"] + want["flash_lse_wide"] == want["flash_attention_lse"]
    # the combine launches: train_kl_vae's two, whose d = 512 grids are under
    # one wave; train_ldm's sweeps (d ≤ 128) are never split
    assert (train["flash_lse_combine"], klvae["flash_lse_combine"]) == (0, 2)
    counters = {*fa.LSE_ROUTE_COUNTERS.values(), fa.LSE_COMBINE_COUNTER}
    assert counters <= set(kernels.LAUNCHES) & set(chip_smoke.KERNELS)
    assert chip_smoke.LSE_ROUTE_COUNTER == fa.LSE_ROUTE_COUNTERS


# [B, Sq, Skv, H, D] and the parts the kv sweep is split into: wide-route
# grids under one wave of the H100 when doubled are split (64 blocks at
# train_kl_vae's codec), full ones, one-step sweeps and the d ≤ 128 route
# are not
SPLITS = [((1, 4096, 4096, 8, 40), 1), ((1, 1024, 1024, 8, 80), 1), ((4, 1024, 1024, 1, 512), 2),
          ((1, 4096, 4096, 1, 512), 2), ((1, 64, 64, 1, 512), 1), ((4, 4096, 4096, 1, 512), 1),
          ((2, 256, 300, 1, 136), 2)]


@pytest.mark.parametrize("shape,parts", SPLITS)
def test_lse_split_rule(shape, parts):
    assert fa.lse_split(*shape) == parts


def _lse_parts(q, k, v, scale, n_split, bk):
    """The parts a split sweep leaves, in plain fp32: per part of
    ceil(tiles / n_split) kv tiles of bk rows, unnormalized O, m and l."""
    b, sq, h, d = q.shape
    tiles = -(-k.shape[1] // bk)
    per = -(-tiles // n_split)
    s2 = torch.einsum("bqhd,bkhd->bhqk", q, k) * (scale * fa.LOG2E)
    po, ml = [], []
    for z in range(n_split):
        sl = slice(z * per * bk, (z + 1) * per * bk)
        m = s2[..., sl].amax(dim=-1, keepdim=True)
        p = torch.exp2(s2[..., sl] - m)
        po.append(torch.einsum("bhqk,bkhd->bhqd", p, v[:, sl]).reshape(-1, d))
        ml.append(torch.stack([m[..., 0], p.sum(dim=-1)], dim=-1).reshape(-1, 2))
    return torch.cat([torch.stack(po).flatten(), torch.stack(ml).flatten()])


@pytest.mark.parametrize("b,sq,skv,h,d,bk", [(1, 16, 200, 2, 40, 64), (2, 8, 129, 1, 136, 64)])
def test_lse_combine_ref_gives_the_unsplit_forward(b, sq, skv, h, d, bk):
    q, k, v = (to_torch(nprand(b, s, h, d, seed=i)) for i, s in enumerate((sq, skv, skv)))
    part = _lse_parts(q, k, v, d**-0.5, 2, bk)
    o, lse = fa._lse_combine_ref(part, b, h, sq, d, 2, torch.float32)
    o_ref, lse_ref = fa._flash_lse_ref(q, k, v, d**-0.5)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)


# [B, H, W, C, O] and the tile (rows, pixels): ragged H and W at small tiles,
# several 8-channel boxes, and the kernel's own tile at W past one tile
CONV_CASES = [((1, 5, 11, 32, 16), (2, 4)), ((2, 7, 9, 48, 24), (2, 8)),
              ((1, 3, 130, 32, 8), conv2d.CONV_TILE)]


@pytest.mark.parametrize("shape,tile", CONV_CASES)
def test_conv_window_ref_matches_pallas(shape, tile):
    B, H, W, C, O = shape
    x = nprand(B, H, W, C, seed=0)
    w = nprand(3, 3, C, O, seed=1, scale=(9 * C) ** -0.5)
    b = nprand(O, seed=2, scale=0.1)
    ref = jconv.conv3x3_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    tx, tw, tb = to_torch(x), to_torch(w.transpose(3, 2, 0, 1)), to_torch(b)
    got = conv2d._conv_window_ref(tx, tw, tb, tile)
    assert got.shape == (B, H, W, O) and got.dtype == torch.float32
    assert_close(got, ref)
    assert_close(got, conv2d._xla_conv3x3(tx, tw, tb))


def test_decoder_conv_launches_by_shape(monkeypatch):
    monkeypatch.delenv("SD_TPU_PALLAS_CONV", raising=False)
    seen = Counter()

    def counted(x, w, b, _fn=conv2d.conv3x3_same):
        seen[(x.shape[0], x.shape[1], x.shape[3], w.shape[0])] += 1
        return _fn(x, w, b)

    monkeypatch.setattr(conv2d, "conv3x3_same", counted)
    vae = AutoencoderKL(**sd_v1_config()["first_stage"]["params"], dtype=torch.bfloat16,
                        device="meta")
    with torch.no_grad():
        vae.decode(torch.empty(2, 64, 64, 4, dtype=torch.bfloat16, device="meta"))
    assert seen == dict(zip(chip_smoke.DECODER_CONVS, chip_smoke.DECODER_CONV_LAUNCHES))
    assert sum(seen.values()) == chip_smoke.EXPECTED_LAUNCHES["conv3x3_same"] == 18
