"""The Hopper GEGLU feed-forward (`csrc/geglu_sm90.cu`) and cross-attention
(`csrc/cross_attention_sm90.cu`): their plans and the plain forms of their
decompositions on the CPU, the kernels themselves on the card.

Plans, from the shape alone on every device: `geglu_plan` splits the inner
columns over a cluster of 1, 2 or 4 blocks (the shortest critical path in
waves of one block per SM times the 64-column chunks a block sums);
`xattn_plan` sizes the attention's query rows per block (the projections
take 128 × 128 tiles). At the UNet shapes the GEGLU and attention grids keep
at least 128 of the H100's 132 SMs busy; at ragged shapes the tiles are
valid (every rank of a split has a chunk); shapes the kernels do not take
raise, on CPU tensors too.

Plain forms, fp32, against the TPU package's Pallas kernels in interpret
mode within 1e-4·max(1, max|ref|): `_geglu_split_ref` (the inner columns
split as the plan splits them, each rank's partial summed in rank order,
half chunks included) and `_crossattn_kernel_ref` (q scaled to base-2
logits and rounded, p and O rounded, then the output projection).

On the card (`cuda` marker; skipped without a card): each kernel at every
UNet shape and a ragged one within 1e-2·max|ref| of its fp32 plain version
and of its template (`geglu.cu`, `cross_attention.cu`), the same bits twice,
its route counter moved once per call, and a raise, not a fallback, on a
shape it refuses. This file imports JAX only inside the CPU tests, so the
card's tests run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_hopper_ff_xattn.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import cross_attention as xattn, geglu
from sd_tpu_torch.kernels.flash_attention import H100_SMS

GEGLU_SHAPES = chip_smoke.GEGLU_SHAPES
GEGLU_RAGGED = [chip_smoke.GEGLU_RAGGED, (1000, 128, 96), (1, 640, 32), (4097, 320, 1280),
                (64, 256, 2560), (130, 384, 160)]
WAVE_BLOCKS = H100_SMS - 4   # a grid of at least 128 blocks fills a wave
# the ragged cross-attention shapes [B, N, M, heads, d, C]: rows past a q tile,
# a context past 80 tokens, a head dim past 128
XATTN_RAGGED = [chip_smoke.XATTN_RAGGED, (2, 77, 200, 2, 64, 128), (1, 300, 77, 2, 136, 200)]


@pytest.mark.parametrize("n,c,inner", GEGLU_SHAPES)
def test_geglu_plan_fills_a_wave_at_the_unet_shapes(n, c, inner):
    plan = geglu.geglu_plan(n, c, inner)
    assert plan.blocks == -(-n // geglu.GEGLU_ROWS) * plan.split >= WAVE_BLOCKS
    # no other split has a shorter critical path
    n_ch = -(-inner // geglu.GEGLU_CHUNK)
    path = lambda s: -(-(-(-n // 64) * s) // H100_SMS) * -(-n_ch // s)
    assert all(path(plan.split) <= path(s) for s in geglu.GEGLU_SPLITS if s <= n_ch)
    assert plan.split == (1 if c == 320 else 2)


@pytest.mark.parametrize("n,c,inner", GEGLU_RAGGED)
def test_geglu_plan_gives_every_rank_a_chunk(n, c, inner):
    plan = geglu.geglu_plan(n, c, inner)
    n_ch = -(-inner // geglu.GEGLU_CHUNK)
    assert plan.split in geglu.GEGLU_SPLITS and plan.split <= n_ch
    ranks = [(r * n_ch // plan.split, (r + 1) * n_ch // plan.split) for r in range(plan.split)]
    assert all(hi > lo for lo, hi in ranks) and ranks[-1][1] == n_ch
    assert plan.chunks == max(hi - lo for lo, hi in ranks)
    assert plan.blocks == -(-n // 64) * plan.split


@pytest.mark.parametrize("n,c,inner", [(64, 192, 768), (64, 320, 48), (64, 320, 16),
                                        (0, 320, 1280)])
def test_geglu_refuses_what_the_kernel_cannot_take(n, c, inner):
    with pytest.raises(ValueError):
        geglu.geglu_plan(n, c, inner)
    x = torch.zeros(n, c, dtype=torch.bfloat16)
    w1, b1 = torch.zeros(2 * inner, c, dtype=torch.bfloat16), torch.zeros(2 * inner,
                                                                          dtype=torch.bfloat16)
    w2, b2 = torch.zeros(c, inner, dtype=torch.bfloat16), torch.zeros(c, dtype=torch.bfloat16)
    with pytest.raises(ValueError):   # the launch's checks run before any CUDA call
        geglu._launch_geglu(x, w1, b1, w2, b2)


@pytest.mark.parametrize("shape,rows", zip(chip_smoke.XATTN_SHAPES, (128, 128, 64)))
def test_xattn_plan_fills_a_wave_at_the_unet_shapes(shape, rows):
    plan = xattn.xattn_plan(*shape)
    B, N, M, heads, d, C = shape
    assert plan.rows == rows and plan.mp == 80
    assert plan.attend_blocks == -(-N // rows) * heads * B >= WAVE_BLOCKS
    tiles = B * N // 128
    assert plan.q_blocks == tiles * -(-(heads * d) // 128)
    assert plan.o_blocks == tiles * -(-C // 128)


@pytest.mark.parametrize("shape", XATTN_RAGGED)
def test_xattn_plan_at_ragged_shapes(shape):
    B, N, M, heads, d, C = shape
    plan = xattn.xattn_plan(*shape)
    assert plan.rows in (64, 128)
    assert plan.mp == (80 if M <= 80 else 256) and plan.mp >= M
    dp = -(-d // 16) * 16
    assert plan.smem == (plan.rows + 2 * plan.mp) * dp * 2 + 8 <= xattn.XATTN_MAX_SMEM
    assert plan.attend_blocks == -(-N // plan.rows) * heads * B
    tiles = -(-(B * N) // 128)
    assert plan.q_blocks == tiles * -(-(heads * d) // 128)
    assert plan.o_blocks == tiles * -(-C // 128)


@pytest.mark.parametrize("shape", [(1, 256, 77, 8, 40, 12), (1, 256, 77, 2, 12, 64),
                                   (1, 256, 0, 8, 40, 320), (1, 256, 257, 8, 40, 320),
                                   (1, 256, 200, 1, 512, 512)])
def test_xattn_refuses_what_the_kernel_cannot_take(shape):
    B, N, M, heads, d, C = shape
    with pytest.raises(ValueError):
        xattn.xattn_plan(*shape)
    bf = dict(dtype=torch.bfloat16)
    args = (torch.zeros(B, N, C, **bf), torch.zeros(heads * d, C, **bf),
            torch.zeros(B, M, heads * d, **bf), torch.zeros(B, M, heads * d, **bf),
            torch.zeros(C, heads * d, **bf), torch.zeros(C, **bf))
    with pytest.raises(ValueError):   # the launch's checks run before any CUDA call
        xattn._launch_xattn(*args, heads, None)


def test_route_counters_exist_and_chip_smoke_expects_them():
    assert "geglu_sm90" in kernels.LAUNCHES and "crossattn_sm90" in kernels.LAUNCHES
    assert {"geglu_sm90", "crossattn_sm90"} <= set(chip_smoke.KERNELS)
    assert chip_smoke.EXPECTED_LAUNCHES["geglu_sm90"] == chip_smoke.EXPECTED_LAUNCHES["geglu_ff"]
    optin = chip_smoke.EXPECTED_LAUNCHES_OPTIN
    assert optin["geglu_sm90"] == optin["geglu_ff"] == 500
    assert optin["crossattn_sm90"] == optin["crossattn_kv"] == 750
    assert chip_smoke.EXPECTED_SERVE_LAUNCHES["geglu_sm90"] == 10 * chip_smoke.SERVE_UNET_CALLS
    assert chip_smoke.PARITY_OPTIN_LAUNCHES["unet"]["crossattn_sm90"] == 10


def _geglu_np(n, c, inner, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return (f(n, c), f(c, 2 * inner, scale=c**-0.5), f(2 * inner, scale=0.1),
            f(inner, c, scale=inner**-0.5), f(c, scale=0.1))


# [N, C, inner, split]: whole and half chunks of 64 inner columns, ranks of
# one chunk and of two, a split in 4
@pytest.mark.parametrize("n,c,inner,split", [
    (200, 128, 192, 1), (200, 128, 192, 2), (128, 128, 96, 1), (128, 128, 96, 2),
    (64, 256, 160, 2), (72, 128, 320, 4), (72, 128, 288, 4)])
def test_geglu_split_sums_match_pallas(n, c, inner, split):
    import jax.numpy as jnp
    from test_torch_helpers import assert_close, to_torch

    from sd_tpu.kernels import geglu as jgeglu

    x, w1, b1, w2, b2 = _geglu_np(n, c, inner)
    ref = jgeglu.geglu_ff(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), token_tile=64,
                          interpret=True)
    got = geglu._geglu_split_ref(to_torch(x), to_torch(w1.T), to_torch(b1), to_torch(w2.T),
                                 to_torch(b2), split)
    assert_close(got, ref)


def _xattn_np(B, N, M, heads, d, C, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    HD = heads * d
    return (f(B, N, C), f(C, HD, scale=C**-0.5), f(B, M, HD), f(B, M, HD),
            f(HD, C, scale=HD**-0.5), f(C, scale=0.1))


@pytest.mark.parametrize("shape", [(2, 256, 77, 8, 40, 320), (1, 128, 33, 4, 24, 96),
                                   (1, 64, 200, 2, 64, 128)])
def test_crossattn_kernel_arithmetic_matches_pallas(shape):
    import jax.numpy as jnp
    from test_torch_helpers import assert_close, to_torch

    from sd_tpu.kernels import cross_attention as jxattn

    B, N, M, heads, d, C = shape
    x, wq, k, v, wo, bo = _xattn_np(*shape)
    ref = jxattn.crossattn_kv(*(jnp.asarray(a) for a in (x, wq, k, v, wo, bo)), heads,
                              interpret=True)
    args = (to_torch(x), to_torch(wq.T), to_torch(k), to_torch(v), to_torch(wo.T), to_torch(bo))
    assert_close(xattn._crossattn_kernel_ref(*args, heads), ref)


@pytest.mark.parametrize("shape", [(2, 64, 77, 8, 40, 320), (1, 50, 33, 4, 24, 96)])
def test_kernel_arithmetic_rounds_where_the_tpu_kernel_does(shape):
    """In bf16 the kernels' plain form differs from the fp32 plain version
    by its roundings only (q, p, O and the output at 2⁻⁸), and in fp32 it is
    the plain version up to fp32 order."""
    heads, d = shape[3], shape[4]
    args32 = [torch.from_numpy(a) for a in _xattn_np(*shape, seed=3)]
    args32[1], args32[4] = args32[1].T.contiguous(), args32[4].T.contiguous()
    ref = xattn.crossattn_kv_xla(*args32, heads)
    got32 = xattn._crossattn_kernel_ref(*args32, heads)
    assert (got32 - ref).abs().max() <= 1e-5 * ref.abs().max()
    args16 = [a.bfloat16() for a in args32]
    ref16 = xattn.crossattn_kv_xla(*(a.float() for a in args16), heads)
    got16 = xattn._crossattn_kernel_ref(*args16, heads)
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref16).abs().max() <= 1e-2 * ref16.abs().max()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator("cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,inner", GEGLU_SHAPES + GEGLU_RAGGED[:3])
def test_hopper_geglu_on_card(cuda, n, c, inner):
    args = (_rnd(cuda, n, c), _rnd(cuda, 2 * inner, c, scale=c**-0.5),
            _rnd(cuda, 2 * inner, scale=0.1), _rnd(cuda, c, inner, scale=inner**-0.5),
            _rnd(cuda, c, scale=0.1))
    kernels.reset_launches()
    out = geglu.geglu_ff(*args)
    assert kernels.LAUNCHES["geglu_sm90"] == kernels.LAUNCHES["geglu_ff"] == 1
    torch.cuda.synchronize()
    assert _rel(out, geglu._geglu_xla(*(a.float() for a in args))) <= 1e-2
    assert _rel(out, geglu._launch_geglu(*args, source="template")) <= 1e-2
    assert torch.equal(out, geglu.geglu_ff(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.XATTN_SHAPES + XATTN_RAGGED)
def test_hopper_crossattn_on_card(cuda, shape):
    B, N, M, heads, d, C = shape
    hd = heads * d
    args = (_rnd(cuda, B, N, C), _rnd(cuda, hd, C, scale=C**-0.5), _rnd(cuda, B, M, hd),
            _rnd(cuda, B, M, hd), _rnd(cuda, C, hd, scale=hd**-0.5), _rnd(cuda, C, scale=0.1))
    kernels.reset_launches()
    out = xattn.crossattn_kv(*args, heads)
    assert kernels.LAUNCHES["crossattn_sm90"] == kernels.LAUNCHES["crossattn_kv"] == 1
    torch.cuda.synchronize()
    assert _rel(out, xattn.crossattn_kv_xla(*(a.float() for a in args), heads)) <= 1e-2
    assert _rel(out, xattn._launch_xattn(*args, heads, None, source="template")) <= 1e-2
    assert torch.equal(out, xattn.crossattn_kv(*args, heads))


@pytest.mark.cuda
def test_hopper_kernels_raise_rather_than_fall_back(cuda):
    """A shape the Hopper kernels refuse raises on the card, and no launch
    is counted; nothing is computed by the template or the plain version."""
    x = _rnd(cuda, 64, 192)
    kernels.reset_launches()
    with pytest.raises(ValueError):
        geglu.geglu_ff(x, _rnd(cuda, 1536, 192), _rnd(cuda, 1536), _rnd(cuda, 192, 768),
                       _rnd(cuda, 192))
    with pytest.raises(ValueError):
        xattn.crossattn_kv(_rnd(cuda, 1, 256, 512), _rnd(cuda, 512, 512), _rnd(cuda, 1, 200, 512),
                           _rnd(cuda, 1, 200, 512), _rnd(cuda, 512, 512), _rnd(cuda, 512), 1)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
