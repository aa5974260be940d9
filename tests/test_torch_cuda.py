"""The port's CUDA kernels against their plain PyTorch versions, on the card.

bf16 inputs from a seed, the plain version computed in fp32 from the same
inputs, max|Δ| ≤ 1e-2·max|ref| (bf16 output rounding plus p rounded to bf16
in attention; q, p and the head outputs also round to bf16 in the fused
cross-attention). The pipelined flash sweep gives the bits of the serial
sweep of its source (the Hopper kernel at d ≤ 128, the wide kernel above). The
Hopper flash forwards (`flash_attention_sm90.cu` and its int8-PV form
`flash_attention_sm90_pv8.cu` at d ≤ 128, `flash_attention_wide.cu` above)
are counted under their routes and give the same bits twice; the int8-PV
variants are held against the plain sweep at the TPU package's kv tile.
The training forward runs the LSE epilogue of the Hopper forwards (counted
under `flash_lse_sm90` / `flash_lse_wide`), the 3×3 conv the Hopper kernel
`conv2d_sm90.cu` (held against `conv2d.cu`'s too), and the fused GroupNorm
→ SiLU → 3×3 conv `conv2d_gn_sm90.cu` (counted under `gn_silu_conv_sm90`,
held against `conv2d.cu`'s `PRO` form; its statistics within 1e-5·max|ref|),
each giving the same bits twice. The flash backward: lse2 within 1e-3 absolute; dq, dk, dv
within 2e-2·max|ref| and ‖Δ‖₂ ≤ 1e-2·‖ref‖₂ (p and dS round to bf16 at 2⁻⁸
and the sums run over up to 4096 rows); at head dims up to 128 it runs
`flash_attention_bwd_sm90.cu` (counted under `flash_bwd_dq_sm90` /
`flash_bwd_dkv_sm90`) and above it `flash_attention_bwd_wide_sm90.cu`
(`flash_bwd_dq_wide_sm90` / `flash_bwd_dkv_wide_sm90`), held against the
template too, the same bits twice. Every test needs a CUDA device and
skips without one. This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import conv2d, cross_attention as xattn, flash_attention as fa
from sd_tpu_torch.kernels import geglu, groupnorm as gn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator("cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()


def _within(out, ref, tol=1e-2):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 4096, 4096, 1, 512), (1, 200, 333, 3, 40),
                                          (1, 1024, 1024, 8, 80)])
def test_flash_kernel_on_card(cuda, b, sq, skv, h, d):
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    ref = fa._xla_ref(q.float(), k.float(), v.float(), d**-0.5)
    _within(fa.flash_attention(q, k, v), ref)
    hp = fa.flash_attention_hpacked(q.flatten(2), k.flatten(2), v.flatten(2), h)
    _within(hp.unflatten(2, (h, d)), ref)


# [B, Sq, Skv, H, D, head-packed] of the Hopper forward (flash_attention_sm90.cu):
# the UNet's head-packed shapes at batch 4 and 8, a ragged case and strided
# [B, S, H, D] cases at d = 64 and 128
SM90_SHAPES = [(4, 4096, 4096, 8, 40, True), (4, 1024, 1024, 8, 80, True),
               (8, 4096, 4096, 8, 40, True), (1, 1000, 1000, 8, 40, False),
               (2, 512, 700, 4, 64, False), (1, 300, 257, 2, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,packed", SM90_SHAPES)
@pytest.mark.parametrize("exp_bf16", [False, True])
def test_sm90_flash_kernel_on_card(cuda, b, sq, skv, h, d, packed, exp_bf16):
    """The Hopper forward against its plain version (exact attention with p
    rounded to bf16, or the tiled sweep with the bf16 exponential), counted
    under its route, and the same bits on a second run."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    sdt = torch.bfloat16 if exp_bf16 else torch.float32
    if packed:
        run = lambda: fa.flash_attention_hpacked(q.flatten(2), k.flatten(2), v.flatten(2), h,
                                                 softmax_dtype=sdt).unflatten(2, (h, d))
    else:
        run = lambda: fa.flash_attention(q, k, v, softmax_dtype=sdt)
    kernels.reset_launches()
    out = run()
    assert kernels.LAUNCHES["flash_fwd_sm90"] == 1
    if exp_bf16:
        ref = fa._flash_tiled_ref(q, k, v, d**-0.5, 64, torch.bfloat16)
    else:
        ref = fa._xla_ref(q.float(), k.float(), v.float(), d**-0.5)
    _within(out, ref)
    assert torch.equal(out, run())


# [B, Sq, Skv, H, D, head-packed] of the int8-PV Hopper forward
# (flash_attention_sm90_pv8.cu): the served UNet's head-packed shapes at
# batch 8, the TPU package's contract shape, a ragged case and d = 64, 128
PV8_SHAPES = [(8, 4096, 4096, 8, 40, True), (8, 1024, 1024, 8, 80, True),
              (1, 256, 256, 2, 40, False), (1, 1000, 1300, 8, 40, True),
              (2, 512, 700, 4, 64, False), (1, 300, 257, 2, 128, False)]


def _variant_run(q, k, v, h, packed, **kw):
    if packed:
        return lambda: fa.flash_attention_hpacked(q.flatten(2), k.flatten(2), v.flatten(2), h,
                                                  **kw).unflatten(2, (h, q.shape[-1]))
    return lambda: fa.flash_attention(q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,packed", PV8_SHAPES)
@pytest.mark.parametrize("exp_bf16", [False, True])
def test_sm90_pv8_kernel_on_card(cuda, b, sq, skv, h, d, packed, exp_bf16):
    """The int8-PV Hopper forward against the plain tiled sweep at the TPU
    package's kv tile, counted under its route, the same bits twice."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    sdt = torch.bfloat16 if exp_bf16 else torch.float32
    run = _variant_run(q, k, v, h, packed, softmax_dtype=sdt, pv_quant="int8")
    plan = fa.launch_plan(sq, skv, h, d, exp_bf16, True, packed)
    assert plan.route == "sm90_pv8"
    kernels.reset_launches()
    out = run()
    assert kernels.LAUNCHES["flash_fwd_sm90_pv8"] == 1 and kernels.LAUNCHES[plan.name] == 1
    _within(out, fa._flash_tiled_ref(q, k, v, d**-0.5, plan.block_k, sdt, "int8"))
    assert torch.equal(out, run())


# [B, Sq, Skv, H, D] of the wide forward (flash_attention_wide.cu): the
# decoder's mid block at batch 2 and 4 (serving), a ragged case, d = 136, 256
WIDE_SHAPES = [(2, 4096, 4096, 1, 512), (4, 4096, 4096, 1, 512), (1, 512, 700, 1, 512),
               (1, 300, 257, 2, 136), (1, 1000, 1000, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", WIDE_SHAPES)
@pytest.mark.parametrize("exp_bf16,pv_int8", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_wide_flash_kernel_on_card(cuda, b, sq, skv, h, d, exp_bf16, pv_int8):
    """The wide forward, serial sweep, each variant, against its plain
    version (exact attention with p in bf16; the tiled sweep at the TPU
    package's kv tile for a variant), counted under its route, the same bits
    twice."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    sdt = torch.bfloat16 if exp_bf16 else torch.float32
    run = _variant_run(q, k, v, h, False, softmax_dtype=sdt,
                       pv_quant="int8" if pv_int8 else "none")
    plan = fa.launch_plan(sq, skv, h, d, exp_bf16, pv_int8, False)
    assert plan.route == "wide"
    kernels.reset_launches()
    out = run()
    assert kernels.LAUNCHES["flash_fwd_wide"] == 1 and kernels.LAUNCHES[plan.name] == 1
    if exp_bf16 or pv_int8:
        ref = fa._flash_tiled_ref(q, k, v, d**-0.5, plan.block_k, sdt,
                                  "int8" if pv_int8 else "none")
    else:
        ref = fa._xla_ref(q.float(), k.float(), v.float(), d**-0.5)
    _within(out, ref)
    assert torch.equal(out, run())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,packed", [(2, 1024, 1024, 8, 80, True),
                                                 (1, 4096, 4096, 8, 40, True),
                                                 (1, 1024, 1024, 1, 512, False),
                                                 (1, 512, 700, 1, 512, False)])
def test_pv8_kernel_quantizes_over_the_tpu_tile(cuda, b, sq, skv, h, d, packed):
    """The int8 PV variant against the plain tiled sweep at the TPU package's
    kv tile, the one the wrapper passes the kernel."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    tile = fa.launch_plan(sq, skv, h, d, False, True, packed).block_k
    assert tile % 64 == 0 and tile > 64
    if packed:
        out = fa.flash_attention_hpacked(q.flatten(2), k.flatten(2), v.flatten(2), h,
                                         pv_quant="int8").unflatten(2, (h, d))
    else:
        out = fa.flash_attention(q, k, v, pv_quant="int8")
    _within(out, fa._flash_tiled_ref(q, k, v, d**-0.5, tile, pv_quant="int8"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(16384, 320), (4096, 640), (100, 128)])
def test_geglu_kernel_on_card(cuda, n, c):
    inner = 4 * c
    args = (_rnd(cuda, n, c), _rnd(cuda, 2 * inner, c, scale=c**-0.5),
            _rnd(cuda, 2 * inner, scale=0.1), _rnd(cuda, c, inner, scale=inner**-0.5),
            _rnd(cuda, c, scale=0.1))
    ref = geglu._geglu_xla(*(a.float() for a in args))
    _within(geglu.geglu_ff(*args), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128, 512, 512), (1, 37, 50, 64, 128)])
def test_conv3x3_kernel_on_card(cuda, shape):
    B, H, W, C, O = shape
    x = _rnd(cuda, B, H, W, C)
    w = _rnd(cuda, O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    b = _rnd(cuda, O, scale=0.1)
    ref = conv2d._xla_conv3x3(x.float(), w.float(), b.float())
    _within(conv2d.conv3x3_same(x, w, b), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 256, 512, 256), (1, 137, 200, 128, 128),
                                   (1, 3, 5, 32, 128)])
def test_hopper_conv3x3_kernel_on_card(cuda, shape):
    """The Hopper conv (conv2d_sm90.cu) at a decoder shape and ragged ones
    (H, W not multiples of the 2 x 128 tile; a map smaller than one tile):
    one launch, within 1e-2·max|ref|, the same bits twice, and within
    1e-2 of conv2d.cu's kernel."""
    B, H, W, C, O = shape
    x = _rnd(cuda, B, H, W, C)
    w = _rnd(cuda, O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    b = _rnd(cuda, O, scale=0.1)
    kernels.reset_launches()
    out = conv2d.conv3x3_same(x, w, b)
    assert kernels.LAUNCHES["conv3x3_same"] == 1
    _within(out, conv2d._xla_conv3x3(x.float(), w.float(), b.float()))
    assert torch.equal(out, conv2d.conv3x3_same(x, w, b))
    _within(out, conv2d._launch_conv(x, w, b, "template"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 1024, 1024, 8, 80), (1, 200, 333, 3, 40),
                                          (2, 256, 300, 1, 136), (4, 1024, 1024, 1, 512),
                                          (1, 1000, 1300, 1, 512)])
def test_lse_forward_routes_on_card(cuda, b, sq, skv, h, d):
    """The training forward on the Hopper route its shape rule picks (the
    LSE epilogue of flash_attention_sm90.cu or flash_attention_wide.cu, its
    kv sweep split where `lse_split` says): one launch on that route's
    counter and one combine launch per split, o within 1e-2·max|ref|, lse2
    within 1e-3, the same bits twice, and within those of the unsplit sweep."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    kernels.reset_launches()
    o, lse = fa.flash_attention_lse(q, k, v, d**-0.5)
    route, n_split = fa.lse_route(d), fa.lse_split(b, sq, skv, h, d)
    counters = (*fa.LSE_ROUTE_COUNTERS.values(), fa.LSE_COMBINE_COUNTER)
    assert {c: kernels.LAUNCHES[c] for c in counters} == {
        **{c: int(r == route) for r, c in fa.LSE_ROUTE_COUNTERS.items()},
        fa.LSE_COMBINE_COUNTER: int(n_split > 1)}
    o1, lse1 = fa._launch_lse(q, k, v, d**-0.5, route, 1)
    _within(o, o1)
    assert (lse - lse1).abs().max().item() <= 1e-3
    o_ref, lse_ref = fa._flash_lse_ref(q.float(), k.float(), v.float(), d**-0.5)
    _within(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    o2, lse2 = fa.flash_attention_lse(q, k, v, d**-0.5)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = _rnd(cuda, 1, 128, 128, 100)   # C not a multiple of 32
    with pytest.raises(ValueError):
        conv2d.conv3x3_same(x, _rnd(cuda, 128, 100, 3, 3), _rnd(cuda, 128))
    q = torch.randn(1, 128, 1, 64, device="cuda")   # fp32
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


def _grad_within(out, ref):
    d = out.float() - ref.float()
    assert d.abs().max().item() <= 2e-2 * ref.float().abs().max().item()
    assert d.norm().item() <= 1e-2 * ref.float().norm().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 1024, 1024, 8, 80), (1, 200, 333, 3, 40),
                                          (2, 256, 256, 1, 128), (1, 4096, 4096, 8, 40),
                                          (4, 1024, 1024, 1, 512), (1, 1000, 1300, 1, 512),
                                          (1, 200, 333, 2, 192), (2, 256, 300, 1, 136)])
def test_flash_training_kernels_on_card(cuda, b, sq, skv, h, d):
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    do = _rnd(cuda, b, sq, h, d)
    f32 = lambda *ts: [t.float() for t in ts]
    o, lse = fa.flash_attention_lse(q, k, v, d**-0.5)
    o_ref, lse_ref = fa._flash_lse_ref(*f32(q, k, v), d**-0.5)
    _within(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, d**-0.5)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, d**-0.5)
    refs = fa._flash_bwd_ref(*f32(q, k, v, o), lse, do.float(), d**-0.5)
    for got, ref in zip((dq, dk, dv), refs):
        _grad_within(got, ref)
    assert (delta - refs[3]).abs().max().item() <= 1e-3 * refs[3].abs().max().item()
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, d**-0.5)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,packed", [(1, 4096, 4096, 8, 40, False),
                                                 (1, 1024, 1024, 8, 80, False),
                                                 (1, 1000, 1300, 8, 40, False),
                                                 (2, 1024, 1024, 8, 40, True),
                                                 (1, 1001, 777, 2, 80, False)])
def test_hopper_flash_bwd_on_card(cuda, b, sq, skv, h, d, packed):
    """The backward at head dims up to 128 on flash_attention_bwd_sm90.cu:
    each route counter moves once per call, dq, dk and dv within 2e-2·max|ref|
    and ‖Δ‖₂ ≤ 1e-2·‖ref‖₂ of the fp32 plain version and of the template
    (flash_attention_bwd.cu), the same bits twice. `packed`: q, k and v are
    head views of one fused [B, S, 3·H·D] projection (row stride 3·H·D).
    Sq = 1001 is not a multiple of 4: the dK/dV kernel's lse2 and delta rows
    are not 16-byte aligned, so its producer warp stages them with plain
    loads instead of bulk copies."""
    if packed:
        qkv = _rnd(cuda, b, sq, 3 * h * d)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].unflatten(2, (h, d)) for i in range(3))
    else:
        q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    do, scale = _rnd(cuda, b, sq, h, d), d**-0.5
    assert fa.bwd_route(d) == "sm90"
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    kernels.reset_launches()
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
    assert (kernels.LAUNCHES["flash_bwd_dq_sm90"], kernels.LAUNCHES["flash_bwd_dkv_sm90"]) == (1, 0)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    assert (kernels.LAUNCHES["flash_bwd_dq_sm90"], kernels.LAUNCHES["flash_bwd_dkv_sm90"]) == (1, 1)
    refs = fa._flash_bwd_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(), scale)
    tq, td = fa._launch_bwd("dq", q, k, v, o, lse, do, scale, "template")
    tk, tv = fa._launch_bwd("dkv", q, k, v, do, lse, td, scale, "template")
    for got, ref, tpl in zip((dq, dk, dv), refs, (tq, tk, tv)):
        _grad_within(got, ref)
        _grad_within(got, tpl)
    assert (delta - refs[3]).abs().max().item() <= 1e-3 * refs[3].abs().max().item()
    dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    assert all(torch.equal(x, y) for x, y in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    assert (kernels.LAUNCHES["flash_bwd_dq_sm90"], kernels.LAUNCHES["flash_bwd_dkv_sm90"]) == (2, 2)


# [B, Sq, Skv, H, D, head-packed] of the wide Hopper backward: train_kl_vae's
# codec mid-block, a 512² codec's, a ragged d = 512 case, a bf16 train_ddpm's
# 32² level (one block a slab), a ragged d = 136 (Sq not a multiple of 4:
# lse2 and delta staged by plain loads), d = 200 and 384 (head columns past D
# in a 64-column group) over several heads, and head views of one fused
# projection
WIDE_BWD_CASES = [(4, 1024, 1024, 1, 512, False), (1, 4096, 4096, 1, 512, False),
                  (1, 1000, 1300, 1, 512, False), (6, 1024, 1024, 1, 256, False),
                  (1, 1001, 777, 2, 136, False), (2, 256, 300, 3, 200, False),
                  (1, 1024, 1024, 2, 384, False), (1, 500, 500, 2, 256, True),
                  (2, 300, 257, 2, 512, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,packed", WIDE_BWD_CASES)
def test_wide_hopper_flash_bwd_on_card(cuda, b, sq, skv, h, d, packed):
    """The backward at head dims 129-512 on flash_attention_bwd_wide_sm90.cu
    (a cluster of two blocks a slab at padded head dim 512, one at 256):
    each route counter moves once per call; dq, dk and dv within
    2e-2·max|ref| and ‖Δ‖₂ ≤ 1e-2·‖ref‖₂ of the fp32 plain version and of
    the template (flash_attention_bwd.cu), delta within 1e-3·max|ref|, the
    same bits twice."""
    if packed:
        qkv = _rnd(cuda, b, sq, 3 * h * d)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].unflatten(2, (h, d)) for i in range(3))
    else:
        q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    do, scale = _rnd(cuda, b, sq, h, d), d**-0.5
    assert fa.bwd_route(d) == "wide"
    o, lse = fa.flash_attention_lse(q, k, v, scale)
    kernels.reset_launches()
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    counts = {n: kernels.LAUNCHES[n] for n in fa.BWD_ROUTE_COUNTERS.values()}
    assert counts == {"flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0,
                      "flash_bwd_dq_wide_sm90": 1, "flash_bwd_dkv_wide_sm90": 1}
    refs = fa._flash_bwd_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(), scale)
    tq, td = fa._launch_bwd("dq", q, k, v, o, lse, do, scale, "template")
    tk, tv = fa._launch_bwd("dkv", q, k, v, do, lse, td, scale, "template")
    for got, ref, tpl in zip((dq, dk, dv), refs, (tq, tk, tv)):
        _grad_within(got, ref)
        _grad_within(got, tpl)
    assert (delta - refs[3]).abs().max().item() <= 1e-3 * refs[3].abs().max().item()
    dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    assert all(torch.equal(x, y) for x, y in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(1, 512, 2, 40), (2, 1024, 1, 512)])
def test_flash_function_trains_through_the_kernels(cuda, b, s, h, d):
    q, k, v = (_rnd(cuda, b, s, h, d).requires_grad_() for _ in range(3))
    do = _rnd(cuda, b, s, h, d)
    kernels.reset_launches()
    fa.flash_attention(q, k, v).backward(do)
    assert {n: kernels.LAUNCHES[n] for n in ("flash_attention", "flash_attention_lse",
                                             "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_attention": 0, "flash_attention_lse": 1, "flash_bwd_dq": 1,
        "flash_bwd_dkv": 1}
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fa._xla_ref(*ref, d**-0.5).backward(do.float())
    for t, r in zip((q, k, v), ref):
        _grad_within(t.grad, r.grad)


@pytest.mark.cuda
def test_forward_only_kernels_refuse_inputs_that_need_grad(cuda):
    x = _rnd(cuda, 4096, 320).requires_grad_()
    w1, b1 = _rnd(cuda, 2560, 320), _rnd(cuda, 2560)
    w2, b2 = _rnd(cuda, 320, 1280), _rnd(cuda, 320)
    with pytest.raises(RuntimeError, match="requires grad"):
        geglu.geglu_ff(x, w1, b1, w2, b2)
    out = geglu.geglu_ff_trainable(x, w1, b1, w2, b2)
    assert out.grad_fn is not None
    qkv = _rnd(cuda, 1, 1024, 8 * 40).requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention_hpacked(qkv, qkv, qkv, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 4096, 4096, 1, 512), (1, 512, 700, 1, 512),
                                          (1, 1000, 1300, 8, 40)])
def test_pipelined_flash_kernel_on_card(cuda, monkeypatch, b, sq, skv, h, d):
    """The pipelined sweep gives the bits of the serial sweep of its own
    source: the wide kernel above head dim 128, the serial Hopper kernel of
    flash_attention_sm90.cu at d = 40 (the pipelined sweep there is its PIPE
    kernel, counted under `flash_fwd_sm90_pipe`)."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    route = "wide" if d > 128 else "sm90"
    serial = torch.empty_like(q)
    fa._launch(q, k, v, serial, d**-0.5, fa.Plan("flash_attention", route, False, False,
                                                 False, 0))
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", "1")
    kernels.reset_launches()
    out = fa.flash_attention(q, k, v)
    assert kernels.LAUNCHES["flash_attention_pipelined"] == 1
    assert kernels.LAUNCHES["flash_fwd_wide"] == (d > 128)
    assert kernels.LAUNCHES["flash_fwd_sm90_pipe"] == (d <= 128)
    _within(out, fa._xla_ref(q.float(), k.float(), v.float(), d**-0.5))
    assert torch.equal(out, serial)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,groups", [(4, 4096, 320, 32), (4, 1024, 1280, 32),
                                          (4, 64, 2560, 32), (3, 100, 136, 8)])
@pytest.mark.parametrize("eps,act", [(1e-5, None), (1e-6, "silu")])
def test_group_norm_kernel_on_card(cuda, b, s, c, groups, eps, act):
    x = _rnd(cuda, b, s, c, scale=3.0) + 0.5
    scale, bias = 1 + _rnd(cuda, c, scale=0.2), _rnd(cuda, c, scale=0.3)
    ref = gn.group_norm_xla(x.float(), scale.float(), bias.float(), groups=groups,
                            eps=eps, act=act)
    _within(gn.group_norm(x, scale, bias, groups=groups, eps=eps, act=act), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,heads,d,c", [(4, 4096, 77, 8, 40, 320), (4, 1024, 77, 8, 80, 640),
                                             (4, 256, 77, 8, 160, 1280), (1, 1000, 33, 4, 24, 96)])
def test_crossattn_kernel_on_card(cuda, b, n, m, heads, d, c):
    hd = heads * d
    args = (_rnd(cuda, b, n, c), _rnd(cuda, hd, c, scale=c**-0.5), _rnd(cuda, b, m, hd),
            _rnd(cuda, b, m, hd), _rnd(cuda, c, hd, scale=hd**-0.5), _rnd(cuda, c, scale=0.1))
    ref = xattn.crossattn_kv_xla(*(a.float() for a in args), heads)
    _within(xattn.crossattn_kv(*args, heads), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128, 512, 512), (1, 37, 50, 64, 128)])
def test_gn_silu_conv_kernel_on_card(cuda, shape):
    B, H, W, C, O = shape
    x = _rnd(cuda, B, H, W, C, scale=2.0) + 0.5
    s, sb = 1 + _rnd(cuda, C, scale=0.1), _rnd(cuda, C, scale=0.1)
    w = _rnd(cuda, O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    b = _rnd(cuda, O, scale=0.1)
    ref = conv2d._gn_silu_conv_xla(*(t.float() for t in (x, s, sb, w, b)), 32, 1e-6)
    _within(conv2d.gn_silu_conv3x3(x, s, sb, w, b), ref)


# [B, H, W, C, O] of the fused Hopper kernel (conv2d_gn_sm90.cu): a decoder
# shape, the ragged case, and C = 512 with H odd and W past a 128-pixel tile
# (a block's last row and last pixel tile partial), O over two blocks
GN_CONV_SHAPES = [(2, 256, 256, 512, 256), (1, 37, 50, 64, 128), (1, 75, 200, 512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GN_CONV_SHAPES)
def test_hopper_gn_silu_conv_kernel_on_card(cuda, shape):
    """The fused Hopper kernel: one call on its route counter, within
    1e-2·max|ref| of the fp32 plain version and of conv2d.cu's PRO form, the
    same bits twice; its statistics pass within 1e-5·max|ref| of their fp32
    plain version in the kernel's order of sums."""
    B, H, W, C, O = shape
    x = _rnd(cuda, B, H, W, C, scale=2.0) + 0.5
    s, sb = 1 + _rnd(cuda, C, scale=0.1), _rnd(cuda, C, scale=0.1)
    w = _rnd(cuda, O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    b = _rnd(cuda, O, scale=0.1)
    kernels.reset_launches()
    out = conv2d.gn_silu_conv3x3(x, s, sb, w, b)
    assert kernels.LAUNCHES["gn_silu_conv3x3"] == kernels.LAUNCHES["gn_silu_conv_sm90"] == 1
    _within(out, conv2d._gn_silu_conv_xla(*(t.float() for t in (x, s, sb, w, b)), 32, 1e-6))
    assert torch.equal(out, conv2d.gn_silu_conv3x3(x, s, sb, w, b))
    _within(out, conv2d._launch_gn_silu_conv(x, s, sb, w, b, 32, 1e-6, "template"))
    for got, ref in zip(conv2d._launch_gn_stats(x, s, sb, 32, 1e-6),
                        conv2d._gn_stats_tiled_ref(x, s, sb, 32, 1e-6)):
        _within(got, ref, 1e-5)


@pytest.mark.cuda
def test_gn_silu_conv_kernel_refuses_what_it_cannot_take(cuda):
    for C, O, groups in ((48, 128, 8), (64, 64, 8), (64, 128, 24)):
        x = _rnd(cuda, 1, 8, 8, C)
        with pytest.raises(ValueError):
            conv2d.gn_silu_conv3x3(x, _rnd(cuda, C), _rnd(cuda, C), _rnd(cuda, O, C, 3, 3),
                                   _rnd(cuda, O), groups=groups)


@pytest.mark.cuda
def test_gn_silu_conv_trains_through_the_kernel(cuda):
    x = _rnd(cuda, 1, 32, 32, 64).requires_grad_()
    s, sb = (1 + _rnd(cuda, 64, scale=0.1)).requires_grad_(), _rnd(cuda, 64, scale=0.1)
    w = _rnd(cuda, 128, 64, 3, 3, scale=(9 * 64) ** -0.5).requires_grad_()
    b, g = _rnd(cuda, 128), _rnd(cuda, 1, 32, 32, 128)
    kernels.reset_launches()
    conv2d.gn_silu_conv3x3_trainable(x, s, sb, w, b).backward(g)
    assert kernels.LAUNCHES["gn_silu_conv3x3"] == 1
    ref = [t.detach().float().requires_grad_() for t in (x, s, w)]
    conv2d._gn_silu_conv_xla(ref[0], ref[1], sb.float(), ref[2], b.float()).backward(g.float())
    for t, r in zip((x, s, w), ref):
        _grad_within(t.grad, r.grad)


@pytest.mark.cuda
def test_new_forward_only_kernels_refuse_inputs_that_need_grad(cuda):
    x = _rnd(cuda, 2, 256, 128).requires_grad_()
    one, zero = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(RuntimeError, match="requires grad"):
        gn.group_norm(x, one, zero)
    assert gn.group_norm_trainable(x, one, zero).grad_fn is not None
    kv = _rnd(cuda, 2, 77, 128)
    w = _rnd(cuda, 128, 128)
    with pytest.raises(RuntimeError, match="requires grad"):
        xattn.crossattn_kv(x, w, kv, kv, w, zero.bfloat16(), 4)
    assert xattn.crossattn_kv_trainable(x, w, kv, kv, w, zero.bfloat16(), 4).grad_fn is not None


@pytest.mark.cuda
def test_vq_step_trains_through_the_wide_kernels_at_d256(cuda, monkeypatch):
    """One VQ GAN step of `vq_128_train_config()` under the bf16 parameter
    policy (batch 2, `disc_start` 0, every weight random): the codec's two
    mid-block attentions at [2, 1024, 1, 256] launch the wide LSE forward
    (its kv sweep split in two at this batch, then combined), dQ and dK/dV,
    and no other kernel; each backward call's dq, dk and dv are held to the
    dq/dk/dv bounds against the fp32 plain backward on the inputs the step
    handed it."""
    from sd_tpu_torch.core.config import vq_128_train_config
    from sd_tpu_torch.losses.gan import GanLossConfig
    from sd_tpu_torch.models.autoencoder import VQModel
    from sd_tpu_torch.models.discriminator import NLayerDiscriminator
    from sd_tpu_torch.models.lpips import make_lpips_fn
    from sd_tpu_torch.train.gan import gan_adam, init_gan_state, make_vq_gan_train_step
    from sd_tpu_torch.train.diffusion import float32_moments
    from sd_tpu_torch.weights import randomize_params_

    cfg = vq_128_train_config()
    px = cfg["train"]["image_size"]
    vq = VQModel(**cfg["model"]["params"], device="cuda")
    disc = NLayerDiscriminator(**cfg["discriminator"], device="cuda")
    for module in (vq, disc):
        randomize_params_(module, cuda)
    opt = float32_moments(gan_adam(cfg["train"]["lr"]))
    state = init_gan_state(vq, disc, opt, opt, param_dtype=torch.bfloat16)
    step = make_vq_gan_train_step(
        lambda x, g, temp: vq(x, temp=temp, update=True, deterministic=False), disc,
        make_lpips_fn(mode="random", device="cuda"), opt, opt,
        GanLossConfig(**{**cfg["loss"], "disc_start": 0}))
    calls = []
    dq_fn, dkv_fn = fa.flash_bwd_dq, fa.flash_bwd_dkv

    def dq_recorded(q, k, v, o, lse, do, scale):
        dq, delta = dq_fn(q, k, v, o, lse, do, scale)
        calls.append([(q, k, v, o, lse, do, scale), dq])
        return dq, delta

    def dkv_recorded(q, k, v, do, lse, delta, scale):
        dk, dv = dkv_fn(q, k, v, do, lse, delta, scale)
        calls[-1] += [dk, dv]
        return dk, dv

    monkeypatch.setattr(fa, "flash_bwd_dq", dq_recorded)
    monkeypatch.setattr(fa, "flash_bwd_dkv", dkv_recorded)
    kernels.reset_launches()
    x = torch.rand(2, px, px, 3, generator=cuda, device="cuda") * 2 - 1
    logs = step(state, x, None)
    torch.cuda.synchronize()
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in logs.values())
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {
        "flash_attention_lse": 2, "flash_lse_wide": 2, "flash_lse_combine": 2,
        "flash_bwd_dq": 2, "flash_bwd_dkv": 2, "flash_bwd_dq_wide_sm90": 2,
        "flash_bwd_dkv_wide_sm90": 2}
    assert len(calls) == 2
    for (q, k, v, o, lse, do, scale), dq, dk, dv in calls:
        assert q.shape == (2, 1024, 1, 256) and q.dtype == torch.bfloat16
        refs = fa._flash_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                 do.float(), scale)
        for got, ref in zip((dq, dk, dv), refs):
            _grad_within(got, ref)


def _card_and_cpu(module, fn, *inputs):
    """fn(module, *inputs) with the fp32 module on the card and on a CPU copy."""
    import copy

    with torch.no_grad():
        out = fn(module, *(t.cuda() for t in inputs)).cpu()
        ref = fn(copy.deepcopy(module).cpu(), *inputs)
    return out, ref


def _card_vs_cpu_within(out, ref, tol=1e-3):
    err = (out - ref).abs().max().item()
    assert torch.isfinite(out).all() and err <= tol * ref.abs().max().item(), err


@pytest.mark.cuda
def test_sr_unet_runs_plain_on_the_card_as_on_the_cpu(cuda, monkeypatch):
    """ldm_sr_catdog's UNet (SelfAttentionBlock2D at 16² and 8², fp32, every
    weight random) on the card against its CPU copy, with TF32 off: within
    1e-3·max|ref|, and no kernel launched (sq < 512 and fp32: the plain path)."""
    from sd_tpu_torch.core.config import ldm_sr_catdog_config
    from sd_tpu_torch.models.unet_sd import UNetModel
    from sd_tpu_torch.weights import randomize_params_

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    unet = UNetModel(**ldm_sr_catdog_config()["unet"]["params"])
    randomize_params_(unet, cuda)
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn((2, 32, 32, 6), generator=g), torch.tensor([17, 803])
    kernels.reset_launches()
    out, ref = _card_and_cpu(unet, lambda m, x_, t_: m(x_, t_), x, t)
    assert not any(kernels.LAUNCHES.values()), {k: v for k, v in kernels.LAUNCHES.items() if v}
    _card_vs_cpu_within(out, ref)


@pytest.mark.cuda
def test_per_level_codec_runs_on_the_card_as_on_the_cpu(cuda, monkeypatch):
    """A KL codec with per-level attention at 32² (1024 tokens, d = 256):
    fp32 on the card against its CPU copy within 1e-3·max|ref| with no
    launch; in bf16 its 32² blocks take the wide flash kernel (2 in the
    encoder with the mid block, 3 in the decoder, counted under
    `flash_fwd_wide`) and the result stays within 0.1·max|ref| of fp32 (the
    decoder's bf16 bound in `chip_smoke.py`)."""
    from sd_tpu_torch.models.autoencoder import AutoencoderKL
    from sd_tpu_torch.weights import randomize_params_

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    vae = AutoencoderKL(embed_dim=4, ch=64, ch_mult=(1, 2, 4), num_res_blocks=1,
                        attn_resolutions=(32,), resolution=128, z_channels=4).eval()
    randomize_params_(vae, cuda)
    fwd = lambda m, x_: m.decode(m.encode(x_).mode())
    x = torch.rand((1, 128, 128, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    kernels.reset_launches()
    out, ref = _card_and_cpu(vae, fwd, x)
    assert not any(kernels.LAUNCHES.values())
    _card_vs_cpu_within(out, ref)
    with torch.no_grad():
        low = fwd(vae.to(torch.bfloat16), x.cuda().bfloat16()).float().cpu()
    assert kernels.LAUNCHES["flash_attention"] == kernels.LAUNCHES["flash_fwd_wide"] == 5
    _card_vs_cpu_within(low, ref, 0.1)
