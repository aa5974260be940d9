"""The port's CUDA kernels against their plain PyTorch versions, on the card.

bf16 inputs from a seed, the plain version computed in fp32 from the same
inputs, max|Δ| ≤ 1e-2·max|ref| (bf16 output rounding plus p rounded to bf16
in attention). The flash backward: lse2 within 1e-3 absolute; dq, dk, dv
within 2e-2·max|ref| and ‖Δ‖₂ ≤ 1e-2·‖ref‖₂ (p and dS round to bf16 at 2⁻⁸
and the sums run over up to 4096 rows). Every test needs a CUDA device and
skips without one. This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import conv2d, flash_attention as fa, geglu


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
                                          (2, 256, 256, 1, 128), (1, 4096, 4096, 8, 40)])
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
def test_flash_function_trains_through_the_kernels(cuda):
    q, k, v = (_rnd(cuda, 1, 512, 2, 40).requires_grad_() for _ in range(3))
    do = _rnd(cuda, 1, 512, 2, 40)
    kernels.reset_launches()
    fa.flash_attention(q, k, v).backward(do)
    assert {n: kernels.LAUNCHES[n] for n in ("flash_attention", "flash_attention_lse",
                                             "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_attention": 0, "flash_attention_lse": 1, "flash_bwd_dq": 1,
        "flash_bwd_dkv": 1}
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fa._xla_ref(*ref, 40**-0.5).backward(do.float())
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
