"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the TPU kernel run in Pallas interpret mode at tiny shapes (head dim 40,
ragged kv, the head-packed layout), in fp32, within 1e-4·max(1, max|ref|).
The flash training path likewise: the port's autograd Function (the LSE
forward and the dQ, dK/dV plain versions) against `jax.vjp` of the Pallas
LSE forward and backward kernels, and the plain backward against the TPU
package's chunked backward. The CUDA kernels themselves are held against
these plain versions on the card by `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import assert_close, nprand, to_torch

from sd_tpu.kernels import conv2d as jconv
from sd_tpu.kernels import flash_attention as jfa
from sd_tpu.kernels import geglu as jgeglu
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import conv2d, flash_attention as fa, geglu


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 128, 128, 2, 40),     # SD head dim 40
    (2, 128, 200, 1, 64),     # ragged kv
    (1, 64, 77, 1, 512),      # codec single-head width
])
def test_flash_attention_matches_pallas(b, sq, skv, h, d):
    q, k, v = (nprand(b, s, h, d, seed=i) for i, s in enumerate((sq, skv, skv)))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              interpret=True)
    got = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    assert_close(got, ref)


@pytest.mark.parametrize("sq,skv,heads,d", [(128, 128, 2, 40), (128, 300, 4, 16)])
def test_flash_attention_hpacked_matches_pallas(sq, skv, heads, d):
    q = nprand(2, sq, heads * d, seed=0)
    k, v = nprand(2, skv, heads * d, seed=1), nprand(2, skv, heads * d, seed=2)
    ref = jfa.flash_attention_hpacked(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), heads, interpret=True)
    got = fa.flash_attention_hpacked(to_torch(q), to_torch(k), to_torch(v), heads)
    assert_close(got, ref)


@pytest.mark.parametrize("n,c", [(256, 32), (128, 64)])
def test_geglu_matches_pallas(n, c):
    inner = 4 * c
    x = nprand(n, c, seed=0)
    w1, b1 = nprand(c, 2 * inner, seed=1, scale=c**-0.5), nprand(2 * inner, seed=2, scale=0.1)
    w2, b2 = nprand(inner, c, seed=3, scale=inner**-0.5), nprand(c, seed=4, scale=0.1)
    ref = jgeglu.geglu_ff(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                          token_tile=128, interpret=True)
    got = geglu.geglu_ff(to_torch(x), to_torch(w1.T), to_torch(b1),
                         to_torch(w2.T), to_torch(b2))
    assert_close(got, ref)


@pytest.mark.parametrize("shape", [(1, 8, 128, 128, 128), (2, 6, 20, 16, 24)])
def test_conv3x3_matches_pallas(shape):
    B, H, W, C, O = shape
    x = nprand(B, H, W, C, seed=0)
    w = nprand(3, 3, C, O, seed=1, scale=(9 * C) ** -0.5)
    b = nprand(O, seed=2, scale=0.1)
    ref = jconv.conv3x3_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             interpret=True)
    got = conv2d.conv3x3_same(to_torch(x), to_torch(w.transpose(3, 2, 0, 1)),
                              to_torch(b))
    assert_close(got, ref)


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launches()
    x = torch.randn(1, 4, 4, 8)
    conv2d.conv3x3_same(x, torch.randn(8, 8, 3, 3), torch.zeros(8))
    fa.flash_attention(torch.randn(1, 8, 1, 8), torch.randn(1, 8, 1, 8),
                       torch.randn(1, 8, 1, 8))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


# -- the flash training path -----------------------------------------------------

TRAIN_SHAPES = [(1, 128, 128, 2, 40), (2, 128, 200, 1, 64), (1, 128, 128, 2, 80)]


def _qkv_do(b, sq, skv, h, d):
    return [nprand(b, s, h, d, seed=i) for i, s in enumerate((sq, skv, skv, sq))]


@pytest.mark.parametrize("b,sq,skv,h,d", TRAIN_SHAPES)
def test_flash_attention_grads_match_pallas_vjp(b, sq, skv, h, d):
    q, k, v, do = _qkv_do(b, sq, skv, h, d)
    ref, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True),
                       *(jnp.asarray(t) for t in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (to_torch(t).requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    out.backward(to_torch(do))
    assert_close(out, ref)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert_close(got, want)


@pytest.mark.parametrize("b,sq,skv,h,d", TRAIN_SHAPES)
def test_flash_lse_matches_pallas_lse_kernel(b, sq, skv, h, d):
    q, k, v, _ = _qkv_do(b, sq, skv, h, d)
    out, res = jfa._fwd(*(jnp.asarray(t) for t in (q, k, v)), d**-0.5, 2048, 1024, True)
    lse_ref = np.asarray(res[4])[:, :sq, 0].reshape(b, h, sq)
    got, lse = fa.flash_attention_lse(to_torch(q), to_torch(k), to_torch(v), d**-0.5)
    assert_close(got, out)
    assert_close(lse, lse_ref)


@pytest.mark.parametrize("b,sq,skv,h,d", TRAIN_SHAPES)
def test_flash_bwd_ref_matches_bwd_chunked(b, sq, skv, h, d):
    q, k, v, do = _qkv_do(b, sq, skv, h, d)
    ref = jfa._bwd_chunked(d**-0.5, 128, tuple(jnp.asarray(t) for t in (q, k, v)),
                           jnp.asarray(do))
    tq, tk, tv, tdo = (to_torch(t) for t in (q, k, v, do))
    o, lse = fa._flash_lse_ref(tq, tk, tv, d**-0.5)
    dq, dk, dv, delta = fa._flash_bwd_ref(tq, tk, tv, o, lse, tdo, d**-0.5)
    for got, want in zip((dq, dk, dv), ref):
        assert_close(got, want)
    assert_close(delta, np.einsum("bqhd,bqhd->bhq", do, o.numpy()))


def test_flash_bwd_wrappers_are_the_plain_versions_on_cpu():
    q, k, v, do = (to_torch(t) for t in _qkv_do(1, 64, 96, 2, 16))
    o, lse = fa.flash_attention_lse(q, k, v, 0.25)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, 0.25)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, 0.25)
    for got, want in zip((dq, dk, dv, delta), fa._flash_bwd_ref(q, k, v, o, lse, do, 0.25)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_refuse_grad_guards_the_forward_only_kernels():
    x = torch.randn(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.refuse_grad("k", torch.randn(3), x)
    with torch.no_grad():
        kernels.refuse_grad("k", x)
    kernels.refuse_grad("k", x.detach())
    assert kernels.needs_grad(x) and not kernels.needs_grad(x.detach())


def test_trainable_wrappers_keep_the_gradient():
    kernels.reset_launches()
    x = torch.randn(1, 8, 8, 32, requires_grad=True)
    w, b = torch.randn(128, 32, 3, 3, requires_grad=True), torch.randn(128)
    y = conv2d.conv3x3_same_trainable(x, w, b)
    torch.testing.assert_close(y, conv2d._xla_conv3x3(x, w, b))
    h = torch.randn(64, 32, requires_grad=True)
    args = (h, torch.randn(256, 32), torch.randn(256), torch.randn(32, 128), torch.randn(32))
    out = geglu.geglu_ff_trainable(*args)
    (y.sum() + out.sum()).backward()
    assert x.grad is not None and w.grad is not None and h.grad is not None
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_training_trace_turns_the_inference_kernels_off():
    from sd_tpu_torch.kernels import attention as attn_k

    assert conv2d.conv3x3_wants_pallas((1, 512, 512, 128), 128, 128)
    assert attn_k.hpacked_flash_ok(4096, 4096, 8, 40)
    with conv2d.training_trace():
        assert not conv2d.conv3x3_wants_pallas((1, 512, 512, 128), 128, 128)
        assert not attn_k.hpacked_flash_ok(4096, 4096, 8, 40)
    assert conv2d.conv3x3_wants_pallas((1, 512, 512, 128), 128, 128)
