"""The opt-in kernel configuration (`SD_TPU_PALLAS_GN=1
SD_TPU_PALLAS_XATTN=1 SD_TPU_FLASH_PIPE=1`) against the JAX package, fp32 on
the CPU.

Each of the four kernel modules of the opt-in path — GroupNorm, the fused
cross-attention, the pipelined flash sweep and the fused GroupNorm → SiLU →
3×3 conv — is held against its Pallas kernel run in interpret mode at small
shapes: the port's plain version and its public wrapper (which runs the plain
version on a CPU tensor), within 1e-4·max(1, max|ref|). `GroupNorm32` and
`CrossAttention` with their gates forced on are held against the JAX modules
with theirs forced on, at the same tolerance. The tiny-width `generate` of
`tests/test_torch_slice.py`, with the three switches set and the gates
deciding as on the card and the TPU (bf16), is held against `sd_tpu`'s with
the same injected noise, within 1e-3·max(1, max|ref|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_helpers import (SLICE_TOL, assert_close, flax_init, nprand, port,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_VAE, vae_params
from test_torch_slice import PROMPTS, TINY_CLIP, tiny_config

from sd_tpu.core.schedules import DiffusionSchedule
from sd_tpu.diffusion.ddim import DDIMSampler
from sd_tpu.kernels import conv2d as jconv
from sd_tpu.kernels import cross_attention as jxattn
from sd_tpu.kernels import flash_attention as jfa
from sd_tpu.kernels import groupnorm as jgn
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.clip_text import ClipTextConfig, ClipTextTransformer, SimpleHashTokenizer
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.nn import attention as jattn
from sd_tpu.nn import layers as jlayers
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import conv2d, cross_attention as xattn, flash_attention as fa
from sd_tpu_torch.kernels import groupnorm as gn
from sd_tpu_torch.nn import attention, layers
from sd_tpu_torch.pipeline import Text2ImagePipeline

OPT_IN = ("SD_TPU_PALLAS_GN", "SD_TPU_PALLAS_XATTN", "SD_TPU_FLASH_PIPE")


# -- the kernel modules ----------------------------------------------------------


@pytest.mark.parametrize("shape,groups", [((2, 512, 320), 32), ((1, 256, 128), 32),
                                          ((2, 96, 256), 16)])
@pytest.mark.parametrize("eps,act", [(1e-5, None), (1e-6, "silu")])
def test_group_norm_matches_pallas(shape, groups, eps, act):
    C = shape[-1]
    x = nprand(*shape, scale=3.0) + 0.5
    scale, bias = 1 + nprand(C, seed=1, scale=0.2), nprand(C, seed=2, scale=0.3)
    ref = jgn.group_norm(*(jnp.asarray(a) for a in (x, scale, bias)), groups=groups,
                         eps=eps, act=act, interpret=True)
    args = (to_torch(x), to_torch(scale), to_torch(bias))
    assert_close(gn.group_norm_xla(*args, groups=groups, eps=eps, act=act), ref)
    assert_close(gn.group_norm(*args, groups=groups, eps=eps, act=act), ref)


def _xattn_args(B, N, M, heads, d, C, seed=0):
    HD = heads * d
    x, wq = nprand(B, N, C, seed=seed), nprand(C, HD, seed=seed + 1, scale=C**-0.5)
    k, v = nprand(B, M, HD, seed=seed + 2), nprand(B, M, HD, seed=seed + 3)
    wo, bo = nprand(HD, C, seed=seed + 4, scale=HD**-0.5), nprand(C, seed=seed + 5, scale=0.1)
    return x, wq, k, v, wo, bo


@pytest.mark.parametrize("B,N,M,heads,d,C", [(2, 256, 77, 8, 40, 320),
                                             (2, 256, 16, 4, 32, 128),
                                             (1, 256, 77, 8, 80, 640)])
def test_crossattn_matches_pallas(B, N, M, heads, d, C):
    x, wq, k, v, wo, bo = _xattn_args(B, N, M, heads, d, C)
    ref = jxattn.crossattn_kv(*(jnp.asarray(a) for a in (x, wq, k, v, wo, bo)), heads,
                              interpret=True)
    # torch Linear layout: the weights transposed
    args = (to_torch(x), to_torch(wq.T), to_torch(k), to_torch(v), to_torch(wo.T),
            to_torch(bo))
    assert_close(xattn.crossattn_kv_xla(*args, heads), ref)
    assert_close(xattn.crossattn_kv(*args, heads), ref)


@pytest.mark.parametrize("skv,block_k", [(512, 128), (300, 128), (1024, 256)])
def test_flash_pipelined_matches_pallas(skv, block_k, monkeypatch):
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", "1")
    q, k, v = nprand(2, 256, 2, 40), nprand(2, skv, 2, 40, seed=1), nprand(2, skv, 2, 40, seed=2)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_k=block_k, interpret=True)
    assert_close(fa._xla_ref(to_torch(q), to_torch(k), to_torch(v), 40**-0.5), ref)
    kernels.reset_launches()
    assert_close(fa.flash_attention(to_torch(q), to_torch(k), to_torch(v)), ref)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def _jax_takes_pipelined(sq, skv, d, monkeypatch) -> bool:
    """Which forward kernel the TPU package's `flash_attention` builds for
    these shapes (traced abstractly, the Pallas call recorded)."""
    seen = []
    real = jfa.pl.pallas_call

    def spy(kernel, **kw):
        seen.append(kernel.func.__name__)
        return real(kernel, **kw)

    with monkeypatch.context() as m:
        m.setattr(jfa.pl, "pallas_call", spy)
        s = lambda n: jax.ShapeDtypeStruct((1, n, 1, d), jnp.bfloat16)
        jax.eval_shape(lambda q, k, v: jfa.flash_attention(q, k, v), s(sq), s(skv), s(skv))
    assert len(seen) == 1, seen
    return seen[0] == "_flash_kernel_pipelined"


@pytest.mark.parametrize("sq,skv,d", [(4096, 4096, 512), (1024, 1024, 512), (512, 512, 512),
                                      (1024, 1024, 40), (1024, 2048, 40), (256, 1100, 64)])
@pytest.mark.parametrize("pipe", ["0", "1"])
def test_flash_pipelined_switch_matches_the_tpu_package(sq, skv, d, pipe, monkeypatch):
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", pipe)
    assert fa.flash_pipelined_ok(skv, d) == _jax_takes_pipelined(sq, skv, d, monkeypatch)


@pytest.mark.parametrize("B,H,W,C,O,tile", [(2, 16, 16, 32, 32, None), (1, 32, 24, 32, 64, 8)])
def test_gn_silu_conv_matches_pallas(B, H, W, C, O, tile):
    x = nprand(B, H, W, C, scale=2.0) + 0.5
    s, sb = 1 + nprand(C, seed=1, scale=0.1), nprand(C, seed=2, scale=0.1)
    w, cb = nprand(3, 3, C, O, seed=3, scale=0.05), nprand(O, seed=4, scale=0.1)
    jargs = tuple(jnp.asarray(a) for a in (x, s, sb, w, cb))
    ref = jconv.gn_silu_conv3x3(*jargs, groups=8, eps=1e-6, row_tile=tile, interpret=True)
    args = (to_torch(x), to_torch(s), to_torch(sb), to_torch(w.transpose(3, 2, 0, 1)),
            to_torch(cb))
    assert_close(conv2d._gn_silu_conv_xla(*args, 8, 1e-6), ref)
    assert_close(conv2d.gn_silu_conv3x3(*args, groups=8, eps=1e-6), ref)


def test_gn_silu_conv_trainable_grads_match_pallas_vjp():
    x = nprand(1, 16, 16, 32, scale=2.0) + 0.5
    s, sb = 1 + nprand(32, seed=1, scale=0.1), nprand(32, seed=2, scale=0.1)
    w, cb = nprand(3, 3, 32, 32, seed=3, scale=0.05), nprand(32, seed=4, scale=0.1)
    g = nprand(1, 16, 16, 32, seed=5)
    ref, vjp = jax.vjp(lambda *a: jconv.gn_silu_conv3x3_trainable(*a, 8, 1e-6, True),
                       *(jnp.asarray(a) for a in (x, s, sb, w, cb)))
    ref_grads = vjp(jnp.asarray(g))
    ins = [to_torch(a).requires_grad_()
           for a in (x, s, sb, w.transpose(3, 2, 0, 1).copy(), cb)]
    out = conv2d.gn_silu_conv3x3_trainable(*ins, 8, 1e-6)
    out.backward(to_torch(g))
    assert_close(out, ref)
    for got, want in zip([t.grad for t in ins[:3]], ref_grads[:3]):
        assert_close(got, want)
    assert_close(ins[3].grad, ref_grads[3].transpose(3, 2, 0, 1))
    assert_close(ins[4].grad, ref_grads[4])


def test_optin_gates_are_off_by_default_and_in_training(monkeypatch):
    for var in OPT_IN:
        monkeypatch.delenv(var, raising=False)
    assert not gn.group_norm_wants_pallas((4, 64, 64, 320), 32)
    assert not xattn.crossattn_kv_wants_pallas(4096, 77, 8, 40, 320)
    assert not fa.flash_pipelined_ok(4096, 512)
    for var in OPT_IN:
        monkeypatch.setenv(var, "1")
    assert gn.group_norm_wants_pallas((4, 64, 64, 320), 32)
    assert xattn.crossattn_kv_wants_pallas(4096, 77, 8, 40, 320)
    assert fa.flash_pipelined_ok(4096, 512)
    with conv2d.training_trace():
        assert not gn.group_norm_wants_pallas((4, 64, 64, 320), 32)
        assert not xattn.crossattn_kv_wants_pallas(4096, 77, 8, 40, 320)
    assert not gn.group_norm_wants_pallas((4, 64, 64, 320), 32, torch.float32)
    assert not xattn.crossattn_kv_wants_pallas(4096, 77, 8, 40, 320, torch.float32)


# -- the modules with their gates forced on ---------------------------------------


@pytest.fixture
def forced_gates(monkeypatch):
    """Both packages' GroupNorm and cross-attention gates on, the JAX
    kernels run in interpret mode; counts the port's kernel-branch calls."""
    calls = {"gn": 0, "xattn": 0}
    real_gn, real_xa = jgn.group_norm_trainable, jxattn.crossattn_kv_trainable
    monkeypatch.setattr(jgn, "group_norm_wants_pallas", lambda *a: True)
    monkeypatch.setattr(jgn, "group_norm_trainable",
                        lambda x, s, b, groups, eps: real_gn(x, s, b, groups, eps, None, True))
    monkeypatch.setattr(jxattn, "crossattn_kv_wants_pallas", lambda *a: True)
    monkeypatch.setattr(jxattn, "crossattn_kv_trainable",
                        lambda *a: real_xa(*a, None, True))
    monkeypatch.setattr(gn, "group_norm_wants_pallas", lambda *a: True)
    monkeypatch.setattr(xattn, "crossattn_kv_wants_pallas", lambda *a: True)
    for mod, name, key in ((gn, "group_norm_trainable", "gn"),
                           (xattn, "crossattn_kv_trainable", "xattn")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _run(flax_mod, torch_mod, *args, seed=0):
    jargs = [jnp.asarray(a) for a in args]
    params = flax_init(flax_mod, *jargs, seed=seed)
    ref = flax_mod.apply({"params": params}, *jargs)
    with torch.no_grad():
        got = port(torch_mod, params)(*(to_torch(a) for a in args))
    return got, ref


@pytest.mark.parametrize("c,eps", [(64, 1e-5), (128, 1e-6)])
def test_group_norm32_through_the_kernel_branch(forced_gates, c, eps):
    x = nprand(2, 8, 8, c, scale=3.0) + 1.0
    got, ref = _run(jlayers.GroupNorm32(32, epsilon=eps), layers.GroupNorm32(c, 32, eps=eps), x)
    assert_close(got, ref)
    assert forced_gates["gn"] == 1


def test_cross_attention_through_the_fused_branch(forced_gates):
    x, ctx = nprand(2, 16, 32), nprand(2, 7, 24, seed=1)
    got, ref = _run(jattn.CrossAttention(heads=4, dim_head=8),
                    attention.CrossAttention(32, 24, 4, 8), x, ctx)
    assert_close(got, ref)
    assert forced_gates["xattn"] == 1


def test_self_attention_never_takes_the_fused_branch(forced_gates):
    got, ref = _run(jattn.CrossAttention(heads=4, dim_head=8),
                    attention.CrossAttention(32, None, 4, 8), nprand(2, 16, 32))
    assert_close(got, ref)
    assert forced_gates["xattn"] == 0


# -- the opt-in generate at tiny widths ---------------------------------------------

# 128 channels at latent 16²: the GroupNorm rule holds at every UNet norm and
# the cross-attention rule at every cross-attention (256 tokens)
OPTIN_UNET = dict(in_channels=4, model_channels=128, out_channels=4, num_res_blocks=1,
                  attention_resolutions=(1,), channel_mult=(1,), num_heads=4,
                  context_dim=32)


def test_optin_generate_matches_the_tpu_package(monkeypatch):
    for var in OPT_IN:
        monkeypatch.setenv(var, "1")
    decided = {"jax": [], "port": []}

    def as_on_tpu(gate, key):
        def g(*args):
            with monkeypatch.context() as m:
                m.setattr(jax, "default_backend", lambda: "tpu")
                ok = gate(*args[:-1], jnp.bfloat16)
            decided["jax"].append((key, ok))
            return ok
        return g

    def as_on_card(gate, key):
        def g(*args):
            ok = gate(*args[:-1], torch.bfloat16)
            decided["port"].append((key, ok))
            return ok
        return g

    real_gn, real_xa = jgn.group_norm_trainable, jxattn.crossattn_kv_trainable
    monkeypatch.setattr(jgn, "group_norm_wants_pallas",
                        as_on_tpu(jgn.group_norm_wants_pallas, "gn"))
    monkeypatch.setattr(jxattn, "crossattn_kv_wants_pallas",
                        as_on_tpu(jxattn.crossattn_kv_wants_pallas, "xattn"))
    monkeypatch.setattr(jgn, "group_norm_trainable",
                        lambda x, s, b, groups, eps: real_gn(x, s, b, groups, eps, None, True))
    monkeypatch.setattr(jxattn, "crossattn_kv_trainable", lambda *a: real_xa(*a, None, True))
    monkeypatch.setattr(gn, "group_norm_wants_pallas",
                        as_on_card(gn.group_norm_wants_pallas, "gn"))
    monkeypatch.setattr(xattn, "crossattn_kv_wants_pallas",
                        as_on_card(xattn.crossattn_kv_wants_pallas, "xattn"))

    clip = ClipTextTransformer(ClipTextConfig(**TINY_CLIP))
    cparams = flax_init(clip, jnp.zeros((1, 16), jnp.int32), seed=3)
    uparams = flax_init(JUNet(**OPTIN_UNET), jnp.zeros((1, 16, 16, 4)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 32)), seed=4)
    vparams = vae_params(seed=5)
    x_T = nprand(2, 16, 16, 4, seed=6)

    tok = SimpleHashTokenizer(16, 1000)
    emb = jax.jit(clip.apply)({"params": cparams},
                              jnp.concatenate([tok([""] * 2), tok(PROMPTS)]))
    uc, c = jnp.split(emb, 2, axis=0)
    unet = JUNet(**OPTIN_UNET)
    start = len(decided["jax"])          # the param inits above traced the gates too
    sched = DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    z = DDIMSampler(sched).sample(
        lambda x, t, ctx: unet.apply({"params": uparams}, x, t, ctx),
        jax.random.PRNGKey(0), x_T.shape, num_steps=4, cond=c, uncond=uc,
        guidance_scale=7.5, eta=0.0, x_T=jnp.asarray(x_T))
    n_unet = len(decided["jax"])
    ref = jax.jit(lambda p, z: JAutoencoderKL(**TINY_VAE).apply(
        {"params": p}, z, method=JAutoencoderKL.decode))(vparams, z / 0.18215)

    cfg = tiny_config()
    cfg["unet"]["params"].update(OPTIN_UNET)
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    port(pipe.clip, cparams)
    port(pipe.unet, uparams)
    port(pipe.vae, vparams)
    got = pipe.sample(PROMPTS, to_torch(x_T), num_steps=4, guidance_scale=7.5, eta=0.0)
    assert_close(got, ref, SLICE_TOL)

    # the JAX sampler traces its UNet once, the port decides at each of its
    # 4 calls: the same decisions, call site by call site, then the decoder's
    jax_unet, jax_dec = decided["jax"][start:n_unet], decided["jax"][n_unet:]
    assert decided["port"] == jax_unet * 4 + jax_dec
    assert ("gn", True) in jax_unet and ("xattn", True) in jax_unet
