"""Structure and guard tests of the PyTorch port, all on the CPU:

* at full SD-v1 width every leaf of the JAX package's param trees maps onto
  the port's modules (built on the `meta` device, no compute), shape for
  shape, with equal parameter counts — the UNet, the whole KL tree
  (encoder, decoder, quant_conv, post_quant_conv) and CLIP;
* the port's kernel shape rules agree with the JAX package's TPU gates at
  every call site of the 512² text-to-image path (found by running the
  port's full-width UNet and decoder on `meta` tensors), which gives the
  launch counts of one 50-step generate: 501 flash, 500 GEGLU, 18 conv;
* the same with the opt-in switches set (`SD_TPU_PALLAS_GN=1
  SD_TPU_PALLAS_XATTN=1 SD_TPU_FLASH_PIPE=1`), where the GroupNorm,
  fused cross-attention and pipelined-flash rules decide too: 2850 GroupNorm,
  750 cross-attention and 1 pipelined flash launch per generate, no serial
  flash, and the shapes and parity launches `chip_smoke.py` checks; and
  with `SD_TPU_PALLAS_CONV=0`, no conv;
* the same at every call site of one full-width optimizer step of
  `configs/sd512_catdog.yaml` (KL encode, UNet forward, remat recompute and
  backward, 4 microbatches, on `meta` tensors) with the JAX gates in their
  training context; counting the kernel wrappers it reaches gives the
  training launch counts `chip_smoke.py` requires: 80 LSE forwards, 40 dQ,
  40 dK/dV and no other kernel per step, with the opt-in switches set too;
* the same for one full-width step of the KL-f8 first stage's GAN training
  (`configs/kl_f8_256_catdog.yaml`, 256², batch 4, bf16 parameters): the
  codec's two mid-block attentions at head dim 512 pass the flash gate, and
  the step reaches 2 LSE forwards, 2 dQ and 2 dK/dV and no other kernel;
* the serving path at full width (a bucket-4 group of 30-step requests with
  `SD_TPU_FLASH_EXP=bf16 SD_TPU_FLASH_PV=int8`, on `meta` tensors): 310
  head-packed launches of the bf16-exponential int8-PV variant on the
  int8-PV Hopper kernel (`flash_fwd_sm90_pv8`) and 1 flash launch of the
  decoder on the wide kernel (`flash_fwd_wide`), the switches read as the
  JAX package reads them;
* the TPU package's attention switches (`SD_TPU_ATTN_IMPL`,
  `SD_TPU_ATTN_HPACKED`, `SD_TPU_ATTN_PACKED`, `SD_TPU_FLASH_BWD`), each
  value: the port's gates agree with the JAX gates, and the route of a
  level-0 attention at inference and in training and of
  `dot_product_attention` (with and without `impl=`) is the JAX package's;
* every flash launch of a full-width `generate` takes the route its plan
  says: the 500 head-packed launches the Hopper kernel (`flash_fwd_sm90`),
  the decoder's the wide kernel (`flash_fwd_wide`); with
  `SD_TPU_ATTN_HPACKED=0` the 500 move to `flash_attention` on the same
  route;
* the port (the serving modules included) and `chip_smoke.py` import
  neither JAX nor the JAX package;
* the pipeline and the trainer refuse to run without a card unless asked
  for the CPU;
* `sd_v1_config()` is `configs/sd_txt2img.yaml`, `sd512_train_config()`
  is `configs/sd512_catdog.yaml` without the first-stage checkpoint and
  `kl_f8_256_train_config()` is `configs/kl_f8_256_catdog.yaml`.
"""

from __future__ import annotations

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from sd_tpu.core import schedules as jschedules
from sd_tpu.kernels import attention as jattn
from sd_tpu.kernels import conv2d as jconv
from sd_tpu.kernels import cross_attention as jxattn
from sd_tpu.kernels import flash_attention as jfa
from sd_tpu.kernels import geglu as jgeglu
from sd_tpu.kernels import groupnorm as jgn
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.clip_text import ClipTextConfig as JClipConfig
from sd_tpu.models.clip_text import ClipTextTransformer as JClip
from sd_tpu.models.unet_sd import UNetModel as JUNet
import chip_smoke
from sd_tpu_torch.core.config import (kl_f8_256_train_config, sd512_train_config,
                                     sd_v1_config, vq_128_train_config)
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import flash_attention as fa
from sd_tpu_torch.kernels import attention as attn_k
from sd_tpu_torch.kernels import conv2d as conv_k
from sd_tpu_torch.kernels import cross_attention as xattn_k
from sd_tpu_torch.kernels import geglu as geglu_k
from sd_tpu_torch.kernels import groupnorm as gn_k
from sd_tpu_torch.losses.gan import GanLossConfig
from sd_tpu_torch.models.autoencoder import AutoencoderKL, VQModel
from sd_tpu_torch.models.clip_text import ClipTextConfig, ClipTextTransformer
from sd_tpu_torch.models.discriminator import NLayerDiscriminator
from sd_tpu_torch.models.lpips import LPIPS
from sd_tpu_torch.nn.attention import CrossAttention
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.train import diffusion as train
from sd_tpu_torch.train import gan as gan_train
from sd_tpu_torch.train.remat import remat_apply
from sd_tpu_torch.train.runners import train_ldm
from sd_tpu_torch.weights import flax_shapes

REPO = Path(__file__).resolve().parents[1]
CFG = sd_v1_config()
UNET = CFG["unet"]["params"]
VAE = CFG["first_stage"]["params"]
BF16 = dict(dtype=torch.bfloat16, device="meta")


def _shapes(module):
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def _flax_tree(module, *args):
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]


@pytest.mark.parametrize("model", ["unet", "vae", "clip"])
def test_full_width_param_trees_map_onto_the_port(model):
    if model == "unet":
        tree = _flax_tree(JUNet(**UNET), jnp.zeros((1, 64, 64, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768)))
        mod = UNetModel(**UNET, **BF16)
    elif model == "vae":
        tree = _flax_tree(JAutoencoderKL(**VAE), jnp.zeros((1, 512, 512, 3)))
        mod = AutoencoderKL(**VAE, **BF16)
    else:
        tree = _flax_tree(JClip(JClipConfig()), jnp.zeros((1, 77), jnp.int32))
        mod = ClipTextTransformer(ClipTextConfig(), **BF16)
    want, got = flax_shapes(tree), _shapes(mod)
    assert want == got
    assert sum(map(_numel, want.values())) == sum(p.numel() for p in mod.parameters())
    if model == "unet":
        assert sum(p.numel() for p in mod.parameters()) == 859_520_964


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


# -- kernel shape rules at the 512² call sites -----------------------------------


SWITCHES = ("SD_TPU_PALLAS_CONV", "SD_TPU_PALLAS_GN", "SD_TPU_PALLAS_XATTN",
            "SD_TPU_FLASH_PIPE")
ATTN_SWITCHES = ("SD_TPU_ATTN_IMPL", "SD_TPU_ATTN_HPACKED", "SD_TPU_ATTN_PACKED",
                 "SD_TPU_FLASH_BWD")
OPT_IN = {"SD_TPU_PALLAS_GN": "1", "SD_TPU_PALLAS_XATTN": "1", "SD_TPU_FLASH_PIPE": "1"}


@pytest.fixture
def tpu_gates(monkeypatch):
    """The JAX gates as they decide on a TPU at inference; the switches unset
    (their defaults) until a test sets them. Every decision of a port gate
    is checked against the JAX gate's and counted; `decisions.args` keeps
    the arguments of those that chose a kernel."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setitem(jattn._SHARD_CTX, "mesh", None)
    # every switch at its default until a test sets it
    # (`test_attention_switches_agree_with_the_tpu_gates` sets each value)
    for var in (*ATTN_SWITCHES, *SWITCHES):
        monkeypatch.delenv(var, raising=False)

    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}

    def jax_hpacked(sq, skv, heads, d, dtype):
        return jattn.hpacked_flash_ok(sq, skv, heads, d)

    def jax_packed(sq, skv, heads, d, dtype):
        return jattn.packed_flash_ok(sq, skv, heads, d)

    def jax_flash(q, k):
        s = lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jdt[t.dtype])
        return jattn._pallas_ok(s(q), s(k))

    def jax_geglu(n, c, inner, dtype):
        return jgeglu.geglu_wants_pallas(n, c, inner, jdt[dtype])

    def jax_conv(shape, c_in, c_out, dtype):
        return jconv.conv3x3_wants_pallas(tuple(shape), c_in, c_out, jdt[dtype])

    def jax_gn(shape, groups, dtype):
        return jgn.group_norm_wants_pallas(tuple(shape), groups, jdt[dtype])

    def jax_xattn(n, m, heads, d, c, dtype):
        return jxattn.crossattn_kv_wants_pallas(n, m, heads, d, c, jdt[dtype])

    def jax_pipelined(skv, d):
        # which forward kernel the JAX `flash_attention` builds (traced
        # abstractly, its Pallas call recorded); its choice reads no q length
        seen = []
        real = jfa.pl.pallas_call

        def spy(kernel, **kw):
            seen.append(kernel.func.__name__)
            return real(kernel, **kw)

        with monkeypatch.context() as m:
            m.setattr(jfa.pl, "pallas_call", spy)
            s = jax.ShapeDtypeStruct((1, skv, 1, d), jnp.bfloat16)
            jax.eval_shape(lambda q, k, v: jfa.flash_attention(q, k, v), s, s, s)
        return seen == ["_flash_kernel_pipelined"]

    decisions = Counter()
    decisions.args = []

    def record(module, name, jax_gate):
        port_gate = getattr(module, name)

        def gate(*args):
            mine = port_gate(*args)
            assert mine == jax_gate(*args), (name, args)
            decisions[name, mine] += 1
            if mine:
                decisions.args.append((name, args))
            return mine

        monkeypatch.setattr(module, name, gate)

    record(attn_k, "hpacked_flash_ok", jax_hpacked)
    record(attn_k, "packed_flash_ok", jax_packed)
    record(fa, "use_pallas_bwd", jfa._use_pallas_bwd)
    record(attn_k, "flash_ok", jax_flash)
    record(geglu_k, "geglu_wants_pallas", jax_geglu)
    record(conv_k, "conv3x3_wants_pallas", jax_conv)
    record(gn_k, "group_norm_wants_pallas", jax_gn)
    record(xattn_k, "crossattn_kv_wants_pallas", jax_xattn)
    record(fa, "flash_pipelined_ok", jax_pipelined)
    return decisions


GATES = ("hpacked_flash_ok", "flash_ok", "geglu_wants_pallas", "conv3x3_wants_pallas")
OPT_IN_GATES = ("group_norm_wants_pallas", "crossattn_kv_wants_pallas", "flash_pipelined_ok")


def _launched(decisions, gates=GATES):
    return {name: decisions[name, True] for name in gates}


def _walk_512(tpu_gates, batch, gates=GATES):
    """Kernel decisions of one CFG-batched UNet call and of one decode at
    512², on `meta` tensors."""
    unet = UNetModel(**UNET, **BF16)
    vae = AutoencoderKL(**VAE, **BF16)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    with torch.no_grad():
        # one UNet call of the CFG-batched sampler: [uncond; cond] → 2·batch
        unet(meta(2 * batch, 64, 64, 4), meta(2 * batch, dtype=torch.long),
             meta(2 * batch, 77, 768))
        per_step = _launched(tpu_gates, gates)
        tpu_gates.clear()
        img = vae.decode(meta(batch, 64, 64, 4))
        per_decode = _launched(tpu_gates, gates)
    assert img.shape == (batch, 512, 512, 3)
    return per_step, per_decode


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_shape_rules_agree_with_tpu_gates_on_the_512_path(tpu_gates, batch):
    per_step, per_decode = _walk_512(tpu_gates, batch)
    assert per_step == {"hpacked_flash_ok": 10, "flash_ok": 0,
                        "geglu_wants_pallas": 10, "conv3x3_wants_pallas": 0}
    assert per_decode == {"hpacked_flash_ok": 0, "flash_ok": 1,
                          "geglu_wants_pallas": 0, "conv3x3_wants_pallas": 18}
    steps = 50
    flash = steps * (per_step["hpacked_flash_ok"] + per_step["flash_ok"]) + per_decode["flash_ok"]
    assert (flash, steps * per_step["geglu_wants_pallas"],
            per_decode["conv3x3_wants_pallas"]) == (501, 500, 18)


def _spy_plans(monkeypatch) -> list:
    """The launch plans of every inference flash call, in order (made on
    every device: on `meta` tensors, what the card would launch)."""
    plans, plan = [], fa.launch_plan

    def spy(*args):
        plans.append(plan(*args))
        return plans[-1]

    monkeypatch.setattr(fa, "launch_plan", spy)
    return plans


def _plan_launches(plans, times: int = 1) -> Counter:
    """Launch counts of `plans` run `times` over: each under its counter and,
    where a Hopper kernel serves it, under its route's counter."""
    out = Counter()
    for p in plans:
        out[p.name] += times
        if p.route in fa.ROUTE_COUNTERS:
            out[fa.ROUTE_COUNTERS[p.route]] += times
    return +out


@pytest.mark.parametrize("hpacked", ["1", "0"])
def test_generate_flash_launches_take_their_routes(tpu_gates, monkeypatch, hpacked):
    """Every flash launch of one default `generate` (2 prompts, 512², 50
    steps: a UNet call at batch 4 per step, one decode), call by call: the
    500 head-packed launches at d = 40 and 80 go to the Hopper kernel
    (`flash_fwd_sm90`), the decoder's d = 512 launch to the wide kernel
    (`flash_fwd_wide`). With
    `SD_TPU_ATTN_HPACKED=0` the self-attentions take [B, S, H, D] through
    `dot_product_attention`: the 500 move to `flash_attention`, on the same
    Hopper route."""
    monkeypatch.setenv("SD_TPU_ATTN_HPACKED", hpacked)
    plans = _spy_plans(monkeypatch)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    with torch.no_grad():
        UNetModel(**UNET, **BF16)(meta(4, 64, 64, 4), meta(4, dtype=torch.long),
                                  meta(4, 77, 768))
        n_unet = len(plans)
        AutoencoderKL(**VAE, **BF16).decode(meta(2, 64, 64, 4))
    unet, decode = plans[:n_unet], plans[n_unet:]
    assert len(unet) == 10 and {(p.route, p.pipelined, p.pv_int8) for p in unet} == {
        ("sm90", False, False)}
    assert [(p.name, p.route) for p in decode] == [("flash_attention", "wide")]
    launches = _plan_launches(unet, 50) + _plan_launches(decode)
    if hpacked == "1":
        want = {k: v for k, v in chip_smoke.EXPECTED_LAUNCHES.items() if v and "flash" in k}
        assert dict(launches) == want == {"flash_attention_hpacked": 500, "flash_fwd_sm90": 500,
                                          "flash_attention": 1, "flash_fwd_wide": 1}
    else:
        assert dict(launches) == {"flash_attention": 501, "flash_fwd_sm90": 500,
                                  "flash_fwd_wide": 1}


def test_pipelined_switch_combination_reaches_the_pipe_kernel(tpu_gates, monkeypatch):
    """`SD_TPU_ATTN_HPACKED=0 SD_TPU_FLASH_PIPE=1 SD_TPU_PALLAS_GN=1`, the
    combination through which a model reaches the pipelined sweep at d ≤ 128
    (`chip_smoke.py`'s last switch combination): one serving UNet call (batch
    8, 512²) and one decode (batch 4) on `meta` tensors, call by call. The
    5 level-0 self-attentions (4096 tokens, d = 40: 4 of the TPU package's kv
    tiles) take the PIPE kernel (`flash_fwd_sm90_pipe`), the 5 at level 1
    (1024 tokens, d = 80: one tile) the serial Hopper kernel, the decoder's
    the wide kernel's pipelined sweep; none the template; the UNet's 57
    GroupNorms the Hopper GroupNorm. The gates agree with the JAX ones."""
    env, want, reports = next(c for c in chip_smoke.SWITCH_COMBINATIONS
                              if c[0].get("SD_TPU_ATTN_HPACKED") == "0")
    assert env == {"SD_TPU_ATTN_HPACKED": "0", "SD_TPU_FLASH_PIPE": "1", "SD_TPU_PALLAS_GN": "1"}
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    plans = _spy_plans(monkeypatch)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    gates = GATES + OPT_IN_GATES
    with torch.no_grad():
        UNetModel(**UNET, **BF16)(meta(8, 64, 64, 4), meta(8, dtype=torch.long),
                                  meta(8, 77, 768))
        n_unet = len(plans)
        unet = _launched(tpu_gates, gates)
        tpu_gates.clear()
        AutoencoderKL(**VAE, **BF16).decode(meta(4, 64, 64, 4))
        decode = _launched(tpu_gates, gates)
    assert [(p.name, p.route) for p in plans[:n_unet]] == (
        [("flash_attention_pipelined", "sm90_pipe")] * 2 + [("flash_attention", "sm90")] * 2
        + [("flash_attention", "sm90")] * 3 + [("flash_attention_pipelined", "sm90_pipe")] * 3)
    assert [(p.name, p.route) for p in plans[n_unet:]] == [("flash_attention_pipelined", "wide")]
    assert all(p.route != "template" for p in plans)
    launches = _plan_launches(plans) + Counter(
        group_norm=unet["group_norm_wants_pallas"], group_norm_sm90=unet["group_norm_wants_pallas"],
        geglu_ff=unet["geglu_wants_pallas"], geglu_sm90=unet["geglu_wants_pallas"],
        conv3x3_same=decode["conv3x3_wants_pallas"])
    assert unet["group_norm_wants_pallas"] == 57 and decode["group_norm_wants_pallas"] == 0
    assert unet["hpacked_flash_ok"] == 0 and unet["flash_ok"] == 10
    assert dict(launches) == {k: v for k, v in want.items() if v}
    assert reports == ("flash_fwd_sm90_pipe",) and want["flash_fwd_sm90_pipe"] == 5


# each value of the TPU package's attention switches (None: all at their defaults)
ATTN_SWITCH_VALUES = [(None, None), ("SD_TPU_ATTN_IMPL", "xla"), ("SD_TPU_ATTN_IMPL", "pallas"),
                      ("SD_TPU_ATTN_HPACKED", "0"), ("SD_TPU_ATTN_HPACKED", "1"),
                      ("SD_TPU_ATTN_PACKED", "1"), ("SD_TPU_ATTN_PACKED", "0"),
                      ("SD_TPU_FLASH_BWD", "chunked"), ("SD_TPU_FLASH_BWD", "pallas")]


def _jax_dot_route(q, kv_len: int, impl=None) -> str:
    """The path the JAX package's `dot_product_attention` takes for q
    [B, S, H, D] bf16 against kv_len keys (traced abstractly)."""
    seen = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jfa, "flash_attention", lambda q, *a, **kw: seen.append("flash") or q)
        m.setattr(jattn, "_xla_attention", lambda q, *a, **kw: seen.append("plain") or q)
        s = lambda n: jax.ShapeDtypeStruct((q.shape[0], n, *q.shape[2:]), jnp.bfloat16)
        jax.eval_shape(lambda q, k, v: jattn.dot_product_attention(q, k, v, impl=impl),
                       s(q.shape[1]), s(kv_len), s(kv_len))
    return seen[0]


@pytest.mark.parametrize("var,value", ATTN_SWITCH_VALUES)
def test_attention_switches_agree_with_the_tpu_gates(tpu_gates, monkeypatch, var, value):
    """Each value of `SD_TPU_ATTN_IMPL`, `SD_TPU_ATTN_HPACKED`,
    `SD_TPU_ATTN_PACKED` and `SD_TPU_FLASH_BWD`: the port's gates agree with
    the JAX gates on every decision (the fixture holds each), and the route
    each call takes (which wrapper, and so which launch counter, moves on
    `meta` tensors) is the one the JAX package's routing gives: a level-0
    self-attention at inference and in a training step (forward and
    backward), and `dot_product_attention` at a flash shape and at the
    77-token cross-attention shape, with and without `impl=`."""
    if var:
        monkeypatch.setenv(var, value)
    events = []
    plans = _spy_plans(monkeypatch)
    for module, name, tag in ((attn_k, "hpacked_flash_attention", "hpacked"),
                              (attn_k, "packed_flash_attention", "packed"),
                              (attn_k, "_xla_attention", "plain"),
                              (fa, "flash_attention_lse", "lse"), (fa, "flash_bwd_dq", "dq"),
                              (fa, "flash_bwd_dkv", "dkv")):
        def spied(*a, _fn=getattr(module, name), _tag=tag, **kw):
            events.append(_tag)
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, spied)

    def run(fn) -> list:
        events.clear()
        plans.clear()
        fn()
        return events + [f"{p.name}/{p.route}" for p in plans]

    def jax_expected(training: bool, n: int, h: int, d: int) -> list:
        # sd_tpu/nn/attention.py: head-packed, then packed, then the front end
        if jattn.hpacked_flash_ok(n, n, h, d):
            return ["hpacked", "flash_attention_hpacked/sm90"]
        flash = ["lse", "dq", "dkv"] if jfa._use_pallas_bwd() else ["flash_attention/sm90"]
        if not training:
            flash = ["flash_attention/sm90"]
        if jattn.packed_flash_ok(n, n, h, d):
            return ["packed", *flash]
        q = torch.empty(2, n, h, d, device="meta")
        return flash if _jax_dot_route(q, n) == "flash" else ["plain"]

    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    block = CrossAttention(320, None, 8, 40, **BF16)
    with torch.no_grad():
        got = run(lambda: block(meta(2, 4096, 320)))
    assert sorted(got) == sorted(jax_expected(False, 4096, 8, 40)), got
    x = meta(1, 4096, 320).requires_grad_()
    with conv_k.training_trace(), jconv.training_trace():
        got = run(lambda: block(x).float().sum().backward())
        want = jax_expected(True, 4096, 8, 40)
    assert sorted(got) == sorted(want), (got, want)

    q, ctx = meta(2, 4096, 8, 40), meta(2, 77, 8, 40)
    with torch.no_grad():
        for kv, impl in ((q, None), (ctx, None), (q, "xla"), (ctx, "pallas")):
            got = run(lambda: attn_k.dot_product_attention(q, kv, kv, impl=impl))
            jax_route = _jax_dot_route(q, kv.shape[1], impl)
            assert got == (["plain"] if jax_route == "plain" else ["flash_attention/sm90"]), (
                kv.shape, impl, got)
        # the dtype rule: fp32 keeps the plain path even when asked for the kernel
        f32 = torch.empty(2, 4096, 8, 40, device="meta")
        assert run(lambda: attn_k.dot_product_attention(f32, f32, f32, impl="pallas")) == ["plain"]
    want_impl = {"xla": ["plain"], "pallas": ["flash_attention/sm90"]}.get(
        os.environ.get("SD_TPU_ATTN_IMPL"))
    if want_impl:
        with torch.no_grad():
            assert run(lambda: attn_k.dot_product_attention(q, ctx, ctx)) == want_impl


def _generate_launches(per_step, per_decode, steps=50):
    """Kernel launches of one generate from the decisions of one UNet call
    and one decode (no gate holds in CLIP)."""
    both = lambda gate: steps * per_step[gate] + per_decode[gate]
    pipelined = both("flash_pipelined_ok")
    return {**{name: 0 for name in kernels.LAUNCHES},
            "flash_attention": both("flash_ok") - pipelined,
            "flash_attention_pipelined": pipelined,
            "flash_attention_hpacked": both("hpacked_flash_ok"),
            # every head-packed call of these paths is at d ≤ 128 and every
            # [B, S, H, D] call is the decoder's at d = 512, serial or
            # pipelined (the route tests check it call by call)
            "flash_fwd_sm90": both("hpacked_flash_ok"),
            "flash_fwd_wide": both("flash_ok"),
            "geglu_ff": both("geglu_wants_pallas"),
            "conv3x3_same": both("conv3x3_wants_pallas"),
            "group_norm": both("group_norm_wants_pallas"),
            "crossattn_kv": both("crossattn_kv_wants_pallas"),
            # every GEGLU, cross-attention and GroupNorm launch runs the Hopper kernel
            "geglu_sm90": both("geglu_wants_pallas"),
            "crossattn_sm90": both("crossattn_kv_wants_pallas"),
            "group_norm_sm90": both("group_norm_wants_pallas")}


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_optin_shape_rules_agree_with_tpu_gates_on_the_512_path(tpu_gates, monkeypatch,
                                                                  batch):
    """With the three opt-in switches set: of the UNet's 61 GroupNorms, all
    but the four up-path concat norms above 3 MB (1920 ch at level 1; 960,
    640, 640 ch at level 0) take the kernel, no decoder norm does (64²×512
    is already 4 MB); 15 of the 16 cross-attentions (not the mid block's
    64 tokens); the decoder's mid-block attention takes the pipelined sweep."""
    for var, val in OPT_IN.items():
        monkeypatch.setenv(var, val)
    per_step, per_decode = _walk_512(tpu_gates, batch, GATES + OPT_IN_GATES)
    assert per_step == {"hpacked_flash_ok": 10, "flash_ok": 0, "geglu_wants_pallas": 10,
                        "conv3x3_wants_pallas": 0, "group_norm_wants_pallas": 57,
                        "crossattn_kv_wants_pallas": 15, "flash_pipelined_ok": 0}
    assert per_decode == {"hpacked_flash_ok": 0, "flash_ok": 1, "geglu_wants_pallas": 0,
                          "conv3x3_wants_pallas": 18, "group_norm_wants_pallas": 0,
                          "crossattn_kv_wants_pallas": 0, "flash_pipelined_ok": 1}
    assert tpu_gates["group_norm_wants_pallas", False] == 30       # all the decoder's
    launches = _generate_launches(per_step, per_decode)
    assert launches == chip_smoke.EXPECTED_LAUNCHES_OPTIN
    assert {k: v for k, v in launches.items() if v} == {
        "flash_attention_pipelined": 1, "flash_attention_hpacked": 500, "flash_fwd_sm90": 500,
        "flash_fwd_wide": 1, "geglu_ff": 500, "conv3x3_same": 18, "group_norm": 2850,
        "crossattn_kv": 750, "geglu_sm90": 500, "crossattn_sm90": 750, "group_norm_sm90": 2850}


def test_optin_kernel_shapes_of_chip_smoke_are_the_generate_shapes(tpu_gates, monkeypatch):
    """`chip_smoke.py` holds the GroupNorm and cross-attention kernels at
    exactly the shapes one opt-in generate of 2 prompts gives them, and sums
    GroupNorm's time and bound over its launches at each shape."""
    for var, val in OPT_IN.items():
        monkeypatch.setenv(var, val)
    _walk_512(tpu_gates, 2, GATES + OPT_IN_GATES)
    gn_shapes, xattn_shapes = Counter(), set()
    for name, args in tpu_gates.args:
        if name == "group_norm_wants_pallas":
            shape = args[0]
            gn_shapes[shape[0], shape[1] * shape[2], shape[3]] += 50     # 50 UNet calls
        elif name == "crossattn_kv_wants_pallas":
            n, m, heads, d, c, _ = args
            xattn_shapes.add((4, n, m, heads, d, c))
    assert dict(gn_shapes) == dict(zip(chip_smoke.GN_SHAPES, chip_smoke.GN_LAUNCHES))
    assert sum(chip_smoke.GN_LAUNCHES) == chip_smoke.EXPECTED_LAUNCHES_OPTIN["group_norm"]
    assert xattn_shapes == set(chip_smoke.XATTN_SHAPES)


def test_optin_parity_launches_of_chip_smoke(tpu_gates, monkeypatch):
    """The launches `chip_smoke.py` requires of its opt-in parity runs: the
    UNet at latent 32², batch 2, and the decoder at latent 32²."""
    for var, val in OPT_IN.items():
        monkeypatch.setenv(var, val)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    gates = GATES + OPT_IN_GATES
    with torch.no_grad():
        UNetModel(**UNET, **BF16)(meta(2, 32, 32, 4), meta(2, dtype=torch.long),
                                  meta(2, 77, 768))
        unet = _generate_launches(_launched(tpu_gates, gates),
                                  dict.fromkeys(gates, 0), steps=1)
        tpu_gates.clear()
        AutoencoderKL(**VAE, **BF16).decode(meta(1, 32, 32, 4))
        decoder = _generate_launches(dict.fromkeys(gates, 0), _launched(tpu_gates, gates))
    assert {"unet": unet, "decoder": decoder} == chip_smoke.PARITY_OPTIN_LAUNCHES


SERVE_VARIANTS = {"SD_TPU_FLASH_EXP": "bf16", "SD_TPU_FLASH_PV": "int8"}


@pytest.mark.parametrize("pipe", ["0", "1"])
def test_served_generate_variant_launches(tpu_gates, monkeypatch, pipe):
    """The serving path at full width: a bucket-4 group of 30-step CFG
    requests (UNet batch 8, 512²) with `SD_TPU_FLASH_EXP=bf16
    SD_TPU_FLASH_PV=int8`, on `meta` tensors. The gates (held against the
    JAX ones) send the 10 self-attentions per UNet call to the head-packed
    kernel and the decoder's mid-block attention to the flash kernel; the
    switches reach both as the JAX package's attention reads them. 30
    "uniform" DDIM steps make 31 UNet calls in both packages, so 310
    head-packed launches of the bf16-exponential int8-PV variant and 1 of the
    [B, S, H, D] kernel. With `SD_TPU_FLASH_PIPE=1` the decoder's attention
    takes the pipelined sweep, keeps the bf16 exponential and drops int8."""
    for var, val in {**SERVE_VARIANTS, "SD_TPU_FLASH_PIPE": pipe}.items():
        monkeypatch.setenv(var, val)
    # what the JAX package's attention passes its kernels under these switches
    asked = {}
    s = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    with monkeypatch.context() as m:
        for name in ("flash_attention_hpacked", "flash_attention"):
            m.setattr(jfa, name, lambda *a, name=name, **kw: (asked.setdefault(name, kw), a[0])[1])
        jax.eval_shape(lambda q: jattn.hpacked_flash_attention(q, q, q, 8), s(8, 4096, 320))
        jax.eval_shape(lambda q: jattn.dot_product_attention(q, q, q), s(4, 4096, 1, 512))
    assert len(asked) == 2 and all((kw["softmax_dtype"], kw["pv_quant"]) == (jnp.bfloat16, "int8")
                                   for kw in asked.values())

    launches = Counter()
    real = {"hpacked": fa.flash_attention_hpacked, "flash": fa.flash_attention}

    def spy(kind):
        def run(*args, **kw):
            exp, pv = (kw["softmax_dtype"] == torch.bfloat16, kw["pv_quant"] == "int8")
            if kind == "hpacked":
                launches[fa.launch_name("flash_attention_hpacked", exp, pv)] += 1
            else:
                piped = fa.flash_pipelined_ok(args[1].shape[1], args[0].shape[3])
                launches[fa.launch_name("flash_attention_pipelined" if piped
                                        else "flash_attention", exp, pv and not piped)] += 1
            return real[kind](*args, **kw)
        return run

    monkeypatch.setattr(fa, "flash_attention_hpacked", spy("hpacked"))
    monkeypatch.setattr(fa, "flash_attention", spy("flash"))
    plans = _spy_plans(monkeypatch)
    per_step, per_decode = _walk_512(tpu_gates, 4)
    assert per_step["hpacked_flash_ok"] == 10 and per_decode["flash_ok"] == 1
    # the head-packed int8 PV on the Hopper kernel's int8-PV form, the
    # decoder's launch (int8 or pipelined) on the wide kernel, at the TPU
    # package's kv tile
    assert [p.route for p in plans] == ["sm90_pv8"] * 10 + ["wide"]
    assert {p.block_k for p in plans[:10]} == {1024} and plans[10].block_k == 512
    calls = len(jschedules.make_ddim_timesteps("uniform", chip_smoke.SERVE_STEPS, 1000))
    assert calls == chip_smoke.SERVE_UNET_CALLS == 31
    unet = {k: calls * v for k, v in launches.items() if "hpacked" in k}
    decoder = {k: v for k, v in launches.items() if "hpacked" not in k}
    want_decoder = ({"flash_attention_pipelined_exp_bf16": 1} if pipe == "1"
                    else {"flash_attention_exp_bf16_pv_int8": 1})
    assert {**unet, **decoder} == {"flash_attention_hpacked_exp_bf16_pv_int8": 310,
                                   **want_decoder}
    routed = _plan_launches(plans[:10], calls) + _plan_launches(plans[10:])
    assert dict(routed) == {**unet, **decoder, "flash_fwd_sm90_pv8": 310, "flash_fwd_wide": 1}
    assert chip_smoke.EXPECTED_SERVE_LAUNCHES == chip_smoke.launches_of(
        flash_attention_hpacked_exp_bf16_pv_int8=310, flash_fwd_sm90_pv8=310,
        flash_attention_exp_bf16_pv_int8=1, flash_fwd_wide=1, geglu_ff=310, geglu_sm90=310,
        conv3x3_same=18)
    if pipe == "0":
        assert chip_smoke.EXPECTED_SERVE_LAUNCHES == chip_smoke.launches_of(
            **routed, geglu_ff=310, geglu_sm90=310, conv3x3_same=18)


def test_conv_switch_agrees_with_the_tpu_gate(tpu_gates, monkeypatch):
    monkeypatch.setenv("SD_TPU_PALLAS_CONV", "0")
    meta = torch.empty(1, 64, 64, 4, dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        AutoencoderKL(**VAE, **BF16).decode(meta)
    assert tpu_gates["conv3x3_wants_pallas", True] == 0
    assert tpu_gates["conv3x3_wants_pallas", False] > 0


def _count_kernel_calls(monkeypatch) -> Counter:
    """Count the calls of every kernel wrapper (on `meta` tensors each runs
    its plain version, so a call is where a launch would be on the card),
    each training-forward call under the route counter of the source its
    shape rule (`fa.lse_route`) picks and, where `fa.lse_split` splits its kv
    sweep, under the combine launch's counter, and each dQ and dK/dV call
    under the route counter of the source `fa.bwd_route` picks, as the card
    counts them."""
    calls = Counter()
    for module, name in ((fa, "flash_attention_lse"), (fa, "flash_bwd_dq"),
                         (fa, "flash_bwd_dkv"), (fa, "flash_attention_hpacked"),
                         (fa, "_inference"), (geglu_k, "geglu_ff"), (conv_k, "conv3x3_same"),
                         (conv_k, "gn_silu_conv3x3"), (gn_k, "group_norm"),
                         (xattn_k, "crossattn_kv")):
        def counted(*args, _fn=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            if _name == "flash_attention_lse":
                (b, sq, h, d), skv = args[0].shape, args[1].shape[1]
                calls[fa.LSE_ROUTE_COUNTERS[fa.lse_route(d)]] += 1
                if fa.lse_split(b, sq, skv, h, d) > 1:
                    calls[fa.LSE_COMBINE_COUNTER] += 1
            if _name in ("flash_bwd_dq", "flash_bwd_dkv"):
                kind = _name[len("flash_bwd_"):]
                calls[fa.BWD_ROUTE_COUNTERS[kind, fa.bwd_route(args[0].shape[-1])]] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


def _training_step_launches(tpu_gates, monkeypatch):
    """One optimizer step of the training config on `meta` tensors: every
    gate agrees with JAX's as it decides inside a traced train step, and the
    kernel wrappers reached are the launches of one step on the card."""
    cfg = sd512_train_config()
    tc = cfg["train"]
    calls = _count_kernel_calls(monkeypatch)
    unet = UNetModel(**UNET, **BF16)
    vae = AutoencoderKL(**VAE, dtype=torch.float32, device="meta")
    ld = LatentDiffusion(
        process=DDPMProcess(DiffusionSchedule.create(**cfg["diffusion"]).to("meta")),
        unet_apply=remat_apply(unet, tc["remat"]), encode_fn=vae.encode,
        decode_fn=vae.decode)
    opt = train.float32_moments(train.ddpm_optimizer(tc["lr"], 1.0))
    state = train.init_train_state(dict(unet.named_parameters()), opt,
                                   tc["ema_decay"], num_timesteps=1000)
    step = train.make_diffusion_train_step(
        lambda b, g, logvar: ld.training_loss(b, g, logvar), opt,
        grad_accum=tc["grad_accum"])
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    B, px, lat = tc["batch_size"], tc["image_size"], cfg["latent"]["image_size"]
    batch = {"image": meta(B, px, px, 3), "txt_emb": meta(B, 77, 768),
             "t": meta(B, dtype=torch.long), "noise": meta(B, lat, lat, 4),
             "enc_noise": meta(B, lat, lat, 4)}
    with jconv.training_trace():      # the JAX gates inside a traced train step
        logs = step(state, batch)
    assert logs["loss"].shape == () and state.step == 1
    # per microbatch of one image: 10 self-attentions (levels 0 and 1) take
    # the flash rule in the forward and again in the remat recompute; GEGLU's
    # rule holds at the 5 level-0 blocks only (level 1 has 1024 < 2048
    # tokens) and its trainable form takes the plain path under grad;
    # nothing takes the head-packed kernel, the conv, GroupNorm or the fused
    # cross-attention, and no launch reaches the pipelined sweep
    passes = tc["grad_accum"] * 2
    assert _launched(tpu_gates, GATES + OPT_IN_GATES) == {
        "hpacked_flash_ok": 0, "flash_ok": passes * 10, "geglu_wants_pallas": passes * 5,
        "conv3x3_wants_pallas": 0, "group_norm_wants_pallas": 0,
        "crossattn_kv_wants_pallas": 0, "flash_pipelined_ok": 0}
    want = {k: v for k, v in chip_smoke.EXPECTED_TRAIN_LAUNCHES.items() if v}
    assert dict(calls) == want == {"flash_attention_lse": 80, "flash_lse_sm90": 80,
                                   "flash_bwd_dq": 40, "flash_bwd_dkv": 40,
                                   "flash_bwd_dq_sm90": 40, "flash_bwd_dkv_sm90": 40}


def test_training_step_gates_and_launches(tpu_gates, monkeypatch):
    _training_step_launches(tpu_gates, monkeypatch)


def test_training_step_with_the_optin_switches(tpu_gates, monkeypatch):
    """The opt-in switches do not reach training: the same 80 / 40 / 40
    launches and none of the opt-in kernels."""
    for var, val in OPT_IN.items():
        monkeypatch.setenv(var, val)
    _training_step_launches(tpu_gates, monkeypatch)
    assert tpu_gates["group_norm_wants_pallas", False] > 0
    assert tpu_gates["crossattn_kv_wants_pallas", False] > 0


@pytest.mark.parametrize("optin", [False, True])
def test_kl_vae_step_gates_and_launches(tpu_gates, monkeypatch, optin):
    """One full-width step of `kl_f8_256_train_config()` (256², batch 4)
    under the bf16 parameter policy, `disc_start` 0, on `meta` tensors: the
    codec's two mid-block attentions ([4, 1024, 1, 512] bf16) pass the flash
    gate, as the JAX gate decides inside a traced train step, and the step
    reaches 2 LSE forwards, 2 dQ and 2 dK/dV and no other kernel (one
    generator forward: no inference flash kernel), with or without the
    opt-in switches."""
    if optin:
        for var, val in OPT_IN.items():
            monkeypatch.setenv(var, val)
    cfg = kl_f8_256_train_config()
    tc, mp = cfg["train"], cfg["model"]["params"]
    calls = _count_kernel_calls(monkeypatch)
    vae = AutoencoderKL(**mp, **BF16)
    disc = NLayerDiscriminator(**cfg["discriminator"], **BF16)
    lpips = LPIPS(device="meta")
    lpips.requires_grad_(False)
    opt = train.float32_moments(gan_train.gan_adam(tc["lr"]))
    state = gan_train.init_gan_state(vae, disc, opt, opt, param_dtype=torch.bfloat16)
    B, px = tc["batch_size"], tc["image_size"]
    noise = torch.empty(B, px // 8, px // 8, mp["embed_dim"], device="meta")
    step = gan_train.make_kl_gan_train_step(
        lambda x, g: vae(x, noise), disc, lpips, opt, opt,
        GanLossConfig(**{**cfg["loss"], "disc_start": 0}))
    with jconv.training_trace():      # the JAX gates inside a traced train step
        logs = step(state, torch.empty(B, px, px, 3, device="meta"), None)
    assert logs["train/total_loss"].shape == () and logs["train/disc_factor"] == 1.0
    assert state.step == 1
    assert _launched(tpu_gates, GATES + OPT_IN_GATES) == {
        "hpacked_flash_ok": 0, "flash_ok": 2, "geglu_wants_pallas": 0,
        "conv3x3_wants_pallas": 0, "group_norm_wants_pallas": 0,
        "crossattn_kv_wants_pallas": 0, "flash_pipelined_ok": 0}
    assert [[(tuple(t.shape), t.dtype) for t in args]
            for name, args in tpu_gates.args if name == "flash_ok"] == [
        [((4, 1024, 1, 512), torch.bfloat16)] * 2] * 2
    want = {k: v for k, v in chip_smoke.EXPECTED_KLVAE_LAUNCHES.items() if v}
    assert dict(calls) == want == {"flash_attention_lse": 2, "flash_lse_wide": 2,
                                   "flash_lse_combine": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                                   "flash_bwd_dq_wide_sm90": 2, "flash_bwd_dkv_wide_sm90": 2}
    # d = 512 takes the wide backward: the d ≤ 128 route's counters stay at 0
    assert chip_smoke.EXPECTED_KLVAE_LAUNCHES["flash_bwd_dq_sm90"] == 0
    assert chip_smoke.EXPECTED_KLVAE_LAUNCHES["flash_bwd_dkv_sm90"] == 0


def test_vq_step_gates_and_launches(tpu_gates, monkeypatch):
    """One full-width step of `vq_128_train_config()` (128², batch 8) under
    the bf16 parameter policy, `disc_start` 0, on `meta` tensors: the
    codec's two mid-block attentions ([8, 1024, 1, 256] bf16: ch 64 × 4,
    32² tokens) pass the flash gate, and the step reaches 2 LSE forwards on
    the wide route (no kv split at batch 8), 2 dQ and 2 dK/dV on the wide
    backward and no other kernel."""
    cfg = vq_128_train_config()
    tc, mp = cfg["train"], cfg["model"]["params"]
    calls = _count_kernel_calls(monkeypatch)
    vq = VQModel(**mp, **BF16)
    disc = NLayerDiscriminator(**cfg["discriminator"], **BF16)
    lpips = LPIPS(device="meta")
    lpips.requires_grad_(False)
    opt = train.float32_moments(gan_train.gan_adam(tc["lr"]))
    state = gan_train.init_gan_state(vq, disc, opt, opt, param_dtype=torch.bfloat16)
    step = gan_train.make_vq_gan_train_step(
        lambda x, g, temp: vq(x, update=True, deterministic=False), disc, lpips, opt, opt,
        GanLossConfig(**{**cfg["loss"], "disc_start": 0}))
    B, px = tc["batch_size"], tc["image_size"]
    with jconv.training_trace():      # the JAX gates inside a traced train step
        logs = step(state, torch.empty(B, px, px, 3, device="meta"), None)
    assert logs["train/quant_loss"].shape == () and state.step == 1
    assert state.params_g["quantize.weight"].dtype == torch.bfloat16
    assert _launched(tpu_gates, GATES + OPT_IN_GATES) == {
        "hpacked_flash_ok": 0, "flash_ok": 2, "geglu_wants_pallas": 0,
        "conv3x3_wants_pallas": 0, "group_norm_wants_pallas": 0,
        "crossattn_kv_wants_pallas": 0, "flash_pipelined_ok": 0}
    assert [[(tuple(t.shape), t.dtype) for t in args]
            for name, args in tpu_gates.args if name == "flash_ok"] == [
        [((8, 1024, 1, 256), torch.bfloat16)] * 2] * 2
    want = {k: v for k, v in chip_smoke.EXPECTED_VQ_LAUNCHES.items() if v}
    assert dict(calls) == want == {"flash_attention_lse": 2, "flash_lse_wide": 2,
                                   "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                                   "flash_bwd_dq_wide_sm90": 2, "flash_bwd_dkv_wide_sm90": 2}
    assert fa.bwd_wide_split(256) == 1 and fa.lse_split(8, 1024, 1024, 1, 256) == 1


# -- the train_run phase: the KL run's eval, the LDM run's encodes, from_run ------------


def test_kl_run_eval_launches(tpu_gates, monkeypatch):
    """The KL run's eval (`train_kl_vae`'s reconstruction sampler) at full
    width under the bf16 policy: the fixed batch [4, 256², 3] (fp32 images)
    through the bf16 codec with a posterior sample, no grad, on `meta`
    tensors: its two mid-block attentions at [4, 1024, 1, 512] pass the
    inference flash gate (the wide route) and 20 of its 3×3 convs the conv
    gate, as the JAX gates decide; nothing else launches. With the run's 3
    steps that is the phase's KL-run count."""
    cfg = kl_f8_256_train_config()
    mp, tc = cfg["model"]["params"], cfg["train"]
    calls = _count_kernel_calls(monkeypatch)
    plans = _spy_plans(monkeypatch)
    vae = AutoencoderKL(**mp, **BF16)
    B, px = tc["batch_size"], tc["image_size"]
    with torch.no_grad():
        recon, _ = vae(torch.empty(B, px, px, 3, device="meta"),
                       torch.empty(B, px // 8, px // 8, mp["embed_dim"], device="meta"))
    assert recon.shape == (B, px, px, 3)
    assert _launched(tpu_gates, GATES + OPT_IN_GATES) == {
        "hpacked_flash_ok": 0, "flash_ok": 2, "geglu_wants_pallas": 0,
        "conv3x3_wants_pallas": 20, "group_norm_wants_pallas": 0,
        "crossattn_kv_wants_pallas": 0, "flash_pipelined_ok": 0}
    assert [[tuple(t.shape) for t in args] for name, args in tpu_gates.args
            if name == "flash_ok"] == [[(4, 1024, 1, 512)] * 2] * 2
    want = {k: v for k, v in chip_smoke.KL_RUN_EVAL_LAUNCHES.items() if v}
    got = {**{k: v for k, v in calls.items() if k != "_inference"},
           **_plan_launches(plans)}
    assert got == want == {"flash_attention": 2, "flash_fwd_wide": 2, "conv3x3_same": 20}
    run = {k: chip_smoke.TRAIN_RUN_KL_STEPS[1] * v + chip_smoke.KL_RUN_EVAL_LAUNCHES[k]
           for k, v in chip_smoke.EXPECTED_KLVAE_LAUNCHES.items()}
    assert {k: v for k, v in run.items() if v} == {
        "flash_attention_lse": 6, "flash_lse_wide": 6, "flash_lse_combine": 6,
        "flash_bwd_dq": 6, "flash_bwd_dkv": 6, "flash_bwd_dq_wide_sm90": 6,
        "flash_bwd_dkv_wide_sm90": 6, "flash_attention": 2, "flash_fwd_wide": 2,
        "conv3x3_same": 20}


@pytest.mark.parametrize("batch", [4, 1])
def test_ldm_run_first_stage_encodes_launch_nothing(tpu_gates, monkeypatch, batch):
    """The LDM run's first stage is fp32 (the KL run's bf16 weights cast up),
    so its encodes, the calibration batch's (4 images) and each microbatch's
    (1 image) at 512², pass no kernel gate: FIRST_STAGE_ENCODE_LAUNCHES."""
    cfg = sd512_train_config()
    calls = _count_kernel_calls(monkeypatch)
    vae = AutoencoderKL(**cfg["first_stage"]["params"], dtype=torch.float32, device="meta")
    px = cfg["train"]["image_size"]
    with torch.no_grad():
        post = vae.encode(torch.empty(batch, px, px, 3, device="meta"))
    assert tuple(post.mean.shape) == (batch, px // 8, px // 8, 4)
    assert not any(_launched(tpu_gates, GATES + OPT_IN_GATES).values())
    assert dict(calls) == {k: v for k, v in chip_smoke.FIRST_STAGE_ENCODE_LAUNCHES.items() if v}
    assert not any(chip_smoke.FIRST_STAGE_ENCODE_LAUNCHES.values())


def test_from_run_generate_launches(tpu_gates, monkeypatch, tmp_path):
    """`Text2ImagePipeline.from_run` of a full-width SD-v1 LDM run (its
    checkpoint and the first stage's read as `meta` trees) builds the
    modules `generate` walks: one CFG-batched UNet call of 2 prompts at 512²
    and one decode give EXPECTED_LAUNCHES over 50 steps."""
    from sd_tpu_torch.train import runners as port_runners

    cfg = sd512_train_config()
    cfg["first_stage"]["ckpt"] = str(tmp_path / "kl" / "ckpt")
    (tmp_path / "calibration.json").write_text('{"scale_factor": 0.9}')

    def meta_tree(module):
        return {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for n, p in module.named_parameters()}

    trees = {"kl": {"params_g": meta_tree(AutoencoderKL(**VAE, device="meta")),
                    "model_state": {}},
             "run": {"ema": {"shadow": meta_tree(UNetModel(**UNET, device="meta"))}}}
    monkeypatch.setattr(port_runners, "restore_tree", lambda d: trees["kl"])
    # generators live on the CPU: the meta tensors take no draw
    cpu_generator = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device=None: cpu_generator("cpu"))
    monkeypatch.setattr("sd_tpu_torch.train.checkpoint.restore_tree",
                        lambda d: trees["kl" if "kl" in str(d) else "run"])
    pipe = Text2ImagePipeline.from_run(cfg, str(tmp_path), device="meta")
    assert pipe.ld.scale_factor == 0.9 and pipe.dtype == torch.bfloat16
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    gates = GATES + OPT_IN_GATES
    with torch.no_grad():
        pipe.unet(meta(4, 64, 64, 4), meta(4, dtype=torch.long), meta(4, 77, 768))
        per_step = _launched(tpu_gates, gates)
        tpu_gates.clear()
        pipe.vae.decode(meta(2, 64, 64, 4))
        per_decode = _launched(tpu_gates, gates)
    assert _generate_launches(per_step, per_decode) == chip_smoke.EXPECTED_LAUNCHES


# -- the image_edit phase: the image-editing entry points at full width -----------------


def _ddim_calls(steps: int, strength: float | None = None) -> int:
    """UNet calls of a DDIM pass of `steps` steps on the SD schedule (the
    "uniform" striding's table length), or of img2img's decode from
    `strength` (t_start, as both packages' img2img take it)."""
    from sd_tpu_torch.core.schedules import DDIMSchedule

    n = DDIMSchedule.create(DiffusionSchedule.create(**CFG["diffusion"]), steps).num_steps
    return n if strength is None else max(1, min(int(strength * steps), steps))


def test_image_edit_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s image_edit launches, piece by piece on `meta`
    tensors with every gate checked against the JAX package's: a CFG UNet
    call (batch 4) at 64² and 128² and with ToMe + FreeU at 64², the
    inpainting model's UNet at 32², the KL-f8 encoder and decoder at each
    batch and size the entry points give them (the tiles at batch 18: a 3 ×
    3 grid of `_cover_stride`), the f4 codec's; each entry point's total
    from its UNet calls (the DDIM table, img2img's t_start) equals
    IMAGE_EDIT_LAUNCHES, and the encoder's alone ENCODER_512_LAUNCHES."""
    from sd_tpu_torch.core.config import inpaint_128_config

    calls = _count_kernel_calls(monkeypatch)
    plans = _spy_plans(monkeypatch)
    flash = {"_inference", "flash_attention_hpacked"}

    def piece(fn) -> Counter:
        before, n = Counter(calls), len(plans)
        with torch.no_grad():
            fn()
        got = Counter({k: v - before[k] for k, v in calls.items() if k not in flash})
        got["geglu_sm90"] = got["geglu_ff"]          # every GEGLU launch runs geglu_sm90.cu
        return +got + _plan_launches(plans[n:])

    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    unet, vae = UNetModel(**UNET, **BF16), AutoencoderKL(**VAE, **BF16)
    icfg = inpaint_128_config()
    iunet = UNetModel(**icfg["unet"]["params"], **BF16)
    ivae = AutoencoderKL(**icfg["first_stage"]["params"], **BF16)
    call = lambda net, hw, c: lambda: net(meta(4, hw, hw, c), meta(4, dtype=torch.long),
                                          meta(4, 16 if net is iunet else 77,
                                               64 if net is iunet else 768))
    f, size, big, tile = 8, chip_smoke.EDIT_SIZE, chip_smoke.EDIT_BIG, chip_smoke.EDIT_TILE
    stride = Text2ImagePipeline._cover_stride(tile, big, big, step=f)
    tiles = 2 * ((big - tile) // stride + 1) ** 2
    assert tiles == 18 and Text2ImagePipeline._cover_stride(tile // f, big // f,
                                                            big // f) == stride // f
    p = {"unet64": piece(call(unet, size // f, 4)), "unet128": piece(call(unet, big // f, 4)),
         "iunet": piece(call(iunet, chip_smoke.INPAINT_SIZE // 4, 7)),
         "enc": piece(lambda: vae.encode(meta(2, size, size, 3))),
         "enc_tiles": piece(lambda: vae.encode(meta(tiles, tile, tile, 3))),
         "enc_big": piece(lambda: vae.encode(meta(2, big, big, 3))),
         "dec": piece(lambda: vae.decode(meta(2, size // f, size // f, 4))),
         "dec_tiles": piece(lambda: vae.decode(meta(tiles, tile // f, tile // f, 4))),
         "dec_big": piece(lambda: vae.decode(meta(2, big // f, big // f, 4))),
         "ienc": piece(lambda: ivae.encode(meta(2, 128, 128, 3))),
         "idec": piece(lambda: ivae.decode(meta(2, 32, 32, 3)))}
    unet.set_options(**chip_smoke.TOME_FREEU)
    p["unet64_tome"] = piece(call(unet, size // f, 4))
    # the head-packed shapes: ToMe's merged sequences pass the gate
    hp = [args for name, args in tpu_gates.args if name == "hpacked_flash_ok"]
    assert {a[:2] for a in hp[-10:]} == {(2048, 2048), (512, 512)}
    assert {a[3] for a in hp} == {40, 80, 160}

    times = lambda n, c: Counter({k: n * v for k, v in c.items()})
    i2i, hires = _ddim_calls(chip_smoke.EDIT_STEPS, chip_smoke.EDIT_STRENGTH), _ddim_calls(
        chip_smoke.HIRES_STEPS[1], chip_smoke.HIRES_STRENGTH)
    big_i2i = _ddim_calls(chip_smoke.EDIT_BIG_STEPS, chip_smoke.EDIT_STRENGTH)
    steps, gen = _ddim_calls(chip_smoke.EDIT_STEPS), _ddim_calls(chip_smoke.EDIT_GENERATE_STEPS)
    assert (i2i, hires, big_i2i, steps, gen) == (15, 5, 6, 20, 10)
    derived = {
        "img2img": times(i2i, p["unet64"]) + p["enc"] + p["dec"],
        "inpaint": times(steps, p["unet64"]) + p["enc"] + p["dec"],
        "inpaint_128": times(steps, p["iunet"]) + p["ienc"] + p["idec"],
        "generate_tiled": times(_ddim_calls(chip_smoke.EDIT_BIG_STEPS), p["unet128"])
        + p["dec_tiles"],
        "img2img_tiled": times(big_i2i, p["unet128"]) + p["enc_tiles"] + p["dec_big"],
        "generate_hires": times(_ddim_calls(chip_smoke.HIRES_STEPS[0]), p["unet64"]) + p["dec"]
        + times(hires, p["unet128"]) + p["enc_big"] + p["dec_big"],
        "generate": times(gen, p["unet64"]) + p["dec"],
        "generate_tome_freeu": times(gen, p["unet64_tome"]) + p["dec"],
        "generate_ti": times(gen, p["unet64"]) + p["dec"]}
    want = {name: {k: v for k, v in counts.items() if v}
            for name, counts in chip_smoke.IMAGE_EDIT_LAUNCHES.items()}
    assert {name: dict(c) for name, c in derived.items()} == want
    assert dict(p["enc"]) == {k: v for k, v in chip_smoke.ENCODER_512_LAUNCHES.items() if v}
    assert not p["iunet"] and dict(p["ienc"]) == {"flash_attention": 1, "flash_fwd_wide": 1}


def test_launch_counters_are_chip_smokes_kernels():
    assert set(kernels.LAUNCHES) == set(chip_smoke.KERNELS)
    assert chip_smoke.ROUTE_COUNTER == fa.ROUTE_COUNTERS
    for want in (chip_smoke.EXPECTED_LAUNCHES, chip_smoke.EXPECTED_LAUNCHES_OPTIN,
                 chip_smoke.EXPECTED_TRAIN_LAUNCHES, chip_smoke.EXPECTED_KLVAE_LAUNCHES,
                 chip_smoke.EXPECTED_VQ_LAUNCHES, chip_smoke.KL_RUN_EVAL_LAUNCHES,
                 chip_smoke.FIRST_STAGE_ENCODE_LAUNCHES, chip_smoke.ENCODER_512_LAUNCHES,
                 *chip_smoke.IMAGE_EDIT_LAUNCHES.values()):
        assert set(want) == set(kernels.LAUNCHES)


def test_shape_rules_refuse_other_dtypes():
    assert not attn_k.hpacked_flash_ok(4096, 4096, 8, 40, torch.float32)
    assert not geglu_k.geglu_wants_pallas(16384, 320, 1280, torch.float32)
    assert not conv_k.conv3x3_wants_pallas((2, 512, 512, 128), 128, 128, torch.float32)


# -- guards -------------------------------------------------------------------------


# the serving path's modules, among those the import check walks
SERVING_MODULES = ("sd_tpu_torch.serve", "sd_tpu_torch.utils.prompt_weights",
                   "sd_tpu_torch.utils.watermark", "sd_tpu_torch.diffusion.dpm_solver",
                   "sd_tpu_torch.diffusion.unipc", "sd_tpu_torch.diffusion.plms",
                   "sd_tpu_torch.diffusion.k_samplers")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import sd_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(sd_tpu_torch.__path__, 'sd_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"assert set({SERVING_MODULES!r}) <= set(names), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sd_tpu', 'flax')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Text2ImagePipeline(CFG)
    tiny = dict(model_channels=32, channel_mult=(1,), attention_resolutions=(),
                num_heads=4, context_dim=32)
    for build in (lambda **kw: UNetModel(**tiny, **kw),
                  lambda **kw: AutoencoderKL(ch=32, ch_mult=(1,), **kw),
                  lambda **kw: ClipTextTransformer(ClipTextConfig(
                      vocab_size=10, hidden_size=8, num_layers=1, num_heads=2,
                      max_length=4), **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        assert next(build(device="cpu").parameters()).device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_sd_v1_config_is_the_yaml():
    with open(REPO / "configs" / "sd_txt2img.yaml") as f:
        assert sd_v1_config() == yaml.safe_load(f)


def test_sd512_train_config_is_the_yaml():
    with open(REPO / "configs" / "sd512_catdog.yaml") as f:
        want = yaml.safe_load(f)
    del want["first_stage"]["ckpt"]    # no trained first stage in the repository
    assert sd512_train_config() == want


def test_inpaint_128_config_is_the_yaml():
    from sd_tpu_torch.core.config import inpaint_128_config

    with open(REPO / "configs" / "inpaint_128_catdog.yaml") as f:
        want = yaml.safe_load(f)
    del want["first_stage"]["ckpt"]    # the trained KL-f4 run is not in the repository
    assert inpaint_128_config() == want


def test_kl_f8_256_train_config_is_the_yaml():
    with open(REPO / "configs" / "kl_f8_256_catdog.yaml") as f:
        assert kl_f8_256_train_config() == yaml.safe_load(f)


def test_trainer_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ldm(sd512_train_config(), [])


def test_chip_smoke_refuses_to_run_outside_the_repository(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
