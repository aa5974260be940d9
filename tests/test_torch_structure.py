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
* the port (the serving and super-resolution modules included) and
  `chip_smoke.py` import neither JAX nor the JAX package;
* the pipeline and the trainer refuse to run without a card unless asked
  for the CPU;
* `sd_v1_config()` is `configs/sd_txt2img.yaml`, `sd512_train_config()`
  is `configs/sd512_catdog.yaml` without the first-stage checkpoint and
  `kl_f8_256_train_config()` is `configs/kl_f8_256_catdog.yaml`; the few-step
  configs are theirs;
* the pieces of a consistency-distillation step and of the few-step
  samplers at full width on `meta` tensors give the launches
  `chip_smoke.py`'s few_step phase requires;
* the model families at full width: the param trees of LDM-KL-8-G's BERT and
  UNet, the ADM ImageNet 256² UNet and the CompVis codec UNet map onto the
  port (shapes only), and their bf16 forwards on `meta` tensors give the
  launches of `chip_smoke.py`'s model_families phase;
* the GAN generator (`UNetGenerator`) and two codec heads
  (`MergedRescaleDecoder` at the KL-f8 widths, `FirstStagePostProcessor`)
  map onto the port at full width; one full-width `train_ddpm` step of
  `ddpm_256_train_config()` under `model.params.dtype: bfloat16` (256²,
  batch 6, on `meta` tensors, the JAX gates in their training context)
  gives the launches of `chip_smoke.py`'s training_options phase: its five
  level-3 attentions on the wide flash training kernels; one served SD-v1
  512² `generate` for each of its bench_serve phase's rows and buckets, and
  its eval_tools phase's heatmap forward (every cross-attention captured,
  the other attentions on their routes), give the launches those phases
  require;
* the parallel phase's per-rank launches: a data-parallel rank's step is the
  train cell's, and a full-width UNet split at model 2 (`shard_module_`)
  takes every kernel gate tp = 1 takes, default and opt-in.
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
from sd_tpu.models.autoencoder import VQModel as JVQModel
from sd_tpu.models.clip_text import ClipTextConfig as JClipConfig
from sd_tpu.models.clip_text import ClipTextTransformer as JClip
from sd_tpu.models import codec as jcodec
from sd_tpu.models.conditioners import BERTEmbedder as JBERTEmbedder
from sd_tpu.models.discriminator import UNetGenerator as JUNetGenerator
from sd_tpu.models.unet_compvis import UNetCompVis as JUNetCompVis
from sd_tpu.models.unet_sd import UNetModel as JUNet
import chip_smoke
from sd_tpu_torch.core.config import (adm_imagenet256_config, kl_f8_256_train_config,
                                     kl_f32_config, ldm_kl8g_txt2img_config,
                                     ldm_sr_catdog_config, sd512_train_config, sd_v1_config,
                                     vq_128_train_config, vq_gumbel_f8_config)
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
from sd_tpu_torch.models import codec
from sd_tpu_torch.models.conditioners import BERTEmbedder
from sd_tpu_torch.models.discriminator import NLayerDiscriminator, UNetGenerator
from sd_tpu_torch.models.lpips import LPIPS
from sd_tpu_torch.nn.attention import CrossAttention
from sd_tpu_torch.models.unet_compvis import UNetCompVis
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


def _tuples(params: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in params.items()}


@pytest.mark.parametrize("model", ["unet", "vae", "clip", "sr_unet", "kl_f32", "vq_gumbel_f8",
                                   "bert_1p4b", "ldm_kl8g_unet", "adm_imagenet256",
                                   "unet_compvis", "unet_generator", "merged_rescale_decoder",
                                   "post_processor"])
def test_full_width_param_trees_map_onto_the_port(model):
    if model == "unet_generator":
        # the GAN generator at its defaults (ngf 64, 6 residual blocks), 256²
        tree = _flax_tree(JUNetGenerator(), jnp.zeros((1, 256, 256, 3)))
        mod = UNetGenerator(**BF16)
    elif model == "merged_rescale_decoder":
        # a rescaler to KL-f8's z (4 × 4 channels) then its decoder, 32² → 256²
        kw = dict(z_channels=4, ch=128, ch_mult=(1, 2, 4, 4), resolution=256)
        tree = _flax_tree(jcodec.MergedRescaleDecoder(**kw), jnp.zeros((1, 32, 32, 4)))
        mod = codec.MergedRescaleDecoder(**kw, **BF16)
    elif model == "post_processor":
        kw = dict(ch_mult=(1, 2), in_channels=4, proj_channels=128)
        tree = _flax_tree(jcodec.FirstStagePostProcessor(**kw), jnp.zeros((1, 32, 32, 4)))
        mod = codec.FirstStagePostProcessor(**kw, **BF16)
    elif model == "bert_1p4b":
        # LDM-KL-8-G's text conditioner: 32 layers, 1280 wide, vocab 30522
        params = ldm_kl8g_txt2img_config()["cond_stage"]["params"]
        tree = _flax_tree(JBERTEmbedder(**params), jnp.zeros((1, 77), jnp.int32))
        mod = BERTEmbedder(**params, **BF16)
    elif model in ("ldm_kl8g_unet", "adm_imagenet256"):
        # the SD-v1 UNet with a 1280-wide context; the ADM class-conditional UNet
        cfg = (ldm_kl8g_txt2img_config if model == "ldm_kl8g_unet" else adm_imagenet256_config)()
        params = cfg["unet"]["params"]
        if model == "ldm_kl8g_unet":
            args = (jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32),
                    jnp.zeros((1, 77, 1280)))
        else:
            args = (jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,), jnp.int32), None,
                    jnp.zeros((1,), jnp.int32))
        tree = _flax_tree(JUNet(**_tuples(params)), *args)
        mod = UNetModel(**params, **BF16)
    elif model == "unet_compvis":
        # the CompVis codec UNet at its defaults (ch 128 × (1, 2, 4, 8), 256²)
        tree = _flax_tree(JUNetCompVis(), jnp.zeros((1, 256, 256, 3)),
                          jnp.zeros((1,), jnp.int32))
        mod = UNetCompVis(**BF16)
    elif model == "unet":
        tree = _flax_tree(JUNet(**UNET), jnp.zeros((1, 64, 64, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768)))
        mod = UNetModel(**UNET, **BF16)
    elif model == "vae":
        tree = _flax_tree(JAutoencoderKL(**VAE), jnp.zeros((1, 512, 512, 3)))
        mod = AutoencoderKL(**VAE, **BF16)
    elif model == "sr_unet":
        # ldm_sr_catdog's UNet without spatial transformers: SelfAttentionBlock2D at 16², 8²
        sr_unet = ldm_sr_catdog_config()["unet"]["params"]
        tree = _flax_tree(JUNet(**_tuples(sr_unet)), jnp.zeros((1, 32, 32, 6)),
                          jnp.zeros((1,), jnp.int32), None)
        mod = UNetModel(**sr_unet, **BF16)
    elif model in ("kl_f32", "vq_gumbel_f8"):
        # per-level attention: AttnBlock_k at 16² and 8² (kl_f32), 32² (vq_gumbel_f8)
        cfg = (kl_f32_config if model == "kl_f32" else vq_gumbel_f8_config)()
        jcls, cls = ((JAutoencoderKL, AutoencoderKL) if model == "kl_f32"
                     else (JVQModel, VQModel))
        tree = _flax_tree(jcls(**_tuples(cfg["model"]["params"])), jnp.zeros((1, 256, 256, 3)))
        mod = cls(**cfg["model"]["params"], **BF16)
        assert sum(".AttnBlock_" in n for n in _shapes(mod)) > 2 * 8
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


# the JAX `flash_attention`'s kernel choice by (skv, d, SD_TPU_* switches)
_PIPELINED: dict = {}


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
        # abstractly, its Pallas call recorded); its choice reads no q length,
        # only (skv, d) and the switches, so each answer is traced once
        key = (skv, d, tuple(sorted((k, v) for k, v in os.environ.items()
                                    if k.startswith("SD_TPU_"))))
        if key not in _PIPELINED:
            _PIPELINED[key] = trace_pipelined(skv, d)
        return _PIPELINED[key]

    def trace_pipelined(skv, d):
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


def test_adapter_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s adapters launches, piece by piece on `meta` tensors
    with every gate checked against the JAX package's: a CFG UNet call
    (batch 4) at 64² plain, with the ControlNet branch in front of it (its
    level-0 and level-1 transformers: 4 head-packed and 4 GEGLU launches),
    as SAG's probe (the mid-block attention, 64 tokens, on the probe path:
    no kernel) and as its degraded pass (batch 2: the same 10 and 10), and
    with an IP-Adapter payload (the cross-attentions' image read takes no
    kernel); the decoder at 512². Each entry point's total over
    ADAPTER_STEPS DDIM steps equals ADAPTER_LAUNCHES."""
    from sd_tpu_torch.diffusion.sag import make_probs_apply
    from sd_tpu_torch.models.controlnet import controlled_apply_fn, controlnet_from_unet_config
    from sd_tpu_torch.models.ip_adapter import init_ip_adapter, ip_apply_fn

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
    cn = controlnet_from_unet_config(UNET, hint_downsamples=3, **BF16)
    ip = init_ip_adapter(unet, torch.Generator())
    ip["proj"] = {k: v.to("meta") for k, v in ip["proj"].items()}
    size, f = chip_smoke.EDIT_SIZE, 8
    args = lambda b: (meta(b, size // f, size // f, 4), meta(b, dtype=torch.long),
                      meta(b, 77, 768))
    probes = make_probs_apply(unet)
    p = {"unet": piece(lambda: unet(*args(4))),
         "controlled": piece(lambda: controlled_apply_fn(unet, cn)(
             *args(4), control=meta(4, size, size, 3, dtype=torch.float32))),
         "probe": piece(lambda: probes(*args(4))),
         "degraded": piece(lambda: unet(*args(2))),
         "ip": piece(lambda: ip_apply_fn(unet, ip)(*args(4), ip_embed=meta(4, 512))),
         "dec": piece(lambda: vae.decode(meta(2, size // f, size // f, 4)))}
    assert p["probe"] == p["unet"] == p["ip"] == p["degraded"]
    times = lambda n, c: Counter({k: n * v for k, v in c.items()})
    steps = _ddim_calls(chip_smoke.ADAPTER_STEPS)
    assert steps == chip_smoke.ADAPTER_STEPS
    derived = {"generate": times(steps, p["unet"]) + p["dec"],
               "generate_lora": times(steps, p["unet"]) + p["dec"],
               "generate_controlnet": times(steps, p["controlled"]) + p["dec"],
               "generate_sag": times(steps, p["probe"] + p["degraded"]) + p["dec"],
               "generate_ip": times(steps, p["ip"]) + p["dec"]}
    want = {name: {k: v for k, v in counts.items() if v}
            for name, counts in chip_smoke.ADAPTER_LAUNCHES.items()}
    assert {name: dict(c) for name, c in derived.items()} == want
    branch = p["controlled"] - p["unet"]
    assert dict(branch) == {"flash_attention_hpacked": 4, "flash_fwd_sm90": 4, "geglu_ff": 4,
                            "geglu_sm90": 4}


def test_few_step_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s few_step launches, piece by piece on `meta` tensors
    with every gate checked against the JAX package's: an inference UNet
    call at the rows the phase gives it (the teacher's CFG pair of a
    microbatch-4 batch: 8; the samplers' 2 and 4, `EXPECTED_LAUNCHES`), the
    same 10 head-packed and 10 GEGLU launches; the target network's no-grad
    forward inside the training step (1 row, the JAX training context
    entered with the port's); the bf16 decoder and the fp32 first stage. A
    distillation step of batch 4 in 4 microbatches is the teacher's call and
    4 × (a target forward + a `train_ldm` microbatch's forward and backward,
    `test_training_step_gates_and_launches`); a `flow512_train_config()` step
    is `train_ldm`'s (the flow objective changes the loss's target, not the
    UNet's passes). Each entry point's total equals FEW_STEP_LAUNCHES."""
    from sd_tpu_torch.core.config import flow512_train_config, lcm512_distill_config
    from sd_tpu_torch.kernels import conv2d as port_conv
    from sd_tpu_torch.train import distill

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

    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    cfg = lcm512_distill_config()
    unet = UNetModel(**UNET, **BF16)
    args = lambda b: (meta(b, 64, 64, 4, dtype=torch.bfloat16), meta(b, dtype=torch.long),
                      {"c_crossattn": [meta(b, 77, 768)]})
    calls_by_rows = {b: piece(lambda: distill.unet_fn(unet, dict(unet.named_parameters()))(
        *args(b))) for b in (2, 8)}
    shadow = {n: torch.empty_like(p) for n, p in unet.named_parameters()}

    def target():
        with port_conv.training_trace(), jconv.training_trace():
            distill.unet_fn(unet, shadow)(*args(1))

    target_call = piece(target)
    decode = piece(lambda: AutoencoderKL(**VAE, **BF16).decode(meta(2, 64, 64, 4)))
    fp32_vae = AutoencoderKL(**VAE, dtype=torch.float32, device="meta")
    first_stage = (piece(lambda: fp32_vae.encode(meta(4, 512, 512, 3)))
                   + piece(lambda: fp32_vae.decode(meta(4, 64, 64, 4))))
    unet_call = calls_by_rows[2]
    assert calls_by_rows[8] == unet_call and not first_stage
    assert dict(target_call) == {"flash_attention": 10, "flash_fwd_sm90": 10, "geglu_ff": 5,
                                 "geglu_sm90": 5}

    times = lambda n, c: Counter({k: n * v for k, v in c.items()})
    accum = cfg["train"]["grad_accum"]
    train_step = Counter({k: v for k, v in chip_smoke.EXPECTED_TRAIN_LAUNCHES.items() if v})
    assert accum == sd512_train_config()["train"]["grad_accum"]
    assert flow512_train_config()["train"] == sd512_train_config()["train"]
    steps, flow_steps = chip_smoke.LCM_STEPS, chip_smoke.FLOW_STEPS
    assert steps == cfg["distill"]["sample_steps"]
    distill_step = unet_call + times(accum, target_call) + train_step
    derived = {"distill_step": distill_step,
               # LCM-LoRA runs the same module on merged weights of the same
               # shapes and dtype: the same launches
               "lora_step": distill_step,
               "distill_eval": times(steps, unet_call) + first_stage,
               "flow_step": train_step,
               "generate_lcm": times(steps, unet_call) + decode,
               "generate_flow": times(flow_steps, unet_call) + decode,
               "generate_flow_midpoint": times(2 * (flow_steps // 2), unet_call) + decode}
    want = {name: {k: v for k, v in counts.items() if v}
            for name, counts in chip_smoke.FEW_STEP_LAUNCHES.items()}
    assert {name: dict(c) for name, c in derived.items()} == want


def _fine_tune_piece(monkeypatch):
    """`piece(fn, grad)`: the launches `fn` makes (on `meta` tensors), the
    inference flash launches by their plans' routes."""
    calls = _count_kernel_calls(monkeypatch)
    plans = _spy_plans(monkeypatch)
    flash = {"_inference", "flash_attention_hpacked"}

    def piece(fn, grad=False) -> Counter:
        before, n = Counter(calls), len(plans)
        with torch.set_grad_enabled(grad):
            fn()
        got = Counter({k: v - before[k] for k, v in calls.items() if k not in flash})
        got["geglu_sm90"] = got["geglu_ff"]          # every GEGLU launch runs geglu_sm90.cu
        return +got + _plan_launches(plans[n:])

    return piece


def test_fine_tune_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s fine_tune launches of the bf16 branches and the
    served checks, piece by piece on `meta` tensors with every gate checked
    against the JAX package's. A training step (batch 4 as 4 microbatches
    of 1, remat "dots") is 4 × one microbatch's forward and backward, built
    as `ldm_branch` builds each: LoRA's merged kernels train every
    attention, as `train_ldm`'s UNet does
    (`test_training_step_gates_and_launches`), and so does the trainable
    text encoder (the UNet trains; the tower's 77-token attention takes no
    kernel); the ControlNet runs the frozen base encoder without a gradient
    (its 4 self-attentions take the inference flash kernel and its level-0
    GEGLUs the fused kernel, again in the remat recompute) and trains its
    own copy; IP-Adapter's first self-attention sits before the first image
    read (no gradient there). The served checks: `generate` (CFG, batch-4
    UNet calls), with the ControlNet branch, and the mask-conditioned
    `inpaint` (its UNet calls, the masked images' encode, the decode)."""
    import dataclasses

    from sd_tpu_torch.core.config import sd512_inpaint_train_config
    from sd_tpu_torch.models.controlnet import controlled_apply_fn, controlnet_from_unet_config
    from sd_tpu_torch.models.ip_adapter import flat_ip, init_ip_adapter, ip_apply_fn, nest_ip
    from sd_tpu_torch.train.lora import flat_lora, init_lora, merged_kernels, nest_lora
    from sd_tpu_torch.train.runners import params_apply

    piece = _fine_tune_piece(monkeypatch)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    on_meta = lambda tree: {k: torch.empty(v.shape, dtype=torch.bfloat16, device="meta",
                                           requires_grad=True) for k, v in tree.items()}
    cfg = sd512_train_config()
    unet = UNetModel(**UNET, **BF16).requires_grad_(False)
    vae = AutoencoderKL(**VAE, dtype=torch.float32, device="meta")
    ld = LatentDiffusion(
        process=DDPMProcess(DiffusionSchedule.create(**cfg["diffusion"]).to("meta")),
        unet_apply=unet, encode_fn=vae.encode, decode_fn=vae.decode)
    batch = {"image": meta(1, 512, 512, 3, dtype=torch.float32), "txt_emb": meta(1, 77, 768),
             "t": meta(1, dtype=torch.long), "noise": meta(1, 64, 64, 4),
             "enc_noise": meta(1, 64, 64, 4)}

    def microbatch(apply, extra=None):
        """One microbatch's loss and backward in the training context."""
        def run():
            with conv_k.training_trace(), jconv.training_trace():
                model = dataclasses.replace(ld, unet_apply=remat_apply(apply(), "dots"))
                model.training_loss({**batch, **(extra or {})})[0].backward()

        return piece(run, grad=True)

    lora = on_meta(flat_lora(init_lora(unet, 4, torch.Generator())))
    cn = controlnet_from_unet_config(UNET, hint_downsamples=3, **BF16).requires_grad_(True)
    ip = init_ip_adapter(unet, torch.Generator())
    ip = on_meta(flat_ip({"proj": ip["proj"], "layers": ip["layers"]}))
    per_mb = {
        "lora": microbatch(lambda: params_apply(unet, merged_kernels(unet, nest_lora(lora)))),
        "controlnet": microbatch(lambda: controlled_apply_fn(unet, cn),
                                 {"hint": meta(1, 512, 512, 3, dtype=torch.float32)}),
        "ip_adapter": microbatch(lambda: ip_apply_fn(unet, nest_ip(ip)),
                                 {"ip_embed": meta(1, 512)})}
    clip = ClipTextTransformer(ClipTextConfig(), **BF16)
    tower = piece(lambda: clip(meta(1, 77, dtype=torch.long)), grad=True)
    times = lambda n, c: Counter({k: n * v for k, v in c.items()})
    accum = cfg["train"]["grad_accum"]
    train_step = Counter({k: v for k, v in chip_smoke.EXPECTED_TRAIN_LAUNCHES.items() if v})
    assert times(accum, per_mb["lora"]) == train_step and not tower

    unet.requires_grad_(False)
    call = lambda: (meta(4, 64, 64, 4), meta(4, dtype=torch.long), meta(4, 77, 768))
    unet_call = piece(lambda: unet(*call()))
    controlled = piece(lambda: controlled_apply_fn(unet, cn)(
        *call(), control=meta(4, 512, 512, 3, dtype=torch.float32)))
    iunet = UNetModel(**sd512_inpaint_train_config()["unet"]["params"], **BF16)
    inpaint_call = piece(lambda: iunet(meta(4, 64, 64, 9), *call()[1:]))
    bvae = AutoencoderKL(**VAE, **BF16)
    dec = piece(lambda: bvae.decode(meta(2, 64, 64, 4)))
    enc = piece(lambda: bvae.encode(meta(2, 512, 512, 3)))
    steps = _ddim_calls(chip_smoke.FINE_TUNE_GENERATE_STEPS)
    assert steps == chip_smoke.FINE_TUNE_GENERATE_STEPS
    derived = {**{f"{name}_step": times(accum, c) for name, c in per_mb.items()},
               "cond_step": train_step + times(accum, tower),
               "fp32_step": Counter(),
               "generate": times(steps, unet_call) + dec,
               "generate_controlnet": times(steps, controlled) + dec,
               "inpaint_conditioned": times(steps, inpaint_call) + enc + dec}
    want = {name: {k: v for k, v in counts.items() if v}
            for name, counts in chip_smoke.FINE_TUNE_LAUNCHES.items()}
    assert {name: dict(c) for name, c in derived.items()} == want


def test_fine_tune_fp32_trainers_reach_no_kernel(monkeypatch):
    """Textual inversion, DreamBooth (its class images too) and inpainting
    train and sample in fp32 (`build_ldm` without a parameter dtype, as the
    TPU package's trainers call it): the UNet at 4 and 9 input channels, the
    text tower and the first stage reach no kernel (every port gate takes
    bf16 only; the JAX package's shape rules would say yes, so its gates
    are not consulted here), and a backward adds launches only through the
    flash autograd Function an fp32 forward never enters."""
    from sd_tpu_torch.core.config import sd512_inpaint_train_config

    piece = _fine_tune_piece(monkeypatch)
    fp32 = dict(dtype=torch.float32, device="meta")
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    t, ctx = meta(2, dtype=torch.long), meta(2, 77, 768)
    got = (piece(lambda: UNetModel(**UNET, **fp32)(meta(2, 64, 64, 4), t, ctx))
           + piece(lambda: UNetModel(**sd512_inpaint_train_config()["unet"]["params"], **fp32)(
               meta(2, 64, 64, 9), t, ctx))
           + piece(lambda: ClipTextTransformer(ClipTextConfig(), **fp32)(
               meta(2, 77, dtype=torch.long)))
           + piece(lambda: AutoencoderKL(**VAE, **fp32).encode(meta(1, 512, 512, 3)))
           + piece(lambda: AutoencoderKL(**VAE, **fp32).decode(meta(2, 64, 64, 4))))
    assert not got
    assert not chip_smoke.FINE_TUNE_LAUNCHES["fp32_step"] or not any(
        chip_smoke.FINE_TUNE_LAUNCHES["fp32_step"].values())


def test_model_family_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s model_families launches, piece by piece on `meta`
    tensors in bf16 with every gate checked against the JAX package's:
    LDM-KL-8-G's BERT over the two prompts and the two empty ones (its
    77-token attention is explicit, its 1280-wide FF fails the GEGLU rule:
    nothing), one CFG UNet call at the 32² latent (batch 4, context 1280)
    times the DDIM table's FAMILY_STEPS calls plus the 256² decode; the ADM
    UNet's forward at 256², batch 2, with labels."""
    piece = _fine_tune_piece(monkeypatch)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    ldm, adm = ldm_kl8g_txt2img_config(), adm_imagenet256_config()
    n = len(chip_smoke.FAMILY_PROMPTS)
    times = lambda k, c: Counter({name: k * v for name, v in c.items()})
    with torch.no_grad():
        bert = BERTEmbedder(**ldm["cond_stage"]["params"], **BF16)
        text = piece(lambda: bert(meta(n, 77, dtype=torch.long))) + piece(
            lambda: bert(meta(n, 77, dtype=torch.long)))
        unet = UNetModel(**ldm["unet"]["params"], **BF16)
        unet_call = piece(lambda: unet(meta(2 * n, 32, 32, 4), meta(2 * n, dtype=torch.long),
                                       meta(2 * n, 77, 1280)))
        dec = piece(lambda: AutoencoderKL(**ldm["first_stage"]["params"], **BF16).decode(
            meta(n, 32, 32, 4)))
        size = adm["image_size"]
        adm_unet = UNetModel(**adm["unet"]["params"], **BF16)
        adm_fwd = piece(lambda: adm_unet(meta(chip_smoke.ADM_BATCH, size, size, 3),
                                         meta(chip_smoke.ADM_BATCH, dtype=torch.long), None,
                                         meta(chip_smoke.ADM_BATCH, dtype=torch.long)))
    steps = _ddim_calls(chip_smoke.FAMILY_STEPS)
    assert steps == chip_smoke.FAMILY_STEPS
    derived = {"bert": text, "ldm_kl8g_generate": times(steps, unet_call) + dec,
               "adm_forward": adm_fwd}
    want = {name: {k: v for k, v in counts.items() if v}
            for name, counts in chip_smoke.MODEL_FAMILY_LAUNCHES.items()}
    assert {name: dict(c) for name, c in derived.items()} == want
    assert unet_call["flash_attention_hpacked"] == unet_call["geglu_ff"] > 0


def test_training_options_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s training_options launches: one `make_ddpm_trainer`
    step of `chip_smoke.training_options_config()` (`ddpm_256_train_config()`
    under `model.params.dtype: bfloat16`, dropout 0.1) at full width, 256²,
    batch 6, fp32 parameters, on `meta` tensors, with every gate checked
    against the JAX package's inside a traced train step: the 5 level-3
    AttnBlocks ([6, 1024, 1, 256]) pass the flash rule and reach the wide
    training kernels (LSE forward, dQ, dK/dV: no remat, one each), the 16²
    bottleneck's 256 tokens stay plain, no conv kernel in training; the run
    is one warm-up and TRAINING_OPTIONS_STEPS timed steps. (No dropout
    generator here: `meta` tensors have none, and dropout moves no gate.)"""
    from sd_tpu_torch.core.config import split_dtype
    from sd_tpu_torch.models.unet_ddpm import UNetDDPM
    from sd_tpu_torch.train.runners import make_ddpm_trainer

    calls = _count_kernel_calls(monkeypatch)
    cfg = chip_smoke.training_options_config()
    mp, compute = split_dtype(cfg["model"]["params"])
    assert compute == torch.bfloat16 and mp["dropout"] == chip_smoke.TRAINING_OPTIONS_DROPOUT
    model = UNetDDPM(**mp, compute_dtype=compute, device="meta")
    state, step = make_ddpm_trainer(cfg, model)
    B, px = cfg["train"]["batch_size"], cfg["train"]["image_size"]
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    with jconv.training_trace():      # the JAX gates inside a traced train step
        logs = step(state, {"image": meta(B, px, px, 3), "t": meta(B, dtype=torch.long),
                            "noise": meta(B, px, px, 3)})
    assert logs["loss"].shape == () and state.step == 1
    assert {p.dtype for p in state.params.values()} == {torch.float32}
    assert _launched(tpu_gates, GATES + OPT_IN_GATES) == {
        "hpacked_flash_ok": 0, "flash_ok": 5, "geglu_wants_pallas": 0,
        "conv3x3_wants_pallas": 0, "group_norm_wants_pallas": 0,
        "crossattn_kv_wants_pallas": 0, "flash_pipelined_ok": 0}
    assert [args[0].shape for name, args in tpu_gates.args if name == "flash_ok"] == [
        (B, 1024, 1, 256)] * 5
    runs = 1 + chip_smoke.TRAINING_OPTIONS_STEPS
    want = {k: v for k, v in chip_smoke.TRAINING_OPTIONS_LAUNCHES["ddpm_bf16_steps"].items()
            if v}
    assert {k: runs * v for k, v in calls.items()} == want == {
        k: runs * 5 for k in ("flash_attention_lse", "flash_lse_wide", "flash_bwd_dq",
                              "flash_bwd_dkv", "flash_bwd_dq_wide_sm90",
                              "flash_bwd_dkv_wide_sm90")}


def test_launch_counters_are_chip_smokes_kernels():
    assert set(kernels.LAUNCHES) == set(chip_smoke.KERNELS)
    assert chip_smoke.ROUTE_COUNTER == fa.ROUTE_COUNTERS
    for want in (chip_smoke.EXPECTED_LAUNCHES, chip_smoke.EXPECTED_LAUNCHES_OPTIN,
                 chip_smoke.EXPECTED_TRAIN_LAUNCHES, chip_smoke.EXPECTED_KLVAE_LAUNCHES,
                 chip_smoke.EXPECTED_VQ_LAUNCHES, chip_smoke.KL_RUN_EVAL_LAUNCHES,
                 chip_smoke.FIRST_STAGE_ENCODE_LAUNCHES, chip_smoke.ENCODER_512_LAUNCHES,
                 *chip_smoke.IMAGE_EDIT_LAUNCHES.values(), *chip_smoke.ADAPTER_LAUNCHES.values(),
                 *chip_smoke.FEW_STEP_LAUNCHES.values(),
                 *chip_smoke.FINE_TUNE_LAUNCHES.values(),
                 *chip_smoke.MODEL_FAMILY_LAUNCHES.values(),
                 *chip_smoke.TRAINING_OPTIONS_LAUNCHES.values()):
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
# ... and the super-resolution path's
SR_MODULES = ("sd_tpu_torch.train.sr", "sd_tpu_torch.sample_sr",
              "sd_tpu_torch.data.degradation", "sd_tpu_torch.data.datasets")
# ... and the model families'
FAMILY_MODULES = ("sd_tpu_torch.models.x_transformer", "sd_tpu_torch.models.unet_compvis",
                  "sd_tpu_torch.models.conditioners")
# ... and the training options' and the utilities'
OPTION_MODULES = ("sd_tpu_torch.diffusion.visualize", "sd_tpu_torch.models.codec",
                  "sd_tpu_torch.models.quantize", "sd_tpu_torch.models.discriminator",
                  "sd_tpu_torch.train.metrics", "sd_tpu_torch.train.lr_schedules",
                  "sd_tpu_torch.core.distributions", "sd_tpu_torch.nn.layers")
# ... and the evaluation and diagnostic tools' and the last two commands'
EVAL_MODULES = ("sd_tpu_torch.eval", "sd_tpu_torch.eval.fid", "sd_tpu_torch.eval.classifier",
                "sd_tpu_torch.utils.attn_viz", "sd_tpu_torch.utils.debug",
                "sd_tpu_torch.data.imagenet_utils", "sd_tpu_torch.bench_serve",
                "sd_tpu_torch.eval_steering")


def test_port_imports_neither_jax_nor_the_jax_package():
    ported = SERVING_MODULES + SR_MODULES + FAMILY_MODULES + OPTION_MODULES + EVAL_MODULES
    code = (
        "import pkgutil, sys, importlib\n"
        "import sd_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(sd_tpu_torch.__path__, 'sd_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"assert set({ported!r})"
        " <= set(names), names\n"
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


@pytest.mark.parametrize("name,drop", [("lcm_512_catdog", ("distill.teacher_run",
                                                             "first_stage.ckpt")),
                                       ("distill_smoke", ()), ("flow_smoke", ())])
def test_few_step_configs_are_the_yaml(name, drop):
    """`lcm512_distill_config()` is `configs/lcm_512_catdog.yaml` less what a
    run fills in (its teacher run, the trained first stage);
    `distill_smoke_config()` and `flow_smoke_config()` are their YAML;
    `flow512_train_config()` is the SD-v1 recipe with the flow smoke
    config's `diffusion:` block."""
    from sd_tpu_torch.core import config

    with open(REPO / "configs" / f"{name}.yaml") as f:
        want = yaml.safe_load(f)
    for key in drop:
        block, leaf = key.split(".")
        del want[block][leaf]
    fn = {"lcm_512_catdog": config.lcm512_distill_config,
          "distill_smoke": config.distill_smoke_config,
          "flow_smoke": config.flow_smoke_config}[name]
    assert fn() == want
    if name == "flow_smoke":
        assert config.flow512_train_config() == {**sd512_train_config(),
                                                 "diffusion": want["diffusion"]}


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


def test_bench_serve_and_attn_viz_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s bench_serve launches, piece by piece on `meta`
    tensors in bf16 with every gate checked against the JAX package's: one
    served generate at SD-v1's 512² for each row and bucket is its sampler's
    UNet calls (ddim50 cut to BENCH_SERVE_STEPS: the DDIM table's calls, each
    CFG call of 2·bucket rows; lcm4: 4 calls of bucket rows, no CFG) and one
    decode of the bucket; and the eval_tools phase's heatmap forward (2 rows,
    every cross-attention captured) keeps every other attention's route."""
    from sd_tpu_torch.utils import attn_viz

    piece = _fine_tune_piece(monkeypatch)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    times = lambda k, c: Counter({name: k * v for name, v in c.items()})
    unet = UNetModel(**UNET, **BF16)
    vae = AutoencoderKL(**VAE, **BF16)
    call = lambda rows: piece(lambda: unet(meta(rows, 64, 64, 4), meta(rows, dtype=torch.long),
                                           meta(rows, 77, 768)))
    calls = {"ddim50": _ddim_calls(chip_smoke.BENCH_SERVE_STEPS["ddim50"]),
             "lcm4": chip_smoke.BENCH_SERVE_STEPS["lcm4"]}
    derived = {}
    for b in chip_smoke.BENCH_SERVE_BUCKETS:
        decode = piece(lambda: vae.decode(meta(b, 64, 64, 4)))
        derived["ddim50", b] = times(calls["ddim50"], call(2 * b)) + decode
        derived["lcm4", b] = times(calls["lcm4"], call(b)) + decode
    want = {key: {k: v for k, v in counts.items() if v}
            for key, counts in chip_smoke.BENCH_SERVE_LAUNCHES.items()}
    assert {key: dict(c) for key, c in derived.items()} == want
    with torch.no_grad():
        maps = {}
        viz = piece(lambda: maps.update(attn_viz.cross_attention_maps(
            unet, meta(2, 64, 64, 4), meta(2, dtype=torch.long), meta(2, 77, 768))))
    assert len(maps) == chip_smoke.ATTN_VIZ_MAPS
    assert dict(viz) == {k: v for k, v in chip_smoke.ATTN_VIZ_LAUNCHES.items() if v}


def test_parallel_phase_launches(tpu_gates, monkeypatch):
    """`chip_smoke.py`'s parallel phase, each rank's launches, on `meta`
    tensors with every gate checked against the JAX package's. A rank of the
    data-parallel run (batch 8 as 4 microbatches over 2 ranks) trains 4
    microbatches of one row a step, the train cell's step
    (`test_training_step_gates_and_launches`); the world-1 runs train the
    cell's own. A tensor-parallel rank's full-width UNet, split at model 2
    by `shard_module_` (its attention at 4 of 8 heads, its feed-forwards at
    half the inner width; a stand-in axis sums nothing), takes every kernel
    tp = 1 takes at a 4-row call, under the default and the opt-in switches;
    its 10-step generate is 10 such calls and a decode of 2. A served
    request of one prompt is 10 calls of 2 rows and a decode of 1."""
    import types

    from sd_tpu_torch.parallel import mesh as pm

    steps = {"train_zero1_w1": chip_smoke.PARALLEL_W1_STEPS,
             "train_fsdp_w1": chip_smoke.PARALLEL_W1_STEPS,
             "train_dp2": chip_smoke.PARALLEL_DP_STEPS}
    per_step = {k: v for k, v in chip_smoke.EXPECTED_TRAIN_LAUNCHES.items() if v}
    for r in range(2):
        rows = pm.local_rows(chip_smoke.PARALLEL_DP_BATCH, sd512_train_config()["train"]
                             ["grad_accum"], r, 2)
        assert len(rows) == sd512_train_config()["train"]["batch_size"] == 4
    for run, n in steps.items():
        assert {k: v for k, v in chip_smoke.PARALLEL_LAUNCHES[run].items() if v} == {
            k: n * v for k, v in per_step.items()}

    axes = {"data": 1, "model": 2}
    mesh = types.SimpleNamespace(axes=lambda: dict(axes), size=lambda a: axes.get(a, 1),
                                 index=lambda a: 0, group=lambda a: None)
    monkeypatch.setattr(pm.ModelParallel, "enter", lambda self, x: x)
    monkeypatch.setattr(pm.ModelParallel, "reduce", lambda self, p, b: (
        p.float() + (0.0 if b is None else b.float())).to(p.dtype))
    piece = _fine_tune_piece(monkeypatch)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    times = lambda k, c: Counter({name: k * v for name, v in c.items()})
    whole = UNetModel(**UNET, **BF16)
    unet = UNetModel(**UNET, **BF16)
    split = pm.shard_module_(unet, mesh)
    assert len(split) == 32 * 4 + 16 * 3        # 32 attentions, 16 feed-forwards
    assert all(m.tp is not None for m in unet.modules() if isinstance(m, CrossAttention))
    vae = AutoencoderKL(**VAE, **BF16)
    call = lambda model, rows: piece(lambda: model(meta(rows, 64, 64, 4),
                                                  meta(rows, dtype=torch.long),
                                                  meta(rows, 77, 768)))
    want = lambda run: {k: v for k, v in chip_smoke.PARALLEL_LAUNCHES[run].items() if v}
    tp_call = call(unet, 4)
    assert dict(tp_call) == want("tp2_unet") == dict(call(whole, 4))
    for var, value in chip_smoke.OPT_IN.items():
        monkeypatch.setenv(var, value)
    optin = call(unet, 4)
    # every GroupNorm and fused cross-attention launch runs its Hopper source
    optin.update(group_norm_sm90=optin["group_norm"], crossattn_sm90=optin["crossattn_kv"])
    assert dict(optin) == want("tp2_unet_optin")
    for var in chip_smoke.OPT_IN:
        monkeypatch.delenv(var)
    steps_tp = _ddim_calls(chip_smoke.PARALLEL_TP_STEPS)
    decode = lambda b: piece(lambda: vae.decode(meta(b, 64, 64, 4)))
    assert dict(times(steps_tp, tp_call) + decode(2)) == want("tp2_generate")
    served = times(_ddim_calls(chip_smoke.PARALLEL_SERVE_STEPS), call(whole, 2)) + decode(1)
    assert dict(times(2, served)) == want("serve_shard_w1")
