"""Structure and guard tests of the PyTorch port, all on the CPU:

* at full SD-v1 width every leaf of the JAX package's param trees maps onto
  the port's modules (built on the `meta` device, no compute), shape for
  shape, with equal parameter counts — the UNet, the whole KL tree
  (encoder, decoder, quant_conv, post_quant_conv) and CLIP;
* the port's kernel shape rules agree with the JAX package's TPU gates at
  every call site of the 512² text-to-image path (found by running the
  port's full-width UNet and decoder on `meta` tensors), which gives the
  launch counts of one 50-step generate: 501 flash, 500 GEGLU, 18 conv;
* the same at every call site of one full-width optimizer step of
  `configs/sd512_catdog.yaml` (KL encode, UNet forward, remat recompute and
  backward, 4 microbatches, on `meta` tensors) with the JAX gates in their
  training context; counting the kernel wrappers it reaches gives the
  training launch counts `chip_smoke.py` requires: 80 LSE forwards, 40 dQ,
  40 dK/dV and no other kernel per step;
* the port and `chip_smoke.py` import neither JAX nor the JAX package;
* the pipeline and the trainer refuse to run without a card unless asked
  for the CPU;
* `sd_v1_config()` is `configs/sd_txt2img.yaml` and `sd512_train_config()`
  is `configs/sd512_catdog.yaml` without the first-stage checkpoint.
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

from sd_tpu.kernels import attention as jattn
from sd_tpu.kernels import conv2d as jconv
from sd_tpu.kernels import geglu as jgeglu
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.clip_text import ClipTextConfig as JClipConfig
from sd_tpu.models.clip_text import ClipTextTransformer as JClip
from sd_tpu.models.unet_sd import UNetModel as JUNet
import chip_smoke
from sd_tpu_torch.core.config import sd512_train_config, sd_v1_config
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.kernels import flash_attention as fa
from sd_tpu_torch.kernels import attention as attn_k
from sd_tpu_torch.kernels import conv2d as conv_k
from sd_tpu_torch.kernels import geglu as geglu_k
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.clip_text import ClipTextConfig, ClipTextTransformer
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.train import diffusion as train
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


@pytest.fixture
def tpu_gates(monkeypatch):
    """The JAX gates as they decide on a TPU at inference."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setitem(jattn._SHARD_CTX, "mesh", None)
    for var in ("SD_TPU_ATTN_HPACKED", "SD_TPU_ATTN_IMPL", "SD_TPU_PALLAS_CONV"):
        monkeypatch.delenv(var, raising=False)

    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}

    def jax_hpacked(sq, skv, heads, d, dtype):
        return jattn.hpacked_flash_ok(sq, skv, heads, d)

    def jax_flash(q, k):
        s = lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jdt[t.dtype])
        return jattn._pallas_ok(s(q), s(k))

    def jax_geglu(n, c, inner, dtype):
        return jgeglu.geglu_wants_pallas(n, c, inner, jdt[dtype])

    def jax_conv(shape, c_in, c_out, dtype):
        return jconv.conv3x3_wants_pallas(tuple(shape), c_in, c_out, jdt[dtype])

    decisions = Counter()

    def record(module, name, jax_gate):
        port_gate = getattr(module, name)

        def gate(*args):
            mine = port_gate(*args)
            assert mine == jax_gate(*args), (name, args)
            decisions[name, mine] += 1
            return mine

        monkeypatch.setattr(module, name, gate)

    record(attn_k, "hpacked_flash_ok", jax_hpacked)
    record(attn_k, "flash_ok", jax_flash)
    record(geglu_k, "geglu_wants_pallas", jax_geglu)
    record(conv_k, "conv3x3_wants_pallas", jax_conv)
    return decisions


def _launched(decisions):
    return {name: decisions[name, True] for name in (
        "hpacked_flash_ok", "flash_ok", "geglu_wants_pallas", "conv3x3_wants_pallas")}


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_shape_rules_agree_with_tpu_gates_on_the_512_path(tpu_gates, batch):
    unet = UNetModel(**UNET, **BF16)
    vae = AutoencoderKL(**VAE, **BF16)
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    with torch.no_grad():
        # one UNet call of the CFG-batched sampler: [uncond; cond] → 2·batch
        unet(meta(2 * batch, 64, 64, 4), meta(2 * batch, dtype=torch.long),
             meta(2 * batch, 77, 768))
        per_step = _launched(tpu_gates)
        tpu_gates.clear()
        img = vae.decode(meta(batch, 64, 64, 4))
        per_decode = _launched(tpu_gates)
    assert img.shape == (batch, 512, 512, 3)
    assert per_step == {"hpacked_flash_ok": 10, "flash_ok": 0,
                        "geglu_wants_pallas": 10, "conv3x3_wants_pallas": 0}
    assert per_decode == {"hpacked_flash_ok": 0, "flash_ok": 1,
                          "geglu_wants_pallas": 0, "conv3x3_wants_pallas": 18}
    steps = 50
    flash = steps * (per_step["hpacked_flash_ok"] + per_step["flash_ok"]) + per_decode["flash_ok"]
    assert (flash, steps * per_step["geglu_wants_pallas"],
            per_decode["conv3x3_wants_pallas"]) == (501, 500, 18)


def test_training_step_gates_and_launches(tpu_gates, monkeypatch):
    """One optimizer step of the training config on `meta` tensors: every
    gate agrees with JAX's as it decides inside a traced train step, and the
    kernel wrappers reached are the launches of one step on the card."""
    cfg = sd512_train_config()
    tc = cfg["train"]
    calls = Counter()
    for module, name in ((fa, "flash_attention_lse"), (fa, "flash_bwd_dq"),
                         (fa, "flash_bwd_dkv"), (fa, "flash_attention_hpacked"),
                         (fa, "_launch"), (geglu_k, "geglu_ff"), (conv_k, "conv3x3_same")):
        def counted(*args, _fn=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)

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
    # nothing takes the head-packed kernel or the conv
    passes = tc["grad_accum"] * 2
    assert _launched(tpu_gates) == {"hpacked_flash_ok": 0, "flash_ok": passes * 10,
                                    "geglu_wants_pallas": passes * 5,
                                    "conv3x3_wants_pallas": 0}
    want = {k: v for k, v in chip_smoke.EXPECTED_TRAIN_LAUNCHES.items() if v}
    assert dict(calls) == want == {"flash_attention_lse": 80, "flash_bwd_dq": 40,
                                   "flash_bwd_dkv": 40}


def test_shape_rules_refuse_other_dtypes():
    assert not attn_k.hpacked_flash_ok(4096, 4096, 8, 40, torch.float32)
    assert not geglu_k.geglu_wants_pallas(16384, 320, 1280, torch.float32)
    assert not conv_k.conv3x3_wants_pallas((2, 512, 512, 128), 128, 128, torch.float32)


# -- guards -------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import sd_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(sd_tpu_torch.__path__, 'sd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
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
