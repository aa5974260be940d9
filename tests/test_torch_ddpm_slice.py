"""The pixel-space DDPM slice of the port (capability config #1) against the
JAX package, fp32 on the CPU at `configs/ddpm_smoke.yaml` widths (base 16,
(1, 2), attention at level 1, 16² images):

* `ResnetBlock` with the time-embedding input, and `UNetDDPM`'s forward,
  within 1e-4·max(1, max|ref|) (`MODULE_TOL`); its parameter tree at the
  full width of `configs/ddpm_256_catdog.yaml` (names and shapes) against
  `jax.eval_shape` of the JAX module; `conv_out` zero after `init_params_`;
* `cosine_annealing` and the runner's `make_lr` against the JAX schedule;
* one step of the runner's recipe (`make_ddpm_trainer`: p_losses, clip +
  Adam on the cosine lr, EMA) against `p_losses` + `ddpm_optimizer` +
  `make_diffusion_train_step` from the same weights, t and noise: loss and
  `grad_norm` within `MODULE_TOL`, the parameters and the EMA shadow after
  the step within ‖Δ‖₂ ≤ 1e-4·‖ref‖₂;
* `p_sample_loop` with `clip_denoised=True` over `UNetDDPM` for 4 steps,
  the JAX sampler's own draws injected;
* `train_ddpm` running two steps on the CPU, its config functions equal to
  their YAML files, and its refusals.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_helpers import (assert_close, flax_init, injected_dropout, nprand, port,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion.ddpm import DDPMProcess as JProcess
from sd_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from sd_tpu.nn.resnet import ResnetBlock as JResnetBlock
from sd_tpu.train import diffusion as jtrain
from sd_tpu.train import lr_schedules as jlr
from sd_tpu.train import runners as jrunners
from sd_tpu_torch.core.config import ddpm_256_train_config, ddpm_smoke_config
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.models.unet_ddpm import UNetDDPM
from sd_tpu_torch.nn.layers import dropout_rng
from sd_tpu_torch.nn.resnet import ResnetBlock
from sd_tpu_torch.train.lr_schedules import cosine_annealing
from sd_tpu_torch.train.runners import make_ddpm_trainer, make_lr, train_ddpm
from sd_tpu_torch.weights import flax_shapes, init_params_, load_flax_params

SMOKE = ddpm_smoke_config()
UNET = SMOKE["model"]["params"]
PX = SMOKE["train"]["image_size"]


@pytest.fixture(scope="module")
def unet_weights():
    x0 = jnp.zeros((1, PX, PX, 3))
    return flax_init(JUNetDDPM(**UNET), x0, jnp.zeros((1,), jnp.int32), seed=11)


def _port_unet(params) -> UNetDDPM:
    return port(UNetDDPM(**UNET, device="cpu"), params)


# -- modules ------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(32, 32), (16, 32)])
def test_resnet_block_with_temb_matches(cin, cout):
    x, temb = nprand(2, 8, 8, cin, seed=1), nprand(2, 64, seed=2)
    jb = JResnetBlock(out_channels=cout)
    params = flax_init(jb, jnp.asarray(x), jnp.asarray(temb), seed=3)
    ref = jb.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    tb = port(ResnetBlock(cin, cout, temb_channels=64, device="cpu"), params)
    assert_close(tb(to_torch(x), to_torch(temb)), ref)


def test_resnet_block_refuses_dropout_in_training():
    """(Named when the port refused dropout.) Dropout 0.1 in training: the
    TPU package's masked form inside a step's `dropout_rng` (both packages'
    masks injected), the deterministic form bit for bit outside it and in
    eval mode."""
    x, temb = nprand(2, 8, 8, 32, seed=1), nprand(2, 64, seed=2)
    jb = JResnetBlock(out_channels=32, dropout=0.1)
    params = flax_init(jb, jnp.asarray(x), jnp.asarray(temb), seed=3)
    block = port(ResnetBlock(32, temb_channels=64, dropout=0.1, device="cpu"), params).train()
    args = (to_torch(x), to_torch(temb))
    det = block(*args)
    assert_close(det, jb.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb)))
    with injected_dropout(block):
        ref = jb.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb),
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        with dropout_rng(torch.Generator().manual_seed(0)):
            assert_close(block(*args), ref, 1e-5)
            assert torch.equal(block.eval()(*args), det)
    assert not np.allclose(np.asarray(ref), det.numpy())


def test_unet_ddpm_matches(unet_weights):
    x, t = nprand(2, PX, PX, 3, seed=4), np.array([3, 41])
    ref = jax.jit(JUNetDDPM(**UNET).apply)({"params": unet_weights}, jnp.asarray(x),
                                           jnp.asarray(t))
    got = _port_unet(unet_weights)(to_torch(x), torch.from_numpy(t))
    assert_close(got, ref)


def test_unet_ddpm_tree_at_full_width():
    """The full-width tree, down the skip list's channel counts at every
    level, on `meta` tensors against the JAX module's shapes."""
    params = ddpm_256_train_config()["model"]["params"]
    shapes = jax.eval_shape(lambda: JUNetDDPM(**params).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,), jnp.int32)))
    mod = UNetDDPM(**params, device="meta")
    want = flax_shapes(shapes["params"])
    assert {n: tuple(p.shape) for n, p in mod.named_parameters()} == want
    assert want["up_3_res_0.conv1.weight"] == (256, 512 + 256, 3, 3)
    assert sum(math.prod(s) for s in want.values()) == sum(
        p.numel() for p in mod.parameters())


def test_init_keeps_conv_out_at_zero():
    model = UNetDDPM(**UNET, device="cpu")
    init_params_(model, torch.Generator().manual_seed(0))
    assert not model.conv_out.weight.any() and not model.conv_out.bias.any()
    assert model.conv_in.weight.any() and model.down_1_attn_0.q.weight.any()


# -- the lr schedule ------------------------------------------------------------------


def test_cosine_annealing_matches():
    total = 2000
    got, want = cosine_annealing(1e-4, total), jlr.cosine_annealing(1e-4, total)
    for step in (0, 1, total // 2, total, total + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert got(0) == pytest.approx(1e-4) and got(total) == got(total + 5) == 0.0


@pytest.mark.parametrize("tc", [{"lr": 3e-4, "lr_schedule": "cosine"},
                                {"lr": 3e-4, "lr_schedule": "cosine", "total_steps": 40}])
def test_make_lr_cosine_matches(tc):
    got, want = make_lr(tc), jrunners._make_lr(tc)
    for step in (0, 7, 20, 5000, 10000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        make_lr({"lr_schedule": "step"})


# -- one training step and the sampler ------------------------------------------------


def _ddpm_cfg():
    cfg = ddpm_smoke_config()
    cfg["train"]["lr_schedule"] = "cosine"      # the full-width recipe's schedule
    return cfg


def _step_batch():
    rng = np.random.default_rng(12)
    return {"image": rng.uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32),
            "t": np.array([5, 44]), "noise": nprand(2, PX, PX, 3, seed=13)}


def test_one_ddpm_step_matches(unet_weights):
    cfg, batch = _ddpm_cfg(), _step_batch()
    tc = cfg["train"]
    jmodel = JUNetDDPM(**UNET)
    process = JProcess(JSchedule.create(**cfg["diffusion"]), clip_denoised=True)

    def loss_fn(p, b, rng, logvar):
        return process.p_losses(lambda x, t, c: jmodel.apply({"params": p}, x, t),
                                b["image"], b["t"], b["noise"], learned_logvar=logvar)

    opt = jtrain.ddpm_optimizer(jrunners._make_lr(tc), tc["grad_clip"])
    jstate = jtrain.init_train_state(unet_weights, opt, tc["ema_decay"])
    jstep = jtrain.make_diffusion_train_step(loss_fn, opt)
    jstate, jlogs = jstep(jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))

    model = _port_unet(unet_weights)
    state, step = make_ddpm_trainer(cfg, model)
    logs = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "loss_simple", "loss_vlb", "grad_norm"):
        assert_close(logs[k], jlogs[k])
    assert float(logs["grad_norm"]) > tc["grad_clip"]      # the clip acted
    ref = UNetDDPM(**UNET, device="cpu")
    load_flax_params(ref, jax.tree.map(np.asarray, jstate.params))
    shadow = UNetDDPM(**UNET, device="cpu")
    load_flax_params(shadow, jax.tree.map(np.asarray, jstate.ema.shadow))
    ref, shadow = dict(ref.named_parameters()), dict(shadow.named_parameters())
    for got, want in ((state.params, ref), (state.ema.shadow, shadow)):
        d2 = sum(float(((got[n].detach() - want[n].detach()) ** 2).sum()) for n in want)
        n2 = sum(float((want[n].detach() ** 2).sum()) for n in want)
        assert math.sqrt(d2 / n2) <= 1e-4
    assert state.step == int(jstate.step) == 1
    assert state.ema.num_updates == int(jstate.ema.num_updates) == 1


def test_p_sample_loop_over_unet_ddpm_matches(unet_weights):
    """4 ancestral steps with the x0 clamp, the JAX loop's per-step draws
    (its key split once per step, t = T-1 … 0) fed to the port."""
    T, shape = 4, (2, PX, PX, 3)
    sched = dict(SMOKE["diffusion"], timesteps=T)
    x_T = nprand(*shape, seed=14, scale=1.5)
    jmodel = JUNetDDPM(**UNET)
    key, draws = jax.random.PRNGKey(7), {}
    key, _ = jax.random.split(key)                       # the loop's x_T key
    for t in range(T - 1, -1, -1):
        key, step_key = jax.random.split(key)
        draws[t] = to_torch(np.asarray(jax.random.normal(step_key, shape, jnp.float32)))
    ref = JProcess(JSchedule.create(**sched), clip_denoised=True).p_sample_loop(
        lambda x, t, c: jmodel.apply({"params": unet_weights}, x, t),
        jax.random.PRNGKey(7), shape, x_T=jnp.asarray(x_T))
    model = _port_unet(unet_weights)
    with torch.no_grad():
        got = DDPMProcess(DiffusionSchedule.create(**sched), clip_denoised=True).p_sample_loop(
            lambda x, t, c: model(x, t), shape, to_torch(x_T), noise=lambda t, s: draws[t])
    assert_close(got, ref)


# -- the runner ---------------------------------------------------------------------


def test_train_ddpm_runs_on_the_cpu():
    cfg = _ddpm_cfg()
    rng = np.random.default_rng(0)
    batches = [{"image": rng.uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)}
               for _ in range(3)]
    state, hist = train_ddpm(cfg, batches, max_steps=2, device="cpu")
    assert len(hist) == 2 and state.step == 2 and state.opt_state.count == 2
    assert all(math.isfinite(v) for row in hist for v in row.values())
    assert all(row["grad_norm"] > 0 for row in hist)
    assert state.params["conv_out.weight"].any()            # left zero
    assert state.ema.num_updates == 2 and state.ema.decay == cfg["train"]["ema_decay"]
    assert {p.dtype for p in state.params.values()} == {torch.float32}


def test_train_ddpm_refusals(monkeypatch):
    """(Named when `model.params.dtype` was refused.) A pinned bf16 compute
    dtype trains with fp32 parameters, Adam moments and EMA; without
    `device` and a card, `train_ddpm` refuses."""
    cfg = _ddpm_cfg()
    cfg["model"]["params"]["dtype"] = "bfloat16"
    images = [{"image": np.random.default_rng(0).uniform(-1, 1, (2, PX, PX, 3))
               .astype(np.float32)}]
    state, hist = train_ddpm(cfg, images, max_steps=1, device="cpu")
    assert math.isfinite(hist[0]["loss"]) and state.step == 1
    for tensors in (state.params.values(), state.ema.shadow.values(),
                    state.opt_state.mu, state.opt_state.nu):
        assert {t.dtype for t in tensors} == {torch.float32}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ddpm(ddpm_256_train_config(), [])


@pytest.mark.parametrize("fn,path", [(ddpm_256_train_config, "configs/ddpm_256_catdog.yaml"),
                                     (ddpm_smoke_config, "configs/ddpm_smoke.yaml")])
def test_config_functions_equal_their_yaml(fn, path):
    with open(Path(__file__).resolve().parents[1] / path) as f:
        assert fn() == yaml.safe_load(f)
