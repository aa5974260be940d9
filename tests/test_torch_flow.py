"""The rectified-flow objective and its samplers, and the schedule options
that came with them, against the JAX package on the CPU in fp32.

* `rescale_zero_terminal_snr`, `given_betas` and the v-only guard of
  `DiffusionSchedule.create`: the tables equal the JAX package's to 1e-7
  relative (the zero-SNR terminal step's infinite ε tables included);
* `FlowSchedule.q_sample`, `FlowProcess.p_losses` (uniform and
  logit-normal, shift 1 and 3), `FlowEulerSampler` (Euler and midpoint,
  with and without CFG) and `LatentDiffusion.sample`'s flow dispatch on a
  tiny UNet (in 4, 16 channels, one level with attention, 2 heads, a 16-wide
  context; latent 8²) carried across by `load_flax_params`: within
  1e-5·max(1, max|ref|) (`TOL`); the dispatch's errors are the JAX
  package's;
* `train/runners.py build_process`, shared by `build_ldm` and the
  pipeline, gives the JAX `build_ldm`'s process for a flow config and a
  zero-terminal-SNR one;
* a flow run on `flow_smoke_config()` through `python -m
  sd_tpu_torch.train --device cpu`, served through `from_run` with the
  default (flow) sampler of `python -m sd_tpu_torch.sample`.

The JAX samplers run their `lax.scan` as a Python loop (`scan_as_loop`:
the same steps) around one jitted UNet apply, which every test calls at 2
rows (2 samples, or 1 under CFG), so the reference compiles the UNet once.
"""

from __future__ import annotations

import contextlib
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import assert_close, flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core import schedules as jsched
from sd_tpu.diffusion import flow as jflow
from sd_tpu.diffusion import latent as jlatent
from sd_tpu.models import unet_sd as junet
from sd_tpu_torch.core import schedules as sched
from sd_tpu_torch.core.config import flow_smoke_config
from sd_tpu_torch.diffusion import flow
from sd_tpu_torch.diffusion.ddpm import DDPMProcess
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.train.runners import build_process

TOL = 1e-5
TINY_UNET = dict(in_channels=4, model_channels=16, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(), channel_mult=(1,), num_heads=2, context_dim=16)
# every UNet call sees 2 rows, so the JAX apply compiles once: 2 samples, or 1
# under CFG ([uncond; cond])
LATENT, CONTEXT = (2, 8, 8, 4), (2, 8, 16)
CFG_LATENT, CFG_CONTEXT = (1, 8, 8, 4), (1, 8, 16)


@functools.lru_cache(maxsize=None)
def tiny_unet(seed: int = 0):
    """(JAX params, the jitted JAX apply (p, x, t, ctx), the port's UNet with
    the same weights)."""
    unet = junet.UNetModel(**TINY_UNET)
    params = flax_init(unet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 8, 16)), seed=seed)
    japply = jax.jit(lambda p, x, t, c: unet.apply({"params": p}, x, t, c))
    return params, japply, port(UNetModel(**TINY_UNET, device="cpu"), params)


@contextlib.contextmanager
def scan_as_loop():
    """`jax.lax.scan` as the Python loop it stands for, so a sampler's body
    runs eagerly around the jitted model apply."""
    def loop(f, init, xs=None, length=None, **kw):
        n = length if xs is None else len(jax.tree.leaves(xs)[0])
        carry, ys = init, []
        for i in range(n):
            carry, y = f(carry, None if xs is None else jax.tree.map(lambda a: a[i], xs))
            ys.append(y)
        if ys and ys[0] is not None:
            return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)
        return carry, None

    with mock.patch.object(jax.lax, "scan", loop):
        yield


def models(seed: int = 0):
    """(JAX model_fn(x, t, ctx), the port's) of the tiny UNet."""
    params, japply, unet = tiny_unet(seed)
    return (lambda x, t, c: japply(params, x, t, c)), (lambda x, t, c: unet(x, t, c))


# -- schedules --------------------------------------------------------------------------


def test_zero_terminal_snr_rescale_matches():
    betas = sched.make_beta_schedule("linear", 1000, 0.00085, 0.012)
    got = sched.rescale_zero_terminal_snr(betas)
    np.testing.assert_allclose(got, jsched.rescale_zero_terminal_snr(betas), rtol=1e-7)
    assert got[-1] == 1.0                  # ᾱ_T = 0


@pytest.mark.parametrize("kw", [
    dict(parameterization="v", zero_terminal_snr=True),
    dict(parameterization="x0", zero_terminal_snr=True),
    dict(given_betas=np.linspace(1e-4, 2e-2, 40)),
    dict(given_betas=np.linspace(1e-4, 2e-2, 40), parameterization="v",
         zero_terminal_snr=True)])
def test_schedule_options_match(kw):
    """Every table of the port's schedule equals the JAX package's to 1e-7
    relative (infinities in place)."""
    args = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                linear_end=0.012, **kw)
    got, ref = sched.DiffusionSchedule.create(**args), jsched.DiffusionSchedule.create(**args)
    assert got.num_timesteps == ref.num_timesteps
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                  "posterior_log_variance_clipped", "posterior_mean_coef1",
                  "posterior_mean_coef2", "lvlb_weights"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-7, err_msg=field)


def test_zero_terminal_snr_needs_v_or_x0():
    for create in (sched.DiffusionSchedule.create, jsched.DiffusionSchedule.create):
        with pytest.raises(ValueError, match="requires parameterization='v'"):
            create(zero_terminal_snr=True)


# -- the flow objective -----------------------------------------------------------------


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_q_sample_and_times_match(shift):
    t = np.array([0, 7, 25, 49])
    x, n = nprand(4, 8, 8, 4, seed=1), nprand(4, 8, 8, 4, seed=2)
    js, ps = jflow.FlowSchedule(50, shift), flow.FlowSchedule(50, shift)
    np.testing.assert_array_equal(ps.t_cont(torch.from_numpy(t)).numpy(),
                                  np.asarray(js.t_cont(jnp.asarray(t))))
    got = ps.q_sample(to_torch(x), torch.from_numpy(t), to_torch(n))
    assert_close(got, js.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(n)), TOL)
    np.testing.assert_array_equal(got[0].numpy(), x[0])       # t = 0: the data
    np.testing.assert_array_equal(got[3].numpy(), n[3])       # t = T − 1: the noise


@pytest.mark.parametrize("density", ["uniform", "logit_normal"])
@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_p_losses_match(density, shift):
    """The velocity loss of the tiny UNet at t = 1 and 37 (interior lattice
    points, where the logit-normal weight is finite)."""
    jfn, tfn = models()
    x, n, c = nprand(*LATENT, seed=3), nprand(*LATENT, seed=4), nprand(*CONTEXT, seed=5)
    t = np.array([1, 37])
    kw = dict(timestep_density=density, logit_mean=0.3, logit_std=1.2)
    ref, rlogs = jflow.FlowProcess(jflow.FlowSchedule(50, shift), **kw).p_losses(
        jfn, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n), jnp.asarray(c))
    with torch.no_grad():
        got, logs = flow.FlowProcess(flow.FlowSchedule(50, shift), **kw).p_losses(
            tfn, to_torch(x), torch.from_numpy(t), to_torch(n), to_torch(c))
    assert_close(got, ref, TOL)
    assert set(logs) == set(rlogs)


@pytest.mark.parametrize("method", ["euler", "midpoint"])
@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_flow_sampler_matches(method, guidance):
    jfn, tfn = models()
    shape, ctx = (LATENT, CONTEXT) if guidance == 1.0 else (CFG_LATENT, CFG_CONTEXT)
    x_T, c, uc = nprand(*shape, seed=6), nprand(*ctx, seed=7), nprand(*ctx, seed=8)
    with scan_as_loop():
        ref = jflow.FlowEulerSampler(jflow.FlowSchedule(50, 3.0), method=method).sample(
            jfn, jax.random.PRNGKey(0), shape, num_steps=3, cond=jnp.asarray(c),
            uncond=jnp.asarray(uc), guidance_scale=guidance, x_T=jnp.asarray(x_T))
    with torch.no_grad():
        got = flow.FlowEulerSampler(flow.FlowSchedule(50, 3.0), method=method).sample(
            tfn, shape, to_torch(x_T), num_steps=3, cond=to_torch(c), uncond=to_torch(uc),
            guidance_scale=guidance)
    assert_close(got, ref, TOL)


def _latents(unet_apply, jax_apply=None):
    """(port LatentDiffusion, JAX LatentDiffusion) of a T = 50 flow model."""
    ld = LatentDiffusion(process=flow.FlowProcess(flow.FlowSchedule(50)), unet_apply=unet_apply)
    jld = jlatent.LatentDiffusion(process=jflow.FlowProcess(jflow.FlowSchedule(50)),
                                  unet_apply=jax_apply)
    return ld, jld


def test_latent_sample_defaults_to_flow_and_matches():
    """`sampler` omitted on a flow model is "flow" in both packages (CFG
    batched), and "flow_midpoint" takes the midpoint rule."""
    params, japply, unet = tiny_unet()
    ld, jld = _latents(unet, lambda p, x, t, ctx, y=None: japply(p, x, t, ctx))
    x_T = nprand(*CFG_LATENT, seed=9)
    c, uc = nprand(*CFG_CONTEXT, seed=10), nprand(*CFG_CONTEXT, seed=11)
    cond, uncond = {"c_crossattn": [to_torch(c)]}, {"c_crossattn": [to_torch(uc)]}
    with scan_as_loop():
        ref = jld.sample(params, jax.random.PRNGKey(0), CFG_LATENT,
                         cond={"c_crossattn": [jnp.asarray(c)]},
                         uncond={"c_crossattn": [jnp.asarray(uc)]}, guidance_scale=4.0,
                         num_steps=2, decode=False, x_T=jnp.asarray(x_T))
    with torch.no_grad():
        got = ld.sample(CFG_LATENT, to_torch(x_T), cond, uncond, guidance_scale=4.0,
                        num_steps=2, guidance_rescale=0.7, decode=False)
        mid = ld.sample(CFG_LATENT, to_torch(x_T), cond, uncond, guidance_scale=4.0,
                        num_steps=2, sampler="flow_midpoint", decode=False)
        want_mid = flow.FlowEulerSampler(ld.schedule, "midpoint").sample(
            ld.apply_model, CFG_LATENT, to_torch(x_T), num_steps=2, cond=cond, uncond=uncond,
            guidance_scale=4.0)
    assert_close(got, ref, TOL)
    assert torch.equal(mid, want_mid)


@pytest.mark.parametrize("kw,msg", [
    (dict(sampler="ddim"), "needs sampler='flow' or 'flow_midpoint'"),
    (dict(sampler="lcm"), "needs sampler='flow' or 'flow_midpoint'"),
    (dict(sag_scale=0.5), "only supported by the ddim sampler")])
def test_flow_model_refuses_what_the_jax_package_refuses(kw, msg):
    ld, jld = _latents(lambda x, t, ctx: x, lambda p, x, t, ctx, y=None: x)
    x = torch.zeros(LATENT)
    with pytest.raises(ValueError, match=msg):
        ld.sample(LATENT, x, {"c_crossattn": [torch.zeros(CONTEXT)]}, decode=False, **kw)
    with pytest.raises(ValueError, match=msg):
        jld.sample({}, jax.random.PRNGKey(0), LATENT, decode=False, x_T=jnp.zeros(LATENT), **kw)


def test_flow_sampler_needs_a_flow_model():
    ld = LatentDiffusion(process=DDPMProcess(sched.DiffusionSchedule.create(50)),
                         unet_apply=lambda x, t, ctx: x)
    for sampler in ("flow", "flow_midpoint"):
        with pytest.raises(ValueError, match="needs a FlowProcess model"):
            ld.sample(LATENT, torch.zeros(LATENT), {"c_crossattn": [torch.zeros(CONTEXT)]},
                      sampler=sampler, decode=False)


# -- build_process ------------------------------------------------------------------------


def test_build_process_gives_the_jax_packages_processes():
    """`build_process` (shared by `build_ldm` and `Text2ImagePipeline`)
    gives the process the JAX `build_ldm` gives: a flow config's
    FlowProcess, field for field, and a zero-terminal-SNR v-model's DDPM
    schedule."""
    from test_torch_helpers import jax_pipeline

    from sd_tpu_torch.pipeline import Text2ImagePipeline

    cfg = flow_smoke_config()
    ref = jax_pipeline(cfg).ld.process
    got = build_process(cfg)
    assert isinstance(got, flow.FlowProcess) and got.schedule == flow.FlowSchedule(
        ref.schedule.num_timesteps, ref.schedule.shift)
    for field in ("parameterization", "timestep_density", "logit_mean", "logit_std"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ref.loss_type == "l2" and ref.is_flow         # the port's only loss
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    assert pipe.ld.process == got

    diff = {"timesteps": 100, "beta_schedule": "linear", "linear_start": 0.00085,
            "linear_end": 0.012, "parameterization": "v", "zero_terminal_snr": True}
    proc = build_process({"diffusion": diff})
    want = jsched.DiffusionSchedule.create(**diff)
    assert isinstance(proc, DDPMProcess) and proc.parameterization == "v"
    assert not proc.clip_denoised
    np.testing.assert_allclose(proc.schedule.alphas_cumprod.numpy(),
                               np.asarray(want.alphas_cumprod), rtol=1e-7)
    assert float(proc.schedule.alphas_cumprod[-1]) == 0.0


# -- a flow run ---------------------------------------------------------------------------


def test_flow_run_trains_and_serves(tmp_path, capsys):
    """`python -m sd_tpu_torch.train` on flow_smoke_config() (2 steps, CPU),
    then `from_run` with the flow sampler and `python -m
    sd_tpu_torch.sample`, whose default for a flow model is flow."""
    from sd_tpu_torch import sample
    from sd_tpu_torch.data.image_io import decode_png, write_png
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.train.__main__ import main

    rng = np.random.default_rng(0)
    (tmp_path / "data").mkdir()
    for i in range(2):
        write_png(str(tmp_path / "data" / f"cat_{i}.png"),
                  rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    cfg = flow_smoke_config()
    cfg["train"].update(total_steps=2, checkpoint_every=2)
    (tmp_path / "flow.json").write_text(json.dumps(cfg))
    run = tmp_path / "run"
    assert main(["--config", str(tmp_path / "flow.json"), "--data", str(tmp_path / "data"),
                 "--out", str(run), "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
    pipe = Text2ImagePipeline.from_run(str(tmp_path / "flow.json"), str(run), device="cpu",
                                       param_dtype=torch.float32)
    assert isinstance(pipe.ld.process, flow.FlowProcess)
    img = pipe.generate(["a cat", "a dog"], num_steps=3, sampler="flow", guidance_scale=2.0)
    assert img.shape == (2, 32, 32, 3) and img.std() > 0
    with pytest.raises(ValueError, match="flow-matching model"):
        pipe.generate(["a cat"], num_steps=3)          # generate's default is ddim
    out = tmp_path / "grid.png"
    assert sample.main(["--config", str(tmp_path / "flow.json"), "--ckpt", str(run / "ckpt"),
                        "--prompt", "a cat", "--out", str(out), "--device", "cpu"]) == 0
    assert "sampler=flow" in capsys.readouterr().out
    assert decode_png(out.read_bytes()).shape == (32, 32, 3)
