"""The ported samplers against the JAX package's, fp32 on the CPU.

Each sampler runs 4–6 steps of the same deterministic model function (a
linear map of the latent and the conditioning, with a timestep-dependent
term) from the same x_T, with classifier-free guidance; the stochastic
ones (dpm_sde, euler_a, ddpm, DDIM with eta > 0) are fed the JAX package's
own draws through the port's `noise(index, shape)` hook. Tolerance:
max|Δ| ≤ 1e-4·max(1, max|ref|) (`MODULE_TOL`).

Also: `apply_cfg` with `guidance_rescale`, the Karras and trailing
timestep stridings, and `LatentDiffusion.sample`'s dispatch and errors,
the consistency (lcm) sampler on an ε-model among them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import MODULE_TOL, assert_close, nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core import schedules as jsched
from sd_tpu.diffusion import ddim as jddim, ddpm as jddpm, dpm_solver as jdpm
from sd_tpu.diffusion import guidance as jguid, k_samplers as jk, plms as jplms
from sd_tpu.diffusion import unipc as junipc
from sd_tpu_torch.core import schedules as sched
from sd_tpu_torch.diffusion import ddim, ddpm, dpm_solver, guidance, k_samplers, plms, unipc
from sd_tpu_torch.diffusion.latent import LatentDiffusion

SHAPE = (2, 4, 4, 3)
STEPS = 5


def jax_model(x, t, c):
    w = (t.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1, 1)
    return 0.3 * x + (0.5 - w) * c + 0.1 * jnp.sin(x)


def torch_model(x, t, c):
    w = (t.float() / 1000.0).reshape(-1, 1, 1, 1)
    return 0.3 * x + (0.5 - w) * c + 0.1 * torch.sin(x)


@pytest.fixture(scope="module")
def data():
    x_T = nprand(*SHAPE, seed=1)
    cond, uncond = nprand(2, 1, 1, 3, seed=2), nprand(2, 1, 1, 3, seed=3)
    return x_T, cond, uncond


def schedules(T: int = 1000):
    return (jsched.DiffusionSchedule.create(T, "linear", 0.00085, 0.012),
            sched.DiffusionSchedule.create(T, "linear", 0.00085, 0.012))


# the JAX samplers' draws, each compiled once
_normal = jax.jit(lambda key: jax.random.normal(key, SHAPE, jnp.float32))
_fold_in_normal = jax.jit(lambda key, i: jax.random.normal(jax.random.fold_in(key, i), SHAPE))
_split2, _split3 = jax.jit(jax.random.split), jax.jit(lambda key: jax.random.split(key, 3))


def fold_in_noise(key):
    """The port's noise hook fed the JAX samplers' per-step draws,
    normal(fold_in(key, index))."""
    return lambda index, shape: to_torch(np.asarray(_fold_in_normal(key, index)))


def run_both(jsampler, tsampler, data, noise=None, guidance_scale=5.0, **kw):
    x_T, cond, uncond = data
    ref = jsampler.sample(jax_model, jax.random.PRNGKey(7), SHAPE, num_steps=STEPS,
                          cond=jnp.asarray(cond), uncond=jnp.asarray(uncond),
                          guidance_scale=guidance_scale, x_T=jnp.asarray(x_T), **kw)
    extra = {} if noise is None else {"noise": noise}
    got = tsampler.sample(torch_model, SHAPE, to_torch(x_T), num_steps=STEPS,
                          cond=to_torch(cond), uncond=to_torch(uncond),
                          guidance_scale=guidance_scale, **extra, **kw)
    assert_close(got, ref, MODULE_TOL)
    return got


@pytest.mark.parametrize("param", ["eps", "v", "x0"])
@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_ddim_matches(data, param, rescale):
    js, ts = schedules()
    run_both(jddim.DDIMSampler(js, parameterization=param),
             ddim.DDIMSampler(ts, parameterization=param), data, guidance_rescale=rescale)


def test_ddim_eta_draws_are_injectable(data):
    """eta > 0: the JAX sampler splits its key three ways per step and draws
    from the last; the port takes those draws by DDIM table index."""
    js, ts = schedules()
    key = _split2(jax.random.PRNGKey(7))[0]
    draws = {}
    for index in range(STEPS - 1, -1, -1):
        key, _, step = _split3(key)
        draws[index] = to_torch(np.asarray(_normal(step)))
    run_both(jddim.DDIMSampler(js), ddim.DDIMSampler(ts), data,
             noise=lambda index, shape: draws[index], eta=0.8)


@pytest.mark.parametrize("sde", [False, True])
@pytest.mark.parametrize("param", ["eps", "v"])
def test_dpm_solver_matches(data, sde, param):
    js, ts = schedules()
    steps_key = jax.random.split(jax.random.PRNGKey(7))[1]
    run_both(jdpm.DPMSolverSampler(js, parameterization=param, sde=sde),
             dpm_solver.DPMSolverSampler(ts, parameterization=param, sde=sde), data,
             noise=fold_in_noise(steps_key) if sde else None, guidance_rescale=0.5)


@pytest.mark.parametrize("method", ["uniform", "karras"])
@pytest.mark.parametrize("param", ["eps", "x0"])
def test_unipc_matches(data, method, param):
    js, ts = schedules()
    run_both(junipc.UniPCSampler(js, parameterization=param),
             unipc.UniPCSampler(ts, parameterization=param), data, method=method)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_plms_matches(data, param):
    js, ts = schedules()
    run_both(jplms.PLMSSampler(js, parameterization=param),
             plms.PLMSSampler(ts, parameterization=param), data, guidance_rescale=0.3)


@pytest.mark.parametrize("order", ["euler", "euler_a", "heun"])
@pytest.mark.parametrize("method", ["uniform", "trailing"])
def test_k_samplers_match(data, order, method):
    js, ts = schedules()
    noise_key = jax.random.split(jax.random.PRNGKey(7))[0]
    run_both(jk.KDiffusionSampler(js, order=order), k_samplers.KDiffusionSampler(ts, order=order),
             data, noise=fold_in_noise(noise_key) if order == "euler_a" else None,
             method=method)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_ddpm_ancestral_matches(data, param):
    """T = 6 ancestral steps (the sampler runs every DDPM step); the JAX
    loop splits its key once per step, in the order t = T-1 … 0."""
    T = 6
    js, ts = schedules(T)
    x_T, cond, _ = data
    key = _split2(jax.random.PRNGKey(7))[0]
    draws = {}
    for t in range(T - 1, -1, -1):
        key, step = _split2(key)
        draws[t] = to_torch(np.asarray(_normal(step)))
    ref = jddpm.DDPMProcess(js, parameterization=param).p_sample_loop(
        jax_model, jax.random.PRNGKey(7), SHAPE, jnp.asarray(cond), x_T=jnp.asarray(x_T))
    got = ddpm.DDPMProcess(ts, parameterization=param).p_sample_loop(
        torch_model, SHAPE, to_torch(x_T), to_torch(cond),
        noise=lambda t, shape: draws[t])
    assert_close(got, ref, MODULE_TOL)


def test_stochastic_samplers_draw_from_the_generator(data):
    """Without a noise hook, the same seed gives the same sample and another
    seed another one."""
    _, ts = schedules()
    x_T, cond, uncond = (to_torch(a) for a in data)

    def run(seed):
        return k_samplers.KDiffusionSampler(ts, order="euler_a").sample(
            torch_model, SHAPE, x_T, num_steps=STEPS, cond=cond, uncond=uncond,
            guidance_scale=5.0, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


@pytest.mark.parametrize("rescale", [0.0, 0.7, 1.0])
def test_apply_cfg_rescale_matches(rescale):
    u, c = nprand(3, 8, 8, 4, seed=4), nprand(3, 8, 8, 4, seed=5, scale=2.0)
    ref = jguid.apply_cfg(jnp.asarray(u), jnp.asarray(c), 7.5, rescale)
    got = guidance.apply_cfg(to_torch(u), to_torch(c), 7.5, rescale)
    assert_close(got, ref, MODULE_TOL)
    if rescale == 1.0:   # the per-sample std is pulled back to the conditional's
        np.testing.assert_allclose(got.std(dim=(1, 2, 3), unbiased=False).numpy(),
                                   c.reshape(3, -1).std(axis=1), rtol=1e-5)


@pytest.mark.parametrize("steps", [4, 10, 30])
def test_timestep_stridings_match(steps):
    js, _ = schedules()
    abar = np.asarray(js.alphas_cumprod, np.float64)
    np.testing.assert_array_equal(sched.make_karras_timesteps(abar, steps),
                                  jsched.make_karras_timesteps(abar, steps))
    for method in ("uniform", "quad", "trailing"):
        np.testing.assert_array_equal(sched.make_ddim_timesteps(method, steps, 1000),
                                      jsched.make_ddim_timesteps(method, steps, 1000))


def test_posterior_and_coordinate_changes_match():
    js, ts = schedules()
    x, o = nprand(*SHAPE, seed=8), nprand(*SHAPE, seed=9)
    t = np.array([3, 700])
    jx, jo, jt = jnp.asarray(x), jnp.asarray(o), jnp.asarray(t)
    tx, to_, tt = to_torch(x), to_torch(o), torch.from_numpy(t)
    for name in ("predict_start_from_noise", "predict_eps_from_start",
                 "predict_start_from_v", "predict_eps_from_v"):
        assert_close(getattr(ts, name)(tx, tt, to_), getattr(js, name)(jx, jt, jo), MODULE_TOL)
    for got, ref in zip(ts.q_posterior(to_, tx, tt), js.q_posterior(jo, jx, jt)):
        assert_close(got.expand(SHAPE), jnp.broadcast_to(ref, SHAPE), MODULE_TOL)


def _latent(param="eps") -> LatentDiffusion:
    _, ts = schedules()
    return LatentDiffusion(process=ddpm.DDPMProcess(ts, parameterization=param),
                           unet_apply=torch_model)


@pytest.mark.parametrize("sampler", ["ddim", "dpm", "dpm_sde", "unipc", "plms", "euler",
                                     "euler_a", "heun"])
def test_latent_sample_dispatches(data, sampler):
    """`LatentDiffusion.sample(sampler=…)` runs the named sampler with CFG
    and the rescale passed through."""
    x_T, cond, uncond = (to_torch(a) for a in data)
    ld = _latent()
    noise = lambda index, shape: torch.ones(shape)
    got = ld.sample(SHAPE, x_T, {"c_crossattn": [cond]}, {"c_crossattn": [uncond]},
                    guidance_scale=5.0, num_steps=STEPS, sampler=sampler,
                    guidance_rescale=0.5, noise=noise, decode=False)
    want = {"ddim": ddim.DDIMSampler, "dpm": dpm_solver.DPMSolverSampler,
            "dpm_sde": dpm_solver.DPMSolverSampler, "unipc": unipc.UniPCSampler,
            "plms": plms.PLMSSampler, "euler": k_samplers.KDiffusionSampler,
            "euler_a": k_samplers.KDiffusionSampler, "heun": k_samplers.KDiffusionSampler}
    kw = {"order": sampler} if "euler" in sampler or sampler == "heun" else {}
    if sampler.startswith("dpm"):
        kw = {"sde": sampler == "dpm_sde"}
    extra = {"noise": noise} if sampler in ("dpm_sde", "euler_a") else {}
    direct = want[sampler](ld.schedule, **kw).sample(
        ld.apply_model, SHAPE, x_T, num_steps=STEPS, cond={"c_crossattn": [cond]},
        uncond={"c_crossattn": [uncond]}, guidance_scale=5.0, guidance_rescale=0.5, **extra)
    assert torch.equal(got, direct)


def test_latent_sample_errors(data):
    """The same kinds of error as the JAX package: flow and lcm-with-CFG raise
    ValueError on an SD (ε) model (lcm without CFG runs:
    `test_latent_sample_lcm_matches_sd_tpu`), SAG with another sampler ValueError, and
    SAG without a probe apply (`unet_apply_probs`) ValueError; with one it
    runs, and is DDIM's SAG sample on the routed probe."""
    x_T, cond, uncond = (to_torch(a) for a in data)
    ld = _latent()
    args = (SHAPE, x_T, {"c_crossattn": [cond]}, {"c_crossattn": [uncond]})
    with pytest.raises(ValueError, match="FlowProcess"):
        ld.sample(*args, sampler="flow", decode=False)
    with pytest.raises(ValueError, match="no CFG branch"):
        ld.sample(*args, guidance_scale=5.0, sampler="lcm", decode=False)
    with pytest.raises(ValueError, match="only supported by the ddim"):
        ld.sample(*args, sampler="euler", sag_scale=0.5, decode=False)
    with pytest.raises(ValueError, match="unet_apply_probs"):
        ld.sample(*args, sampler="ddim", sag_scale=0.5, decode=False)
    mask = (torch.arange(SHAPE[1] * SHAPE[2]).reshape(1, SHAPE[1], SHAPE[2], 1) % 3 == 0).float()
    probes = lambda x, t, ctx: (torch_model(x, t, ctx), mask.expand(x.shape[0], -1, -1, -1))
    ld = dataclasses.replace(ld, unet_apply_probs=probes)
    got = ld.sample(*args, sampler="ddim", sag_scale=0.5, guidance_scale=5.0, decode=False)
    want = ddim.DDIMSampler(ld.schedule).sample(
        ld.apply_model, SHAPE, x_T, num_steps=50, cond={"c_crossattn": [cond]},
        uncond={"c_crossattn": [uncond]}, guidance_scale=5.0, sag_scale=0.5,
        sag_probs_fn=ld.model_probs_fn())
    assert torch.equal(got, want)


def test_latent_sample_lcm_matches_sd_tpu(data):
    """`LatentDiffusion.sample(sampler="lcm")` without CFG (guidance 1, the
    unconditional branch unused) on an ε-model against the JAX package's,
    4 consistency steps over 50 boundaries, each call's fresh noise replayed
    from the JAX key stream (the last call's drawn and unused)."""
    from sd_tpu.diffusion import latent as jlatent

    x_T, cond, uncond = data
    js, _ = schedules()
    jld = jlatent.LatentDiffusion(process=jddpm.DDPMProcess(js),
                                  unet_apply=lambda p, x, t, ctx, **kw: jax_model(x, t, ctx))
    rng = jax.random.PRNGKey(11)
    ref = jld.sample(None, rng, SHAPE, cond={"c_crossattn": [jnp.asarray(cond)]},
                     uncond={"c_crossattn": [jnp.asarray(uncond)]}, guidance_scale=1.0,
                     num_steps=4, sampler="lcm", decode=False, x_T=jnp.asarray(x_T))
    key, draws = _split2(rng)[0], []
    for _ in range(4):
        key, nkey = _split2(key)
        draws.append(to_torch(np.asarray(_normal(nkey))))
    got = _latent().sample(SHAPE, to_torch(x_T), {"c_crossattn": [to_torch(cond)]},
                           {"c_crossattn": [to_torch(uncond)]}, guidance_scale=1.0, num_steps=4,
                           sampler="lcm", noise=lambda k, shape: draws[k], decode=False)
    assert_close(got, ref, MODULE_TOL)


def test_pipeline_ddpm_generate_matches_sd_tpu():
    """`generate(sampler="ddpm")` at the pipeline level: the JAX pipeline's
    own process (built by `build_ldm`, x0 unclamped) against the port's
    pipeline, the same weights (every one random, `jax_pipeline`, carried by
    `load_flax_params`), fp32 on the CPU, a
    6-step schedule, x_T and every step's draw injected from the JAX key
    stream. x_T is N(0, 2²) and ᾱ stays near 1 over 6 steps, so the
    predicted x0 leaves [-1, 1] and a clamp would show."""
    from test_torch_helpers import SLICE_TOL, jax_pipeline, port_pipeline
    from test_torch_slice import PROMPTS, tiny_config

    cfg = tiny_config()
    cfg["diffusion"]["timesteps"] = T = 6
    jpipe = jax_pipeline(cfg, seed=3)
    assert not jpipe.ld.process.clip_denoised
    pipe = port_pipeline(cfg, jpipe)
    assert not pipe.ld.process.clip_denoised

    shape = (2, 16, 16, 4)
    x_T = nprand(*shape, seed=11, scale=2.0)
    c, _ = pipe.encode_prompts(PROMPTS)
    key = jax.random.PRNGKey(5)
    normal = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32))
    draws, k = {}, _split2(key)[0]
    for t in range(T - 1, -1, -1):
        k, step = _split2(k)
        draws[t] = to_torch(np.asarray(normal(step)))
    ref = jpipe.ld.sample(jpipe.unet_params, key, shape,
                          cond={"c_crossattn": [jnp.asarray(c.numpy())]},
                          sampler="ddpm", decode=True, x_T=jnp.asarray(x_T))
    got = pipe.sample(PROMPTS, to_torch(x_T), sampler="ddpm",
                      noise=lambda t, s: draws[t])
    assert_close(got, ref, SLICE_TOL)
