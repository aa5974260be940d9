"""Consistency distillation and its sampler against the JAX package on the
CPU in fp32, and the distillation run.

* the EMA (the distillation's target network): fp32 and bf16 shadows, with
  and without the warm-up (`use_num_updates`), over 3 updates, bit for bit;
* `boundary_scalings` and `boundary_timesteps` exactly, the sampler's
  boundaries (the indices [50, 38, 25, 12, 0] of N = 50 at 4 steps:
  np.round takes 37.5 to the even 38), `pseudo_huber`;
* on the tiny UNet of `test_torch_flow.py` (weights carried across by
  `load_flax_params`, every draw injected from the JAX key streams):
  `consistency_fn`, `teacher_step` with CFG, `draw_pair`, `student_loss`
  and `sample` at 2 and 4 steps, within 1e-5·max(1, max|ref|) (`TOL`);
* (one distillation step against the JAX package's:
  `test_torch_distill_step.py`);
* `distill_smoke_config()` with a teacher the port's `train_ldm` trained for
  2 steps: a run broken after one step and resumed ends in the unbroken
  run's state bit for bit, `from_run` serves it with `lcm`; an LCM-LoRA run
  through `python -m sd_tpu_torch.train --device cpu` writes a
  `lora.safetensors` that loads through `load_lora`; a flow teacher and an
  uncalibrated one are refused as the JAX package refuses them.
"""

from __future__ import annotations

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flow import CFG_CONTEXT, CFG_LATENT, CONTEXT, LATENT, scan_as_loop, tiny_unet
from test_torch_helpers import assert_close, nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core import ema as jema
from sd_tpu.core import schedules as jsched
from sd_tpu.diffusion import consistency as jcons
from sd_tpu_torch.core import ema, schedules
from sd_tpu_torch.core.config import distill_smoke_config
from sd_tpu_torch.diffusion import consistency
from sd_tpu_torch.train import diffusion as train

TOL = 1e-5
T, N = 50, 10


def schedules_pair():
    args = (T, "linear", 0.00085, 0.012)
    return jsched.DiffusionSchedule.create(*args), schedules.DiffusionSchedule.create(*args)


def distillers(**kw):
    js, ps = schedules_pair()
    return (jcons.ConsistencyDistiller(js, num_boundaries=N, **kw),
            consistency.ConsistencyDistiller(ps, num_boundaries=N, **kw))


def jax_model(seed: int = 0):
    params, japply, unet = tiny_unet(seed)
    return (lambda x, t, c: japply(params, x, t, c)), (lambda x, t, c: unet(x, t, c))


# -- the EMA ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_bitwise(dtype, use_num_updates):
    p0 = {"w": nprand(7, 5, seed=1), "b": nprand(5, seed=2)}
    js = jema.ema_init(p0, 0.95, use_num_updates=use_num_updates, dtype=jnp.dtype(dtype))
    ps = ema.ema_init({k: to_torch(v) for k, v in p0.items()}, 0.95,
                      use_num_updates=use_num_updates, dtype=getattr(torch, dtype))
    for i in range(3):
        p = {k: nprand(*v.shape, seed=10 + i) for k, v in p0.items()}
        js = jema.ema_update(js, p)
        ema.ema_update(ps, {k: to_torch(v) for k, v in p.items()})
        for k in p0:
            assert ps.shadow[k].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(ps.shadow[k].float().numpy(),
                                          np.asarray(js.shadow[k].astype(jnp.float32)))
    assert ps.num_updates == int(js.num_updates) == (3 if use_num_updates else -1)


def test_train_state_param_and_ema_dtypes():
    """`init_train_state(param_dtype=, ema_dtype=)`: parameters cast (a
    tensor already in the dtype kept), moments in the optimizer's dtype, the
    shadow in `ema_dtype`."""
    w = torch.nn.Parameter(torch.randn(3, 2, dtype=torch.bfloat16))
    opt = train.float32_moments(train.ddpm_optimizer(1e-3))
    st = train.init_train_state({"w": w, "b": torch.zeros(2)}, opt, 0.95,
                                param_dtype=torch.bfloat16, ema_dtype=torch.bfloat16)
    assert st.params["w"] is w and st.params["b"].dtype == torch.bfloat16
    assert st.ema.shadow["b"].dtype == torch.bfloat16 and st.opt_state.mu[0].dtype == torch.float32


# -- the distiller's pieces ------------------------------------------------------------


def test_boundaries_and_scalings_match_exactly():
    t = np.arange(0, 1000, 37)
    for got, ref in zip(consistency.boundary_scalings(torch.from_numpy(t), 0.5, 10.0),
                        jcons.boundary_scalings(jnp.asarray(t), 0.5, 10.0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    c_skip, c_out = consistency.boundary_scalings(torch.tensor([0]))
    assert float(c_skip) == 1.0 and float(c_out) == 0.0
    for steps, n in ((1000, 50), (50, 10), (1000, 7)):
        np.testing.assert_array_equal(consistency.boundary_timesteps(steps, n),
                                      jcons.boundary_timesteps(steps, n))
    # the JAX sampler's grid (its comment says index 37; np.round takes 37.5 to 38)
    d = consistency.ConsistencyDistiller(schedules.DiffusionSchedule.create(1000))
    idx = [int(np.where(d.boundaries == t)[0][0]) for t in d.sample_timesteps(4)]
    assert idx == [50, 38, 25, 12, 0]
    a, b = nprand(3, 4, 4, 2, seed=1), nprand(3, 4, 4, 2, seed=2)
    for c in (None, 0.1):
        assert_close(consistency.pseudo_huber(to_torch(a), to_torch(b), c),
                     jcons.pseudo_huber(jnp.asarray(a), jnp.asarray(b), c), TOL)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_consistency_fn_and_teacher_step_match(param):
    """consistency_fn on 2 samples; the teacher's CFG step on 1 (the UNet
    sees [uncond; cond])."""
    jd, pd = distillers(parameterization=param)
    jfn, tfn = jax_model()
    z, c = nprand(*LATENT, seed=1), nprand(*CONTEXT, seed=2)
    z1, c1, uc1 = (nprand(*CFG_LATENT, seed=1), nprand(*CFG_CONTEXT, seed=2),
                   nprand(*CFG_CONTEXT, seed=3))
    t_hi, t_lo = np.array([49, 20]), np.array([44, 15])
    with torch.no_grad():
        got = pd.consistency_fn(tfn, to_torch(z), torch.from_numpy(t_hi), to_torch(c))
        step = pd.teacher_step(tfn, to_torch(z1), torch.from_numpy(t_hi[:1]),
                               torch.from_numpy(t_lo[:1]), cond=to_torch(c1),
                               uncond=to_torch(uc1), guidance_scale=7.5)
    assert_close(got, jd.consistency_fn(jfn, jnp.asarray(z), jnp.asarray(t_hi), jnp.asarray(c)),
                 TOL)
    assert_close(step, jd.teacher_step(jfn, jnp.asarray(z1), jnp.asarray(t_hi[:1]),
                                       jnp.asarray(t_lo[:1]), cond=jnp.asarray(c1),
                                       uncond=jnp.asarray(uc1), guidance_scale=7.5), TOL)


def test_draw_pair_and_student_loss_match():
    """The pair's draws replayed from the JAX key (boundary index, then the
    noise; the CFG teacher's step is `teacher_step`'s, held above); the
    student at seed 0, the target at seed 1."""
    jd, pd = distillers()
    jfn, tfn = jax_model()
    jtarget, ttarget = jax_model(seed=1)
    z0, c = nprand(*LATENT, seed=4), nprand(*CONTEXT, seed=5)
    rng = jax.random.PRNGKey(3)
    ref = jd.draw_pair(jfn, jnp.asarray(z0), rng, cond=jnp.asarray(c))
    rng_i, rng_n = jax.random.split(rng)
    i = np.asarray(jax.random.randint(rng_i, (2,), 1, N + 1))
    noise = np.asarray(jax.random.normal(rng_n, LATENT, jnp.float32))
    got = pd.draw_pair(tfn, to_torch(z0), cond=to_torch(c), i=torch.from_numpy(i),
                       noise=to_torch(noise))
    for g, r in zip(got, ref):
        assert_close(g, r, TOL)
    loss, logs = pd.student_loss(tfn, ttarget, *got, cond=to_torch(c))
    rloss, rlogs = jd.student_loss(jfn, jtarget, *ref, cond=jnp.asarray(c))
    assert_close(loss, rloss, TOL)
    assert set(logs) == set(rlogs)
    for k in logs:
        assert_close(logs[k], rlogs[k], TOL)


@pytest.mark.parametrize("steps", [2, 4])
def test_consistency_sample_matches(steps):
    """Fresh noise at every model call, the last one's drawn and unused."""
    jd, pd = distillers()
    jfn, tfn = jax_model()
    x_T, c = nprand(*LATENT, seed=7), nprand(*CONTEXT, seed=8)
    rng = jax.random.PRNGKey(5)
    with scan_as_loop():
        ref = jd.sample(jfn, rng, LATENT, num_steps=steps, cond=jnp.asarray(c),
                        x_T=jnp.asarray(x_T))
    key = jax.random.split(rng)[0]
    draws = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        draws.append(to_torch(np.asarray(jax.random.normal(nkey, LATENT, jnp.float32))))
    seen = []
    with torch.no_grad():
        got = pd.sample(tfn, LATENT, to_torch(x_T), num_steps=steps, cond=to_torch(c),
                        noise=lambda k, shape: seen.append(k) or draws[k])
    assert_close(got, ref, TOL)
    assert seen == list(range(steps))


def test_latent_sample_lcm_errors_and_knobs():
    """`LatentDiffusion.sample(sampler="lcm")` pops `sigma_data`,
    `timestep_scaling` and `num_boundaries` (the JAX package's defaults) and
    refuses any other extra argument, as the JAX sampler does."""
    from sd_tpu_torch.diffusion.ddpm import DDPMProcess
    from sd_tpu_torch.diffusion.latent import LatentDiffusion

    _, ps = schedules_pair()
    ld = LatentDiffusion(process=DDPMProcess(ps), unet_apply=lambda x, t, ctx: 0.3 * x)
    x_T, cond = to_torch(nprand(*LATENT, seed=9)), {"c_crossattn": [torch.zeros(CONTEXT)]}
    noise = lambda k, shape: torch.zeros(shape)
    got = ld.sample(LATENT, x_T, cond, sampler="lcm", num_steps=2, noise=noise, decode=False,
                    guidance_rescale=0.7, num_boundaries=N, sigma_data=0.3)
    want = consistency.ConsistencyDistiller(ps, num_boundaries=N, sigma_data=0.3).sample(
        ld.apply_model, LATENT, x_T, num_steps=2, cond=cond, noise=noise)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        ld.sample(LATENT, x_T, cond, sampler="lcm", decode=False, bogus=1)
    with pytest.raises(TypeError):
        ld.sample(LATENT, x_T, cond, sampler="ddim", decode=False, sigma_data=0.5)


# -- the distillation run -----------------------------------------------------------------


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A folder of PNGs and a teacher run: distill_smoke_config()'s LDM
    trained by the port's `train_ldm` for 2 steps."""
    from sd_tpu_torch.data.image_io import write_png
    from sd_tpu_torch.train.__main__ import main

    root = tmp_path_factory.mktemp("distill")
    rng = np.random.default_rng(0)
    (root / "data").mkdir()
    for i in range(4):
        write_png(str(root / "data" / f"{('cat', 'dog')[i // 2]}_{i}.png"),
                  rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    cfg = distill_smoke_config()
    cfg["task"] = "ldm"
    del cfg["distill"]
    cfg["train"].update(total_steps=2, checkpoint_every=2, ema_decay=0.5)
    (root / "teacher.json").write_text(json.dumps(cfg))
    assert main(["--config", str(root / "teacher.json"), "--data", str(root / "data"),
                 "--out", str(root / "teacher"), "--device", "cpu"]) == 0
    return root


def _distill(root, out, cfg, *extra) -> int:
    from sd_tpu_torch.train.__main__ import main

    path = out.parent / f"{out.name}.json"
    path.write_text(json.dumps(cfg))
    return main(["--config", str(path), "--data", str(root / "data"), "--out", str(out),
                 "--device", "cpu", *extra])


def _distill_cfg(root) -> dict:
    cfg = distill_smoke_config()
    cfg["distill"]["teacher_run"] = str(root / "teacher")
    cfg["train"].update(total_steps=2, checkpoint_every=1, eval_every=2)
    return cfg


def test_distill_run_resumes_and_serves_with_lcm(tmp_path, teacher):
    """A run (checkpoints, metrics, the eval grid) broken after one step and
    resumed ends in the unbroken run's state bit for bit (the same batches
    handed in: a resumed run's loader starts its epochs again, as in
    sd_tpu); `from_run` serves the student with `lcm`. Under
    `scale_factor: auto` the run copies the teacher's `calibration.json`,
    and `from_run` decodes the student at the teacher's scale (sd_tpu's
    run writes none, and its `from_run` decodes at 1.0). (The command
    line's `task: distill` runs in the LCM-LoRA test below.)"""
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.train.distill import distill_ldm
    from test_torch_train_run import assert_same_tree

    auto_teacher = tmp_path / "auto_teacher"          # the teacher, calibrated
    auto_teacher.mkdir()
    (auto_teacher / "ckpt").symlink_to(teacher / "teacher" / "ckpt")
    (auto_teacher / "calibration.json").write_text(json.dumps({"scale_factor": 0.25}))
    cfg = _distill_cfg(teacher)
    cfg["distill"]["teacher_run"] = str(auto_teacher)
    cfg["latent"]["scale_factor"] = "auto"
    rng = np.random.default_rng(3)
    batches = [{"image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                "txt_raw": ["a photo of a cat", "a photo of a dog"]} for _ in range(2)]
    run = tmp_path / "a"
    whole, _ = distill_ldm(cfg, batches, out_dir=str(run), max_steps=2, device="cpu")
    distill_ldm(cfg, batches[:1], out_dir=str(tmp_path / "b"), max_steps=1, device="cpu")
    resumed, hist = distill_ldm(cfg, batches[1:], out_dir=str(tmp_path / "b"), max_steps=2,
                                device="cpu")
    assert len(hist) == 1 and resumed.step == whole.step == 2
    assert_same_tree(resumed, whole)
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == ["step_1.pt", "step_2.pt"]
    assert (run / "samples" / "step_2.png").exists()

    assert json.loads((run / "calibration.json").read_text()) == {"scale_factor": 0.25}
    pipe = Text2ImagePipeline.from_run(cfg, str(run), device="cpu", param_dtype=torch.float32)
    assert pipe.ld.scale_factor == 0.25
    img = pipe.generate(["a cat", "a dog"], num_steps=2, sampler="lcm", guidance_scale=1.0)
    assert img.shape == (2, 32, 32, 3) and img.std() > 0
    with pytest.raises(ValueError, match="no CFG branch"):
        pipe.generate(["a cat"], num_steps=2, sampler="lcm")


def test_lcm_lora_run_writes_a_loadable_lora(tmp_path, teacher):
    """An LCM-LoRA run (rank 4, CFG 3 baked in, grad_accum 2): the factors
    train, the teacher's weights do not, and `lora.safetensors` merges
    into a `from_run` of the teacher."""
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.train.checkpoint import restore_tree, trained_weights
    from sd_tpu_torch.utils.safetensors_io import load_safetensors

    cfg = _distill_cfg(teacher)
    cfg["distill"].update(lora_rank=4, guidance_scale=3.0)
    cfg["train"]["grad_accum"] = 2
    out = tmp_path / "lora"
    assert _distill(teacher, out, cfg) == 0
    tree = restore_tree(str(out / "ckpt"))
    assert sorted(tree["params"]) == sorted(tree["ema"]["shadow"])
    assert all(k.endswith((".a", ".b")) for k in tree["params"])
    assert any(float(v.abs().max()) > 0 for k, v in tree["params"].items() if k.endswith(".b"))
    _, meta = load_safetensors(str(out / "lora.safetensors"), return_metadata=True)
    assert meta["kind"] == "lcm-lora" and meta["rank"] == "4"

    tcfg = json.loads((teacher / "teacher.json").read_text())
    base = Text2ImagePipeline.from_run(tcfg, str(teacher / "teacher"), device="cpu",
                                       param_dtype=torch.float32)
    plain = {n: p.clone() for n, p in base.unet.named_parameters()}
    want = trained_weights(restore_tree(str(teacher / "teacher" / "ckpt")))
    assert all(torch.equal(plain[n], want[n]) for n in plain)
    base.load_lora(str(out / "lora.safetensors"))
    moved = [n for n, p in base.unet.named_parameters() if not torch.equal(p, plain[n])]
    assert moved and all("attn" in n for n in moved)
    img = base.generate(["a cat"], num_steps=2, sampler="lcm", guidance_scale=1.0)
    assert img.shape == (1, 32, 32, 3)


def test_distill_refuses_what_the_jax_package_refuses(tmp_path, teacher):
    from sd_tpu_torch.core.config import flow_smoke_config
    from sd_tpu_torch.train.distill import distill_ldm

    cfg = _distill_cfg(teacher)
    flow_cfg = copy.deepcopy(cfg)
    flow_cfg["diffusion"] = flow_smoke_config()["diffusion"]
    with pytest.raises(ValueError, match="not a flow model"):
        distill_ldm(flow_cfg, str(teacher / "data"), device="cpu")
    auto = copy.deepcopy(cfg)
    auto["latent"]["scale_factor"] = "auto"
    with pytest.raises(ValueError, match="has no calibration.json"):
        distill_ldm(auto, str(teacher / "data"), device="cpu")
