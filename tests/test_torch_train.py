"""The port's training pieces against the JAX package, fp32 on the CPU:
`DDPMProcess.p_losses` (eps / x0 / v, l2 / l1, min-SNR, learned logvar,
ELBO weight) with the same toy model, the EMA update, the lambda-linear LR
schedule, and clip + Adam under `float32_moments` on one fixed gradient
tree, within 1e-4·max(1, max|ref|); and the remat policies, which must not
change a gradient and must keep the training context in the recompute.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_helpers import MODULE_TOL, assert_close, nprand, to_torch

from sd_tpu.core import ema as jema
from sd_tpu.core import schedules as jsched
from sd_tpu.diffusion import ddpm as jddpm
from sd_tpu.train import diffusion as jtrain
from sd_tpu.train import lr_schedules as jlr
from sd_tpu_torch.core import ema, schedules
from sd_tpu_torch.diffusion import ddpm
from sd_tpu_torch.kernels import conv2d
from sd_tpu_torch.train import diffusion as train
from sd_tpu_torch.train import lr_schedules
from sd_tpu_torch.train.remat import remat_apply


def _toy_model(lib):
    """The same toy model in both frameworks: depends on x, t and cond."""
    def fn(x, t, c):
        if lib is jnp:
            tt = jnp.reshape(t, (-1, 1, 1, 1)).astype("float32")
        else:
            tt = t.reshape(-1, 1, 1, 1).float()
        return lib.tanh(x * 0.9) + tt / 2000.0 + c
    return fn


@pytest.mark.parametrize("param,loss_type,min_snr,logvar,elbo", [
    ("eps", "l2", None, False, 0.0),
    ("x0", "l1", None, False, 0.5),
    ("v", "l2", 5.0, False, 0.0),
    ("eps", "l2", 5.0, True, 0.0),
    ("x0", "l2", 5.0, True, 1.0),
    ("v", "l1", None, True, 0.25),
])
def test_p_losses(param, loss_type, min_snr, logvar, elbo):
    kw = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
              linear_end=0.012, parameterization=param)
    proc = ddpm.DDPMProcess(schedules.DiffusionSchedule.create(**kw), parameterization=param,
                            loss_type=loss_type, min_snr_gamma=min_snr,
                            original_elbo_weight=elbo)
    jproc = jddpm.DDPMProcess(jsched.DiffusionSchedule.create(**kw), parameterization=param,
                              loss_type=loss_type, min_snr_gamma=min_snr,
                              original_elbo_weight=elbo)
    x0, noise = nprand(4, 5, 5, 3, seed=1), nprand(4, 5, 5, 3, seed=2)
    cond = nprand(4, 1, 1, 3, seed=3, scale=0.1)
    t = np.array([0, 5, 500, 999])
    lv = nprand(1000, seed=4, scale=0.3) if logvar else None
    loss, logs = proc.p_losses(_toy_model(torch), to_torch(x0), torch.from_numpy(t),
                               to_torch(noise), to_torch(cond),
                               None if lv is None else to_torch(lv))
    jloss, jlogs = jproc.p_losses(_toy_model(jnp), jnp.asarray(x0), jnp.asarray(t),
                                  jnp.asarray(noise), jnp.asarray(cond),
                                  None if lv is None else jnp.asarray(lv))
    assert sorted(logs) == sorted(jlogs)
    assert_close(loss, jloss)
    for k in logs:
        assert_close(logs[k], jlogs[k])


def test_draw_training_noise_offset_shape():
    g = torch.Generator().manual_seed(0)
    base = ddpm.draw_training_noise((2, 4, 4, 3), generator=g)
    g.manual_seed(0)
    off = ddpm.draw_training_noise((2, 4, 4, 3), 0.1, generator=g)
    dc = off - base                                # one offset per (sample, channel)
    assert torch.allclose(dc, dc[:, :1, :1, :].expand_as(dc))
    assert dc.abs().sum() > 0


@pytest.mark.parametrize("decay", [0.99, 0.9999])
def test_ema_update(decay):
    params = {"a": nprand(3, 4, seed=0), "b": nprand(5, seed=1)}
    tparams = {k: to_torch(v).bfloat16() for k, v in params.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    st = ema.ema_init(tparams, decay)
    jst = jema.ema_init(jparams, decay)
    for i in range(3):
        step = {k: nprand(*v.shape, seed=10 + i) for k, v in params.items()}
        tparams = {k: to_torch(v).bfloat16() for k, v in step.items()}
        jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in step.items()}
        ema.ema_update(st, tparams)
        jst = jema.ema_update(jst, jparams)
    assert st.num_updates == int(jst.num_updates)
    for k in params:
        assert st.shadow[k].dtype == torch.float32
        assert_close(st.shadow[k], jst.shadow[k])
        assert_close(ema.ema_copy_to(st, tparams)[k].float(),
                     jema.ema_copy_to(jst, jparams)[k].astype(jnp.float32))


@pytest.mark.parametrize("sched", [
    dict(warm_up_steps=[200], f_min=[1.0], f_max=[1.0], f_start=[1e-6],
         cycle_lengths=[10000000000000]),             # configs/sd512_catdog.yaml
    dict(warm_up_steps=[10, 20], f_min=[0.1, 0.2], f_max=[1.0, 0.5], f_start=[0.0, 0.01],
         cycle_lengths=[100, 300]),
])
def test_lambda_linear_schedule(sched):
    lam, jlam = lr_schedules.lambda_linear_schedule(**sched), jlr.lambda_linear_schedule(**sched)
    for step in (0, 1, 9, 10, 11, 57, 99, 100, 105, 120, 250, 399, 400, 5000):
        np.testing.assert_allclose(lam(step), float(jlam(step)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_moments_clip_adam(dtype):
    """Two steps on one fixed gradient tree, the first clipped (norm > 1),
    the second not. bf16 parameters: the fp32 moments within 1e-4, the
    parameters within one bf16 rounding (2⁻⁸ relative), since an update
    computed in another order may round to the neighbouring bf16 value."""
    shapes = {"w": (6, 7), "b": (7,), "s": (3, 2, 2)}
    params = {k: nprand(*s, seed=i) for i, (k, s) in enumerate(shapes.items())}
    grads = [{k: nprand(*s, seed=10 + 3 * j + i, scale=scale)
              for i, (k, s) in enumerate(shapes.items())}
             for j, scale in enumerate((2.0, 0.01))]
    lam = dict(warm_up_steps=[1], f_min=[1.0], f_max=[1.0], f_start=[0.5],
               cycle_lengths=[1000])
    lr, jlr_ = lr_schedules.lambda_linear_schedule(**lam), jlr.lambda_linear_schedule(**lam)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)

    opt = train.float32_moments(train.ddpm_optimizer(lambda s: 1e-2 * lr(s), 1.0))
    tp = {k: to_torch(v).to(tdt) for k, v in params.items()}
    st = opt.init(list(tp.values()))
    jopt = jtrain.float32_moments(jtrain.ddpm_optimizer(lambda s: 1e-2 * jlr_(s), 1.0))
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jst = jopt.init(jp)
    for g in grads:
        opt.update_(list(tp.values()), [to_torch(g[k]).to(tdt) for k in tp], st)
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        up, jst = jopt.update(jg, jst, jp)
        jp = optax.apply_updates(jp, up)
    adam = jst[1][0]                           # chain(clip, adam(scale_by_adam, lr))
    for i, k in enumerate(tp):
        assert st.mu[i].dtype == torch.float32
        assert_close(st.mu[i], adam.mu[k])
        assert_close(st.nu[i], adam.nu[k])
        assert tp[k].dtype == tdt
        tol = MODULE_TOL if dtype == "float32" else 2.0**-8
        assert_close(tp[k].float(), jp[k].astype(jnp.float32), tol)
    assert st.count == int(adam.count) == 2


def test_global_norm_is_fp32():
    g = [torch.full((1000,), 0.01, dtype=torch.bfloat16) for _ in range(50)]
    np.testing.assert_allclose(float(train.global_norm(g)),
                               float(optax.global_norm([jnp.asarray(t.float().numpy())
                                                        for t in g])), rtol=1e-6)


# -- remat --------------------------------------------------------------------------


def _tiny_net(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                               torch.nn.Linear(16, 8))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_keeps_the_gradients(policy):
    x = torch.randn(4, 8)
    grads = []
    for pol in ("none", policy):
        net = _tiny_net()
        remat_apply(net, pol)(x).pow(2).sum().backward()
        grads.append([p.grad for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_recompute_runs_in_the_training_context(policy):
    """Autograd may run the recompute on another thread (it does for CUDA
    tensors), where the forward's context variables are not set; the
    recompute must still see `training_trace`."""
    seen = []
    net = _tiny_net()

    def fn(x):
        seen.append(conv2d._TRAIN_CTX_VAR.get())
        return net(x)

    with conv2d.training_trace():
        loss = remat_apply(fn, policy)(torch.randn(4, 8)).pow(2).sum()
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert seen == [True, True]              # the forward and its recompute
    assert all(p.grad is not None for p in net.parameters())


def test_remat_dots_saves_the_weight_products():
    from sd_tpu_torch.train import remat

    ops = torch.ops.aten
    assert remat._dots_policy(None, ops.mm.default).name == "MUST_SAVE"
    assert remat._dots_policy(None, ops.convolution.default).name == "MUST_SAVE"
    assert remat._dots_policy(None, ops.bmm.default).name == "PREFER_RECOMPUTE"
    with pytest.raises(ValueError):
        remat_apply(lambda x: x, "everything")


def test_cast_floating():
    t = {"w": torch.randn(2), "i": torch.arange(3)}
    out = train.cast_floating(t, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int64
    jout = jtrain.cast_floating({"w": jnp.zeros(2), "i": jnp.arange(3)}, jnp.bfloat16)
    assert jout["w"].dtype == jnp.bfloat16 and jout["i"].dtype == jnp.int32
    assert train.cast_floating(t, None)["w"].dtype == torch.float32
