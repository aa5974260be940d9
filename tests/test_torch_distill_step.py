"""One consistency-distillation step against the JAX package's, on the CPU
in fp32: `make_consistency_train_step` with `consistency_loss_fn`, the
full-parameter student and LCM-LoRA (random b, so both factors get
gradients), at `grad_accum` 1 and 2, on the same prepped pair, the tiny UNet
of `test_torch_flow.py` carried across by `load_flax_params`: the loss,
`grad_norm` and the gradients (Adam's first moment, 0.1·g) within
1e-5·max(1, max|ref|) (`TOL`). At lr 1e-3 Adam's first step moves each
entry by lr·g/(|g| + 1e-8); where |g| > 1e-5 (`GRAD_FLOOR`: a thousand
times Adam's ε, so rounding near zero cannot flip it) that is ±lr to 1 %, and
there the update p' − p equals the JAX package's within 1e-3·lr
(`UPDATE_TOL`), and the updated parameters and the target network within
`TOL`.
The JAX step runs sd_tpu's `make_consistency_train_step` with
`distill_ldm`'s loss closures, its `lax.scan` as a Python loop around the
jitted loss, and its optimizer update, EMA update and tree-wide sums
jitted whole (the same arithmetic, a few compiles in all).
"""

from __future__ import annotations

import dataclasses
import functools
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_distill import N, T, distillers, schedules_pair
from test_torch_flow import TINY_UNET, scan_as_loop, tiny_unet
from test_torch_helpers import assert_close, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core import ema as jema
from sd_tpu.diffusion import consistency as jcons
from sd_tpu.diffusion import ddpm as jddpm
from sd_tpu.diffusion import latent as jlatent
from sd_tpu.train import diffusion as jtrain
from sd_tpu.train import distill as jdistill
from sd_tpu.train import lora as jlora
from sd_tpu_torch.diffusion import consistency
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.train import diffusion as train
from sd_tpu_torch.train import distill
from sd_tpu_torch.train.lora import flat_lora
from sd_tpu_torch.weights import _flatten, torch_name

TOL = 1e-5
LR = 1e-3
GRAD_FLOOR = 1e-5
UPDATE_TOL = 1e-3 * LR


def as_port(tree) -> dict[str, np.ndarray]:
    """A flax tree by the port's parameter names, in the port's layout."""
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf, np.float32)
        name, perm = torch_name(path, arr.ndim)
        out[name] = arr if perm is None else arr.transpose(perm)
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_and_optimizer(lora: bool, lr: float):
    """`distill_ldm`'s loss (its closures, jitted once per mode, so both
    grad_accum cases share one compile) and sd_tpu's optimizer with its
    update jitted."""
    _, japply, _ = tiny_unet()
    js, _ = schedules_pair()
    ld = jlatent.LatentDiffusion(process=jddpm.DDPMProcess(js),
                                 unet_apply=lambda p, x, t, ctx, y=None: japply(p, x, t, ctx))
    dist = jcons.ConsistencyDistiller(js, num_boundaries=N)
    if lora:
        def loss_fn(p, target_p, pr, step_rng):
            sfn = lambda q: ld.model_fn(jlora.merge_lora(pr["base"], q))
            return dist.student_loss(sfn(p), sfn(target_p), pr["z_hi"], pr["z_lo"],
                                     pr["t_hi"], pr["t_lo"], pr["cond"])
    else:
        def loss_fn(p, target_p, pr, step_rng):
            return dist.student_loss(ld.model_fn(p), ld.model_fn(target_p), pr["z_hi"],
                                     pr["z_lo"], pr["t_hi"], pr["t_lo"], pr["cond"])
    opt = jtrain.ddpm_optimizer(lr, 1.0)
    return jax.jit(loss_fn), optax.GradientTransformation(opt.init, jax.jit(opt.update))


# the step's tree-wide updates, jitted as a whole (eager, each leaf's ops
# would compile one by one)
_JITTED = {"ema_update": jax.jit(jema.ema_update),
           "optax": types.SimpleNamespace(apply_updates=jax.jit(optax.apply_updates),
                                          global_norm=jax.jit(optax.global_norm))}


@functools.lru_cache(maxsize=None)
def _jax_init(opt):
    return jax.jit(lambda p: jtrain.init_train_state(p, opt, 0.95))


def _jax_step(lora: bool, grad_accum: int, student, target, prepped, lr: float):
    """sd_tpu's `make_consistency_train_step` with `distill_ldm`'s loss on
    one prepped pair; returns (state, logs)."""
    loss_fn, opt = _jax_loss_and_optimizer(lora, lr)
    if lora:
        prepped = dict(prepped, base=jax.tree.map(jnp.asarray, tiny_unet()[0]))
    state = _jax_init(opt)(student)
    state = dataclasses.replace(state, ema=dataclasses.replace(state.ema, shadow=target))
    step = jdistill.make_consistency_train_step(loss_fn, opt, jit=False, grad_accum=grad_accum)
    with scan_as_loop(), mock.patch.multiple(jdistill, **_JITTED):
        return step(state, prepped, jax.random.PRNGKey(0))


def _adam_mu(opt_state):
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")).mu


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_distill_step_matches(lora, grad_accum):
    """The target differs from the student (another random tree), so the
    loss is not the warm start's zero."""
    params, _, _ = tiny_unet()
    B = 2 * grad_accum                            # microbatches of 2: one JAX compile a mode
    ts = consistency.boundary_timesteps(T, N)
    i = np.array([3, 10, 1, 7])[:B]
    prepped = {"z_hi": nprand(B, 8, 8, 4, seed=1), "z_lo": nprand(B, 8, 8, 4, seed=2),
               "t_hi": ts[i].astype(np.int32), "t_lo": ts[i - 1].astype(np.int32),
               "cond": {"c_crossattn": [nprand(B, 8, 16, seed=3)]}}
    unet = port(UNetModel(**TINY_UNET, device="cpu"), params)
    if lora:
        rng = np.random.default_rng(4)
        factors = {k: {"a": pair["a"], "b": (0.05 * rng.standard_normal(pair["b"].shape)
                                             ).astype(np.float32)}
                   for k, pair in jlora.init_lora(params, 2, jax.random.PRNGKey(1)).items()}
        factors = jax.tree.map(np.asarray, factors)
        target = jax.tree.map(lambda x: (x + 0.02 * np.random.default_rng(5).standard_normal(
            x.shape)).astype(np.float32), factors)
        student = factors
        unet.requires_grad_(False)
        t_params = flat_lora(jax.tree.map(to_torch, factors))
        t_target = flat_lora(jax.tree.map(to_torch, target))
        names = lambda tree: flat_lora(tree)
    else:
        target = tiny_unet(seed=1)[0]
        student = params
        t_params = dict(unet.named_parameters())
        t_target = {k: to_torch(v) for k, v in as_port(target).items()}
        names = as_port
    before = {k: v.detach().numpy().copy() for k, v in t_params.items()}
    jstate, jlogs = _jax_step(lora, grad_accum, jax.tree.map(jnp.asarray, student),
                              jax.tree.map(jnp.asarray, target),
                              jax.tree.map(jnp.asarray, prepped), LR)

    _, pd = distillers()
    opt = train.ddpm_optimizer(LR, 1.0)
    state = train.init_train_state(t_params, opt, 0.95)
    with torch.no_grad():
        for k, s in state.ema.shadow.items():
            s.copy_(t_target[k])
    step = distill.make_consistency_train_step(
        distill.consistency_loss_fn(pd, unet, lora=lora), opt, grad_accum=grad_accum)
    logs = step(state, jax.tree.map(to_torch, prepped))

    assert set(logs) == set(jlogs)
    for k in logs:
        assert_close(logs[k], jlogs[k], TOL)
    assert float(logs["loss"]) > 0 and float(logs["grad_norm"]) > 0
    want = {k: np.asarray(v) for k, v in names(jax.tree.map(np.asarray, jstate.params)).items()}
    want_mu = {k: np.asarray(v) for k, v in names(
        jax.tree.map(np.asarray, _adam_mu(jstate.opt_state))).items()}
    want_target = {k: np.asarray(v) for k, v in names(
        jax.tree.map(np.asarray, jstate.ema.shadow)).items()}
    assert sorted(want) == sorted(state.params)
    counted = total = 0
    for (k, p), mu in zip(state.params.items(), state.opt_state.mu):
        assert_close(mu, want_mu[k], TOL)
        sure = np.abs(want_mu[k]) > 0.1 * GRAD_FLOOR             # mu = 0.1·g
        counted, total = counted + int(sure.sum()), total + sure.size
        got_p = p.detach().numpy()
        step_ref = (want[k] - before[k])[sure]
        assert np.all((0.99 * LR < np.abs(step_ref)) & (np.abs(step_ref) < 1.01 * LR)), k
        assert np.max(np.abs((got_p - before[k])[sure] - step_ref), initial=0.0) <= UPDATE_TOL, k
        assert_close(got_p[sure], want[k][sure], TOL)
        assert_close(state.ema.shadow[k].numpy()[sure], want_target[k][sure], TOL)
    assert counted > total // 2, (counted, total)
    assert state.step == 1 and state.ema.num_updates == int(jstate.ema.num_updates) == 1
