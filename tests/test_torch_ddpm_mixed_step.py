"""One `make_ddpm_trainer` step of `UNetDDPM` (base 32, (1, 2), attention at
level 1, 16², dropout 0.1) against the JAX package's, from the same weights,
t, noise and dropout masks (both packages' masks injected at the flax
paths), on the CPU:

* fp32: the loss, loss_simple and grad_norm within 1e-4·max(1, |ref|), the
  parameters after the step within ‖Δ‖₂ ≤ 1e-4·‖ref‖₂;
* bf16 compute over fp32 storage (`compute_dtype`, the config's
  `model.params.dtype`): the loss within 1e-2 relative of the JAX bf16
  step's, the parameters after the step no further from the JAX fp32
  step's than 1.5× the JAX bf16 step's are, and the stored parameters, Adam
  moments and EMA fp32.

The two JAX steps compile in two threads (XLA compiles without the GIL).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_helpers import MODULE_TOL, assert_close, flax_init, injected_dropout, nprand, port
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion.ddpm import DDPMProcess as JProcess
from sd_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from sd_tpu.train import diffusion as jtrain
from sd_tpu.train import runners as jrunners
from sd_tpu_torch.core.config import ddpm_smoke_config
from sd_tpu_torch.models.unet_ddpm import UNetDDPM
from sd_tpu_torch.train.runners import make_ddpm_trainer

LOSS_REL = 1e-2          # the bf16-compute losses, relative
PARAMS_RATIO = 1.5       # ‖p_port,bf16 − p_jax,fp32‖ ≤ 1.5·‖p_jax,bf16 − p_jax,fp32‖
UNET = dict(base_channels=32, ch_mult=(1, 2), attn_levels=(1,), num_res_blocks=1,
            dropout=0.1)
PX = 16


def _ddpm_cfg(dtype=None):
    cfg = ddpm_smoke_config()
    cfg["model"]["params"] = dict(UNET, **({"dtype": dtype} if dtype else {}))
    cfg["train"]["lr_schedule"] = "cosine"
    return cfg


def _jax_step(params, batch, dtype):
    cfg = _ddpm_cfg()
    tc = cfg["train"]
    jmodel = JUNetDDPM(**UNET, dtype=dtype)
    process = JProcess(JSchedule.create(**cfg["diffusion"]), clip_denoised=True)

    def loss_fn(p, b, rng, logvar):
        return process.p_losses(
            lambda x, t, c: jmodel.apply({"params": p}, x, t, deterministic=False,
                                         rngs={"dropout": jax.random.fold_in(rng, 1)}),
            b["image"], b["t"], b["noise"], learned_logvar=logvar)

    opt = jtrain.ddpm_optimizer(jrunners._make_lr(tc), tc["grad_clip"])
    state = jtrain.init_train_state(params, opt, tc["ema_decay"])
    state, logs = jtrain.make_diffusion_train_step(loss_fn, opt)(
        state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    ref = UNetDDPM(**UNET, device="cpu")
    port(ref, jax.tree.map(np.asarray, state.params))
    return logs, {n: p.detach() for n, p in ref.named_parameters()}


def _dist(a: dict, b: dict) -> float:
    return math.sqrt(sum(float(((a[n].float() - b[n].float()) ** 2).sum()) for n in b))


def test_ddpm_step_with_dropout_in_fp32_and_bf16_compute_matches():
    x0 = jnp.zeros((1, PX, PX, 3))
    params = flax_init(JUNetDDPM(**UNET), x0, jnp.zeros((1,), jnp.int32), seed=8)
    rng = np.random.default_rng(9)
    batch = {"image": rng.uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32),
             "t": np.array([5, 44]), "noise": nprand(2, PX, PX, 3, seed=10)}
    model32 = UNetDDPM(**UNET, device="cpu")
    model16 = UNetDDPM(**UNET, compute_dtype=torch.bfloat16, device="cpu")
    with injected_dropout(model32, model16):
        with ThreadPoolExecutor(2) as pool:
            (jlogs32, jp32), (jlogs16, jp16) = pool.map(
                lambda dt: _jax_step(params, batch, dt), (None, jnp.bfloat16))
        model32 = port(model32, params).train()
        model16 = port(model16, params).train()
        logs32, logs16 = {}, {}
        for model, logs in ((model32, logs32), (model16, logs16)):
            state, step = make_ddpm_trainer(_ddpm_cfg(), model)
            logs.update(step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                             torch.Generator().manual_seed(0)))
            logs["params"] = {n: p.detach() for n, p in state.params.items()}
            logs["state"] = state
    for k in ("loss", "loss_simple", "grad_norm"):
        assert_close(logs32[k], jlogs32[k], MODULE_TOL)
    assert _dist(logs32["params"], jp32) <= 1e-4 * math.sqrt(
        sum(float((p ** 2).sum()) for p in jp32.values()))
    assert abs(float(logs16["loss"]) - float(jlogs16["loss"])) <= LOSS_REL * float(jlogs16["loss"])
    assert _dist(logs16["params"], jp32) <= PARAMS_RATIO * _dist(jp16, jp32)
    assert _dist(jp16, jp32) > 0                                  # bf16 moved the step
    st = logs16["state"]
    for tensors in (st.params.values(), st.ema.shadow.values(), st.opt_state.mu,
                    st.opt_state.nu):
        assert {t.dtype for t in tensors} == {torch.float32}
    # without the step's generator (an eval call) the model is deterministic
    with torch.no_grad():
        t = torch.tensor([5, 44])
        x = torch.from_numpy(batch["image"])
        assert torch.equal(model16(x, t), model16(x, t))
