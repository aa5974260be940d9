"""`train_ldm`'s fine-tuning branches against the JAX package's, on the CPU in
fp32 at `configs/ip_smoke.yaml`'s widths (the tiny LDM: UNet 32 × (1, 2),
attention at 8², a 32-wide 2-layer text tower of 16 tokens).

For each of LoRA, ControlNet, IP-Adapter and the trainable text encoder
(with AdamW and the learned logvar), the port's branch (`ldm_branch`, the
function `train_ldm` calls) takes one `make_diffusion_train_step` on a
batch of 2, and the JAX package's `make_diffusion_train_step` takes the
same step over the loss `sd_tpu`'s `train_ldm` builds for that branch
(`merge_lora`, `controlled_apply_fn`, `ip_apply_fn`, the text tower inside
the loss), its `LatentDiffusion.get_input` and `p_losses`. Every weight is
random, carried across by `load_flax_params` (LoRA's b and the adapter's
kernels too, so every factor has a gradient); the first stage runs once,
in the port, and both steps read its latent; t, the training noise and
the posterior noise are injected. The loss, its logs and `grad_norm` agree
within 1e-5·max(1, |ref|) (`TOL`); Adam's first moment (0.1·g after the
clip) within `TOL`; where |g| > 1e-5 (`GRAD_FLOOR`) the update p' − p
within 1e-3·lr (`UPDATE_TOL`) of the JAX package's at lr 1e-3. The frozen
tensors keep their bits and get no `.grad`.

Also: AdamW against `optax.adamw` (and under `float32_moments`), the noise
offset's noise from injected draws, IP-Adapter's keep mask from the (seed,
0x1BAD2) numpy stream, ControlNet before its first step equal to the base
UNet bit for bit, `get_input` under `hybrid` and `concat`, and the branch
rules' errors.
"""

from __future__ import annotations

import functools
import re
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_helpers import COMPILE_OPTIONS, assert_close, nprand, randomize_tree, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion import ddpm as jddpm
from sd_tpu.diffusion.latent import LatentDiffusion as JLatentDiffusion
from sd_tpu.models import controlnet as jcn
from sd_tpu.models import ip_adapter as jip
from sd_tpu.models.clip_text import ClipTextConfig as JClipConfig
from sd_tpu.models.clip_text import ClipTextTransformer as JClip
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.train import diffusion as jtrain
from sd_tpu.train import lora as jlora
from sd_tpu_torch.core.config import ip_smoke_config
from sd_tpu_torch.diffusion import ddpm
from sd_tpu_torch.diffusion.latent import LatentDiffusion
from sd_tpu_torch.models.clip_text import ClipTextConfig, ClipTextTransformer
from sd_tpu_torch.models.controlnet import controlnet_from_unet_config
from sd_tpu_torch.models.ip_adapter import flat_ip, nest_ip
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.nn.attention import LayerNorm32
from sd_tpu_torch.nn.layers import GroupNorm32
from sd_tpu_torch.train import diffusion as train
from sd_tpu_torch.train import runners
from sd_tpu_torch.train.lora import flat_lora, nest_lora
from sd_tpu_torch.weights import _flatten, load_flax_params, torch_name

TOL = 1e-5
LR = 1e-3
GRAD_FLOOR = 1e-5
UPDATE_TOL = 1e-3 * LR
T = 50                                   # the smoke configs' schedule
B = 2


def smoke_config(**blocks) -> dict:
    """`ip_smoke_config()`'s tiny LDM without its adapter, plus `blocks`."""
    cfg = ip_smoke_config()
    del cfg["ip_adapter"]
    cfg.update(blocks)
    return cfg


def unet_kwargs(cfg: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["unet"]["params"].items()}


def flax_tree(module: torch.nn.Module, seed: int) -> dict:
    """A random param tree of the JAX package's module that `module` ports:
    its flax paths from the port's names (the inverse of `torch_name`: the
    norm wrappers' `LayerNorm_0` / `GroupNorm_0` levels, `kernel` in the
    flax layout, `scale`, `embedding`), every leaf drawn as `randomize_tree`
    draws it. Built without tracing the flax module's init."""
    tree: dict = {}
    for mname, mod in module.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            parts = tuple(mname.split(".")) if mname else ()
            if isinstance(mod, LayerNorm32):
                parts += ("LayerNorm_0",)
            elif isinstance(mod, GroupNorm32):
                parts += ("GroupNorm_0",)
            shape = tuple(p.shape)
            if leaf == "weight" and isinstance(mod, torch.nn.Embedding):
                leaf = "embedding"
            elif leaf == "weight" and p.ndim == 1:
                leaf = "scale"
            elif leaf == "weight":
                leaf = "kernel"
                shape = shape[::-1] if p.ndim == 2 else (*shape[2:], shape[1], shape[0])
            node = tree
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = np.zeros(shape, np.float32)
    return randomize_tree(tree, seed)


@functools.lru_cache(maxsize=None)
def jax_weights(in_channels: int = 4):
    """Random flax trees of the smoke config's UNet (with `in_channels`)
    and text tower."""
    cfg = smoke_config()
    kw = {k: v for k, v in cfg["unet"]["params"].items()}
    unet = UNetModel(**{**kw, "in_channels": in_channels}, device="cpu")
    clip = ClipTextTransformer(ClipTextConfig(**cfg["cond_stage"]["params"]), device="cpu")
    return flax_tree(unet, 11), flax_tree(clip, 12)


def port_stack(cfg: dict):
    """`build_ldm(cfg)` on the CPU in fp32 with the JAX package's random
    UNet and text tower carried across (the first stage keeps the port's
    own random init): (ld, unet, vae, embed)."""
    ld, unet, vae, embed = runners.build_ldm(cfg, torch.Generator().manual_seed(0),
                                             device="cpu")
    uparams, cparams = jax_weights(cfg["unet"]["params"]["in_channels"])
    load_flax_params(unet, uparams)
    load_flax_params(embed.clip, cparams)
    return ld, unet, vae, embed


def host_batch(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
            "txt_raw": ["a photo of a cat", "a photo of a dog"]}


def draws(seed: int = 2, latent: tuple = (B, 8, 8, 4)) -> dict:
    """The injected t, training noise and posterior noise."""
    return {"t": np.array([3, 41], np.int64), "noise": nprand(*latent, seed=seed),
            "enc_noise": nprand(*latent, seed=seed + 1)}


def with_draws(batch: dict, d: dict) -> dict:
    return {**batch, **{k: to_torch(v) for k, v in d.items()}}


def as_port(tree) -> dict[str, np.ndarray]:
    """A flax tree by the port's parameter names, in the port's layout."""
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf, np.float32)
        name, perm = torch_name(path, arr.ndim)
        out[name] = arr if perm is None else arr.transpose(perm)
    return out


def jax_ld(apply, key: str = "crossattn", scale: float = 0.18215):
    """The JAX package's LatentDiffusion on the smoke schedule whose first
    stage is the identity: the batch's `image` is the port's latent."""
    return JLatentDiffusion(
        process=jddpm.DDPMProcess(JSchedule.create(**smoke_config()["diffusion"]),
                                  clip_denoised=False),
        unet_apply=apply, encode_fn=lambda x, rng: x, conditioning_key=key,
        scale_factor=scale)


def jax_loss(ld, params_of=lambda p: p, batch_of=lambda p, b: b):
    """`loss_fn(p, batch, rng, logvar)`: get_input + p_losses with the
    batch's injected t and noise."""
    def loss_fn(p, b, rng, logvar):
        z, cond = ld.get_input(batch_of(p, b), rng)
        return ld.p_losses(params_of(p), z, cond, b["t"], b["noise"], logvar)

    return loss_fn


def lower_jax_step(loss_fn, params, batch: dict, weight_decay: float = 0.0,
                   learn_logvar: bool = False):
    """The JAX package's `make_diffusion_train_step` with `ddpm_optimizer`
    over `params` raveled into one vector (the same elementwise optimizer
    and EMA arithmetic; one small program for them instead of one per
    leaf), lowered: (lowered, its arguments, the numpy unravel)."""
    flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, params))
    leaves, treedef = jax.tree.flatten(params)
    cuts = np.cumsum([np.size(x) for x in leaves])[:-1]

    def np_unravel(vec):
        parts = np.split(np.asarray(vec), cuts)
        return treedef.unflatten([p.reshape(np.shape(x)) for p, x in zip(parts, leaves)])

    opt = jtrain.ddpm_optimizer(LR, 1.0, weight_decay=weight_decay)
    state = jtrain.init_train_state(flat, opt, 0.999, num_timesteps=T,
                                    learn_logvar=learn_logvar)
    step = jtrain.make_diffusion_train_step(
        lambda p, b, rng, logvar: loss_fn(unravel(p), b, rng, logvar), opt,
        learn_logvar=learn_logvar)
    args = (state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    return step.lower(*args), args, np_unravel


def build_and_run(cases: dict) -> dict:
    """Build each case, `case() -> (port, lowered JAX step, checks)`, and
    compile its JAX step in a thread as soon as it is lowered (XLA compiles
    outside the GIL, so the next case builds meanwhile; list the slowest
    compile first), then run the JAX steps: {name: (port, (state, logs,
    unravel), checks)}."""
    built, compiled = {}, {}
    with ThreadPoolExecutor(len(cases)) as ex:
        for name, case in cases.items():
            built[name] = case()
            compiled[name] = ex.submit(built[name][1][0].compile,
                                       compiler_options=COMPILE_OPTIONS)
        out = {}
        for name, (port, (_, args, unravel), checks) in built.items():
            state, logs = compiled[name].result()(*args)
            out[name] = (port, (state, logs, unravel), checks)
    return out


def port_step(params: dict, loss_fn, batch: dict, weight_decay: float = 0.0,
              learn_logvar: bool = False):
    """The port's one step: (state, logs, the parameters before)."""
    opt = train.ddpm_optimizer(LR, 1.0, weight_decay=weight_decay)
    state = train.init_train_state(params, opt, 0.999, num_timesteps=T,
                                   learn_logvar=learn_logvar)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    logs = train.make_diffusion_train_step(loss_fn, opt)(state, batch)
    return state, logs, before


def adam_mu(opt_state):
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")).mu


def assert_step_matches(port, jax_out, names, weight_decay=0.0, learn_logvar=False) -> None:
    """The port's step (state, logs, the parameters before) against the JAX
    package's (state, logs, unravel) (see the module docstring);
    `names(flax tree) -> {port name: array}`."""
    state, logs, before = port
    jstate, jlogs, unravel = jax_out
    assert set(logs) == set(jlogs), (sorted(logs), sorted(jlogs))
    for k in logs:
        assert_close(logs[k], jlogs[k], TOL)
    assert float(logs["grad_norm"]) > 0
    jmu = adam_mu(jstate.opt_state)
    want = names(unravel(jstate.params))
    want_mu = names(unravel(jmu["model"] if learn_logvar else jmu))
    assert sorted(want) == sorted(state.params)
    counted = total = 0
    for (k, p), mu in zip(state.params.items(), state.opt_state.mu):
        assert_close(mu, want_mu[k], TOL)
        sure = np.abs(want_mu[k]) > 0.1 * GRAD_FLOOR             # mu = 0.1·g
        counted, total = counted + int(sure.sum()), total + sure.size
        got_step = (p.detach().numpy() - before[k].numpy())[sure]
        ref_step = (want[k] - before[k].numpy())[sure]
        if not weight_decay:
            assert np.all((0.99 * LR < np.abs(ref_step)) & (np.abs(ref_step) < 1.01 * LR)), k
        assert np.max(np.abs(got_step - ref_step), initial=0.0) <= UPDATE_TOL, k
    assert counted > total // 2, (counted, total)
    if learn_logvar:
        assert_close(state.opt_state.mu[-1], np.asarray(jmu["logvar"]), TOL)
        assert_close(state.logvar, np.asarray(jstate.logvar), TOL)
    assert state.step == int(jstate.step) == 1


def _frozen(*modules) -> dict:
    return {f"{i}.{n}": p.detach().clone() for i, m in enumerate(modules)
            for n, p in m.named_parameters()}


def assert_frozen(snapshot: dict, *modules) -> None:
    """Every parameter of `modules` keeps its bits and has no `.grad`."""
    for i, m in enumerate(modules):
        for n, p in m.named_parameters():
            assert p.grad is None and not p.requires_grad, n
            assert torch.equal(p, snapshot[f"{i}.{n}"]), n


def _port_and_jax_batches(ld, branch, d: dict, extra=()):
    """The branch's batch with the draws, and the JAX package's: the port's
    latent (before the scale factor) as its image, the same text
    embeddings and the branch's `extra` entries."""
    pb = with_draws(branch.embed_batch(host_batch()), d)
    with torch.no_grad():
        z = ld.encode_first_stage(pb["image"], pb["enc_noise"])
    jb = {"image": z.numpy(), "t": d["t"].astype(np.int32), "noise": d["noise"]}
    for k in ("txt_emb", "txt_ids", *extra):
        if k in pb:
            jb[k] = pb[k].numpy()
    return pb, jb


@functools.lru_cache(maxsize=None)
def frozen_stack():
    """One port stack the adapter cases share: each freezes the UNet, and
    the checks hold it unchanged."""
    return port_stack(smoke_config())


def _lora_case():
    cfg = smoke_config(lora={"rank": 4, "scale": 0.75})
    ld, unet, vae, embed = frozen_stack()
    branch = runners.ldm_branch(cfg, ld, unet, embed)
    rng = np.random.default_rng(4)
    with torch.no_grad():                       # random b: every factor has a gradient
        for n, p in branch.params.items():
            if n.endswith(".b"):
                p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape)))
    frozen = _frozen(unet, vae, embed.clip)
    pb, jb = _port_and_jax_batches(ld, branch, draws())
    port = port_step(branch.params, branch.loss_fn, pb)
    assert_frozen(frozen, unet, vae, embed.clip)

    junet = JUNet(**unet_kwargs(cfg))
    jld = jax_ld(lambda p, x, t, ctx, y=None: junet.apply({"params": p}, x, t, ctx))
    base = jax.tree.map(jnp.asarray, jax_weights()[0])
    factors = jax.tree.map(lambda t: t.detach().numpy(), nest_lora(port[2]))
    lowered = lower_jax_step(jax_loss(jld, lambda p: jlora.merge_lora(base, p, 0.75)),
                             factors, jb)
    return port, lowered, {}


@functools.lru_cache(maxsize=None)
def jax_controlnet():
    cfg = smoke_config()
    cn = jcn.controlnet_from_unet_config(unet_kwargs(cfg), hint_downsamples=2)
    port_cn = controlnet_from_unet_config(cfg["unet"]["params"], hint_downsamples=2,
                                          device="cpu")
    return cn, flax_tree(port_cn, 13)


def _controlnet_case():
    """Before its first step the controlled UNet is the base UNet bit for
    bit (the zero convs); then the step with a random branch."""
    cfg = smoke_config(controlnet={"hint": "canny"})
    ld, unet, vae, embed = frozen_stack()
    branch = runners.ldm_branch(cfg, ld, unet, embed)
    pb, jb = _port_and_jax_batches(ld, branch, draws(), extra=("hint",))
    x, t = to_torch(nprand(B, 8, 8, 4, seed=5)), torch.tensor([3, 41])
    with torch.no_grad():
        base = unet(x, t, pb["txt_emb"])
        controlled = branch.ld.apply_model(x, t, {"c_crossattn": [pb["txt_emb"]],
                                                  "c_control": pb["hint"]})
    cn, cparams = jax_controlnet()
    load_flax_params(branch.modules["controlnet"], cparams)
    frozen = _frozen(unet, vae, embed.clip)
    port = port_step(branch.params, branch.loss_fn, pb)
    assert_frozen(frozen, unet, vae, embed.clip)

    junet = JUNet(**unet_kwargs(cfg))
    base_p = jax.tree.map(jnp.asarray, jax_weights()[0])
    jld = jax_ld(jcn.controlled_apply_fn(junet, cn))
    lowered = lower_jax_step(jax_loss(jld, lambda p: {"unet": base_p, "controlnet": p}),
                             cparams, jb)
    return port, lowered, {"starts_at_base": torch.equal(controlled, base)}


def _ip_case():
    cfg = smoke_config(ip_adapter=dict(ip_smoke_config()["ip_adapter"]))
    ld, unet, vae, embed = frozen_stack()
    branch = runners.ldm_branch(cfg, ld, unet, embed)
    rng = np.random.default_rng(6)
    with torch.no_grad():          # the image read differs from the text read
        for p in branch.params.values():
            p.add_(torch.from_numpy(0.1 * rng.standard_normal(p.shape)).float())
    pb, jb = _port_and_jax_batches(ld, branch, draws(), extra=("ip_embed",))
    modules = (unet, vae, embed.clip, branch.modules["embedder"])
    # the keep mask of the (seed, 0x1BAD2) stream at image_dropout 0.5, batch after batch
    stream = np.random.default_rng((cfg["seed"], 0x1BAD2))
    kept = lambda emb: emb.abs().sum(-1).numpy() > 0
    keeps = [(kept(pb["ip_embed"]), stream.random(B) >= 0.5)]
    keeps += [(kept(branch.embed_batch(host_batch(i))["ip_embed"]), stream.random(B) >= 0.5)
              for i in (7, 8, 9)]
    frozen = _frozen(*modules)
    port = port_step(branch.params, branch.loss_fn, pb)
    assert_frozen(frozen, *modules)

    junet = JUNet(**unet_kwargs(cfg))
    base_p = jax.tree.map(jnp.asarray, jax_weights()[0])
    jld = jax_ld(jip.ip_apply_fn(junet, 1.0))
    tree = jax.tree.map(lambda t: t.detach().numpy(), nest_ip(port[2]))
    lowered = lower_jax_step(jax_loss(jld, lambda p: {"unet": base_p, "ip": p}), tree, jb)
    return port, lowered, {"keeps": keeps}


def _cond_case():
    """The UNet and the text tower trained together ({unet, cond}), AdamW
    at weight decay 1e-2, the logvar table learned, the noise offset set
    (the injected noise bypasses it)."""
    cfg = smoke_config(cond_stage={**smoke_config()["cond_stage"], "trainable": True})
    cfg["train"].update(weight_decay=1e-2, noise_offset=0.1, learn_logvar=True)
    ld, unet, vae, embed = port_stack(cfg)
    branch = runners.ldm_branch(cfg, ld, unet, embed)
    pb, jb = _port_and_jax_batches(ld, branch, draws())
    frozen = _frozen(vae)
    port = port_step(branch.params, branch.loss_fn, pb, weight_decay=1e-2, learn_logvar=True)
    assert_frozen(frozen, vae)
    checks = {"txt_ids": "txt_emb" not in pb and pb["txt_ids"].dtype == torch.int64,
              "logvar_grad": port[0].logvar.grad,
              "logvar_moved": sorted(np.flatnonzero(port[0].logvar.detach().numpy()))}

    uparams, cparams = jax_weights()
    junet = JUNet(**unet_kwargs(cfg))
    jclip = JClip(JClipConfig(**cfg["cond_stage"]["params"]))
    jld = jax_ld(lambda p, x, t, ctx, y=None: junet.apply({"params": p["unet"]}, x, t, ctx))
    embed_ids = lambda p, b: {**b, "txt_emb": jclip.apply({"params": p["cond"]}, b["txt_ids"])}
    jb["txt_ids"] = jb["txt_ids"].astype(np.int32)
    lowered = lower_jax_step(jax_loss(jld, batch_of=embed_ids),
                             {"unet": uparams, "cond": cparams}, jb, weight_decay=1e-2,
                             learn_logvar=True)
    return port, lowered, checks


CASES = {"cond": _cond_case, "controlnet": _controlnet_case, "lora": _lora_case,
         "ip_adapter": _ip_case}


@pytest.fixture(scope="module")
def steps():
    """Every branch's port step and its JAX counterpart: {name: (port,
    jax, checks)}."""
    return build_and_run(CASES)


def test_lora_step_matches(steps):
    port, jout, _ = steps["lora"]
    assert_step_matches(port, jout, flat_lora)


def test_controlnet_starts_at_the_base_and_its_step_matches(steps):
    port, jout, checks = steps["controlnet"]
    assert checks["starts_at_base"]
    assert_step_matches(port, jout, as_port)


def test_ip_adapter_step_matches(steps):
    port, jout, _ = steps["ip_adapter"]
    assert_step_matches(port, jout,
                        lambda tree: {k: np.asarray(v) for k, v in flat_ip(tree).items()})


def test_trainable_text_encoder_with_adamw_and_learned_logvar_matches(steps):
    port, jout, checks = steps["cond"]
    assert checks["txt_ids"]
    assert checks["logvar_grad"] is None and checks["logvar_moved"] == [3, 41]

    def names(tree):
        return {**{f"unet.{k}": v for k, v in as_port(tree["unet"]).items()},
                **{f"cond.{k}": v for k, v in as_port(tree["cond"]).items()}}

    assert_step_matches(port, jout, names, weight_decay=1e-2, learn_logvar=True)


def test_ip_adapter_keep_mask_is_the_numpy_stream(steps):
    """The image embedding is zeroed where the (seed, 0x1BAD2) stream's
    draw falls below `image_dropout`, batch after batch."""
    for got, want in steps["ip_adapter"][2]["keeps"]:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("fp32_moments", [False, True])
def test_adamw_matches_optax(fp32_moments):
    """Three AdamW steps (clip 1, lr 1e-2, weight decay 0.1) against optax's
    `chain(clip_by_global_norm, adamw)`; under `float32_moments` on bf16
    parameters, against the JAX package's wrapper, the updates cast to bf16."""
    dtype, jdtype = ((torch.bfloat16, jnp.bfloat16) if fp32_moments
                     else (torch.float32, jnp.float32))
    p0 = {"w": nprand(5, 7, seed=1), "b": nprand(7, seed=2)}
    opt = train.ddpm_optimizer(1e-2, 1.0, weight_decay=0.1)
    jopt = jtrain.ddpm_optimizer(1e-2, 1.0, weight_decay=0.1)
    if fp32_moments:
        opt, jopt = train.float32_moments(opt), jtrain.float32_moments(jopt)
    params = {k: to_torch(v).to(dtype) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v, jdtype) for k, v in p0.items()}
    state, jstate = opt.init(list(params.values())), jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    for i in range(3):
        g = {k: nprand(*v.shape, seed=10 + i, scale=0.7) for k, v in p0.items()}
        opt.update_(list(params.values()), [to_torch(g[k]).to(dtype) for k in params], state)
        up, jstate = jupdate({k: jnp.asarray(v, jdtype) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, up)
        for k in params:
            got, want = params[k].float().numpy(), np.asarray(jparams[k], np.float32)
            if fp32_moments:   # bf16 parameters: the same bits
                assert np.array_equal(got, want), (i, k)
            else:
                assert_close(got, want, 1e-6)


def test_noise_offset_from_injected_draws():
    """`draw_training_noise` is ε + offset·ε_c with ε_c one per (sample,
    channel): the port fed the JAX package's two draws gives its noise; a
    LatentDiffusion with `noise_offset` draws it in its loss."""
    shape = (3, 4, 5, 2)

    @jax.jit
    def jax_draws(key):
        r1, r2 = jax.random.split(key)
        return (jddpm.draw_training_noise(key, shape, 0.1),
                jax.random.normal(r1, shape, jnp.float32),
                jax.random.normal(r2, (3, 1, 1, 2), jnp.float32))

    want, eps, eps_c = map(np.asarray, jax_draws(jax.random.PRNGKey(7)))
    draws_ = iter([to_torch(eps), to_torch(eps_c)])
    with mock.patch.object(torch, "randn", lambda *a, **kw: next(draws_)):
        got = ddpm.draw_training_noise(shape, 0.1)
    assert_close(got, want, 1e-7)

    seen = []
    real = ddpm.draw_training_noise
    ld = LatentDiffusion(process=mock.Mock(schedule=mock.Mock(num_timesteps=T),
                                           p_losses=lambda *a: (a[3], {})),
                         unet_apply=None, encode_fn=lambda x: x, noise_offset=0.1)
    with mock.patch("sd_tpu_torch.diffusion.latent.draw_training_noise",
                    lambda *a, **kw: seen.append(a) or real(*a, **kw)):
        noise, _ = ld.training_loss({"image": torch.zeros(2, 4, 4, 3),
                                     "txt_emb": torch.zeros(2, 3, 8)},
                                    torch.Generator().manual_seed(0))
    assert seen == [((2, 4, 4, 3), 0.1)] and noise.shape == (2, 4, 4, 3)


@pytest.mark.parametrize("policy,runs", [("none", 1), ("dots", 2), ("nothing", 2)])
def test_remat_recomputes_the_frozen_base_as_jax_checkpoint_does(policy, runs):
    """Under remat the backward of a branch over a frozen base runs the
    base's no-grad part again, in the port (`torch.utils.checkpoint`) as in
    the JAX package (`jax.checkpoint`): the decoder's backward reads the
    frozen encoder's skip. So the ControlNet step runs its base encoder
    twice a microbatch in both. log1p marks the frozen part."""
    from sd_tpu.train.remat import remat_apply as jremat_apply
    from sd_tpu_torch.train.remat import remat_apply

    def apply(base, branch, x, log1p, sin, tanh):
        skip = log1p(x @ base[0])                      # the frozen encoder
        h = skip + sin(x @ branch)                     # the trained residual
        return (tanh(h @ base[1]) * skip).sum()        # the decoder

    x = np.linspace(0.1, 1.0, 32, dtype=np.float32).reshape(4, 8)
    base = [np.full((8, 8), 0.1, np.float32), np.full((8, 8), 0.2, np.float32)]
    branch = np.full((8, 8), 0.3, np.float32)

    jfn = jremat_apply(lambda b, p, v: apply(b, p, v, jnp.log1p, jnp.sin, jnp.tanh), policy)
    jaxpr = str(jax.make_jaxpr(jax.grad(lambda p: jfn(base, p, x)))(branch))
    jax_runs = len(re.findall(r"\blog1p\b", jaxpr))

    port_runs = []

    def log1p(v):
        port_runs.append(v)
        return torch.log1p(v)

    fn = remat_apply(lambda b, p, v: apply(b, p, v, log1p, torch.sin, torch.tanh), policy)
    p = torch.from_numpy(branch).requires_grad_(True)
    fn([torch.from_numpy(b) for b in base], p, torch.from_numpy(x)).backward()
    assert p.grad is not None
    assert len(port_runs) == jax_runs == runs


@pytest.mark.parametrize("key", ["hybrid", "concat"])
def test_get_input_matches(key):
    """z and the conditioning dict (`c_crossattn`, `c_concat`, `c_control`,
    `c_ip`) of the port's `get_input` against the JAX package's, the first
    stage the identity in both."""
    b = {"image": nprand(2, 4, 4, 3, seed=1), "txt_emb": nprand(2, 5, 8, seed=2),
         "concat_cond": nprand(2, 4, 4, 5, seed=3), "hint": nprand(2, 16, 16, 3, seed=4),
         "ip_embed": nprand(2, 6, seed=5)}
    z, cond = LatentDiffusion(process=None, unet_apply=None, encode_fn=lambda x: x,
                              conditioning_key=key).get_input(
        {k: to_torch(v) for k, v in b.items()})
    jz, jcond = JLatentDiffusion(process=None, unet_apply=None, encode_fn=lambda x, r: x,
                                 conditioning_key=key).get_input(
        jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(0))
    assert_close(z, jz, 1e-7)
    assert sorted(cond) == sorted(jcond)
    for k, v in cond.items():
        for got, want in zip(v if isinstance(v, list) else [v],
                             jcond[k] if isinstance(jcond[k], list) else [jcond[k]]):
            assert np.array_equal(got.numpy(), np.asarray(want)), k


@pytest.mark.parametrize("blocks,match", [
    ({"lora": {"rank": 2}, "controlnet": {"hint": "canny"}}, "mutually exclusive"),
    ({"ip_adapter": {"n_tokens": 2}, "cond_stage": {"trainable": True}}, "exclusive"),
    ({"lora": {"rank": 2}, "cond_stage": {"trainable": True}}, "exclusive"),
    ({"controlnet": {"hint": "canny"}, "cond_stage": {"trainable": True}}, "exclusive")])
def test_branch_rules_are_the_tpu_packages(blocks, match):
    cfg = smoke_config(**blocks)
    cfg["cond_stage"] = {**ip_smoke_config()["cond_stage"], **blocks.get("cond_stage", {})}
    ld, unet, _, embed = port_stack(cfg)
    with pytest.raises(ValueError, match=match):
        runners.ldm_branch(cfg, ld, unet, embed)
