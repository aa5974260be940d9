"""The VQ-VAE slice of the port (capability config #4) against the JAX
package, fp32 on the CPU at `configs/vq_smoke.yaml` widths (ch 16, (1, 2),
64 codes of width 4, 32² images), every random draw injected:

* each quantizer family (argmin with both β placements, Gumbel-softmax with
  the JAX package's own Gumbel draw handed in, the EMA codebook) and
  `ema_quantize`: z_q, the loss, perplexity and the straight-through
  gradients within 1e-4·max(1, max|ref|) (`MODULE_TOL`), the indices equal
  wherever the best two candidates differ by more than 1e-5 of the best
  (at a near-tie either is right, and z_q must be that code), the EMA
  codebook after an update;
* `VQModel` per family: reconstruction, codebook loss, perplexity and
  indices under the same rule (where a near-tie picked another code, the
  reconstruction is held against the JAX decoder on the port's codes);
* one VQ GAN step per family (`make_vq_gan_train_step`) against the JAX
  step (jitted: its compile takes less time than its op-by-op run here)
  from the same state: every log within `MODULE_TOL`;
  with plain SGD at lr 1 (the update is the gradient) the generator's and
  the discriminator's gradients within ‖Δ‖₂ ≤ 1e-4·‖ref‖₂ and each
  parameter's within 1e-4·‖ref‖₂ plus 1e-6 of its network's ‖ref‖₂; the
  EMA codebook after the step within `MODULE_TOL`;
* `gumbel_temp_schedule`, the codebooks' initialisers, the carry-over of
  the 'codebook' collection, the config functions against their YAML, the
  refusals, and `train_vq` running two steps per family on the CPU (the
  argmin family under the bf16 parameter policy).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from test_torch_helpers import (COMPILE_OPTIONS, MODULE_TOL, assert_close, flax_init, nprand,
                                port, to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.losses.gan import GanLossConfig as JGanLossConfig
from sd_tpu.models import discriminator as jdisc
from sd_tpu.models import lpips as jlpips
from sd_tpu.models import quantize as jq
from sd_tpu.models.autoencoder import VQModel as JVQModel
from sd_tpu.train import gan as jgan
from sd_tpu_torch.core.config import (vq_64_train_config, vq_128_train_config,
                                      vq_smoke_config)
from sd_tpu_torch.losses.gan import GanLossConfig
from sd_tpu_torch.models import quantize as q
from sd_tpu_torch.models.autoencoder import VQModel
from sd_tpu_torch.models.discriminator import NLayerDiscriminator
from sd_tpu_torch.nn.layers import dropout_rng
from sd_tpu_torch.models.lpips import LPIPS
from sd_tpu_torch.train import gan as gan_train
from sd_tpu_torch.train.runners import train_vq
from sd_tpu_torch.weights import _flatten, init_params_, load_flax_codebook, torch_name

SMOKE = vq_smoke_config()
VQ = SMOKE["model"]["params"]
PX = SMOKE["train"]["image_size"]
K, D = VQ["n_embed"], VQ["embed_dim"]
FAMILIES = ("vq", "gumbel", "ema")


def _torch_flat(tree) -> dict[str, np.ndarray]:
    """A flax tree as {torch name: array in the torch layout}."""
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf, np.float32)
        name, perm = torch_name(path, arr.ndim)
        out[name] = arr if perm is None else arr.transpose(perm)
    return out


def _codebook(seed: int, n_e: int = K, e_dim: int = D) -> dict:
    """An EMA 'codebook' collection mid-training: random weights, positive
    cluster sizes, random sums."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return {"weight": f32(rng.standard_normal((n_e, e_dim))),
            "cluster_size": f32(rng.uniform(0.5, 3.0, n_e)),
            "embed_avg": f32(rng.standard_normal((n_e, e_dim)))}


def assert_indices(got, want, dist) -> None:
    """Equal wherever the best two candidates of `dist` [N, K] (lower is
    better) differ by more than 1e-5 of the best; else `got` is one of the
    two."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    order = np.argsort(dist, axis=1)
    best = np.take_along_axis(dist, order[:, :2], axis=1)
    clear = best[:, 1] - best[:, 0] > 1e-5 * np.maximum(np.abs(best[:, 0]), 1e-30)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    assert all(got[i] in order[i, :2] for i in np.flatnonzero(~clear))


def _distances(z, codebook) -> np.ndarray:
    z64 = np.asarray(z, np.float64).reshape(-1, codebook.shape[1])
    e64 = np.asarray(codebook, np.float64)
    return ((z64[:, None, :] - e64[None]) ** 2).sum(-1)


# -- the quantizers -------------------------------------------------------------------


@pytest.mark.parametrize("legacy", [True, False])
def test_vector_quantizer_matches(legacy):
    z, w = nprand(2, 4, 4, D, seed=1), nprand(2, 4, 4, D, seed=2)
    codebook = nprand(K, D, seed=3, scale=0.7)
    jmod = jq.VectorQuantizer(n_e=K, e_dim=D, beta=0.25, legacy=legacy)
    # the JAX side jitted throughout: one compile, not one per eager op
    (zq, loss, (ppl, _, idx)) = jax.jit(jmod.apply)({"params": {"embedding": codebook}},
                                                    jnp.asarray(z))
    mod = port(q.VectorQuantizer(K, D, beta=0.25, legacy=legacy, device="cpu"),
               {"embedding": codebook})
    tzq, tloss, (tppl, _, tidx) = mod(to_torch(z))
    assert_indices(tidx, idx, _distances(z, codebook))
    # each row is its code, up to the straight-through sum's rounding
    np.testing.assert_allclose(tzq.detach().numpy().reshape(-1, D), codebook[tidx.numpy()],
                               rtol=0, atol=1e-6)
    assert_close(tzq, zq)
    assert_close(tloss, loss)
    assert_close(tppl, ppl)

    def jfn(z, e):
        zq, loss, _ = jmod.apply({"params": {"embedding": e}}, z)
        return jnp.sum(zq * w) + loss

    jgz, jge = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jnp.asarray(z), jnp.asarray(codebook))

    mod.requires_grad_(True)
    tz = to_torch(z).requires_grad_()
    tzq, tloss, _ = mod(tz)
    ((tzq * to_torch(w)).sum() + tloss).backward()
    assert_close(tz.grad, jgz)
    assert_close(mod.weight.grad, jge)


def test_vector_quantizer_sane_index_shape_and_lookup():
    codebook = nprand(K, D, seed=4)
    mod = port(q.VectorQuantizer(K, D, sane_index_shape=True, device="cpu"),
               {"embedding": codebook})
    zq, _, (_, _, idx) = mod(to_torch(nprand(2, 3, 5, D, seed=5)))
    assert idx.shape == (2, 3, 5)
    torch.testing.assert_close(mod.get_codebook_entry(idx, (2, 3, 5, D)), zq.detach(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("deterministic", [False, True])
def test_gumbel_quantize_matches(deterministic):
    z, w = nprand(2, 4, 4, D, seed=6), nprand(2, 4, 4, D, seed=7)
    jmod = jq.GumbelQuantize(n_e=K, e_dim=D, kl_weight=5e-3)
    params = flax_init(jmod, jnp.asarray(z), seed=8)
    key, temp = jax.random.PRNGKey(9), 0.7
    gumbel = jax.random.gumbel(key, (2, 4, 4, K), jnp.float32)

    def jfn(z, p):
        zq, kl, _ = jmod.apply({"params": p}, z, rng=key, temp=temp,
                               deterministic=deterministic)
        return jnp.sum(zq * w) + kl

    zq, kl, (ppl, _, idx) = jax.jit(lambda p, z: jmod.apply(
        {"params": p}, z, rng=key, temp=temp, deterministic=deterministic))(params, jnp.asarray(z))
    jgz, jgp = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jnp.asarray(z), params)
    mod = port(q.GumbelQuantize(K, D, kl_weight=5e-3, device="cpu"), params)
    mod.requires_grad_(True)
    tz = to_torch(z).requires_grad_()
    tzq, tkl, (tppl, _, tidx) = mod(tz, gumbel=to_torch(gumbel), temp=temp,
                                    deterministic=deterministic)
    ((tzq * to_torch(w)).sum() + tkl).backward()
    # the argmax of the (noisy) logits: compare where the best two differ
    logits = np.asarray(mod.proj(to_torch(z)).detach().float())
    if not deterministic:
        logits = logits + np.asarray(gumbel)
    assert_indices(tidx, idx, -logits.reshape(-1, K))
    assert_close(tzq, zq)
    assert_close(tkl, kl)
    assert_close(tppl, ppl)
    assert_close(tz.grad, jgz)
    want = _torch_flat(jgp)
    for name, p in mod.named_parameters():
        assert_close(p.grad, want[name])


def test_ema_vector_quantizer_matches():
    z, w = nprand(2, 4, 4, D, seed=10), nprand(2, 4, 4, D, seed=11)
    cb = _codebook(12)
    jmod = jq.EMAVectorQuantizer(n_e=K, e_dim=D, beta=0.25, decay=0.9)
    (zq, loss, (ppl, _, idx)), mut = jax.jit(lambda z: jmod.apply(
        {"codebook": cb}, z, update=True, mutable=["codebook"]))(jnp.asarray(z))
    jgz = jax.jit(jax.grad(lambda z: jnp.sum(jmod.apply({"codebook": cb}, z)[0] * w)
                           + jmod.apply({"codebook": cb}, z)[1]))(jnp.asarray(z))
    mod = q.EMAVectorQuantizer(K, D, beta=0.25, decay=0.9, device="cpu")
    load_flax_codebook(mod, cb)
    assert not any(b.requires_grad for b in mod.buffers()) and not list(mod.parameters())
    tz = to_torch(z).requires_grad_()
    tzq, tloss, (tppl, _, tidx) = mod(tz, update=True)
    ((tzq * to_torch(w)).sum() + tloss).backward()
    assert_indices(tidx, idx, _distances(z, cb["weight"]))
    # z_q from the codebook as it was before the update
    np.testing.assert_allclose(tzq.detach().numpy().reshape(-1, D),
                               cb["weight"][tidx.numpy()], rtol=0, atol=1e-6)
    assert_close(tzq, zq)
    assert_close(tloss, loss)
    assert_close(tppl, ppl)
    assert_close(tz.grad, jgz)
    for name, want in mut["codebook"].items():
        assert_close(getattr(mod, name), want)
    # no update: the buffers stay
    before = {n: b.clone() for n, b in mod.named_buffers()}
    mod(to_torch(z))
    assert all(torch.equal(b, before[n]) for n, b in mod.named_buffers())


@pytest.mark.parametrize("update", [True, False])
def test_ema_quantize_matches(update):
    z = nprand(3, 5, D, seed=13)
    cb = _codebook(14)
    jcb = jq.EmaCodebook(**{k: jnp.asarray(v) for k, v in cb.items()}, decay=0.95)
    zq, new, ppl, idx = jq.ema_quantize(jcb, jnp.asarray(z), update=update)
    tcb = q.EmaCodebook(**{k: to_torch(v) for k, v in cb.items()}, decay=0.95)
    tzq, tnew, tppl, tidx = q.ema_quantize(tcb, to_torch(z), update=update)
    assert_indices(tidx, idx, _distances(z, cb["weight"]))
    assert_close(tzq, zq)
    assert_close(tppl, ppl)
    for name in ("weight", "cluster_size", "embed_avg"):
        assert_close(getattr(tnew, name), getattr(new, name))
        assert torch.equal(getattr(tcb, name), to_torch(cb[name]))    # a new codebook
    created = q.EmaCodebook.create(torch.Generator().manual_seed(0), K, D)
    assert torch.equal(created.embed_avg, created.weight) and not created.cluster_size.any()


def test_codebook_initialisers():
    """`init_params_` draws each family's codebook from the TPU package's
    distribution: U(−1/K, 1/K), N(0, 1), and for the EMA codebook N(0, 1)
    weights, zero cluster sizes and the weights as the sums."""
    gen = torch.Generator().manual_seed(0)
    n = 4096
    vq = q.VectorQuantizer(n, 8, device="cpu")
    gumbel = q.GumbelQuantize(n, 8, device="cpu")
    ema = q.EMAVectorQuantizer(n, 8, device="cpu")
    for mod in (vq, gumbel, ema):
        init_params_(mod, gen)
    assert vq.weight.abs().max() <= 1 / n and vq.weight.std() > 0.5 / (n * 3**0.5)
    assert abs(float(gumbel.weight.std()) - 1) < 0.05 and gumbel.proj.weight.any()
    assert not gumbel.proj.bias.any()
    assert abs(float(ema.weight.std()) - 1) < 0.05
    assert torch.equal(ema.embed_avg, ema.weight) and not ema.cluster_size.any()


# -- the VQ model ------------------------------------------------------------------


def _vq_model_pair(family: str, seed: int):
    mp = dict(VQ, quantizer_type=family)
    jvq = JVQModel(**mp)
    params = flax_init(jvq, jnp.zeros((1, PX, PX, 3)), seed=seed)
    state = {"codebook": {"quantize": _codebook(seed + 1)}} if family == "ema" else {}
    tvq = port(VQModel(**mp, device="cpu"), params)
    if state:
        load_flax_codebook(tvq, state["codebook"])
    return jvq, params, state, tvq


def _gumbel_draw(key, b: int):
    return jax.random.gumbel(key, (b, PX // 2, PX // 2, K), jnp.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_vq_model_matches(family):
    jvq, params, state, tvq = _vq_model_pair(family, seed=20)
    x = np.tanh(nprand(2, PX, PX, 3, seed=21))
    key = jax.random.PRNGKey(22)
    kw = dict(rng=key, temp=0.8, deterministic=False) if family == "gumbel" else {}
    (recon, loss, (ppl, _, idx)), mut = jvq.apply(
        {"params": params, **state}, jnp.asarray(x), update=family == "ema",
        mutable=list(state), **kw)
    tkw = dict(gumbel=to_torch(_gumbel_draw(key, 2)), temp=0.8, deterministic=False)
    with torch.no_grad():
        trecon, tloss, (tppl, _, tidx) = tvq(to_torch(x), update=family == "ema",
                                             **(tkw if family == "gumbel" else {}))
        h = tvq.encode_pre_quant(to_torch(x)).numpy()
    if family == "gumbel":
        logits = np.asarray(tvq.quantize.proj(to_torch(h)).float()) + np.asarray(tkw["gumbel"])
        dist = -logits.reshape(-1, K)
    else:
        dist = _distances(h, (state["codebook"]["quantize"]["weight"] if family == "ema"
                              else params["quantize"]["embedding"]))
    assert_indices(tidx, idx, dist)
    if np.array_equal(tidx.numpy().reshape(-1), np.asarray(idx).reshape(-1)):
        assert_close(trecon, recon)
        assert_close(tloss, loss)
    else:
        # a near-tie took the other code: the JAX decoder on the port's codes
        codes = tvq.quantize.get_codebook_entry(tidx, (2, PX // 2, PX // 2, D))
        ref = jvq.apply({"params": params, **state}, jnp.asarray(codes.detach().numpy()),
                        method=JVQModel.decode)
        assert_close(trecon, ref)
    assert_close(tppl, ppl)
    if family == "ema":
        for name, want in mut["codebook"]["quantize"].items():
            assert_close(getattr(tvq.quantize, name), want)


def test_vq_model_decode_code_and_pre_quant():
    jvq, params, _, tvq = _vq_model_pair("vq", seed=23)
    x = np.tanh(nprand(1, PX, PX, 3, seed=24))
    with torch.no_grad():
        h = tvq.encode_pre_quant(to_torch(x))
        zq, _, (_, _, idx) = tvq.encode(to_torch(x))
        assert_close(h, jax.jit(lambda p, x: jvq.apply(
            {"params": p}, x, method=JVQModel.encode_pre_quant))(params, jnp.asarray(x)))
        shape = (1, PX // 2, PX // 2, D)
        codes = tvq.quantize.get_codebook_entry(idx, shape)
        torch.testing.assert_close(codes, zq, rtol=0, atol=1e-6)
        assert torch.equal(tvq.decode_code(idx, shape), tvq.decode(codes))


def test_vq_model_refusals():
    """(Named when `remap` and dropout were refused.) Both families build
    their index remap (held against the JAX package in
    `test_torch_quantize_codec_heads.py`); per-level attention; dropout acts
    inside a step's `dropout_rng` only, and not in eval mode."""
    vq = VQModel(**VQ, remap=[0, 1, 2], device="cpu")
    assert vq.quantize.used.tolist() == [0, 1, 2] and vq.quantize.re_embed == 3
    gumbel = VQModel(**VQ, quantizer_type="gumbel", remap=[0, 1, 2], device="cpu")
    assert gumbel.quantize.used.tolist() == [0, 1, 2]
    # per-level attention is ported: a 16² level attends (`test_torch_codec_attn.py`)
    attn = VQModel(**{**VQ, "attn_resolutions": [16]}, device="cpu")
    assert attn.encoder.attn_names and "AttnBlock_1" in dict(attn.decoder.named_children())
    drop = VQModel(**VQ, dropout=0.1, device="cpu")
    init_params_(drop, torch.Generator().manual_seed(0))
    x = torch.tanh(torch.from_numpy(nprand(1, PX, PX, 3, seed=5)))
    with torch.no_grad():
        det = drop(x)[0]
        with dropout_rng(torch.Generator().manual_seed(1)):
            assert not torch.equal(drop(x)[0], det)
            assert torch.equal(drop.eval()(x)[0], det)


# -- one VQ GAN step --------------------------------------------------------------------


class _SGD:
    """p ← p − g: the update is the gradient itself."""

    def init(self, params):
        return None

    @torch.no_grad()
    def update_(self, params, grads, state):
        for p, g in zip(params, grads):
            p.sub_(g)


GUMBEL_SCHEDULE = dict(temp_min=0.05, anneal_rate=0.05)
STEP = {"vq": 0, "gumbel": 3, "ema": 0}   # the Gumbel step starts later: temp < temp_init


def _gan_setup(family: str):
    jvq, vparams, mstate, tvq = _vq_model_pair(family, seed=30)
    x0 = jnp.zeros((1, PX, PX, 3))
    jd = jdisc.NLayerDiscriminator(**SMOKE["discriminator"])
    dparams = flax_init(jd, x0, seed=31)
    # LPIPS on the argmin family (the full configs' perceptual term), off on
    # the others (the smoke config's)
    loss = dict(SMOKE["loss"], perceptual_weight=1.0 if family == "vq" else 0.0)
    lparams = flax_init(jlpips.LPIPS(), x0, x0, seed=32) if family == "vq" else None
    x = np.clip(nprand(2, PX, PX, 3, seed=33, scale=0.6), -1, 1)
    return dict(jvq=jvq, vparams=vparams, mstate=mstate, tvq=tvq, jd=jd, dparams=dparams,
                lparams=lparams, loss=loss, x=x)


def _lower_jax_vq_step(s, family):
    """The JAX package's jitted step of `family` from its initial state,
    lowered: (state, lowered step, its arguments)."""
    jvq = s["jvq"]

    if family == "vq":
        apply, stateful = (lambda p, x: jvq.apply({"params": p}, x)), False
    else:
        def apply(p, ms, x, rng, temp, update):
            vs = {"params": p, **ms}
            kw = dict(rng=rng, temp=temp, deterministic=False)
            if update and "codebook" in ms:
                out, mut = jvq.apply(vs, x, update=True, mutable=["codebook"], **kw)
                return (*out, {**ms, "codebook": mut["codebook"]})
            return (*jvq.apply(vs, x, update=False, **kw), ms)
        stateful = True
    lpips = None
    if s["lparams"] is not None:
        lpips = lambda a, b: jlpips.LPIPS().apply({"params": s["lparams"]}, a, b)
    temp_fn = (jgan.gumbel_temp_schedule(temp_init=1.0, **GUMBEL_SCHEDULE)
               if family == "gumbel" else None)
    opt = optax.sgd(1.0)
    state = jgan.init_gan_state(s["vparams"], {"params": s["dparams"]}, opt, opt,
                                model_state=s["mstate"])
    state = jgan.GanTrainState(**{**state.__dict__, "step": jnp.asarray(STEP[family])})
    step = jgan.make_vq_gan_train_step(apply, s["jd"], lpips, opt, opt,
                                       JGanLossConfig(**s["loss"]), stateful=stateful,
                                       temp_fn=temp_fn, jit=True)
    args = (state, jnp.asarray(s["x"]), jax.random.PRNGKey(0))
    return state, step.lower(*args), args


@pytest.fixture(scope="module")
def jax_vq_steps():
    """{family: (setup, JAX state before, state after, logs)}: each family's
    step lowered in turn and compiled in a thread as soon as it is lowered
    (XLA compiles outside the GIL, so the next family traces meanwhile)."""
    built = {}
    with ThreadPoolExecutor(len(FAMILIES)) as ex:
        for family in FAMILIES:
            s = _gan_setup(family)
            state, lowered, args = _lower_jax_vq_step(s, family)
            built[family] = (s, state, args,
                             ex.submit(lowered.compile, compiler_options=COMPILE_OPTIONS))
        return {family: (s, state, *compiled.result()(*args))
                for family, (s, state, args, compiled) in built.items()}


def _torch_vq_step(s, family):
    tvq = s["tvq"]
    td = port(NLayerDiscriminator(**SMOKE["discriminator"], device="cpu"), s["dparams"])
    lpips = port(LPIPS(device="cpu"), s["lparams"]) if s["lparams"] is not None else None
    # the Gumbel draw the JAX step's quantizer makes: its key is the step's
    # rng folded with the step count
    gumbel = to_torch(_gumbel_draw(jax.random.fold_in(jax.random.PRNGKey(0), STEP[family]), 2))

    def vq_apply(x, generator, temp):
        return tvq(x, gumbel=gumbel, temp=temp, update=True, deterministic=False)

    temp_fn = (gan_train.gumbel_temp_schedule(temp_init=1.0, **GUMBEL_SCHEDULE)
               if family == "gumbel" else None)
    opt = _SGD()
    state = gan_train.init_gan_state(tvq, td, opt, opt)
    state.step = STEP[family]
    step = gan_train.make_vq_gan_train_step(vq_apply, td, lpips, opt, opt,
                                            GanLossConfig(**s["loss"]), temp_fn=temp_fn)
    before = {k: v.detach().clone() for k, v in {**state.params_g, **state.params_d}.items()}
    logs = step(state, to_torch(s["x"]), None)
    return before, state, logs


@pytest.mark.parametrize("family", FAMILIES)
def test_one_vq_gan_step_matches(family, jax_vq_steps):
    s, jold, jnew, jlogs = jax_vq_steps[family]
    before, state, logs = _torch_vq_step(s, family)
    assert state.step == int(jnew.step) == STEP[family] + 1
    assert sorted(logs) == sorted(jlogs)
    for key, want in jlogs.items():
        assert_close(torch.as_tensor(logs[key]), np.asarray(want, np.float32))
    assert float(logs["train/d_weight"]) > 0 and float(logs["train/disc_factor"]) == 1.0

    old = {**_torch_flat(jold.params_g["model"]), **_torch_flat(jold.params_d)}
    new = {**_torch_flat(jnew.params_g["model"]), **_torch_flat(jnew.params_d)}
    old["logvar"], new["logvar"] = (np.asarray(t.params_g["logvar"], np.float32)
                                    for t in (jold, jnew))
    now = {**state.params_g, **state.params_d}
    assert sorted(now) == sorted(new)
    for names in (state.params_g, state.params_d):
        got = {n: (before[n] - now[n]).detach().numpy() for n in names}
        want = {n: old[n] - new[n] for n in names}
        for n in names:
            np.testing.assert_array_equal(before[n].numpy(), old[n])
        total = math.sqrt(sum(float(np.sum(w * w)) for w in want.values()))
        err = math.sqrt(sum(float(np.sum((got[n] - want[n]) ** 2)) for n in names))
        assert err <= 1e-4 * total
        for n in names:
            assert np.linalg.norm(got[n] - want[n]) <= (1e-4 * np.linalg.norm(want[n])
                                                        + 1e-6 * total), n
    if family == "ema":
        # the codebook: updated once, from the step's assignments; no
        # optimizer saw it
        assert sorted(state.model_state) == ["quantize.cluster_size", "quantize.embed_avg",
                                             "quantize.weight"]
        assert not any(n.startswith("quantize.") for n in state.params_g)
        for name, want in _torch_flat(jnew.model_state["codebook"]).items():
            assert_close(state.model_state[name], want)
        assert not np.allclose(jnew.model_state["codebook"]["quantize"]["weight"],
                               s["mstate"]["codebook"]["quantize"]["weight"])
    else:
        assert state.model_state == {}


# -- the bf16 parameter policy against the JAX package's --------------------------------

# the bf16 step against the JAX package's bf16 step: the port's distance
# from its own fp32 step (the bf16 policy's effect, e16) at most twice the
# JAX package's, and the two bf16 steps no farther apart than BF16_SPREAD
# times two independent draws of that effect, √(e_port² + e_jax²) (over 6
# seeds the generator's were 0.65-0.83 of it, the discriminator's 0.92-0.99)
BF16_SPREAD = 1.25


class _GradRecorder:
    """Keeps the gradients it is handed (fp32) and changes no parameter."""

    def init(self, params):
        return None

    def update_(self, params, grads, state):
        self.grads = [g.detach().float().clone() for g in grads]


def _jax_grad_recorder():
    """An optax transformation whose state is the last gradient (fp32)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g),
                              jax.tree.map(lambda a: a.astype(jnp.float32), g)))


def test_bf16_vq_step_matches_the_jax_packages_bf16_step():
    """One step of `vq_smoke_config()`'s recipe (argmin codebook, ActNorm
    PatchGAN from step 0) under the bf16 parameter policy in both packages,
    and in fp32 in both, from the same bf16-rounded weights and images and on
    the same codes: every run quantizes to the codes the port's bf16 run
    chose (the argmin flips at near-ties under any rounding), by patching
    each package's `_nearest_code`. The fp32 steps agree to 1e-4 of the
    gradients' norm; each package's bf16 step is as far from its own fp32
    step as at most twice the JAX package's is from its own, and the two
    bf16 steps are no farther apart than two independent draws of those
    distances (times BF16_SPREAD): what bf16 moves is the policy's, not a
    fault of the port. (The JAX package's discriminator gradients move ~4×
    the port's under bf16 on the CPU, where XLA runs the bf16 convs.)"""
    bf16 = lambda tree: jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), tree)
    x0 = jnp.zeros((1, PX, PX, 3))
    vparams = bf16(flax_init(JVQModel(**VQ), x0, seed=50))
    jd = jdisc.NLayerDiscriminator(**SMOKE["discriminator"])
    dparams = bf16(flax_init(jd, x0, seed=150))
    x = np.clip(nprand(2, PX, PX, 3, seed=250, scale=0.6), -1, 1)
    loss_cfg = SMOKE["loss"]
    codes = []

    def torch_step(param_dtype):
        tvq = port(VQModel(**VQ, device="cpu"), vparams)
        td = port(NLayerDiscriminator(**SMOKE["discriminator"], device="cpu"), dparams)
        opt_g, opt_d = _GradRecorder(), _GradRecorder()
        state = gan_train.init_gan_state(tvq, td, opt_g, opt_d, param_dtype=param_dtype)
        step = gan_train.make_vq_gan_train_step(
            lambda x, g, temp: tvq(x, update=True, deterministic=False), td, None,
            opt_g, opt_d, GanLossConfig(**loss_cfg))
        own = q._nearest_code

        def nearest(z, e):
            if not codes:
                codes.append(own(z, e))
            return codes[0]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(q, "_nearest_code", nearest)
            logs = step(state, to_torch(x), None)
        grads = {**dict(zip(state.params_g, opt_g.grads)),
                 **{"d/" + n: g for n, g in zip(state.params_d, opt_d.grads)}}
        return {k: float(v) for k, v in logs.items()}, {k: g.numpy() for k, g in grads.items()}

    def lower_jax_step(dtype):
        """The JAX step on the port's bf16 codes, lowered, and its arguments."""
        jvq = JVQModel(**VQ, dtype=dtype)
        opt = _jax_grad_recorder()
        state = jgan.init_gan_state(vparams, {"params": dparams}, opt, opt, param_dtype=dtype)
        step = jgan.make_vq_gan_train_step(lambda p, x: jvq.apply({"params": p}, x), jd, None,
                                           opt, opt, JGanLossConfig(**loss_cfg), jit=True)
        fixed = jnp.asarray(codes[0].numpy().astype(np.int32))
        args = (state, jnp.asarray(x), jax.random.PRNGKey(0))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jq, "_nearest_code", lambda z, e: fixed)
            return step.lower(*args), args

    def jax_result(new, logs):
        grads = _torch_flat(new.opt_state_g["model"])
        grads["logvar"] = np.asarray(new.opt_state_g["logvar"])
        grads.update({"d/" + n: g for n, g in _torch_flat(new.opt_state_d).items()})
        return {k: float(v) for k, v in logs.items()}, grads

    port16 = torch_step(torch.bfloat16)
    # both JAX steps compile in threads while the port's fp32 step runs
    with ThreadPoolExecutor(2) as ex:
        steps = []
        for dtype in (jnp.bfloat16, None):
            lowered, args = lower_jax_step(dtype)
            steps.append((ex.submit(lowered.compile, compiler_options=COMPILE_OPTIONS), args))
        port32 = torch_step(None)
        jax16, jax32 = (jax_result(*compiled.result()(*args)) for compiled, args in steps)
    assert sorted(port16[1]) == sorted(jax16[1])
    for names in ([n for n in jax16[1] if not n.startswith("d/")],
                  [n for n in jax16[1] if n.startswith("d/")]):
        def dist(a, b):
            num = sum(float(np.sum((a[1][n] - b[1][n]) ** 2)) for n in names)
            return math.sqrt(num / sum(float(np.sum(b[1][n] ** 2)) for n in names))
        assert dist(port32, jax32) <= 1e-4
        e_port, e_jax = dist(port16, port32), dist(jax16, jax32)
        assert e_port <= 2.0 * e_jax, (e_port, e_jax)
        assert dist(port16, jax16) <= BF16_SPREAD * math.hypot(e_port, e_jax), (
            dist(port16, jax16), e_port, e_jax)
    assert sorted(port16[0]) == sorted(jax16[0])
    for key, want in jax32[0].items():
        assert abs(port32[0][key] - want) <= MODULE_TOL * max(1.0, abs(want)), key


def test_gumbel_temp_schedule_matches():
    kw = dict(temp_init=0.9, temp_min=0.05, anneal_rate=3e-4)
    got, want = gan_train.gumbel_temp_schedule(**kw), jgan.gumbel_temp_schedule(**kw)
    for step in (0, 1, 1000, 10000, 20000):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6)
    assert got(20000) == pytest.approx(0.05)


# -- the runner ------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_train_vq_runs_on_the_cpu(family):
    """Two steps per family: the argmin family under the bf16 parameter
    policy (its codebook bf16, the logvar, the Adam moments fp32), the EMA
    codebook fp32 buffers that moved and no optimizer sees, the Gumbel
    temperature from the schedule."""
    cfg = vq_smoke_config()
    cfg["model"]["params"]["quantizer_type"] = family
    if family == "vq":
        cfg["train"]["param_dtype"] = "bfloat16"
    if family == "gumbel":
        cfg["gumbel_schedule"] = dict(GUMBEL_SCHEDULE)
    rng = np.random.default_rng(0)
    batches = [{"image": rng.uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)}
               for _ in range(3)]
    state, hist = train_vq(cfg, batches, max_steps=2, device="cpu")
    assert len(hist) == 2 and state.step == 2
    assert all(math.isfinite(v) for row in hist for v in row.values())
    assert all(row["train/perplexity"] >= 1 for row in hist)
    assert state.params_g["logvar"].dtype == torch.float32
    dtypes = {p.dtype for n, p in state.params_g.items() if n != "logvar"}
    if family == "vq":
        assert dtypes == {torch.bfloat16} and state.params_g["quantize.weight"].dtype == \
            torch.bfloat16
        assert {p.dtype for p in state.params_d.values()} == {torch.bfloat16}
        assert {m.dtype for m in state.opt_state_g.mu + state.opt_state_g.nu} == {
            torch.float32}
    if family == "ema":
        assert {b.dtype for b in state.model_state.values()} == {torch.float32}
        assert state.model_state["quantize.cluster_size"].any()          # it moved
        assert "quantize.weight" not in state.params_g
    if family == "gumbel":
        assert "quantize.proj.weight" in state.params_g


def test_train_vq_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vq(vq_128_train_config(), [])


@pytest.mark.parametrize("fn,path", [(vq_128_train_config, "configs/vq_128_catdog.yaml"),
                                     (vq_64_train_config, "configs/vq_64_catdog.yaml"),
                                     (vq_smoke_config, "configs/vq_smoke.yaml")])
def test_config_functions_equal_their_yaml(fn, path):
    with open(Path(__file__).resolve().parents[1] / path) as f:
        assert fn() == yaml.safe_load(f)
