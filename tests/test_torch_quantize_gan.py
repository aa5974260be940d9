"""The quantizers' index remap, the one-hot VQ, the GAN generator, the
Gaussian helpers and the remaining LR schedules of the port against the
JAX package, fp32 on the CPU at tiny widths:

* `VectorQuantizer(remap=…)` with `unknown_index` "random" (the JAX draws
  handed in), "extra" and an integer, the remap from a list and from a
  `.npy` file: z_q, loss and perplexity within 1e-5·max(1, max|ref|)
  (`TOL`), the remapped indices equal, `get_codebook_entry` through the
  remap; `GumbelQuantize(remap=…)` with the JAX Gumbel draw handed in;
  `VectorQuantizerOneHot` (z_q, loss, perplexity, the one-hot matrix and
  indices);
* `ResidualBlock` and `UNetGenerator` (ngf 8, two residual blocks, 16²);
* `normal_kl` and `Dirac`;
* `lambda_warmup_cosine_schedule`, `lambda_warmup_cosine_schedule_v2` and
  `reduce_on_plateau` step for step against the JAX schedules and optax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import assert_close, flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core import distributions as jdist
from sd_tpu.models import discriminator as jdisc
from sd_tpu.models import quantize as jq
from sd_tpu.train import lr_schedules as jlr
from sd_tpu_torch.core.distributions import Dirac, normal_kl
from sd_tpu_torch.models import discriminator as disc
from sd_tpu_torch.models import quantize as q
from sd_tpu_torch.train import lr_schedules as lr
from sd_tpu_torch.weights import init_params_

TOL = 1e-5
N_E, E_DIM = 16, 4
USED = [1, 3, 4, 7, 9, 12]


def _z(seed: int) -> np.ndarray:
    return nprand(2, 4, 4, E_DIM, seed=seed)


@pytest.mark.parametrize("unknown", ["random", "extra", 2])
def test_vector_quantizer_remap_matches(tmp_path, unknown):
    remap = USED
    if unknown == "random":
        remap = str(tmp_path / "used.npy")
        np.save(remap, np.asarray(USED, np.int64))
    jmod = jq.VectorQuantizer(N_E, E_DIM, remap=remap, unknown_index=unknown,
                              sane_index_shape=True)
    z = _z(1)
    params = flax_init(jmod, jnp.asarray(z), seed=2)
    key = jax.random.PRNGKey(3)
    zq, loss, (perp, _, idx) = jmod.apply({"params": params}, jnp.asarray(z), key)
    tmod = port(q.VectorQuantizer(N_E, E_DIM, remap=remap, unknown_index=unknown,
                                  sane_index_shape=True, device="cpu"), params)
    draws = None
    if unknown == "random":
        draws = to_torch(jax.random.randint(key, (2, 16), 0, len(USED), jnp.int32))
    got_zq, got_loss, (got_perp, _, got_idx) = tmod(to_torch(z), remap_draws=draws)
    for got, ref in ((got_zq, zq), (got_loss, loss), (got_perp, perp)):
        assert_close(got, ref, TOL)
    assert got_idx.tolist() == np.asarray(idx).tolist()
    assert tmod.re_embed == len(USED) + (unknown == "extra")
    raw = np.asarray(jax.jit(lambda z: jq._nearest_code(z, params["embedding"]))(
        jnp.asarray(z.reshape(-1, E_DIM))))
    assert (~np.isin(raw, USED)).any() and np.isin(raw, USED).any()   # both kinds of codes
    ref_codes = jmod.apply({"params": params}, idx, (2, 4, 4, E_DIM),
                           method=jq.VectorQuantizer.get_codebook_entry)
    assert_close(tmod.get_codebook_entry(got_idx, (2, 4, 4, E_DIM)), ref_codes, TOL)
    assert tmod.unmap_to_all(torch.arange(len(USED))).tolist() == USED


def test_gumbel_quantize_remap_matches():
    jmod = jq.GumbelQuantize(N_E, E_DIM, remap=USED)
    z = _z(4)
    params = flax_init(jmod, jnp.asarray(z), seed=5)
    key = jax.random.PRNGKey(6)
    zq, kl, (perp, _, idx) = jmod.apply({"params": params}, jnp.asarray(z), key, temp=0.7)
    gumbel = jax.random.gumbel(key, (2, 4, 4, N_E), jnp.float32)
    tmod = port(q.GumbelQuantize(N_E, E_DIM, remap=USED, device="cpu"), params)
    got_zq, got_kl, (got_perp, _, got_idx) = tmod(to_torch(z), gumbel=to_torch(gumbel),
                                                  temp=0.7)
    for got, ref in ((got_zq, zq), (got_kl, kl), (got_perp, perp)):
        assert_close(got, ref, TOL)
    assert got_idx.tolist() == np.asarray(idx).tolist() and int(got_idx.max()) < len(USED)
    ref_codes = jmod.apply({"params": params}, idx, (2, 4, 4, E_DIM),
                           method=jq.GumbelQuantize.get_codebook_entry)
    assert_close(tmod.get_codebook_entry(got_idx, (2, 4, 4, E_DIM)), ref_codes, TOL)


def test_vector_quantizer_one_hot_matches():
    jmod = jq.VectorQuantizerOneHot(N_E, E_DIM, beta=0.3)
    z = _z(7)
    params = flax_init(jmod, jnp.asarray(z), seed=8)
    zq, loss, (perp, one_hot, idx) = jmod.apply({"params": params}, jnp.asarray(z))
    tmod = port(q.VectorQuantizerOneHot(N_E, E_DIM, beta=0.3, device="cpu"), params)
    got = tmod(to_torch(z))
    for g, ref in ((got[0], zq), (got[1], loss), (got[2][0], perp), (got[2][1], one_hot)):
        assert_close(g, ref, TOL)
    assert got[2][2].tolist() == np.asarray(idx).tolist()
    # the codebook initialiser: U(-1/K, 1/K)
    init_params_(tmod, torch.Generator().manual_seed(0))
    assert float(tmod.weight.abs().max()) <= 1.0 / N_E


def test_residual_block_and_unet_generator_match():
    x = nprand(1, 16, 16, 3, seed=9)
    jgen = jdisc.UNetGenerator(ngf=8, n_res_blocks=2)
    params = flax_init(jgen, jnp.asarray(x), seed=10)
    ref = jgen.apply({"params": params}, jnp.asarray(x))
    tgen = port(disc.UNetGenerator(ngf=8, n_res_blocks=2, device="cpu"), params)
    assert_close(tgen(to_torch(x)), ref, TOL)
    h = nprand(2, 6, 5, 8, seed=11)
    jres = jdisc.ResidualBlock(8)
    rparams = flax_init(jres, jnp.asarray(h), seed=12)
    tres = port(disc.ResidualBlock(8, device="cpu"), rparams)
    assert_close(tres(to_torch(h)), jres.apply({"params": rparams}, jnp.asarray(h)), TOL)


def test_normal_kl_and_dirac_match():
    m1, l1, m2, l2 = (nprand(3, 5, seed=s) for s in range(13, 17))
    assert_close(normal_kl(*map(to_torch, (m1, l1, m2, l2))), jdist.normal_kl(m1, l1, m2, l2),
                 TOL)
    assert_close(normal_kl(to_torch(m1), to_torch(l1), 0.0, 0.0),
                 jdist.normal_kl(m1, l1, 0.0, 0.0), TOL)
    v = to_torch(m1)
    d = Dirac(v)
    assert d.sample() is v and d.mode() is v and torch.equal(d.kl(), torch.zeros(3))
    assert np.array_equal(np.asarray(jdist.Dirac(jnp.asarray(m1)).kl()), d.kl().numpy())


def test_warmup_cosine_schedules_match():
    got = lr.lambda_warmup_cosine_schedule(10, 1e-6, 1e-3, 1e-5, 50)
    want = jlr.lambda_warmup_cosine_schedule(10, 1e-6, 1e-3, 1e-5, 50)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    cycles = dict(warm_up_steps=[3, 5], f_min=[0.1, 0.01], f_max=[1.0, 0.5],
                  f_start=[1e-3, 0.2], cycle_lengths=[10, 20])
    got, want = (lr.lambda_warmup_cosine_schedule_v2(**cycles),
                 jlr.lambda_warmup_cosine_schedule_v2(**cycles))
    for step in range(0, 36):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    cum = np.concatenate([[0], np.cumsum(cycles["cycle_lengths"])])
    for step in (0, 9, 10, 29, 30, 99):
        assert lr._cycle_index(step, cum) == int(jlr._cycle_index(step, cum))


def test_reduce_on_plateau_matches_optax():
    kw = dict(factor=0.5, patience=2, rtol=1e-3, cooldown=1, min_scale=0.2)
    jopt = jlr.reduce_on_plateau(**kw)
    state = jopt.init({"p": jnp.zeros(())})
    update = jax.jit(lambda s, v: jopt.update({"p": jnp.ones(())}, s, value=v))
    mine = lr.reduce_on_plateau(**kw)
    values = [5.0, 4.0, 4.0, 3.999, 4.1, 4.0, 4.0, 4.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0]
    scales = []
    for v in values:
        upd, state = update(state, v)
        scales.append(float(upd["p"]))
        assert mine.update(v) == pytest.approx(scales[-1], rel=1e-7)
    assert min(scales) == pytest.approx(0.2) and len(set(scales)) > 2
    with pytest.raises(ValueError):
        lr.reduce_on_plateau(factor=1.5)
