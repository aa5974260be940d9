"""The KL-VAE GAN training slice of the port against the JAX package, on the
CPU:

* one KL GAN step (`make_kl_gan_train_step`) of a tiny AutoencoderKL with
  a BatchNorm PatchGAN and LPIPS at 32², adaptive weight on, `disc_start`
  0, from the same carried-across state, with the same posterior noise
  injected into both packages' `ae_apply`, in fp32: every log within
  1e-4·max(1, |ref|); with plain SGD at lr 1 (so the update is the
  gradient) the generator's and the discriminator's gradients within
  ‖Δ‖₂ ≤ 1e-4·‖ref‖₂, and each parameter's within 1e-4·‖ref‖₂ plus 1e-6
  of its network's ‖ref‖₂ (some gradients are 0 in exact arithmetic and
  only rounding noise in both: the attention k biases, since softmax
  ignores a shift, and at these widths the conv biases that feed a
  one-channel GroupNorm group), and the running statistics within 1e-4. The JAX
  step runs jitted: one compile takes about a quarter of the time its op
  by op run takes on this CPU;
* the runner's GAN Adam (betas 0.5, 0.9; fp32 moments under bf16) against
  optax's on fixed gradients;
* `train_kl_vae` at tiny widths under the bf16 parameter policy runs 2
  steps: generator and discriminator parameters bf16, the logvar, the
  running statistics and the Adam moments fp32;
* the flash attention training path at head dim 512 (the codec's
  mid-block attention): the plain forward and backward against the Pallas
  kernels in interpret mode under `jax.vjp`, within 1e-4·max(1, max|ref|).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_helpers import assert_close, flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.kernels import flash_attention as jfa
from sd_tpu.losses.gan import GanLossConfig as JGanLossConfig
from sd_tpu.models import discriminator as jdisc
from sd_tpu.models import lpips as jlpips
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.train import gan as jgan_train
from sd_tpu.train.diffusion import float32_moments as jfloat32_moments
from sd_tpu_torch.core.config import kl_f8_256_train_config
from sd_tpu_torch.kernels import flash_attention as fa
from sd_tpu_torch.losses.gan import GanLossConfig
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.discriminator import NLayerDiscriminator
from sd_tpu_torch.models.lpips import LPIPS
from sd_tpu_torch.train import gan as gan_train
from sd_tpu_torch.train.diffusion import float32_moments
from sd_tpu_torch.train.runners import train_kl_vae
from sd_tpu_torch.weights import _flatten, load_flax_batch_stats, torch_name

TINY_AE = dict(embed_dim=4, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
LOSS = dict(disc_start=0, kl_weight=1e-3, disc_weight=0.5, perceptual_weight=1.0,
            disc_loss="hinge")


def _torch_flat(tree) -> dict[str, np.ndarray]:
    """A flax tree as {torch name: array in the torch layout}."""
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf, np.float32)
        name, perm = torch_name(path, arr.ndim)
        out[name] = arr if perm is None else arr.transpose(perm)
    return out


class _SGD:
    """p ← p − g: the update is the gradient itself."""

    def init(self, params):
        return None

    @torch.no_grad()
    def update_(self, params, grads, state):
        for p, g in zip(params, grads):
            p.sub_(g)


def _l2_rel(got: torch.Tensor, want: np.ndarray) -> float:
    d = np.asarray(got.detach().float(), np.float32) - want
    return float(np.linalg.norm(d) / max(np.linalg.norm(want), 1e-30))


def _gan_setup():
    """Both packages' tiny autoencoder, discriminator and LPIPS on the same
    random weights, a batch and the posterior noise."""
    x0 = jnp.zeros((1, 32, 32, 3))
    jvae = JAutoencoderKL(**TINY_AE, resolution=32)
    vparams = flax_init(jvae, x0, seed=1)
    jd = jdisc.NLayerDiscriminator(ndf=8, n_layers=2)
    dparams = flax_init(jd, x0, seed=2)
    stats = jax.eval_shape(jd.init, jax.random.PRNGKey(0), x0)["batch_stats"]
    rng = np.random.default_rng(3)
    stats = {n: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                 "var": (1 + np.abs(rng.standard_normal(s["var"].shape))).astype(np.float32)}
             for n, s in stats.items()}
    lparams = flax_init(jlpips.LPIPS(), x0, x0, seed=4)
    x = np.clip(nprand(2, 32, 32, 3, seed=5, scale=0.6), -1, 1)
    noise = nprand(2, 16, 16, 4, seed=6)
    return dict(jvae=jvae, vparams=vparams, jd=jd, dparams=dparams, stats=stats,
                lparams=lparams, x=x, noise=noise)


gan_setup = pytest.fixture(scope="module")(_gan_setup)


def _jax_step(s, opt):
    jvae = s["jvae"]
    noise = jnp.asarray(s["noise"])

    def ae_apply(p, x, rng):
        post = jvae.apply({"params": p}, x, method=JAutoencoderKL.encode)
        z = (post.mean + post.std * noise).astype(post.mean.dtype)
        return jvae.apply({"params": p}, z, method=JAutoencoderKL.decode), post

    lp = lambda a, b: jlpips.LPIPS().apply({"params": s["lparams"]}, a, b)
    state = jgan_train.init_gan_state(s["vparams"], {"params": s["dparams"],
                                                     "batch_stats": s["stats"]}, opt, opt)
    step = jgan_train.make_kl_gan_train_step(ae_apply, s["jd"], lp, opt, opt,
                                             JGanLossConfig(**LOSS))
    new, logs = step(state, jnp.asarray(s["x"]), jax.random.PRNGKey(0))
    return state, new, logs


def _torch_step(s, opt):
    vae = port(AutoencoderKL(**TINY_AE, resolution=32, device="cpu"), s["vparams"])
    td = port(NLayerDiscriminator(ndf=8, n_layers=2, device="cpu"), s["dparams"])
    load_flax_batch_stats(td, s["stats"])
    tl = port(LPIPS(device="cpu"), s["lparams"])
    noise = to_torch(s["noise"])
    state = gan_train.init_gan_state(vae, td, opt, opt)
    step = gan_train.make_kl_gan_train_step(lambda x, g: vae(x, noise), td, tl, opt, opt,
                                            GanLossConfig(**LOSS))
    before = {k: v.detach().clone() for k, v in {**state.params_g, **state.params_d}.items()}
    logs = step(state, to_torch(s["x"]), None)
    return before, state, logs


def test_one_kl_gan_step_matches(gan_setup):
    s = gan_setup
    jold, jnew, jlogs = _jax_step(s, optax.sgd(1.0))
    before, state, logs = _torch_step(s, _SGD())
    assert state.step == 1 and int(jnew.step) == 1
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
    for name, want in _torch_flat(jnew.batch_stats_d).items():
        assert_close(state.batch_stats_d[name], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gan_adam_matches_optax(dtype):
    params = [nprand(4, 3, seed=30), nprand(5, seed=31)]
    tparams = [to_torch(p).to(getattr(torch, dtype)) for p in params]
    jparams = [jnp.asarray(p, dtype) for p in params]
    opt, jopt = gan_train.gan_adam(1e-2), jgan_train.gan_adam(1e-2)
    if dtype == "bfloat16":
        opt, jopt = float32_moments(opt), jfloat32_moments(jopt)
    st, jst = opt.init(tparams), jopt.init(jparams)
    for i in range(3):
        grads = [nprand(*p.shape, seed=40 + 2 * i + j) for j, p in enumerate(params)]
        opt.update_(tparams, [to_torch(g).to(getattr(torch, dtype)) for g in grads], st)
        up, jst = jopt.update([jnp.asarray(g, dtype) for g in grads], jst, jparams)
        jparams = optax.apply_updates(jparams, up)
    for t, j in zip(tparams, jparams):
        assert t.dtype == getattr(torch, dtype)
        assert_close(t.float(), np.asarray(j, np.float32), 1e-4 if dtype == "float32" else 1e-2)


def test_train_kl_vae_runs_under_the_bf16_policy():
    cfg = kl_f8_256_train_config()
    cfg["model"]["params"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=32)
    cfg["discriminator"] = {"ndf": 8, "n_layers": 2, "use_actnorm": False}
    cfg["loss"]["disc_start"] = 1
    cfg["train"].update(image_size=32, batch_size=2, param_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batches = [{"image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)}
               for _ in range(3)]
    state, hist = train_kl_vae(cfg, batches, max_steps=2, device="cpu")
    assert len(hist) == 2 and state.step == 2
    assert all(math.isfinite(v) for row in hist for v in row.values())
    assert [row["train/disc_factor"] for row in hist] == [0.0, 1.0]
    assert {p.dtype for n, p in state.params_g.items() if n != "logvar"} == {torch.bfloat16}
    assert state.params_g["logvar"].dtype == torch.float32
    assert {p.dtype for p in state.params_d.values()} == {torch.bfloat16}
    assert {b.dtype for b in state.batch_stats_d.values()} == {torch.float32}
    moments = (state.opt_state_g.mu + state.opt_state_g.nu
               + state.opt_state_d.mu + state.opt_state_d.nu)
    assert {m.dtype for m in moments} == {torch.float32}
    assert hist[1]["train/logvar"] != 0.0          # the logvar trains


def test_trainer_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_kl_vae(kl_f8_256_train_config(), [])


# -- flash attention at head dim 512 ----------------------------------------------


@pytest.mark.parametrize("b,sq,skv", [(1, 256, 256), (1, 256, 300)])
def test_flash_training_path_at_d512_matches_pallas(b, sq, skv):
    d = 512
    q, k, v, do = (nprand(b, s, 1, d, seed=i) for i, s in enumerate((sq, skv, skv, sq)))
    ref, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True),
                       *(jnp.asarray(t) for t in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (to_torch(t).requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    out.backward(to_torch(do))
    assert_close(out, ref)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        assert_close(got, want)
    _, res = jfa._fwd(*(jnp.asarray(t) for t in (q, k, v)), d**-0.5, 2048, 1024, True)
    _, lse = fa.flash_attention_lse(tq.detach(), tk.detach(), tv.detach(), d**-0.5)
    assert_close(lse, np.asarray(res[4])[:, :sq, 0].reshape(b, 1, sq))
