"""The evaluation metrics in the port (`sd_tpu_torch/eval`) against the JAX
package's (`sd_tpu/eval`), fp32 on the CPU.

FID: `gaussian_stats` and `frechet_distance` are float64 numpy on both
sides, so they agree to 1e-12 relative (D = 1 included, where `np.cov`
would squeeze the matrix away); `extract_features` hands the feature
function full batches only and drops the padding of a short last one;
`clip_feature_fn` on weights carried across by `load_flax_params` (the
ViT-B/32 tower shrunk in both packages alike, so that its XLA compile
stays cheap) within 1e-5·max|ref|. The probe classifier at width 8: its
forward on even and odd sides (flax's "SAME" padding at stride 2) and three
Adam steps on both packages' draws (the JAX package's batch indices and
flips handed to the port, its initial weights carried across): parameters,
loss and accuracy within 1e-5·max|ref| (1e-4 for the parameters, which
Adam's normalised step moves by ±lr whatever the gradient's size; the
first conv's bias, whose gradient is rounding noise, within its three ±lr
steps of the start); then `steering_score` on the trained probes. And the
gradient of a loss through `differentiable_decode_first_stage` against
`jax.grad` through the JAX package's (a small KL decoder, within
1e-5·max|ref|), while `decode_first_stage` gives none.
"""

from __future__ import annotations

import functools
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import flax_init, nprand, port, randomize_tree, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_VAE

from sd_tpu.diffusion import latent as jlatent
from sd_tpu.eval import classifier as jclassifier
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models import conditioners as jcond
from sd_tpu_torch.diffusion import latent
from sd_tpu_torch.eval import classifier
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models import conditioners
from sd_tpu_torch.weights import load_flax_params

# each package's `eval` exports a function `fid`, which hides the module
jfid = importlib.import_module("sd_tpu.eval.fid")
fid = importlib.import_module("sd_tpu_torch.eval.fid")
TOL = 1e-5
SMALL_VIT = dict(patch_size=32, width=32, layers=2, heads=4, output_dim=16)
SMALL_VAE = {**TINY_VAE, "ch": 8}


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, bound = np.abs(got - ref).max(), tol * np.abs(ref).max()
    assert err <= bound, f"max|Δ| = {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("d", [1, 6])
def test_gaussian_stats_and_frechet_distance_match(d):
    a, b = nprand(40, d, seed=d), nprand(30, d, seed=d + 1, scale=1.5) + 0.3
    for got, ref in zip(fid.gaussian_stats(a), jfid.gaussian_stats(a)):
        assert got.shape == ref.shape == ((d,) if got.ndim == 1 else (d, d))
        close(got, ref, 1e-12)
    got = fid.frechet_distance(*fid.gaussian_stats(a), *fid.gaussian_stats(b))
    ref = jfid.frechet_distance(*jfid.gaussian_stats(a), *jfid.gaussian_stats(b))
    assert got > 0 and abs(got - ref) <= 1e-12 * abs(ref)
    assert fid.fid_from_features(a, b) == got
    assert fid.frechet_distance(*fid.gaussian_stats(a), *fid.gaussian_stats(a)) < 1e-9
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        fid.gaussian_stats(a[0])


def test_extract_features_pads_the_short_last_batch():
    images = nprand(7, 4, 4, 3, seed=2)
    seen = []

    def feature_fn(x):
        seen.append(tuple(x.shape))
        return x.mean(dim=(1, 2)) * 2.0

    got = fid.extract_features(feature_fn, images, batch_size=3)
    ref = jfid.extract_features(lambda x: x.mean(axis=(1, 2)) * 2.0, images, batch_size=3)
    assert seen == [(3, 4, 4, 3)] * 3
    close(got, ref)
    assert got.shape == (7, 3)
    close(fid.fid(feature_fn, images, images[::-1], batch_size=3), 0.0)
    with pytest.raises(ValueError, match="no images"):
        fid.extract_features(feature_fn, [], batch_size=3)


def test_clip_feature_fn_matches_on_carried_weights(monkeypatch):
    monkeypatch.setattr(jcond, "ClipVisionTransformer",
                        functools.partial(jcond.ClipVisionTransformer, **SMALL_VIT))
    monkeypatch.setattr(conditioners, "ClipVisionTransformer",
                        functools.partial(conditioners.ClipVisionTransformer, **SMALL_VIT))
    shapes = jax.eval_shape(lambda r: jcond.FrozenClipImageEmbedder().init(
        r, jnp.zeros((1, 32, 32, 3))), jax.random.PRNGKey(0))["params"]
    params = randomize_tree(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                   shapes), seed=3)
    images = np.tanh(nprand(5, 32, 32, 3, seed=4))
    ref = jfid.extract_features(jfid.clip_feature_fn(params), images, batch_size=4)
    got = fid.extract_features(fid.clip_feature_fn(params, device="cpu"), images, batch_size=4)
    assert got.shape == (5, 16)
    close(got, ref)
    # without weights: the seeded surrogate, the same features twice
    a = fid.clip_feature_fn(seed=1, device="cpu")(to_torch(images[:2]))
    b = fid.clip_feature_fn(seed=1, device="cpu")(to_torch(images[:2]))
    assert torch.equal(a, b) and a.dtype == torch.float32


def _port_probe(params, width=8, classes=2) -> classifier.TinyImageClassifier:
    model = classifier.TinyImageClassifier(classes, width, device="cpu")
    load_flax_params(model, params)
    return model


@pytest.mark.parametrize("hw", [(32, 32), (33, 35)])
def test_tiny_classifier_forward_matches(hw):
    jmodel = jclassifier.TinyImageClassifier(num_classes=2, width=8)
    params = flax_init(jmodel, jnp.zeros((1, 32, 32, 3)), seed=5)
    x = nprand(3, *hw, 3, seed=6)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        close(_port_probe(params)(to_torch(x)), ref)
    assert classifier._same_pad(32) == (0, 1) and classifier._same_pad(33) == (1, 1)


def test_probe_training_steps_and_steering_score_match(monkeypatch):
    """Three steps of batch 4 on 6 labelled images, each step's indices and
    flips the JAX package's own draws (jax.random.fold_in of the seed's
    key by the step), its init carried across in place of the port's."""
    images, labels = np.tanh(nprand(6, 32, 32, 3, seed=7)), np.array([0, 1, 0, 1, 1, 0])
    kw = dict(steps=3, batch_size=4, lr=1e-3, width=8, seed=0)
    # flax's init compiled as one program (the same draws as op by op, at a
    # fraction of the compile time)
    real_init = fnn.Module.init
    jitted = jax.jit(lambda m, r, x: real_init(m, r, x), static_argnums=0)
    monkeypatch.setattr(jclassifier.TinyImageClassifier, "init",
                        lambda self, rngs, x: jitted(self, rngs, x))
    jmodel, jout = jclassifier.train_image_classifier(images, labels, 2, **kw)
    rng = jax.random.PRNGKey(0)
    init = jmodel.init(rng, jnp.zeros((1, 32, 32, 3)))["params"]

    def draws(i):
        key = jax.random.fold_in(rng, i)
        idx = np.asarray(jax.random.randint(key, (4,), 0, len(images)))
        flip = jax.random.bernoulli(jax.random.fold_in(key, 1), shape=(4, 1, 1, 1))
        return idx, np.asarray(flip).reshape(-1)

    monkeypatch.setattr(classifier, "init_params_", lambda m, g: load_flax_params(m, init))
    model, out = classifier.train_image_classifier(images, labels, 2, draws=draws,
                                                   device="cpu", **kw)
    ref = _port_probe(jout["params"])
    for name, p in ref.named_parameters():
        if name != "conv_0.bias":
            close(out["params"][name], p.detach(), 1e-4)
    # conv_0's bias feeds a GroupNorm of one channel a group, which removes
    # it: its gradient is rounding noise in both packages, and Adam's
    # normalised step turns noise into steps of ±lr. Both stay within them.
    start = torch.from_numpy(np.asarray(init["conv_0"]["bias"]))
    for moved in (out["params"]["conv_0.bias"], torch.from_numpy(
            np.asarray(jout["params"]["conv_0"]["bias"]))):
        assert float((moved - start).abs().max()) <= 3 * 1e-3 * (1 + 1e-3)
    assert abs(out["final_loss"] - jout["final_loss"]) <= TOL * abs(jout["final_loss"])
    assert out["final_acc"] == jout["final_acc"]

    samples = np.tanh(nprand(5, 32, 32, 3, seed=8))
    got = classifier.steering_score(classifier.classifier_fn(model, out["params"]), samples, 1)
    want = jclassifier.steering_score(jclassifier.classifier_fn(jmodel, jout["params"]),
                                      samples, 1)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["confidence"] - want["confidence"]) <= TOL


# -- diffusion/latent.py: the decode with its gradient ---------------------------------------


def test_differentiable_decode_gradient_matches():
    vparams = flax_init(JAutoencoderKL(**SMALL_VAE), jnp.zeros((1, 32, 32, 3)), seed=25)
    vae = port(AutoencoderKL(**SMALL_VAE, device="cpu"), vparams).requires_grad_(False)
    z, w = nprand(2, 16, 16, 4, seed=26), nprand(2, 32, 32, 3, seed=27)
    jvae = JAutoencoderKL(**SMALL_VAE)
    jld = jlatent.LatentDiffusion(process=None, unet_apply=None, scale_factor=0.18215,
                                  decode_fn=lambda z_: jvae.apply({"params": vparams}, z_,
                                                                  method=JAutoencoderKL.decode))
    loss = lambda z_: (jld.differentiable_decode_first_stage(z_) * jnp.asarray(w)).sum()
    ref = jax.jit(jax.grad(loss))(jnp.asarray(z))
    ld = latent.LatentDiffusion(process=None, unet_apply=None, scale_factor=0.18215,
                                decode_fn=vae.decode)
    zt = to_torch(z).requires_grad_(True)
    (ld.differentiable_decode_first_stage(zt) * to_torch(w)).sum().backward()
    close(zt.grad, ref)
    assert not ld.decode_first_stage(zt).requires_grad
