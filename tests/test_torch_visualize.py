"""A pixel-space latent diffusion (`IdentityFirstStage`), the visual logs of
`diffusion/visualize.py` and the metrics utilities against the JAX package,
fp32 on the CPU at tiny widths (UNet 32 × (1, 2) at 16² RGB, CLIP 32 wide):

* the identity first stage's LDM: `build_ldm` with `first_stage.target:
  IdentityFirstStage` (no parameters, factor 1), its ε-loss on an injected
  batch against the JAX `LatentDiffusion` over an identity encode / decode
  within 1e-4·max(1, |ref|), and a 2-step `train_ldm` on it;
* `log_images` (4 DDIM steps, the inpainting and outpainting demos) with
  the JAX package's draws injected (its key split into the diffusion row's
  noises, the samplers' x_T and the inpainting's per-step mask noise):
  every key, each array within 1e-4·max(1, max|ref|), the rendered
  captions pixel for pixel; `progressive_denoising_grid` is the decoded
  denoising strip;
* `ismap`, `isimage`, `log_txt_as_img` (PIL's default font in both, pixel
  for pixel), `save_animation` (a GIF of the frames' grids),
  `compiled_cost` (the FLOPs of a matmul and a conv as XLA's cost analysis
  counts them) and `profile_trace` (a Chrome trace written).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import MODULE_TOL, assert_close, flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_UNET

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.diffusion import visualize as jvis
from sd_tpu.diffusion.ddpm import DDPMProcess as JProcess
from sd_tpu.diffusion.latent import LatentDiffusion as JLatentDiffusion
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.train import metrics as jmetrics
from sd_tpu_torch.core.config import sd512_train_config
from sd_tpu_torch.diffusion import visualize
from sd_tpu_torch.train import metrics, runners

PIX_UNET = dict(TINY_UNET, in_channels=3, out_channels=3)
CLIP = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4, max_length=16)
STEPS = 4


def _pixel_cfg() -> dict:
    cfg = sd512_train_config()
    cfg["unet"]["params"].update(PIX_UNET)
    cfg["first_stage"] = {"target": "sd_tpu.models.autoencoder.IdentityFirstStage"}
    cfg["cond_stage"]["params"] = dict(CLIP)
    cfg["latent"].update(image_size=16, channels=3, scale_factor=1.0)
    cfg["train"].update(image_size=16, lr_schedule=None, grad_accum=1, remat="none")
    cfg["train"].pop("param_dtype")
    return cfg


@pytest.fixture(scope="module")
def pixel_ldm():
    """(port ld, JAX ld, the UNet's flax params): the identity first stage,
    the same random UNet in both."""
    cfg = _pixel_cfg()
    ld, unet, identity, _ = runners.build_ldm(cfg, torch.Generator().manual_seed(0),
                                              device="cpu")
    params = flax_init(JUNet(**PIX_UNET), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 16, 32)), seed=1)
    port(unet, params)
    junet = JUNet(**PIX_UNET)
    jld = JLatentDiffusion(
        process=JProcess(JSchedule.create(**{k: v for k, v in cfg["diffusion"].items()
                                             if k != "parameterization"}),
                         clip_denoised=False),
        unet_apply=lambda p, x, t, ctx, y=None: junet.apply({"params": p}, x, t, ctx),
        encode_fn=lambda x, r: x, decode_fn=lambda z: z, conditioning_key="crossattn",
        scale_factor=1.0)
    return ld, jld, params, identity


def test_identity_first_stage_ldm_loss_matches(pixel_ldm):
    ld, jld, params, identity = pixel_ldm
    assert not list(identity.parameters())
    assert runners.first_stage_factor(_pixel_cfg()["first_stage"]) == 1
    x, ctx, noise = nprand(2, 16, 16, 3, seed=2), nprand(2, 16, 32, seed=3), nprand(2, 16, 16, 3,
                                                                                   seed=4)
    t = np.array([11, 640])
    ref, jlogs = jax.jit(lambda p: jld.p_losses(
        p, jnp.asarray(x), {"c_crossattn": [jnp.asarray(ctx)]}, jnp.asarray(t),
        jnp.asarray(noise)))(params)
    with torch.no_grad():
        loss, logs = ld.training_loss({"image": to_torch(x), "txt_emb": to_torch(ctx),
                                       "t": torch.from_numpy(t), "noise": to_torch(noise)})
    assert_close(loss, ref)
    assert_close(logs["loss_simple"], jlogs["loss_simple"])


def test_identity_first_stage_ldm_trains_two_steps():
    rng = np.random.default_rng(5)
    batches = [{"image": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
                "txt_raw": ["a photo of a cat", "a photo of a dog"]} for _ in range(2)]
    state, hist = runners.train_ldm(_pixel_cfg(), batches, max_steps=2, device="cpu")
    assert state.step == 2 and all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in hist)


def _jax_draws(z_shape, T):
    """The JAX `log_images`' draws from PRNGKey(0), in the port's arguments."""
    _, _, r_diff, r_samp, r_inp = jax.random.split(jax.random.PRNGKey(0), 5)
    ts = jnp.linspace(0, T - 1, 8).astype(jnp.int32)
    rows = [to_torch(jax.random.normal(jax.random.fold_in(r_diff, t), z_shape)) for t in ts]
    x_T = to_torch(jax.random.normal(jax.random.split(r_samp)[1], z_shape))
    rng, init = jax.random.split(r_inp)
    inpaint_x_T = to_torch(jax.random.normal(init, z_shape))
    mask_draws = []
    for _ in range(STEPS):
        rng, mask_rng, _ = jax.random.split(rng, 3)
        mask_draws.append(to_torch(jax.random.normal(mask_rng, z_shape, jnp.float32)))
    # the port calls mask_noise(index, shape) for index S-1 … 0
    return rows, x_T, inpaint_x_T, lambda index, shape: mask_draws[STEPS - 1 - index]


def test_log_images_match(pixel_ldm):
    ld, jld, params, _ = pixel_ldm
    x, ctx = np.tanh(nprand(2, 16, 16, 3, seed=6)), nprand(2, 16, 32, seed=7)
    batch = {"image": x, "txt_emb": ctx, "txt_raw": ["a red cube", "an astronaut on a horse"]}
    ref = jvis.log_images(jld, params, jax.tree.map(
        lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, batch),
        jax.random.PRNGKey(0), n_rows=2, sample_steps=STEPS)
    rows, x_T, inpaint_x_T, mask_noise = _jax_draws(x.shape, 1000)
    got = visualize.log_images(ld, batch, n_rows=2, sample_steps=STEPS, row_noise=rows,
                               x_T=x_T, inpaint_x_T=inpaint_x_T, mask_noise=mask_noise)
    assert sorted(got) == sorted(ref) == sorted(
        ["inputs", "reconstruction", "conditioning", "diffusion_row", "samples",
         "denoise_row", "inpainting", "outpainting"])
    for key in ref:
        assert_close(got[key], ref[key], MODULE_TOL)
    assert np.array_equal(got["conditioning"], ref["conditioning"])
    grid = visualize.progressive_denoising_grid(
        ld, x.shape, x_T, {"c_crossattn": [to_torch(ctx)]}, num_steps=STEPS)
    np.testing.assert_array_equal(grid, got["denoise_row"])


def test_metrics_utilities_match(tmp_path):
    maps = np.zeros((2, 8, 8, 5))
    for fn, jfn in ((metrics.ismap, jmetrics.ismap), (metrics.isimage, jmetrics.isimage)):
        for v in (maps, maps[..., :3], maps[..., :1], maps[0], [1, 2]):
            assert fn(v) == jfn(v)
    texts = ["a photograph of an astronaut riding a horse on the moon", "x"]
    np.testing.assert_array_equal(metrics.log_txt_as_img((40, 64), texts),
                                  jmetrics.log_txt_as_img((40, 64), texts))
    path = tmp_path / "anim" / "a.gif"
    frames = [np.full((2, 8, 8, 3), v, np.float32) for v in (-1.0, 0.0, 1.0)]
    metrics.save_animation(frames, str(path), duration_ms=50)
    from PIL import Image

    with Image.open(path) as gif:
        assert gif.n_frames == 3 and gif.size == (18, 8)
    a, b = nprand(8, 16, seed=8), nprand(16, 4, seed=9)
    want = jmetrics.compiled_cost(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))["flops"]
    assert metrics.compiled_cost(lambda a, b: a @ b, to_torch(a), to_torch(b)) == {
        "flops": float(want)} == {"flops": 2.0 * 8 * 16 * 4}
    with metrics.profile_trace(str(tmp_path / "trace")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
