"""Super-resolution (`task: ldm_sr`) against the JAX package's, on the CPU in
fp32 at `configs/ldm_sr_smoke.yaml`'s widths (32² HR, a ch-16 f4 first
stage, 8² × 4 latent, UNet 32 × (1, 2) with self-attention at 8²).

- `data/degradation.py`: every public function and the four composites
  (BSRGAN, its light ranges, the variant, plus) give the JAX package's
  bits on the same seeds, and leave the generator where the JAX package's
  leaves it (draw for draw).
- `SRDataset` items (HR and LR) bit for bit on native-size PNGs, under each
  degradation and two epochs.
- `lr_to_latent` at sf 2, 4 and 8 over the f4 first stage (down ×2, as it
  is, up ×2) within 1e-6 of `_lr_to_latent` (`jax.image.resize`,
  antialiased bilinear).
- The SR UNet's forward within 1e-4·max(1, |ref|), and one `train_ldm_sr`
  step (its batch transform and loss; AdamW and the learned logvar) against
  the JAX package's step through `tests/test_torch_finetune.py`'s
  `lower_jax_step` / `assert_step_matches` (t and the noises injected).
- `super_resolve` at 2 DDIM steps with x_T injected, decode included,
  within 1e-4·max|ref| (`SR_TOL`).
- `python -m sd_tpu_torch.train` on the smoke config: 2 steps with an eval,
  `calibration.json`, a resume for a third; then `python -m
  sd_tpu_torch.sample_sr` on the run, end to end. And the errors.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_finetune import (as_port, assert_step_matches, draws, jax_ld, jax_loss,
                                 lower_jax_step, port_step, with_draws)
from test_torch_helpers import assert_close, flax_init, nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.core.schedules import DiffusionSchedule as JSchedule
from sd_tpu.data import datasets as jdatasets
from sd_tpu.data import degradation as jdeg
from sd_tpu.diffusion import ddpm as jddpm
from sd_tpu.diffusion.latent import LatentDiffusion as JLatentDiffusion
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.train import sr as jsr
from sd_tpu_torch import sample_sr
from sd_tpu_torch.core.config import ldm_sr_catdog_config, ldm_sr_smoke_config
from sd_tpu_torch.data import datasets
from sd_tpu_torch.data import degradation as deg
from sd_tpu_torch.data.image_io import decode_png, write_png
from sd_tpu_torch.train import sr
from sd_tpu_torch.train.__main__ import main as train_main
from sd_tpu_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parents[1]
SR_TOL = 1e-4
RESIZE_TOL = 1e-6
LATENT = (2, 8, 8, 4)


# -- degradations ---------------------------------------------------------------------


def _img(seed: int = 0, size: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).random((size, size, 3), dtype=np.float32)


KERNEL = jdeg.gaussian_kernel_2d(9, 1.2, 2.0, 0.4)
COMPOSITE_SEEDS = range(6)
DEGRADE = {
    "gaussian_kernel_2d": lambda m, r, x: m.gaussian_kernel_2d(15, 1.3, 2.1, 0.7),
    "random_blur_kernel": lambda m, r, x: [m.random_blur_kernel(r, 21, light=light)
                                           for light in (False, True) for _ in range(4)],
    "apply_blur": lambda m, r, x: m.apply_blur(x, KERNEL),
    "resize": lambda m, r, x: [m.resize(x, (13, 9), meth)
                               for meth in ("bicubic", "bilinear", "nearest", "lanczos")],
    "downsample_classical": lambda m, r, x: [m.downsample_classical(x, 4, r) for _ in range(4)],
    "add_gaussian_noise": lambda m, r, x: [m.add_gaussian_noise(x, r) for _ in range(8)],
    "add_poisson_noise": lambda m, r, x: m.add_poisson_noise(x, r),
    "add_speckle_noise": lambda m, r, x: m.add_speckle_noise(x, r),
    "add_jpeg_noise": lambda m, r, x: [m.add_jpeg_noise(x, r) for _ in range(2)],
    "bicubic_degradation": lambda m, r, x: m.bicubic_degradation(x, 4),
    "srmd_degradation": lambda m, r, x: m.srmd_degradation(x, KERNEL, 2),
    "dpsr_degradation": lambda m, r, x: m.dpsr_degradation(x, KERNEL, 2),
    "classical_degradation": lambda m, r, x: m.classical_degradation(x, KERNEL, 4),
    "shift_pixel": lambda m, r, x: m.shift_pixel(KERNEL, 4),
    "add_sharpening": lambda m, r, x: m.add_sharpening(x),
    "degradation_bsrgan": lambda m, r, x: m.degradation_bsrgan(x, 4, r),
    "degradation_bsrgan_light": lambda m, r, x: m.degradation_bsrgan(x, 4, r, light=True),
    "degradation_bsrgan_variant": lambda m, r, x: m.degradation_bsrgan_variant(x, 4, r),
    "degradation_bsrgan_plus": lambda m, r, x: m.degradation_bsrgan_plus(x, 4, r),
}


def _leaves(out) -> list:
    return ([a for o in out for a in _leaves(o)] if isinstance(out, (list, tuple))
            else [np.asarray(out)])


@pytest.mark.parametrize("name", sorted(DEGRADE))
def test_degradation_is_the_jax_packages_bit_for_bit(name):
    seeds = COMPOSITE_SEEDS if name.startswith("degradation_") else (7,)
    for seed in seeds:
        x = _img(seed)
        rngs = np.random.default_rng(seed), np.random.default_rng(seed)
        got, ref = (_leaves(DEGRADE[name](m, r, x.copy())) for m, r in zip((deg, jdeg), rngs))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
        assert rngs[0].random() == rngs[1].random(), f"{name}: the draws differ"


def test_jpeg_stage_names_what_is_missing(monkeypatch):
    from PIL import features

    monkeypatch.setattr(features, "check", lambda name: False)
    with pytest.raises(RuntimeError, match="JPEG"):
        deg.add_jpeg_noise(_img(), np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="JPEG"):
        deg.degradation_bsrgan(_img(), 4, np.random.default_rng(0))


# -- the dataset and the LR conditioning ----------------------------------------------


@pytest.fixture(scope="module")
def pngs(tmp_path_factory) -> Path:
    """Four native-size 32² RGB PNGs."""
    root = tmp_path_factory.mktemp("sr_pngs")
    rng = np.random.default_rng(11)
    for i in range(4):
        write_png(str(root / f"im_{i}.png"), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    return root


@pytest.mark.parametrize("how", datasets.SR_DEGRADATIONS)
def test_sr_dataset_items_are_the_jax_packages_bit_for_bit(pngs, how):
    port = datasets.SRDataset(str(pngs), image_size=32, sf=4, degradation=how, seed=3)
    ref = jdatasets.SRDataset(str(pngs), image_size=32, sf=4, degradation=how, seed=3)
    assert port.paths == ref.paths
    for epoch in (0, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for idx in range(len(port)):
            a, b = port[idx], ref[idx]
            assert sorted(a) == sorted(b) == ["image", "lr"]
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, idx)
            assert a["lr"].shape == (8, 8, 3)


@pytest.mark.parametrize("sf", [2, 4, 8])
def test_lr_to_latent_is_the_jax_resize(sf):
    lr = nprand(2, 32 // sf, 32 // sf, 3, seed=sf)
    got = sr.lr_to_latent(to_torch(lr), 8)
    ref = np.asarray(jsr._lr_to_latent(jnp.asarray(lr), 8))
    assert got.shape == ref.shape == (2, 8, 8, 3)
    assert float(np.max(np.abs(got.numpy() - ref))) <= RESIZE_TOL


# -- the model, its step and sampling -------------------------------------------------


def _jax_unet(cfg: dict):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["unet"]["params"].items()}
    return JUNet(**kw)


def port_sr_stack(cfg: dict, seed: int = 21):
    """The port's SR stack on the CPU with the JAX package's random UNet
    carried across: (ld, unet, vae, the UNet's flax tree, the JAX UNet)."""
    ld, unet, vae = sr.build_ldm_sr(cfg, torch.Generator().manual_seed(0), "cpu")
    junet = _jax_unet(cfg)
    tree = flax_init(junet, jnp.zeros((1, 8, 8, 7)), jnp.zeros((1,), jnp.int32), None,
                     seed=seed)
    load_flax_params(unet, tree)
    return ld, unet, vae, tree, junet


def test_sr_unet_matches():
    _, unet, _, tree, junet = port_sr_stack(ldm_sr_smoke_config())
    x, t = nprand(2, 8, 8, 7, seed=22), np.array([3, 41], np.int32)
    ref = jax.jit(lambda p, a, b: junet.apply({"params": p}, a, b, None))(tree, x, t)
    with torch.no_grad():
        got = unet(to_torch(x), torch.from_numpy(t.astype(np.int64)))
    assert_close(got, ref)


def test_train_ldm_sr_step_matches():
    cfg = ldm_sr_smoke_config()
    ld, unet, _, tree, junet = port_sr_stack(cfg, seed=23)
    rng = np.random.default_rng(24)
    host = {"image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
            "lr": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)}   # sf 2: resized
    d = draws(latent=LATENT)
    pb = with_draws(sr.sr_batch(host, 8, "cpu"), d)
    with torch.no_grad():
        z = ld.encode_first_stage(pb["image"], pb["enc_noise"])
    jb = {"image": z.numpy(), "concat_cond": np.asarray(jsr._lr_to_latent(host["lr"], 8)),
          "t": d["t"], "noise": d["noise"]}
    jld = jax_ld(lambda p, x, t, ctx, y=None: junet.apply({"params": p}, x, t, ctx),
                 key="concat", scale=ld.scale_factor)
    lowered, args, unravel = lower_jax_step(jax_loss(jld), tree, jb, weight_decay=1e-2,
                                            learn_logvar=True)
    jstate, jlogs = lowered.compile()(*args)
    port = port_step(dict(unet.named_parameters()),
                     lambda b, g, logvar: ld.training_loss(b, g, logvar), pb,
                     weight_decay=1e-2, learn_logvar=True)
    assert_step_matches(port, (jstate, jlogs, unravel), as_port, weight_decay=1e-2,
                        learn_logvar=True)


def test_super_resolve_matches_jax():
    cfg = ldm_sr_smoke_config()
    ld, _, vae, tree, junet = port_sr_stack(cfg, seed=25)
    assert ld.process.clip_denoised is False and ld.conditioning_key == "concat"
    fs = cfg["first_stage"]["params"]
    jvae = JAutoencoderKL(**{k: tuple(v) if isinstance(v, list) else v for k, v in fs.items()})
    vtree = flax_init(jvae, jnp.zeros((1, 32, 32, 3)), seed=26)
    load_flax_params(vae, vtree)
    ld = dataclasses.replace(ld, scale_factor=0.7)
    jld = JLatentDiffusion(
        process=jddpm.DDPMProcess(JSchedule.create(**cfg["diffusion"]), clip_denoised=False),
        unet_apply=lambda p, x, t, ctx, y=None: junet.apply({"params": p}, x, t, ctx),
        decode_fn=lambda z: jvae.apply({"params": vtree}, z, method=JAutoencoderKL.decode),
        conditioning_key="concat", scale_factor=0.7)
    lr, x_T = nprand(2, 8, 8, 3, seed=27), nprand(*LATENT, seed=28)
    ref = jax.jit(lambda p, c, xt: jld.sample(p, jax.random.PRNGKey(0), LATENT, cond=c,
                                              num_steps=2, eta=0.0, sampler="ddim", x_T=xt))(
        tree, {"c_concat": [jsr._lr_to_latent(jnp.asarray(lr), 8)]}, jnp.asarray(x_T))
    got = sr.super_resolve(ld, lr, cfg["latent"], num_steps=2, x_T=to_torch(x_T))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, 32, 32, 3)
    assert float(np.max(np.abs(got - ref))) <= SR_TOL * float(np.max(np.abs(ref)))


# -- the command lines ----------------------------------------------------------------


def test_train_and_sample_sr_from_the_command_line(tmp_path, pngs, capsys):
    cfg = ldm_sr_smoke_config()
    cfg["data"]["sr"]["degradation"] = "bsrgan_light"
    cfg["train"].update(total_steps=3, checkpoint_every=2, eval_every=2)
    cfg["sample"]["num_steps"] = 2
    path, out = tmp_path / "sr.json", tmp_path / "run"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--data", str(pngs), "--out", str(out), "--device", "cpu"]
    assert train_main(argv + ["--max-steps", "2"]) == 0
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1]
    evals = [r for r in rows if "eval_psnr" in r]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval_psnr"]) and "eval_ssim" in evals[0]
    assert (out / "samples" / "step_2.png").exists()
    scale = json.loads((out / "calibration.json").read_text())["scale_factor"]
    assert np.isfinite(scale) and scale > 0
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["step_2.pt"]
    assert train_main(argv) == 0                      # resumed: the third step
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [0, 1, 2]
    assert "step_3.pt" in {p.name for p in (out / "ckpt").iterdir()}

    grid = tmp_path / "sr.png"
    assert sample_sr.main(["--config", str(path), "--ckpt", str(out / "ckpt"), "--input",
                           str(pngs), "--n", "3", "--steps", "2", "--out", str(grid),
                           "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "restored" in said and "scale_factor from" in said and "psnr=" in said
    img = decode_png(grid.read_bytes())
    assert img.shape == (3 * 32 + 2 * 2, 3 * 32 + 2 * 2, 3)        # LR / SR / HR rows of 3
    assert sample_sr.main(["--config", str(path), "--input", str(pngs / "im_0.png"),
                           "--degrade", "none", "--steps", "2", "--out", str(grid),
                           "--device", "cpu"]) == 0
    assert decode_png(grid.read_bytes()).shape[0] == 2 * 32 + 2    # LR / SR rows


def test_sr_configs_equal_their_yaml():
    with open(REPO / "configs" / "ldm_sr_smoke.yaml") as f:
        assert ldm_sr_smoke_config() == yaml.safe_load(f)
    with open(REPO / "configs" / "ldm_sr_catdog.yaml") as f:
        want = yaml.safe_load(f)
    del want["first_stage"]["ckpt"]
    assert ldm_sr_catdog_config() == want


def test_sr_errors(pngs):
    with pytest.raises(ValueError, match="divisible"):
        datasets.SRDataset(str(pngs), image_size=30, sf=4)
    with pytest.raises(ValueError, match="degradation"):
        datasets.SRDataset(str(pngs), image_size=32, degradation="jpeg_only")
    cfg = ldm_sr_smoke_config()
    cfg["unet"]["params"]["in_channels"] = 8
    with pytest.raises(ValueError, match="concat"):
        sr.build_ldm_sr(cfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="concat"):
        jsr.build_ldm_sr(cfg, jax.random.PRNGKey(0))
    ld, *_ = sr.build_ldm_sr(ldm_sr_smoke_config(), torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="sampler"):
        sr.super_resolve(ld, np.zeros((1, 8, 8, 3), np.float32),
                         ldm_sr_smoke_config()["latent"], sampler="euler")
