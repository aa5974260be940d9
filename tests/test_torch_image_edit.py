"""The port's image-editing surface against the JAX package, fp32 on the CPU
at the tiny widths of `tests/test_torch_slice.py`: the same random weights
(`jax_pipeline`, carried by `load_flax_params`), inputs made from a seed
with numpy, and every draw of the JAX key streams injected into the port
(the encoder's posterior noise, `stochastic_encode`'s noise, x_T and the
inpainting blend's noise of each step). Within SLICE_TOL (1e-3·max(1,
max|ref|)) for float outputs, 1 level for uint8 images. Covered:

* DDIM's `stochastic_encode`, `decode` and the masked `sample` (a linear
  model function, as `tests/test_torch_samplers.py`);
* `patched_apply` scaling up by 8 and down by 8, `_cover_stride`;
* `img2img` untiled (the refine pass of `generate_hires`), and masked with
  the first stage tiled (`encode_tile`, `decode_tile`) through `inpaint` on
  a plain model; `generate_hires` in parts (the base pass, the upscale, the
  refine pass on the TPU package's upscaled images);
* `inpaint` on a mask-conditioned model (`configs/inpaint_smoke.yaml`), the
  kept pixels bit for bit;
* `load_textual_inversion` of a file written by the TPU package, and
  safetensors written by either package and read by the other;
* the `nearest` and `lanczos` resamplers and the gray conversion against
  PIL;
* `python -m sd_tpu_torch.img2img` and `python -m sd_tpu_torch.sample`
  in-process, the sample CLI's ControlNet, IP-Adapter and SAG flags
  included.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_helpers import (MODULE_TOL, SLICE_TOL, assert_close, jax_pipeline, nprand,
                                port_pipeline, to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_samplers import jax_model, schedules, torch_model
from test_torch_slice import PROMPTS, tiny_config

from sd_tpu.diffusion import ddim as jddim
from sd_tpu.diffusion import latent as jlatent
from sd_tpu.pipeline import Text2ImagePipeline as JPipeline
from sd_tpu_torch.diffusion import ddim, latent
from sd_tpu_torch.pipeline import Text2ImagePipeline, to_uint8

STEPS = 4
_split = jax.jit(lambda k, n: jax.random.split(k, n), static_argnums=1)


def _normal(key, shape) -> torch.Tensor:
    return to_torch(np.asarray(jax.random.normal(key, shape, jnp.float32)))


def _blend_draws(key, steps: int, shape) -> dict:
    """{DDIM index: the inpainting blend's noise} of the JAX sampler's key
    stream: one split for x_T, then three a step (rng, blend, step)."""
    draws, k = {}, _split(key, 2)[0]
    for index in range(steps - 1, -1, -1):
        k, mk, _ = _split(k, 3)
        draws[index] = _normal(mk, shape)
    return draws


def assert_within_a_level(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert d.max() <= 1, f"max {d.max()} levels, {np.mean(d > 0):.2%} of pixels"


@pytest.fixture(scope="module")
def pipes():
    cfg = tiny_config()
    jpipe = jax_pipeline(cfg, seed=7)
    return jpipe, port_pipeline(cfg, jpipe)


def _images(n, hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)


# -- DDIM: stochastic_encode, decode, the inpainting blend ---------------------------


def test_ddim_img2img_pieces_match():
    js, ts = schedules()
    jsam, tsam = jddim.DDIMSampler(js), ddim.DDIMSampler(ts)
    jdd, tdd = jsam.make_schedule(5), tsam.make_schedule(5)
    x0, noise = nprand(2, 4, 4, 3, seed=1), nprand(2, 4, 4, 3, seed=2)
    cond, uncond = nprand(2, 1, 1, 3, seed=3), nprand(2, 1, 1, 3, seed=4)
    ref = jax.jit(lambda x, n: jsam.stochastic_encode(x, jnp.asarray(2), None, jdd, noise=n))(
        jnp.asarray(x0), jnp.asarray(noise))
    got = tsam.stochastic_encode(to_torch(x0), 2, tdd, to_torch(noise))
    assert_close(got, ref, MODULE_TOL)
    ref = jax.jit(lambda x, c, u: jsam.decode(jax_model, x, 3, jax.random.PRNGKey(0), cond=c,
                                              uncond=u, guidance_scale=5.0, dd=jdd))(
        ref, jnp.asarray(cond), jnp.asarray(uncond))
    got = tsam.decode(torch_model, got, 3, cond=to_torch(cond), uncond=to_torch(uncond),
                      guidance_scale=5.0, dd=tdd)
    assert_close(got, ref, MODULE_TOL)


def test_ddim_masked_sample_matches_with_the_blend_noise_injected():
    """The blend draws fresh q_sample noise at every step, eta 0 or not: the
    JAX key stream's draws (split 3 a step) go in as `mask_noise`."""
    js, ts = schedules()
    shape = (2, 4, 4, 3)
    x_T, x0 = nprand(*shape, seed=1), nprand(*shape, seed=5)
    cond, uncond = nprand(2, 1, 1, 3, seed=2), nprand(2, 1, 1, 3, seed=3)
    mask = (np.random.default_rng(4).random((1, 4, 4, 1)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(lambda *a: jddim.DDIMSampler(js).sample(
        jax_model, key, shape, num_steps=5, cond=a[0], uncond=a[1], guidance_scale=5.0,
        x_T=a[2], mask=a[3], x0=a[4]))(*map(jnp.asarray, (cond, uncond, x_T, mask, x0)))
    draws = _blend_draws(key, 5, shape)
    got = ddim.DDIMSampler(ts).sample(
        torch_model, shape, to_torch(x_T), num_steps=5, cond=to_torch(cond),
        uncond=to_torch(uncond), guidance_scale=5.0, mask=to_torch(mask), x0=to_torch(x0),
        mask_noise=lambda index, s: draws[index])
    assert_close(got, ref, MODULE_TOL)


# -- tiles ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["up", "down"])
def test_patched_apply_matches(direction):
    """Up by 8 (the decoder's scale, checked) and down by 8 (the tiled
    encode's), over a 3 × 3 grid of overlapping tiles."""
    x = nprand(2, 32, 32, 3, seed=1)
    if direction == "up":
        jfn = lambda p: jnp.sin(jnp.repeat(jnp.repeat(p, 8, 1), 8, 2)) * jnp.mean(p)
        tfn = lambda p: torch.sin(p.repeat_interleave(8, 1).repeat_interleave(8, 2)) * p.mean()
        kw = dict(ks=8, stride=4, scale=8)
    else:
        jfn = lambda p: jnp.tanh(p.reshape(p.shape[0], p.shape[1] // 8, 8, -1, 8, 3).mean((2, 4)))
        tfn = lambda p: torch.tanh(p.reshape(p.shape[0], p.shape[1] // 8, 8, -1, 8, 3)
                                   .mean((2, 4)))
        kw = dict(ks=16, stride=8)
    ref = jax.jit(lambda x: jlatent.patched_apply(jfn, x, **kw))(jnp.asarray(x))
    got = latent.patched_apply(tfn, to_torch(x), **kw)
    assert_close(got, ref, MODULE_TOL)


def test_cover_stride_matches():
    for ks, H, W, step in ((64, 128, 128, 1), (512, 1024, 1024, 8), (8, 16, 16, 1),
                           (16, 32, 32, 2), (64, 128, 96, 1), (48, 100, 130, 4), (8, 8, 8, 1)):
        assert (Text2ImagePipeline._cover_stride(ks, H, W, step)
                == JPipeline._cover_stride(ks, H, W, step)), (ks, H, W, step)


# -- img2img, inpainting, hires --------------------------------------------------------


def test_masked_tiled_img2img_through_inpaint_matches(pipes):
    """`inpaint` on a plain model: img2img's blend at strength 1, the first
    stage tiled (16-px encode tiles, 8-latent decode tiles: 3 × 3 grids), an
    image-resolution mask subsampled to the config's latent grid."""
    jpipe, pipe = pipes
    init = _images(2, 32, seed=1)
    mask = np.zeros((32, 32), np.uint8)
    mask[:, :12] = 255
    seed, kw = 3, dict(num_steps=STEPS, guidance_scale=5.0, encode_tile=16, decode_tile=16)
    ref = jpipe.inpaint(PROMPTS, init, mask, seed=seed, **kw)

    r_enc, r_noise, r_dec = _split(jax.random.PRNGKey(seed), 3)
    draws = _blend_draws(r_dec, STEPS, (2, 16, 16, 4))
    m = torch.from_numpy(pipe._latent_keep_mask(mask))
    assert m.shape == (1, 16, 16, 1)
    img = pipe.img2img_sample(
        PROMPTS, torch.from_numpy(pipe._to_model_range(init)), STEPS, num_steps=STEPS,
        guidance_scale=5.0, mask=m, encode_tile=16, decode_tile=8,
        enc_noise=_normal(r_enc, (18, 8, 8, 4)), latent_noise=_normal(r_noise, (2, 16, 16, 4)),
        mask_noise=lambda index, s: draws[index])
    assert_within_a_level(to_uint8(img), ref)
    out = pipe.inpaint(PROMPTS, init, mask, seed=seed, **kw)
    assert out.shape == ref.shape and out.dtype == np.uint8


def test_generate_hires_in_parts(pipes, monkeypatch):
    """The JAX package's `generate_hires` (32² → 64², bicubic) taken apart:
    its base images against the port's `sample` on its x_T, its PIL upscale
    against the port's, and its img2img refine pass against the port's on the
    same upscaled images and draws (seed + 1); then the port's own
    `generate_hires` is its parts."""
    jpipe, pipe = pipes
    seen = {}
    jgen, ji2i = jpipe.generate, jpipe.img2img
    monkeypatch.setattr(jpipe, "generate", lambda *a, **k: seen.setdefault("base", jgen(*a, **k)))
    monkeypatch.setattr(jpipe, "img2img",
                        lambda p, up, **k: ji2i(p, seen.setdefault("up", up), **k))
    seed, kw = 2, dict(num_steps=STEPS, hires_steps=STEPS, guidance_scale=5.0)
    ref = jpipe.generate_hires(PROMPTS, denoising_strength=0.7, seed=seed, **kw)

    x_T = _normal(_split(jax.random.PRNGKey(seed), 2)[1], (2, 16, 16, 4))
    base = to_uint8(pipe.sample(PROMPTS, x_T, num_steps=STEPS, guidance_scale=5.0))
    assert_within_a_level(base, seen["base"])
    assert_within_a_level(pipe.upscale(seen["base"], 2.0), seen["up"])
    r_enc, r_noise, _ = _split(jax.random.PRNGKey(seed + 1), 3)
    t_start = int(0.7 * STEPS)
    img = pipe.img2img_sample(
        PROMPTS, torch.from_numpy(pipe._to_model_range(seen["up"])), t_start,
        num_steps=STEPS, guidance_scale=5.0, enc_noise=_normal(r_enc, (2, 32, 32, 4)),
        latent_noise=_normal(r_noise, (2, 32, 32, 4)))
    assert_within_a_level(to_uint8(img), ref)

    got = pipe.generate_hires(PROMPTS, denoising_strength=0.7, seed=seed, **kw)
    base = pipe.generate(PROMPTS, num_steps=STEPS, guidance_scale=5.0, seed=seed)
    parts = pipe.img2img(PROMPTS, pipe.upscale(base, 2.0), strength=0.7, num_steps=STEPS,
                         guidance_scale=5.0, seed=seed + 1)
    np.testing.assert_array_equal(got, parts)


def test_generate_decode_tile():
    """A tile no smaller than the image is the whole decode, bit for bit; a
    smaller one is `patched_apply` of the decode at `_cover_stride`."""
    cfg = tiny_config()
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    whole = pipe.generate(PROMPTS, num_steps=STEPS, seed=1)
    np.testing.assert_array_equal(pipe.generate(PROMPTS, num_steps=STEPS, seed=1,
                                                decode_tile=32), whole)
    z = to_torch(nprand(2, 16, 16, 4, seed=3))
    tiled = pipe._decode(z, 8)
    assert_close(tiled, latent.patched_apply(pipe.ld.decode_fn, z, 8, 4, scale=2), 0.0)


def test_conditioned_inpaint_matches(tmp_path):
    """`inpaint` on `configs/inpaint_smoke.yaml` (hybrid, in_channels 9):
    the concat conditioning [hole↓ | E(x·(1 − hole))·scale] on both CFG
    branches, x_T and the posterior noise from the JAX key stream; the
    pipeline's uint8 output keeps the kept pixels bit for bit."""
    with open("configs/inpaint_smoke.yaml") as f:
        cfg = yaml.safe_load(f)
    jpipe = jax_pipeline(cfg, seed=11)
    pipe = port_pipeline(cfg, jpipe)
    assert pipe._is_inpaint_model() and jpipe._is_inpaint_model()
    init = _images(2, 32, seed=4)
    mask = np.full((32, 32), 255, np.uint8)
    mask[8:20, 10:30] = 0
    seed, kw = 5, dict(num_steps=STEPS, guidance_scale=3.0)
    ref = jpipe.inpaint(PROMPTS, init, mask, seed=seed, **kw)

    r_enc, r_sample = _split(jax.random.PRNGKey(seed), 2)
    hole = pipe._normalize_keep_mask(mask, 2, 32, 32)
    x = pipe._to_model_range(init)
    img = pipe.inpaint_sample(PROMPTS, torch.from_numpy(x), torch.from_numpy(hole), **kw,
                              enc_noise=_normal(r_enc, (2, 8, 8, 4)),
                              x_T=_normal(_split(r_sample, 2)[1], (2, 8, 8, 4)))
    keep = ~np.broadcast_to(hole.astype(bool), ref.shape)
    assert_within_a_level(np.where(keep, init, to_uint8(img)), ref)
    out = pipe.inpaint(PROMPTS, init, mask, seed=seed, **kw)
    np.testing.assert_array_equal(out[keep], init[keep])
    np.testing.assert_array_equal(ref[keep], init[keep])


# -- textual inversion, safetensors ---------------------------------------------------


def test_textual_inversion_file_of_the_tpu_package(pipes, tmp_path):
    """A 2-vector embedding written by `sd_tpu`'s `save_embedding`, loaded
    by both pipelines: the placeholder expands alike and the text embedding
    of a prompt that names it matches."""
    from sd_tpu.train.textual_inversion import save_embedding

    jpipe, pipe = pipes
    path = str(tmp_path / "embedding.safetensors")
    save_embedding(path, "<cat-toy>", nprand(2, 32, seed=8))
    prompts = ["a photo of <cat-toy> on a mat", "a plain prompt"]
    params, expansions = jpipe.clip.params, dict(jpipe._ti_expansions)
    try:
        assert jpipe.load_textual_inversion(path) == ["<cat-toy>"]
        ids, _ = jpipe._tokenize_weighted(prompts)
        ref = jax.jit(jpipe.clip.encode)(jpipe.clip.params, ids)
    finally:
        jpipe.clip.params, jpipe._ti_expansions = params, expansions
    fresh = port_pipeline(tiny_config(), jpipe)
    assert fresh.load_textual_inversion(path) == ["<cat-toy>"]
    got_ids, _ = fresh._tokenize_weighted(prompts)
    np.testing.assert_array_equal(got_ids, np.asarray(ids))
    c, _ = fresh.encode_prompts(prompts)
    assert_close(c, ref, MODULE_TOL)
    before, _ = pipe.encode_prompts(prompts)
    assert not torch.equal(before[0], c[0]) and torch.equal(before[1], c[1])


def test_safetensors_round_trip_between_packages(tmp_path):
    from sd_tpu.utils import safetensors_io as jst
    from sd_tpu_torch.utils import safetensors_io as st

    tensors = {"w": torch.randn(3, 5).bfloat16(), "b": torch.arange(4, dtype=torch.int32),
               "s": torch.tensor(2.5), "e": torch.zeros(0, 2), "m": torch.ones(2, 2, 2).bool()}
    st.save_safetensors(str(tmp_path / "a.safetensors"), tensors, {"k": "v"})
    back, meta = jst.load_safetensors(str(tmp_path / "a.safetensors"), return_metadata=True)
    assert meta == {"k": "v"} and sorted(back) == sorted(tensors)
    for name, t in tensors.items():
        np.testing.assert_array_equal(np.asarray(back[name], np.float32), t.float().numpy())
    jst.save_safetensors(str(tmp_path / "b.safetensors"), back, {"k": "v"})
    assert ((tmp_path / "a.safetensors").read_bytes()
            == (tmp_path / "b.safetensors").read_bytes())
    again = st.load_safetensors(str(tmp_path / "b.safetensors"))
    for name, t in tensors.items():
        assert again[name].dtype == t.dtype and torch.equal(again[name], t)


# -- resamplers -------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["nearest", "lanczos"])
@pytest.mark.parametrize("size", [(32, 32, 64, 64), (37, 50, 64, 100), (64, 64, 20, 32),
                                  (17, 23, 51, 7)])
def test_resamplers_match_pil(method, size):
    from PIL import Image

    from sd_tpu_torch.data.image_io import resize

    h, w, H, W = size
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    pil = {"nearest": Image.NEAREST, "lanczos": Image.LANCZOS}[method]
    ref = np.asarray(Image.fromarray(img).resize((W, H), pil))
    assert_within_a_level(resize(img, H, W, method), ref)
    if method == "nearest":
        np.testing.assert_array_equal(resize(img, H, W, method), ref)


def test_gray_conversion_matches_pil():
    from PIL import Image

    from sd_tpu_torch.data.image_io import to_gray

    for c in (3, 4):
        img = np.random.default_rng(c).integers(0, 256, (20, 30, c), dtype=np.uint8)
        np.testing.assert_array_equal(to_gray(img), np.asarray(Image.fromarray(img).convert("L")))


# -- the command lines ------------------------------------------------------------------


def _tiny_run_files(tmp_path):
    from sd_tpu_torch.data.image_io import write_png

    cfg = tiny_config()
    cfg["train"]["image_size"] = 32
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    write_png(str(tmp_path / "init.png"), _images(1, 40, seed=2)[0])
    mask = np.zeros((40, 40, 3), np.uint8)
    mask[:20] = 255
    write_png(str(tmp_path / "mask.png"), mask)
    return cfg, str(path)


@pytest.mark.parametrize("masked", [False, True])
def test_img2img_cli_is_the_pipeline(tmp_path, masked):
    from sd_tpu_torch import img2img as cli
    from sd_tpu_torch.data.image_io import read_rgb, resize

    cfg, path = _tiny_run_files(tmp_path)
    out = str(tmp_path / "out.png")
    argv = ["--config", path, "--init-image", str(tmp_path / "init.png"), "--prompt", "a cube",
            "--steps", "4", "--strength", "0.5", "--seed", "3", "--out", out, "--device", "cpu"]
    assert cli.main(argv + (["--mask", str(tmp_path / "mask.png")] if masked else [])) == 0
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    init = resize(read_rgb(str(tmp_path / "init.png")), 32, 32)[None]
    mask = None
    if masked:
        mask = np.zeros((1, 16, 16), np.uint8)
        mask[:, :8] = 255
    want = pipe.img2img(["a cube"], init, strength=0.5, num_steps=4, seed=3, mask=mask)
    np.testing.assert_array_equal(read_rgb(out), want[0])


def test_sample_cli_is_the_pipeline_and_reads_a_run(tmp_path):
    from sd_tpu_torch import sample as cli
    from sd_tpu_torch.data.image_io import read_rgb
    from sd_tpu_torch.train.checkpoint import save_checkpoint
    from sd_tpu_torch.train.metrics import make_grid

    cfg, path = _tiny_run_files(tmp_path)
    out = str(tmp_path / "s.png")
    base = ["--config", path, "--prompt", "a cube", "a cone", "--steps", "4", "--seed", "1",
            "--out", out, "--device", "cpu"]
    assert cli.main(base) == 0
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    want = pipe.generate(["a cube", "a cone"], num_steps=4, guidance_scale=7.5, seed=1)
    np.testing.assert_array_equal(read_rgb(out), make_grid(want))
    # --ckpt: a run's EMA weights, read as from_run reads them
    gen = torch.Generator().manual_seed(5)
    shadow = {n: torch.randn(p.shape, generator=gen) * 0.1
              for n, p in pipe.unet.named_parameters()}
    save_checkpoint(str(tmp_path / "run" / "ckpt"), {"ema": {"shadow": shadow}}, 1)
    assert cli.main(base + ["--ckpt", str(tmp_path / "run" / "ckpt")]) == 0
    with torch.no_grad():
        for n, p in pipe.unet.named_parameters():
            p.copy_(shadow[n])
    want = pipe.generate(["a cube", "a cone"], num_steps=4, guidance_scale=7.5, seed=1)
    np.testing.assert_array_equal(read_rgb(out), make_grid(want))


@pytest.fixture(scope="module")
def adapter_runs(tmp_path_factory):
    """A tiny config's files, a ControlNet run (the branch of a random
    pipeline, its zero projections random too) and an IP-Adapter run (an
    adapter and the ViT-B/32 image embedder, random), as checkpoint
    directories of the port's format."""
    from sd_tpu_torch.data.image_io import write_png
    from sd_tpu_torch.models.conditioners import FrozenClipImageEmbedder
    from sd_tpu_torch.models.controlnet import controlnet_from_unet_config
    from sd_tpu_torch.models.ip_adapter import init_ip_adapter
    from sd_tpu_torch.train.checkpoint import save_checkpoint
    from sd_tpu_torch.weights import randomize_params_

    root = tmp_path_factory.mktemp("sample_cli")
    cfg, path = _tiny_run_files(root)
    gen = torch.Generator().manual_seed(11)
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    randomize_params_(pipe.unet, gen)
    save_checkpoint(str(root / "ldm" / "ckpt"), {"params": dict(pipe.unet.named_parameters())}, 1)
    cn = controlnet_from_unet_config(cfg["unet"]["params"], hint_downsamples=1, device="cpu")
    randomize_params_(cn, gen)
    save_checkpoint(str(root / "cn" / "ckpt"), {"params": dict(cn.named_parameters())}, 1)
    embedder = FrozenClipImageEmbedder(device="cpu")
    randomize_params_(embedder, gen)
    save_checkpoint(str(root / "ip" / "ckpt"), {"params": init_ip_adapter(pipe.unet, gen)}, 1)
    save_checkpoint(str(root / "ip" / "ip_embedder"), dict(embedder.named_parameters()), 1)
    write_png(str(root / "x.png"), _images(1, 24, seed=5)[0])
    return cfg, path, {"ldm": str(root / "ldm" / "ckpt"), "cn": str(root / "cn"),
                       "ip": str(root / "ip"), "x.png": str(root / "x.png"),
                       "init": str(root / "init.png")}


@pytest.mark.parametrize("flag", [["--controlnet", "run"], ["--ip-adapter", "run"],
                                  ["--ip-image", "x.png"], ["--control-image", "x.png"],
                                  ["--sag-scale", "0.5"]])
def test_sample_cli_refuses_the_unported(tmp_path, capsys, flag, adapter_runs):
    """Nothing of these is refused now: each flag (with the flags it needs,
    on a run's random UNet, `--ckpt`) writes the grid of the pipeline call it
    stands for, which differs from plain generate's — `load_controlnet`
    and `generate(control_image=…)` on the edge hint of the image resized
    bicubic to the output size (or, with `--control-extract none`, the
    image / 255), `load_ip_adapter` and `generate(ip_image=…)`,
    `generate(sag_scale=…)`; a ControlNet without its image exits 2."""
    from sd_tpu_torch import sample as cli
    from sd_tpu_torch.data.hints import edge_hint
    from sd_tpu_torch.data.image_io import read_rgb, resize
    from sd_tpu_torch.train.metrics import make_grid

    cfg, path, files = adapter_runs
    out = str(tmp_path / "s.png")
    base = ["--config", path, "--prompt", "a cube", "a cone", "--steps", "4", "--seed", "1",
            "--out", out, "--device", "cpu", "--ckpt", files["ldm"]]
    extra = {"--controlnet": ["--controlnet", files["cn"], "--control-image", files["init"]],
             "--ip-adapter": ["--ip-adapter", files["ip"], "--ip-image", files["x.png"]],
             "--ip-image": ["--ip-adapter", files["ip"], "--ip-image", files["x.png"],
                            "--ip-scale", "0.5"],
             "--control-image": ["--controlnet", files["cn"], "--control-image", files["x.png"],
                                 "--control-extract", "none", "--control-scale", "0.5"],
             "--sag-scale": flag}[flag[0]]
    assert cli.main(base + extra) == 0
    pipe = Text2ImagePipeline.from_run(cfg, str(Path(files["ldm"]).parent), param_dtype=None,
                                       device="cpu")
    kw = {}
    if "--controlnet" in extra:
        image = resize(read_rgb(extra[3]), 32, 32, method="bicubic")
        none = "--control-extract" in extra
        pipe.load_controlnet(files["cn"], control_scale=0.5 if none else 1.0)
        kw["control_image"] = image.astype(np.float32) / 255.0 if none else edge_hint(image)
    elif "--ip-adapter" in extra:
        pipe.load_ip_adapter(files["ip"], ip_scale=0.5 if "--ip-scale" in extra else 1.0)
        kw["ip_image"] = read_rgb(files["x.png"])
    else:
        kw["sag_scale"] = 0.5
    want = pipe.generate(["a cube", "a cone"], num_steps=4, guidance_scale=7.5, seed=1, **kw)
    np.testing.assert_array_equal(read_rgb(out), make_grid(want))
    assert not np.array_equal(want, pipe.generate(["a cube", "a cone"], num_steps=4, seed=1))
    if flag[0] == "--controlnet":
        assert cli.main(base + ["--controlnet", files["cn"]]) == 2
        assert "--control-image" in capsys.readouterr().err
