"""The training run around the port's trainers, on the CPU at tiny widths
(16-32 px, the `*_smoke` configs or narrower):

* checkpoints (`sd_tpu_torch/train/checkpoint.py`): a `TrainState` and a
  `GanTrainState` (bf16 parameters, fp32 moments, EMA, logvar, running
  statistics, codebook buffers, the counts) round trip bitwise into a live
  state, in place; `max_to_keep`; a temporary file left by a killed save is
  never the latest; a checkpoint of another shape is refused with the
  tensor's name; the import helpers equal the JAX package's;
* `python -m sd_tpu_torch.train --device cpu` (`main`) for `ddpm`,
  `kl_vae` and `vq` on a folder of PNGs: each writes `config.json`,
  `ckpt/`, `metrics.jsonl` and its eval grid (with `eval_psnr` /
  `eval_ssim` for the codecs), and a second call resumes with the saved
  state bit for bit and appends to the metrics file;
* `ldm` on a tiny KL run's checkpoint: its first stage's encode equals the
  KL state's autoencoder's, `calibration.json` holds the factor, the run
  resumes bit for bit; a run broken after 2 steps and resumed for a third
  ends in the same state as an unbroken 3-step run on the same batches (each
  step's draws from (seed, step)); a VQ run's checkpoint as the first stage
  (its latent before quantization); a checkpoint of another width refused;
* `Text2ImagePipeline.from_run` of that run gives the images of a pipeline
  given the same EMA weights, first stage and scale factor by hand;
* `python -m sd_tpu_torch.serve --run` answers one request over HTTP;
* the CLI refuses an unported task.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sd_tpu.train import checkpoint as jckpt
from sd_tpu_torch import serve
from sd_tpu_torch.core.config import (ddpm_smoke_config, kl_f8_256_train_config,
                                      sd512_train_config, vq_smoke_config)
from sd_tpu_torch.data.image_io import decode_png, write_png
from sd_tpu_torch.models.autoencoder import AutoencoderKL, VQModel
from sd_tpu_torch.models.discriminator import NLayerDiscriminator
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.train import checkpoint as ckpt
from sd_tpu_torch.train import runners
from sd_tpu_torch.train.__main__ import main
from sd_tpu_torch.train.diffusion import float32_moments, ddpm_optimizer, init_train_state
from sd_tpu_torch.train.gan import gan_adam, init_gan_state

KL_PARAMS = dict(embed_dim=4, ch=16, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[],
                 resolution=32, z_channels=4)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def assert_same_tree(a, b) -> None:
    """Two checkpoint trees (or states) equal: keys, numbers, and every
    tensor's dtype, shape and bits."""
    fa, fb = _flat(ckpt.state_tree(a)), _flat(ckpt.state_tree(b))
    assert sorted(fa) == sorted(fb)
    for k, x in fa.items():
        y = fb[k]
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device)), k
        else:
            assert x == y, k


# -- checkpoints --------------------------------------------------------------------


def _train_state(seed: int):
    g = torch.Generator().manual_seed(seed)
    params = {"a.weight": torch.randn(3, 4, generator=g).bfloat16(),
              "b.bias": torch.randn(5, generator=g).bfloat16()}
    state = init_train_state(params, float32_moments(ddpm_optimizer(1e-3)), 0.999,
                             num_timesteps=7)
    for t in (*state.opt_state.mu, *state.opt_state.nu, *state.ema.shadow.values(),
              state.logvar):
        t.copy_(torch.randn(t.shape, generator=g))
    state.opt_state.count, state.ema.num_updates, state.step = seed + 3, seed + 2, seed + 5
    return state


def _gan_state(seed: int):
    g = torch.Generator().manual_seed(seed)
    vq = VQModel(n_embed=8, embed_dim=4, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                 z_channels=4, quantizer_type="ema", device="cpu")
    disc = NLayerDiscriminator(ndf=4, n_layers=1, device="cpu")
    opt = float32_moments(gan_adam(1e-4))
    state = init_gan_state(vq, disc, opt, opt, param_dtype=torch.bfloat16)
    with torch.no_grad():
        for t in _flat(ckpt.state_tree(state)).values():
            if torch.is_tensor(t):
                t.copy_(torch.randn(t.shape, generator=g))
    state.opt_state_g.count = state.opt_state_d.count = state.step = seed + 1
    return state


@pytest.mark.parametrize("make", [_train_state, _gan_state])
def test_checkpoint_round_trip_is_bitwise(tmp_path, make):
    saved = make(1)
    ckpt.save_checkpoint(str(tmp_path), saved, 6)
    live = make(2)
    ids = {k: v.data_ptr() for k, v in _flat(ckpt.state_tree(live)).items()
           if torch.is_tensor(v)}
    assert ckpt.restore_checkpoint(str(tmp_path), live) is live
    assert_same_tree(live, saved)
    # in place: the live state's own tensors hold the restored values
    assert ids == {k: v.data_ptr() for k, v in _flat(ckpt.state_tree(live)).items()
                   if torch.is_tensor(v)}
    tree = ckpt.restore_tree(str(tmp_path))
    assert sorted(tree) == sorted(f.name for f in dataclasses.fields(saved))
    fresh, start = ckpt.auto_resume(str(tmp_path), lambda: make(3))
    assert start == 6
    assert_same_tree(fresh, saved)


def test_checkpoint_keeps_the_newest_and_skips_temporary_files(tmp_path):
    state = _train_state(0)
    for step in range(1, 6):
        ckpt.save_checkpoint(str(tmp_path), state, step)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    (tmp_path / ".step_9.pt.tmp.123").write_bytes(b"half a file")   # a killed save
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.auto_resume(str(tmp_path / "none"), lambda: "fresh") == ("fresh", 0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_tree(str(tmp_path / "none"))
    other = init_train_state({"a.weight": torch.zeros(3, 5), "b.bias": torch.zeros(5)},
                             ddpm_optimizer(1e-3), 0.999, num_timesteps=7)
    with pytest.raises(ValueError, match="a.weight"):
        ckpt.restore_checkpoint(str(tmp_path), other)


def test_checkpoint_helpers_equal_the_tpu_packages():
    sd = {"model.a": 1, "model.b.c": 2, "first_stage.x": 3, "d": 4}
    assert ckpt.strip_prefix(sd) == jckpt.strip_prefix(sd)
    assert ckpt.filter_ignore_keys(sd, ["model.b", "d"]) == jckpt.filter_ignore_keys(
        sd, ["model.b", "d"])
    tree = {"a": torch.tensor([1.0, float("nan")]), "b": [torch.tensor([float("inf")]),
                                                          torch.tensor([1, 2])]}
    np_tree = {"a": np.array([1.0, np.nan]), "b": [np.array([np.inf]), np.array([1, 2])]}
    assert ckpt.check_tree_health(tree) == jckpt.check_tree_health(np_tree)
    cast = ckpt.cast_tree(tree)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"][1].dtype == torch.int64


# -- the runs -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def images(tmp_path_factory) -> str:
    """8 PNGs of two classes, 40×36 (resized and squashed to the configs'
    sizes by the loader)."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(8):
        write_png(str(root / f"{('cat', 'dog')[i % 2]}.{i}.png"),
                  rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    return str(root)


def _kl_cfg() -> dict:
    cfg = kl_f8_256_train_config()
    cfg["model"]["params"] = dict(KL_PARAMS)
    cfg["discriminator"] = {"ndf": 8, "n_layers": 1, "use_actnorm": False}
    cfg["loss"].update(perceptual="none", disc_start=1)
    cfg["train"].update(image_size=32, batch_size=2, total_steps=2, checkpoint_every=2,
                        eval_every=2, param_dtype="bfloat16")
    return cfg


def _ddpm_cfg() -> dict:
    cfg = ddpm_smoke_config()
    cfg["diffusion"]["timesteps"] = 8
    cfg["train"].update(total_steps=2, checkpoint_every=2, eval_every=2)
    return cfg


def _vq_cfg() -> dict:
    cfg = vq_smoke_config()
    cfg["train"].update(total_steps=2, eval_every=2, checkpoint_every=2)
    return cfg


def _cli(cfg: dict, images: str, out: Path, *extra) -> int:
    out.mkdir(exist_ok=True)
    path = out.parent / f"{out.name}.json"
    path.write_text(json.dumps(cfg))
    return main(["--config", str(path), "--data", images, "--out", str(out), "--device", "cpu",
                 *extra])


class _Resumes:
    """Keeps the state `auto_resume` hands back (a deep copy) and its step."""

    def __init__(self, monkeypatch):
        self.got = []
        real = runners.auto_resume

        def spy(ckpt_dir, fresh):
            state, start = real(ckpt_dir, fresh)
            self.got.append((copy.deepcopy(ckpt.state_tree(state)), start))
            return state, start

        monkeypatch.setattr(runners, "auto_resume", spy)


def _records(out: Path) -> list[dict]:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("task,make", [("ddpm", _ddpm_cfg), ("kl_vae", _kl_cfg),
                                       ("vq", _vq_cfg)])
def test_cli_trains_writes_evaluates_and_resumes(tmp_path, monkeypatch, images, task, make):
    resumes = _Resumes(monkeypatch)
    out = tmp_path / task
    assert _cli(make(), images, out) == 0
    assert sorted(os.listdir(out)) == ["ckpt", "config.json", "metrics.jsonl", "samples"]
    assert json.loads((out / "config.json").read_text()) == make()
    assert ckpt.all_steps(str(out / "ckpt")) == [2]
    grid = decode_png((out / "samples" / "step_2.png").read_bytes())
    assert grid.ndim == 3 and grid.shape[-1] == 3
    saved = ckpt.restore_tree(str(out / "ckpt"))
    assert _cli(make(), images, out, "--max-steps", "3") == 0
    assert [start for _, start in resumes.got] == [0, 2]
    assert_same_tree(resumes.got[1][0], saved)
    assert ckpt.all_steps(str(out / "ckpt")) == [2, 3]
    recs = _records(out)
    assert [r["step"] for r in recs if "eval_psnr" not in r] == [0, 1, 2]
    evals = [r for r in recs if "eval_psnr" in r]
    assert len(evals) == (0 if task == "ddpm" else 1)
    assert all(np.isfinite(r["eval_psnr"]) and np.isfinite(r["eval_ssim"]) for r in evals)


@pytest.fixture(scope="module")
def kl_run(tmp_path_factory, images) -> Path:
    out = tmp_path_factory.mktemp("runs") / "kl"
    assert _cli(_kl_cfg(), images, out) == 0
    return out


def _ldm_cfg(first_stage_ckpt: Path | None) -> dict:
    cfg = sd512_train_config()
    cfg["unet"]["params"].update(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                                 attention_resolutions=[1], num_heads=4, context_dim=32)
    cfg["first_stage"]["params"] = dict(KL_PARAMS)
    if first_stage_ckpt is not None:
        cfg["first_stage"]["ckpt"] = str(first_stage_ckpt)
    cfg["cond_stage"]["params"] = dict(vocab_size=1000, hidden_size=32, num_layers=2,
                                       num_heads=4, max_length=16)
    cfg["latent"]["image_size"] = 8
    cfg["train"].update(image_size=16, total_steps=2, checkpoint_every=2, lr_schedule=None)
    return cfg


@pytest.fixture(scope="module")
def ldm_run(tmp_path_factory, images, kl_run) -> Path:
    out = tmp_path_factory.mktemp("runs") / "ldm"
    assert _cli(_ldm_cfg(kl_run / "ckpt"), images, out) == 0
    return out


def test_ldm_encodes_with_the_kl_runs_first_stage(kl_run):
    cfg = _ldm_cfg(kl_run / "ckpt")
    ld, _, vae, _ = runners.build_ldm(cfg, torch.Generator().manual_seed(0), device="cpu")
    trained = ckpt.restore_tree(str(kl_run / "ckpt"))["params_g"]
    ref = AutoencoderKL(**KL_PARAMS, device="cpu").eval()
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(trained[n].float())
        for n, p in vae.named_parameters():
            assert p.dtype == torch.float32 and torch.equal(p, trained[n].float()), n
        x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
        noise = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(2))
        assert torch.equal(ld.encode_first_stage(x, noise), ref.encode(x).sample(noise))
    with pytest.raises(ValueError, match="shape"):
        wide = _ldm_cfg(kl_run / "ckpt")
        wide["first_stage"]["params"]["ch"] = 32
        runners.build_ldm(wide, torch.Generator().manual_seed(0), device="cpu")
    other = _ldm_cfg(kl_run / "ckpt")
    other["first_stage"] = {"target": "sd_tpu.models.autoencoder.IdentityFirstStage"}
    ld, _, identity, _ = runners.build_ldm(other, torch.Generator().manual_seed(0),
                                           device="cpu")
    assert runners.first_stage_factor(other["first_stage"]) == 1
    assert not list(identity.parameters())
    assert torch.equal(ld.encode_first_stage(x), x) and torch.equal(ld.decode_fn(x), x)


def test_ldm_run_calibrates_and_resumes_bitwise(tmp_path, monkeypatch, images, kl_run, ldm_run):
    assert sorted(os.listdir(ldm_run)) == ["calibration.json", "ckpt", "config.json",
                                           "metrics.jsonl"]
    sf = json.loads((ldm_run / "calibration.json").read_text())["scale_factor"]
    assert np.isfinite(sf) and sf > 0
    assert [r["step"] for r in _records(ldm_run)] == [0, 1]
    # a copy of the run, resumed once through the CLI: the saved state bit for bit
    resumes = _Resumes(monkeypatch)
    out = tmp_path / "ldm"
    import shutil
    shutil.copytree(ldm_run, out)
    saved = ckpt.restore_tree(str(out / "ckpt"))
    assert _cli(_ldm_cfg(kl_run / "ckpt"), images, out, "--max-steps", "3") == 0
    assert resumes.got[0][1] == 2
    assert_same_tree(resumes.got[0][0], saved)
    assert [r["step"] for r in _records(out)] == [0, 1, 2]


def test_a_broken_and_resumed_run_ends_where_an_unbroken_one_does(tmp_path, kl_run):
    cfg = _ldm_cfg(kl_run / "ckpt")
    cfg["train"]["cond_dropout"] = 0.0       # its stream restarts on resume, as in sd_tpu
    cfg["latent"]["scale_factor"] = 0.5      # "auto" calibrates on the batches handed in
    rng = np.random.default_rng(3)
    batches = [{"image": rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32),
                "txt_raw": ["a photo of a cat", "a photo of a dog"] * 2} for _ in range(3)]
    whole, _ = runners.train_ldm(cfg, batches, out_dir=str(tmp_path / "a"), max_steps=3,
                                 device="cpu")
    runners.train_ldm(cfg, batches[:2], out_dir=str(tmp_path / "b"), max_steps=2, device="cpu")
    resumed, hist = runners.train_ldm(cfg, [batches[2]], out_dir=str(tmp_path / "b"),
                                      max_steps=3, device="cpu")
    assert len(hist) == 1 and resumed.step == whole.step == 3
    assert_same_tree(resumed, whole)


def test_ldm_on_a_vq_runs_first_stage(tmp_path, images):
    vq_out = tmp_path / "vq"
    assert _cli(_vq_cfg(), images, vq_out) == 0
    cfg = _ldm_cfg(vq_out / "ckpt")
    cfg["first_stage"] = {"target": "sd_tpu.models.autoencoder.VQModel",
                          "params": dict(vq_smoke_config()["model"]["params"]),
                          "ckpt": str(vq_out / "ckpt")}
    ld, _, vq, _ = runners.build_ldm(cfg, torch.Generator().manual_seed(0), device="cpu")
    trained = ckpt.restore_tree(str(vq_out / "ckpt"))["params_g"]
    assert isinstance(vq, VQModel)
    for n, p in vq.named_parameters():
        assert torch.equal(p, trained[n].float()), n
    x = torch.rand(1, 16, 16, 3) * 2 - 1
    with torch.no_grad():
        z = ld.encode_first_stage(x)
        assert torch.equal(z, vq.encode_pre_quant(x))
        assert torch.equal(ld.decode_fn(z), vq.decode(vq.quantize(z)[0]))


def test_from_run_serves_the_trained_weights(kl_run, ldm_run):
    cfg_path = str(ldm_run / "config.json")
    pipe = Text2ImagePipeline.from_run(cfg_path, str(ldm_run), param_dtype=None, device="cpu")
    images = pipe.generate(["a photo of a cat"], num_steps=4, seed=3)
    cfg = json.loads(Path(cfg_path).read_text())
    del cfg["first_stage"]["ckpt"]
    hand = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    tree = ckpt.restore_tree(str(ldm_run / "ckpt"))
    fs = ckpt.restore_tree(str(kl_run / "ckpt"))["params_g"]
    with torch.no_grad():
        for n, p in hand.unet.named_parameters():
            p.copy_(tree["ema"]["shadow"][n])
        for n, p in hand.vae.named_parameters():
            p.copy_(fs[n].float())
    sf = json.loads((ldm_run / "calibration.json").read_text())["scale_factor"]
    assert pipe.ld.scale_factor == sf
    hand.ld = dataclasses.replace(hand.ld, scale_factor=sf)
    np.testing.assert_array_equal(images, hand.generate(["a photo of a cat"], num_steps=4,
                                                        seed=3))


def test_serve_run_answers_a_request(monkeypatch, ldm_run):
    servers = []
    real = serve.make_http_server

    def capture(*a, **kw):
        servers.append(real(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(serve, "make_http_server", capture)
    done = {}
    t = threading.Thread(target=lambda: done.setdefault("code", serve.main(
        ["--config", str(ldm_run / "config.json"), "--run", str(ldm_run), "--device", "cpu",
         "--port", "0", "--steps", "4", "--batch-window-ms", "1"])), daemon=True)
    t.start()
    for _ in range(600):
        if servers:
            break
        t.join(0.1)
    assert servers, "the server did not start"
    host, port = servers[0].server_address[:2]
    try:
        req = urllib.request.Request(f"http://{host}:{port}/generate",
                                     data=json.dumps({"prompt": "a dog", "seed": 1}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        servers[0].shutdown()
    t.join(30)
    assert done.get("code") == 0
    import base64
    img = decode_png(base64.b64decode(out["image"]))
    assert img.shape == (16, 16, 3) and out["seed"] == 1


def test_cli_refuses_an_unported_task(tmp_path, capsys, images):
    cfg = _ddpm_cfg()
    cfg["task"] = "sr3"
    assert _cli(cfg, images, tmp_path / "sr") == 2
    assert "unknown task 'sr3'" in capsys.readouterr().err
