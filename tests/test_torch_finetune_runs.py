"""Whole fine-tuning runs of the port on the CPU, at the smoke configs'
widths: `python -m sd_tpu_torch.train --device cpu` on a folder of PNGs.

`ti_smoke`, `dreambooth_smoke`, `ip_smoke`, a LoRA config (the tiny LDM
with `lora: {rank: 4}`), `controlnet_32` on a base `ldm` run (at the smoke
configs' widths: its own UNet of 95M parameters would take minutes on the
CPU) and a trainable text encoder with AdamW, the noise offset and the
learned logvar: 2 steps, then resumed to 3 (the resumed run starts from the
saved step); each run's file loads through its loader and generates
(`load_textual_inversion`, `from_run`, `load_ip_adapter`, `load_lora`,
`load_controlnet`), `from_run` refuses the {unet, cond} run, and a task
that is not one of `scripts/train.py`'s exits 2
(`tests/test_torch_inpaint_train.py` runs `inpaint_smoke`,
`tests/test_torch_sr.py` `ldm_sr`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sd_tpu_torch.core import config as port_config
from sd_tpu_torch.data.image_io import write_png
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.train import checkpoint as ckpt
from sd_tpu_torch.train.__main__ import main

torch.set_num_threads(2)


def smoke_config(**blocks) -> dict:
    """`ip_smoke_config()`'s tiny LDM without its adapter, plus `blocks`."""
    cfg = port_config.ip_smoke_config()
    del cfg["ip_adapter"]
    cfg.update(blocks)
    return cfg


@pytest.fixture(scope="module")
def images(tmp_path_factory) -> str:
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(6):
        write_png(str(root / f"{('cat', 'dog')[i % 2]}.{i}.png"),
                  rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    return str(root)


def _short(cfg: dict) -> dict:
    cfg["train"].update(total_steps=2, checkpoint_every=2, eval_every=2)
    cfg.setdefault("sample", {})["num_steps"] = 2
    return cfg


def _cli(cfg: dict, images: str, out: Path, *extra) -> int:
    out.parent.mkdir(exist_ok=True, parents=True)
    path = out.parent / f"{out.name}.json"
    path.write_text(json.dumps(cfg))
    return main(["--config", str(path), "--data", images, "--out", str(out), "--device", "cpu",
                 *extra])


def _run_and_resume(cfg: dict, images: str, out: Path) -> None:
    """2 steps, then resumed to 3: the resumed run starts from the saved
    state (step 2) and ends at 3."""
    assert _cli(cfg, images, out) == 0
    saved = ckpt.restore_tree(str(out / "ckpt"))
    assert saved["step"] == 2
    assert _cli(cfg, images, out, "--max-steps", "3") == 0
    assert ckpt.all_steps(str(out / "ckpt")) == [2, 3]
    steps = [json.loads(line)["step"] for line in (out / "metrics.jsonl").read_text().split("\n")
             if line and "grad_norm" in line]
    assert steps == [0, 1, 2]


def _pipe(cfg: dict) -> Text2ImagePipeline:
    return Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)


def _generate(pipe, prompts=("a photo of a cat",), **kw):
    img = pipe.generate(list(prompts), num_steps=2, guidance_scale=1.0, seed=1, **kw)
    assert img.dtype == np.uint8 and img.shape == (len(prompts), 32, 32, 3)
    return img


def test_textual_inversion_run_resumes_and_serves(tmp_path, images):
    cfg = _short(port_config.ti_smoke_config())
    out = tmp_path / "ti"
    _run_and_resume(cfg, images, out)
    assert (out / "samples" / "step_2.png").exists()
    meta = json.loads((out / "ti.json").read_text())
    assert meta["placeholder"] == "<thing>" and meta["num_vectors"] == 2
    pipe = _pipe(cfg)
    assert pipe.load_textual_inversion(str(out / "embedding.safetensors")) == ["<thing>"]
    rows = pipe.clip.token_embedding.weight[torch.as_tensor(meta["ids"])]
    shadow = ckpt.restore_tree(str(out / "ckpt"))["ema"]["shadow"]["vectors"]
    assert torch.equal(rows, shadow)
    _generate(pipe, ["a photo of a <thing>"])


def test_dreambooth_run_resumes_and_serves(tmp_path, images):
    cfg = _short(port_config.dreambooth_smoke_config())
    out = tmp_path / "db"
    _run_and_resume(cfg, images, out)
    assert sorted(p.name for p in (out / "class_images").iterdir()) == [
        "class_0000.png", "class_0001.png"]
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().split("\n")
            if line and "grad_norm" in line]
    assert all(np.isfinite(r["prior_loss"]) and np.isfinite(r["instance_loss"]) for r in recs)
    _generate(Text2ImagePipeline.from_run(cfg, str(out), param_dtype=None, device="cpu"))


def test_ip_adapter_run_resumes_and_serves(tmp_path, images):
    cfg = _short(port_config.ip_smoke_config())
    out = tmp_path / "ip"
    _run_and_resume(cfg, images, out)
    assert (out / "ip_embedder").is_dir()
    pipe = _pipe(cfg)
    pipe.load_ip_adapter(str(out))
    shadow = ckpt.restore_tree(str(out / "ckpt"))["ema"]["shadow"]
    assert torch.equal(pipe.ip_params["proj"]["kernel"], shadow["proj.kernel"])
    ip_image = np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    _generate(pipe, ip_image=ip_image)


def test_lora_run_resumes_and_serves(tmp_path, images):
    cfg = _short(smoke_config(lora={"rank": 4, "scale": 1.0}))
    out = tmp_path / "lora"
    _run_and_resume(cfg, images, out)
    from sd_tpu_torch.train.lora import load_lora_safetensors

    factors = load_lora_safetensors(str(out / "lora.safetensors"))
    assert all(p["a"].shape[1] == 4 for p in factors.values())
    pipe = _pipe(cfg)
    pipe.load_lora(str(out / "lora.safetensors"))
    _generate(pipe)


def test_controlnet_run_on_a_base_run_resumes_and_serves(tmp_path, images):
    """`controlnet_32_config()` at the smoke configs' widths: the base run
    (`task: ldm`, `scale_factor: auto`) writes calibration.json, the
    ControlNet run loads the base's EMA UNet and its scale factor."""
    small = smoke_config()
    cfg = port_config.controlnet_32_config()
    for block in ("unet", "first_stage", "cond_stage"):
        cfg[block] = small[block]
    cfg["latent"].update(image_size=8, channels=4)
    cfg["train"].update(image_size=32, batch_size=2)
    base = _short({k: v for k, v in json.loads(json.dumps(cfg)).items() if k != "controlnet"})
    assert _cli(base, images, tmp_path / "base") == 0
    cfg["controlnet"]["base_run"] = str(tmp_path / "base")
    out = tmp_path / "cn"
    _run_and_resume(_short(cfg), images, out)
    pipe = Text2ImagePipeline.from_run(base, str(tmp_path / "base"), param_dtype=None,
                                       device="cpu")
    plain = _generate(pipe)
    pipe.load_controlnet(str(out))
    hint = np.random.default_rng(4).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    _generate(pipe, control_image=hint)
    assert np.array_equal(_generate(pipe), plain)


def test_trainable_text_encoder_run_is_refused_by_from_run(tmp_path, images):
    cfg = _short(smoke_config(cond_stage={**smoke_config()["cond_stage"], "trainable": True}))
    cfg["train"].update(weight_decay=1e-2, noise_offset=0.1, learn_logvar=True)
    out = tmp_path / "cond"
    assert _cli(cfg, images, out) == 0
    tree = ckpt.restore_tree(str(out / "ckpt"))
    assert {n.split(".")[0] for n in tree["params"]} == {"unet", "cond"}
    assert np.count_nonzero(tree["logvar"].numpy()) > 0
    with pytest.raises(ValueError, match="unet, cond"):
        Text2ImagePipeline.from_run(cfg, str(out), param_dtype=None, device="cpu")


def test_ldm_sr_still_exits_2(tmp_path, images, capsys):
    """`ldm_sr` was the last task the command line refused; every task of
    `scripts/train.py` now runs, and a task that is none of them exits 2."""
    cfg = port_config.inpaint_smoke_config()
    cfg["task"] = "ldm_sr_x4"
    assert _cli(cfg, images, tmp_path / "sr") == 2
    assert "unknown task 'ldm_sr_x4'" in capsys.readouterr().err


