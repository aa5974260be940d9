"""The mask-conditioned inpainting trainer's pieces against the JAX
package's, and its whole run, on the CPU at `configs/inpaint_smoke.yaml`'s
widths (the tiny LDM with 9 input channels, `hybrid`). Its training step
against the JAX package's is in `tests/test_torch_finetune_tasks.py`, whose
three JAX programs compile side by side.

* `random_inpaint_masks` gives the TPU package's masks bit for bit (3
  seeds, the smoke and the 128² menus), and the config checks raise its
  errors.
* `python -m sd_tpu_torch.train --device cpu` on `inpaint_smoke`: 2 steps
  with the eval grid, resumed to 3; `from_run` + the mask-conditioned
  `inpaint` of the run.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from test_torch_finetune_runs import _cli, _short, images  # noqa: F401 (fixture)

from sd_tpu.train import inpaint as jinpaint
from sd_tpu_torch.core.config import inpaint_128_config, inpaint_smoke_config
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.train import checkpoint as ckpt
from sd_tpu_torch.train import inpaint


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_inpaint_masks_are_the_tpu_packages(seed):
    for menu, (b, h, w) in (({"full_prob": 0.15}, (4, 32, 32)),
                            (inpaint_128_config()["data"]["inpaint"], (3, 128, 96))):
        got = inpaint.random_inpaint_masks(np.random.default_rng((seed, 0x1A5C)), b, h, w, **menu)
        want = jinpaint.random_inpaint_masks(np.random.default_rng((seed, 0x1A5C)), b, h, w,
                                             **menu)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert 0 < got.mean() <= 1


@pytest.mark.parametrize("change", [{"in_channels": 8}, {"conditioning_key": "crossattn"}])
def test_inpaint_config_checks_are_the_tpu_packages(change):
    cfg = inpaint_smoke_config()
    cfg["unet"]["params"]["in_channels"] = change.get("in_channels", 9)
    cfg["latent"]["conditioning_key"] = change.get("conditioning_key", "hybrid")
    with pytest.raises(ValueError) as got:
        inpaint._check_inpaint_config(cfg)
    with pytest.raises(ValueError) as want:
        jinpaint._check_inpaint_config(cfg)
    assert str(got.value) == str(want.value)


def test_inpaint_run_resumes_and_serves(tmp_path, images):
    cfg = _short(inpaint_smoke_config())
    out = tmp_path / "inpaint"
    assert _cli(cfg, images, out) == 0
    assert (out / "samples" / "step_2.png").exists()
    saved = ckpt.restore_tree(str(out / "ckpt"))
    assert saved["step"] == 2 and saved["logvar"].shape == (50,)
    assert _cli(cfg, images, out, "--max-steps", "3") == 0
    assert ckpt.all_steps(str(out / "ckpt")) == [2, 3]
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().split("\n")
            if line and "grad_norm" in line]
    assert [r["step"] for r in recs] == [0, 1, 2]
    pipe = Text2ImagePipeline.from_run(cfg, str(out), param_dtype=None, device="cpu")
    rng = np.random.default_rng(5)
    init = rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    keep = np.ones((32, 32), np.float32)
    keep[8:24, 8:24] = 0.0
    img = pipe.inpaint(["a photo of a cat"], init, keep, num_steps=2, guidance_scale=3.0, seed=1)
    assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8
    assert np.array_equal(img[0][keep == 1], init[0][keep == 1])
