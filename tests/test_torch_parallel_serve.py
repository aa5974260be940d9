"""Serving over a process group (`Text2ImagePipeline.shard_for_serving`,
`python -m sd_tpu_torch.serve --shard`) on the CPU over gloo, against the
port's one-rank fp32 `generate` (the JAX package's
`tests/test_pipeline_parallel.py` case for case;
`tests/test_torch_slice.py::test_text_to_image_slice` holds that `generate`
against the JAX package's, so no JAX pipeline runs here):

* data-parallel (2 ranks on "data") and data 2 × model 2 (the UNet's
  attention and feed-forward split over "model") `generate` within one
  uint8 level of the one-rank images, every rank holding all of them;
* a batch that does not divide the data axis raises;
* `serve --shard` at 2 ranks: rank 0 answers HTTP requests, each grouped
  batch padded to the data axis and broadcast to rank 1, and the images
  equal the one-rank `generate` of that padded batch within one level;
* a rank whose `generate` fails tears the group down and raises (in this
  process, the collectives stubbed).

Both groups start once for the module (`tests/torch_parallel_group.py`).
"""

from __future__ import annotations

import base64
import json

import numpy as np
import pytest
import torch
from torch_parallel_group import Group

from sd_tpu_torch.data.image_io import decode_png
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.weights import randomize_params_

from test_torch_slice import tiny_config

PROMPTS = ["a cat", "a dog"]
GENERATE = dict(num_steps=2, guidance_scale=3.0, seed=7)
REQUESTS = [{"prompt": "a red cube", "steps": 2, "seed": 3},
            {"prompt": "a tree by a lake", "steps": 2, "seed": 5, "sampler": "euler_a"}]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    cfg = tiny_config()
    path = root / "tiny.json"
    path.write_text(json.dumps(cfg))
    inputs = {"config": cfg, "config_path": str(path), "prompts": PROMPTS,
              "generate": GENERATE, "requests": REQUESTS}
    groups = {"dp": Group("serve_dp", 2, root / "dp", inputs),
              "tp": Group("serve_tp", 4, root / "tp", inputs)}
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    randomize_params_(pipe.unet, torch.Generator().manual_seed(11))
    ref = pipe.generate(PROMPTS, **GENERATE)
    server_pipe = Text2ImagePipeline(cfg, device="cpu")
    answers = [server_pipe.generate([r["prompt"]] * 2, negative_prompt=["", ""], num_steps=2,
                                    guidance_scale=7.5, guidance_rescale=0.0,
                                    sampler=r.get("sampler", "ddim"), seed=r["seed"],
                                    **({"eta": 0.0} if "sampler" not in r else {}))[0]
               for r in REQUESTS]
    return {k: g.results() for k, g in groups.items()}, ref, answers


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_sharded_generate_matches_one_rank(served, mesh):
    results, ref, _ = served
    for out in results[mesh]:
        assert _levels(out["images"], ref) <= 1
        # the tiny UNet's 4 transformer blocks: 8 attentions × 4 leaves, 4 feed-forwards × 3
        assert out["split"] == (0 if mesh == "dp" else 44)


def test_batch_must_divide_the_data_axis(served):
    results, _, _ = served
    for out in results["dp"]:
        assert "batch 1 must divide the data axis (2)" in out["divide"]


def test_serve_shard_answers_over_the_group(served):
    results, _, answers = served
    got = results["dp"][0]["answers"]
    assert results["dp"][1]["answers"] == []
    assert len(got) == len(REQUESTS)
    for body, req, want in zip(got, REQUESTS, answers):
        assert body["seed"] == req["seed"] and body["batch_size"] == 1
        img = decode_png(base64.b64decode(body["image"]))
        assert _levels(img, want) <= 1


class _Failing:
    """A pipeline whose `generate` raises (a fault on one rank)."""

    class mesh:
        size = staticmethod(lambda axis: 1)

    def generate(self, prompts, **kw):
        raise RuntimeError("out of memory")


def test_a_failing_rank_tears_the_group_down(monkeypatch):
    from sd_tpu_torch import serve

    down, sent = [], []
    payloads = iter([{"prompts": ["a cat"], "kw": {}}, None])
    monkeypatch.setattr(serve, "_teardown", lambda: down.append(True))
    monkeypatch.setattr(serve, "_broadcast", lambda p: sent.append(p) or next(payloads))
    # a follower: the failure ends its loop and reaches the caller
    with pytest.raises(RuntimeError, match="out of memory"):
        serve.follow(_Failing())
    assert down == [True]
    # rank 0: the failing request raises, the group goes, later calls refuse
    sharded = serve.ShardedGenerate(_Failing())
    with pytest.raises(RuntimeError, match="out of memory"):
        sharded.generate(["a dog"])
    assert down == [True, True]
    with pytest.raises(RuntimeError, match="torn down after RuntimeError: out of memory"):
        sharded.generate(["a dog"])
    n = len(sent)
    sharded.stop()
    assert len(sent) == n
