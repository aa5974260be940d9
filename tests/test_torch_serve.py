"""The ported serving entry point (`sd_tpu_torch.serve`) on the CPU.

The batching and HTTP cases of the JAX package's serving tests, against
the port's `BatchingServer` / `make_http_server` with a stub pipeline
(copied here, not imported). Grouping is made deterministic: requests are
queued first and the batcher is started once all of them wait, so a short
window (≤ 50 ms) still groups them. Every server runs on daemon threads and
every `urllib` call has a timeout, so nothing can hang the suite.

Also: the standard-library PNG writer round trip, the prompt-weighting and
watermark helpers against the JAX package's (the same arrays), the command
line's refusals, and a tiny served `generate` with `SD_TPU_FLASH_EXP=bf16
SD_TPU_FLASH_PV=int8` against the JAX composition with the same switches
(head-packed gates forced on in both packages, the Pallas kernel in
interpret mode), within one uint8 level.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import SLICE_TOL, assert_close, flax_init, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_VAE, unet_params, vae_params
from test_torch_slice import PROMPTS, TINY_CLIP, tiny_config

from sd_tpu.core.schedules import DiffusionSchedule
from sd_tpu.diffusion.ddim import DDIMSampler
from sd_tpu.kernels import attention as jattn
from sd_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from sd_tpu.models.clip_text import ClipTextConfig, ClipTextTransformer, SimpleHashTokenizer
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.utils import prompt_weights as jpw, watermark as jwm
from sd_tpu_torch import serve
from sd_tpu_torch.kernels import attention as attn_k, flash_attention as fa
from sd_tpu_torch.pipeline import Text2ImagePipeline, to_uint8
from sd_tpu_torch.serve import BatchingServer, make_http_server
from sd_tpu_torch.utils import prompt_weights as pw, watermark as wm
from test_torch_models import TINY_UNET

WINDOW_MS = 50
TIMEOUT_S = 30


class StubPipeline:
    """Records every generate() call; returns per-prompt constant images."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail
        self.lock = threading.Lock()

    def generate(self, prompts, negative_prompt="", num_steps=30,
                 guidance_scale=7.5, guidance_rescale=0.0, sampler="ddim",
                 seed=0, height=None, width=None, clip_skip=None, eta=0.0,
                 sag_scale=0.0, watermark=None):
        with self.lock:
            self.calls.append({"prompts": list(prompts), "steps": num_steps,
                               "sampler": sampler, "seed": seed, "sag_scale": sag_scale,
                               "height": height, "width": width, "clip_skip": clip_skip,
                               "guidance_rescale": guidance_rescale, "watermark": watermark})
        if self.fail:
            raise RuntimeError("synthetic model failure")
        h, w = height or 16, width or 16
        return np.stack([np.full((h, w, 3), (len(p) * 7) % 256, np.uint8) for p in prompts])


def _serve(pipeline, **kw):
    batcher = BatchingServer(pipeline, **{"max_batch": 4, "batch_window_ms": WINDOW_MS, **kw})
    server = make_http_server(batcher, port=0)
    threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return batcher, server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture
def served():
    """(batcher not started yet, base url, stub)."""
    stub = StubPipeline()
    batcher, server, url = _serve(stub)
    yield batcher, url, stub
    server.shutdown()
    server.server_close()
    batcher.stop()


def _post(url, body, timeout=TIMEOUT_S):
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def fire(batcher, url, bodies, timeout=TIMEOUT_S):
    """POST every body concurrently; start the batcher once all of them are
    queued. Returns {index: response or HTTPError}."""
    results, lock = {}, threading.Lock()

    def go(i, body):
        try:
            out = _post(url, body, timeout)
        except urllib.error.HTTPError as e:
            out = e
        with lock:
            results[i] = out

    threads = [threading.Thread(target=go, args=(i, b), daemon=True)
               for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    while batcher.queue_depth() < len(bodies) and time.monotonic() < deadline:
        time.sleep(0.005)
    batcher.start()
    for t in threads:
        t.join(timeout)
    assert len(results) == len(bodies)
    return results


def _png(b64: str) -> np.ndarray:
    return serve.decode_png(base64.b64decode(b64))


def test_single_request_roundtrip(served):
    batcher, url, stub = served
    batcher.start()
    out = _post(url, {"prompt": "a cat", "steps": 7, "seed": 3})
    img = _png(out["image"])
    assert img.shape == (16, 16, 3) and (img == (len("a cat") * 7) % 256).all()
    assert out["seed"] == 3 and out["batch_size"] == 1
    assert stub.calls[0]["steps"] == 7 and stub.calls[0]["seed"] == 3


def test_concurrent_same_params_batch_together(served):
    batcher, url, stub = served
    res = fire(batcher, url, [{"prompt": "a cat", "steps": 5},
                              {"prompt": "a big dog", "steps": 5}])
    assert len(stub.calls) == 1, stub.calls
    assert sorted(stub.calls[0]["prompts"]) == ["a big dog", "a cat"]
    assert res[0]["batch_size"] == res[1]["batch_size"] == 2
    assert res[0]["seed"] == res[1]["seed"]             # the group's seed
    for i, p in enumerate(("a cat", "a big dog")):
        assert (_png(res[i]["image"]) == (len(p) * 7) % 256).all()


@pytest.mark.parametrize("a,b", [
    ({"steps": 5}, {"steps": 9}),
    ({"seed": 1}, {"seed": 2}),
    ({"sampler": "ddim"}, {"sampler": "dpm"}),
    ({"height": 32}, {"width": 32}),
    ({"clip_skip": 2}, {}),
    ({"guidance_rescale": 0.7}, {}),
])
def test_different_keys_do_not_batch(served, a, b):
    batcher, url, stub = served
    fire(batcher, url, [{"prompt": "a", **a}, {"prompt": "b", **b}])
    assert len(stub.calls) == 2, stub.calls


@pytest.mark.parametrize("body,msg", [
    ({}, "prompt"),
    ({"prompt": "  "}, "prompt"),
    ({"prompt": "x", "sampler": "banana"}, "sampler"),
    ({"prompt": "x", "steps": 0}, "steps"),
    ({"prompt": "x", "width": 100}, "width"),
    ({"prompt": "x", "height": 36}, "height"),
    ({"prompt": "x", "sampler": "euler", "sag_scale": 0.5}, "ddim"),
])
def test_validation_errors_return_400(served, body, msg):
    batcher, url, _ = served
    batcher.start()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    assert e.value.code == 400
    assert msg in json.loads(e.value.read())["error"]


def test_invalid_json_and_unknown_paths(served):
    batcher, url, _ = served
    batcher.start()
    req = urllib.request.Request(url + "/generate", data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT_S)
    assert e.value.code == 400
    for path in ("/nope", "/generate"):                 # GET /generate is not served
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + path, timeout=TIMEOUT_S)
        assert e.value.code == 404


def test_healthz_and_metrics(served):
    batcher, url, _ = served
    batcher.start()
    _post(url, {"prompt": "warm", "steps": 2})
    with urllib.request.urlopen(url + "/healthz", timeout=TIMEOUT_S) as r:
        h = json.loads(r.read())
    assert h == {"ok": True, "queue_depth": 0, "requests_served": 1, "batches_run": 1}


def test_model_failure_reaches_every_waiter_and_server_survives():
    stub = StubPipeline(fail=True)
    batcher, server, url = _serve(stub, max_batch=2)
    try:
        res = fire(batcher, url, [{"prompt": "boom"}, {"prompt": "bang"}])
        assert len(stub.calls) == 1
        for r in res.values():
            assert isinstance(r, urllib.error.HTTPError) and r.code == 500
            assert "synthetic model failure" in json.loads(r.read())["error"]
        stub.fail = False                               # the worker kept serving
        assert "image" in _post(url, {"prompt": "ok now"})
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


def test_max_batch_respected():
    stub = StubPipeline()
    batcher, server, url = _serve(stub, max_batch=2)
    try:
        fire(batcher, url, [{"prompt": f"p{i}", "steps": 5} for i in range(4)])
        assert [len(c["prompts"]) for c in stub.calls] == [2, 2]
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


def test_sag_scale_keys_batches_and_validates():
    """sag_scale joins the key and reaches generate() (where the port runs
    Self-Attention Guidance: `test_served_sag_request_is_answered`); a
    non-ddim sampler is refused at validation."""
    stub = StubPipeline()
    batcher = BatchingServer(stub, max_batch=4, batch_window_ms=WINDOW_MS)
    batcher.start()
    try:
        assert batcher.submit({"prompt": "a", "steps": 5, "seed": 3,
                               "sag_scale": 0.75})["seed"] == 3
        assert stub.calls[-1]["sag_scale"] == 0.75
        batcher.submit({"prompt": "b", "steps": 5, "seed": 3})
        assert stub.calls[-1]["sag_scale"] == 0.0
        with pytest.raises(ValueError, match="ddim"):
            batcher.submit({"prompt": "c", "sampler": "euler", "sag_scale": 0.5})
    finally:
        batcher.stop()


def test_non_pow2_group_pads_to_bucket(served):
    """A 3-request group runs as a batch-4 generate (the pad repeats the last
    prompt); each requester gets its own image and batch_size 3."""
    batcher, url, stub = served
    res = fire(batcher, url, [{"prompt": "x" * (i + 1), "steps": 5} for i in range(3)])
    assert len(stub.calls) == 1
    prompts = stub.calls[0]["prompts"]
    assert len(prompts) == 4 and prompts[3] == prompts[2]
    for i, r in res.items():
        assert r["batch_size"] == 3
        assert (_png(r["image"]) == ((i + 1) * 7) % 256).all()


def test_request_fields_reach_generate_and_watermark_is_server_wide():
    stub = StubPipeline()
    batcher = BatchingServer(stub, batch_window_ms=WINDOW_MS, watermark="sd-port")
    batcher.start()
    try:
        out = batcher.submit({"prompt": "a", "height": 24, "width": 40, "clip_skip": 2,
                              "guidance_rescale": 0.7, "sampler": "unipc", "seed": 5})
        assert _png(out["image"]).shape == (24, 40, 3)
        call = stub.calls[-1]
        assert (call["height"], call["width"], call["clip_skip"], call["guidance_rescale"],
                call["sampler"], call["watermark"]) == (24, 40, 2, 0.7, "unipc", "sd-port")
    finally:
        batcher.stop()


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(channels):
    from PIL import Image

    img = np.random.default_rng(channels).integers(0, 256, (13, 21, channels), np.uint8)
    data = serve.encode_png(img)
    np.testing.assert_array_equal(serve.decode_png(data), img)
    other = np.asarray(Image.open(io.BytesIO(data)))    # an independent decoder
    np.testing.assert_array_equal(other.reshape(img.shape), img)
    broken = bytearray(data)
    broken[40] ^= 0xFF                                  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        serve.decode_png(bytes(broken))


PROMPT_CASES = ["a plain prompt", "a (red:1.3) cube", "((very)) [faint] words",
                "nested (a (b:0.5) c:1.2) end", r"escaped \(paren\) (x:2)",
                "unbalanced (open", "(:1.5)", ""]


def test_prompt_weights_match_tpu_package():
    for text in PROMPT_CASES:
        assert pw.parse_weighted_prompt(text) == jpw.parse_weighted_prompt(text), text
    tok = SimpleHashTokenizer(16, 1000)
    args = (PROMPT_CASES, tok.encode_chunk, 16, tok.bos_token_id, tok.eos_token_id)
    ids, wts = pw.tokenize_weighted(*args)
    jids, jwts = jpw.tokenize_weighted(*args)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(wts, jwts)
    emb = np.random.default_rng(0).standard_normal((len(PROMPT_CASES), 16, 8)).astype(np.float32)
    assert_close(pw.apply_prompt_weights(to_torch(emb), to_torch(wts)),
                 jpw.apply_prompt_weights(jnp.asarray(emb), jnp.asarray(jwts)), 1e-6)
    ones = torch.ones(len(PROMPT_CASES), 16)
    assert torch.equal(pw.apply_prompt_weights(to_torch(emb), ones), to_torch(emb))


def test_watermark_matches_tpu_package():
    img = np.random.default_rng(1).integers(0, 256, (64, 96, 3), np.uint8)
    for payload in ("sd-port", "x" * 20):
        np.testing.assert_array_equal(wm.str_to_bits(payload, 48),
                                      jwm.str_to_bits(payload, 48))
    bits = wm.str_to_bits("sd-port", 48)
    marked = wm.embed_watermark(img, bits, key=3)
    np.testing.assert_array_equal(marked, jwm.embed_watermark(img, bits, key=3))
    (bits_got, score), (bits_ref, score_ref) = (wm.detect_watermark(marked, 48, key=3),
                                                jwm.detect_watermark(marked, 48, key=3))
    np.testing.assert_array_equal(bits_got, bits_ref)
    assert score == score_ref
    assert wm.verify_watermark(marked, "sd-port", key=3)
    assert not wm.verify_watermark(img, "sd-port", key=3)


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A tiny config (fp32 for the CPU), an SD-v1 checkpoint of a random
    pipeline of it, and a LoRA file of random factors for it."""
    from sd_tpu_torch.train.lora import init_lora, save_lora_safetensors
    from sd_tpu_torch.weights import randomize_params_

    root = tmp_path_factory.mktemp("serve_cli")
    cfg = tiny_config()
    (root / "cfg.json").write_text(json.dumps(cfg))
    src = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(8)
    for module in (src.unet, src.vae):
        randomize_params_(module, gen)
    src.to_sd_checkpoint(str(root / "c.ckpt"))
    factors = init_lora(src.unet, 2, gen)
    for pair in factors.values():
        pair["b"].normal_(0.0, 0.05, generator=gen)
    save_lora_safetensors(str(root / "l.safetensors"), factors)
    return {"cfg": str(root / "cfg.json"), "c.ckpt": str(root / "c.ckpt"),
            "l": str(root / "l.safetensors"), "config": cfg}


@pytest.mark.parametrize("flag", [["--run", "r", "--shard"], ["--sd-checkpoint", "c.ckpt"],
                                  ["--lora", "l"],
                                  ["--shard"], ["--tome", "0.5"], ["--freeu", "1.1,1.2,0.9,0.2"]])
def test_cli_refuses_what_is_not_ported(flag, capsys, cli_files):
    """`--shard` serves over the process group (`tests/test_torch_parallel_serve.py`
    drives it); here, without torchrun, over a group of one rank, which
    refuses a mesh it cannot hold before building anything (the full-width
    `sd_v1` is never built) and leaves no group behind. The other flags
    build the pipeline `scripts/serve.py` builds — the imported checkpoint,
    the merged LoRA, the UNet options — whose weights, options and images
    are the pipeline calls' they stand for."""
    if "--shard" in flag:
        with pytest.raises(ValueError, match=r"mesh \{'data': 2\} wants 2 ranks, got 1"):
            serve.main(["--config", "sd_v1", "--device", "cpu", *flag, "--mesh", "data=2"])
        assert not torch.distributed.is_initialized()
        return
    args = serve.parse_args(["--config", cli_files["cfg"], "--device", "cpu",
                             *(cli_files.get(v, v) for v in flag)])
    got = serve.build_pipeline(args)
    cfg = cli_files["config"]
    if flag[0] == "--sd-checkpoint":
        want = Text2ImagePipeline.from_sd_checkpoint(cfg, cli_files["c.ckpt"], device="cpu")
    else:
        want = Text2ImagePipeline(cfg, device="cpu")
    plain = dict(want.unet.named_parameters())
    if flag[0] == "--lora":
        plain = {n: p.clone() for n, p in plain.items()}
        want.load_lora(cli_files["l"])
    elif flag[0] == "--tome":
        want.set_unet_options(tome_ratio=0.5)
    elif flag[0] == "--freeu":
        want.set_unet_options(freeu=(1.1, 1.2, 0.9, 0.2))
    mine = dict(got.unet.named_parameters())
    assert all(torch.equal(p, mine[n]) for n, p in want.unet.named_parameters())
    assert (flag[0] != "--lora"
            or any(not torch.equal(p, mine[n]) for n, p in plain.items()))
    assert got.unet.freeu == want.unet.freeu and got.unet.mid_attn.tome_ratio == (
        0.5 if flag[0] == "--tome" else 0.0)
    np.testing.assert_array_equal(got.generate(PROMPTS, num_steps=2, seed=3),
                                  want.generate(PROMPTS, num_steps=2, seed=3))


def test_served_sag_request_is_answered():
    """A request with `sag_scale` (the JAX package's server answers it) is
    answered with the image of the pipeline's generate(sag_scale=…)."""
    from sd_tpu_torch.weights import randomize_params_

    pipe = Text2ImagePipeline(tiny_config(), device="cpu", param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    for module in (pipe.unet, pipe.vae, pipe.clip):
        randomize_params_(module, gen)
    batcher = BatchingServer(pipe, max_batch=2, batch_window_ms=WINDOW_MS)
    batcher.start()
    try:
        out = batcher.submit({"prompt": "a red cube", "steps": 4, "seed": 3,
                              "sag_scale": 0.75})
    finally:
        batcher.stop()
    want = pipe.generate(["a red cube"], negative_prompt=[""], num_steps=4, seed=3,
                         sag_scale=0.75)
    np.testing.assert_array_equal(_png(out["image"]), want[0])
    assert not np.array_equal(want, pipe.generate(["a red cube"], num_steps=4, seed=3))


@pytest.mark.parametrize("family,sampler", [("eps", "lcm"), ("flow", "flow"),
                                            ("flow", "flow_midpoint")])
def test_served_few_step_requests_are_answered(family, sampler):
    """A consistency student's `lcm` request (guidance 1: the guidance was
    baked in) and a flow model's `flow` / `flow_midpoint` requests, over
    HTTP, are answered with the image of the pipeline's generate; the
    mismatched request (lcm on the flow model, flow on the ε-model) gets the
    JAX package's ValueError."""
    from sd_tpu_torch.weights import randomize_params_

    cfg = tiny_config()
    if family == "flow":
        cfg["diffusion"] = {"type": "flow", "timesteps": 50, "shift": 3.0}
    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    for module in (pipe.unet, pipe.vae, pipe.clip):
        randomize_params_(module, gen)
    gs = 1.0 if sampler == "lcm" else 4.0
    other = "flow" if sampler == "lcm" else "lcm"
    batcher, server, url = _serve(pipe, max_batch=2)
    batcher.start()
    try:
        ok = _post(url, {"prompt": "a red cube", "steps": 3, "seed": 3, "sampler": sampler,
                         "guidance_scale": gs})
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"prompt": "a red cube", "steps": 3, "seed": 3, "sampler": other,
                        "guidance_scale": 1.0})
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    assert err.value.code == 500 and "ValueError" in json.loads(err.value.read())["error"]
    want = pipe.generate(["a red cube"], negative_prompt=[""], num_steps=3, seed=3,
                         sampler=sampler, guidance_scale=gs)
    np.testing.assert_array_equal(_png(ok["image"]), want[0])
    assert want.std() > 0


class Recording:
    """A pipeline wrapper that keeps the prompts of every batch it ran."""

    def __init__(self, pipe):
        self.pipe, self.batches = pipe, []

    def generate(self, prompts, **kw):
        self.batches.append((list(prompts), kw))
        return self.pipe.generate(prompts, **kw)


def test_served_generate_with_variants_matches_tpu_package(monkeypatch):
    """Two same-key requests (one weighted) served as one batch-2 generate of
    the tiny pipeline with both switches, against the JAX composition of the
    same batch: CLIP with the TPU package's prompt weighting, DDIM-2 with
    CFG over the same x_T (the served generate's, drawn from its seed),
    KL decode; every self-attention through the head-packed kernel in both
    (interpret mode in JAX), with the bf16 exponential and the int8 PV."""
    clip = ClipTextTransformer(ClipTextConfig(**TINY_CLIP))
    cparams = flax_init(clip, jnp.zeros((1, 16), jnp.int32), seed=3)
    uparams, vparams = unet_params(seed=4), vae_params(seed=5)
    monkeypatch.setenv("SD_TPU_FLASH_EXP", "bf16")
    monkeypatch.setenv("SD_TPU_FLASH_PV", "int8")
    monkeypatch.setitem(jattn._HPACKED_CTX, "force_interpret", True)
    monkeypatch.setattr(attn_k, "hpacked_flash_ok", lambda *a: True)
    seen = []
    real = fa.flash_attention_hpacked
    monkeypatch.setattr(fa, "flash_attention_hpacked",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    pipe = Text2ImagePipeline(tiny_config(), device="cpu", param_dtype=torch.float32)
    port(pipe.clip, cparams)
    port(pipe.unet, uparams)
    port(pipe.vae, vparams)

    rec = Recording(pipe)
    batcher, server, url = _serve(rec, max_batch=2)
    try:
        bodies = [{"prompt": p, "steps": 2, "seed": 11, "guidance_scale": 7.5}
                  for p in (PROMPTS[1], "a (very:1.3) red cube")]
        res = fire(batcher, url, bodies, timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    assert len(rec.batches) == 1 and all(r["batch_size"] == 2 for r in res.values())
    assert seen and all(kw["softmax_dtype"] == torch.bfloat16 and kw["pv_quant"] == "int8"
                        for kw in seen)
    prompts = rec.batches[0][0]
    served_imgs = {p: _png(res[i]["image"]) for i, p in
                   enumerate(b["prompt"] for b in bodies)}

    x_T = torch.randn((2, 16, 16, 4), generator=torch.Generator().manual_seed(11)).numpy()
    tok = SimpleHashTokenizer(16, 1000)
    ids, wts = jpw.tokenize_weighted(prompts, tok.encode_chunk, 16, tok.bos_token_id,
                                     tok.eos_token_id)
    encode = jax.jit(clip.apply)
    c = jpw.apply_prompt_weights(encode({"params": cparams}, jnp.asarray(ids)),
                                 jnp.asarray(wts))
    uc = encode({"params": cparams}, jnp.asarray(tok([""] * 2)))
    unet = JUNet(**TINY_UNET)
    z = DDIMSampler(DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)).sample(
        lambda x, t, ctx: unet.apply({"params": uparams}, x, t, ctx),
        jax.random.PRNGKey(0), x_T.shape, num_steps=2, cond=c, uncond=uc,
        guidance_scale=7.5, eta=0.0, x_T=jnp.asarray(x_T))
    ref = jax.jit(lambda z: JAutoencoderKL(**TINY_VAE).apply(
        {"params": vparams}, z / 0.18215, method=JAutoencoderKL.decode))(z)
    got = pipe.sample(prompts, to_torch(x_T), num_steps=2, guidance_scale=7.5)
    assert_close(got, ref, SLICE_TOL)
    ref_u8 = np.clip((np.asarray(ref) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(to_uint8(got), np.stack([served_imgs[p] for p in prompts]))
    for i, p in enumerate(prompts):
        diff = np.abs(served_imgs[p].astype(int) - ref_u8[i].astype(int)).max()
        assert diff <= 1, (p, diff)
