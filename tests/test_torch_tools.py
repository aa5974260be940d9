"""The port's diagnostic and data tools and its last two command lines
against the JAX package, on the CPU.

Exact (host code, or counts): `tree_finite_summary` over a nest; `nan_check`
flags what checkify's `float_checks` flags (0/0, log(−1), a division by
zero) and not a finite step, and `enable_nan_debugging` raises at the op
that makes a NaN, forward and backward; the ImageNet helpers on temporary
files; `parallel_data_prefetch`'s outputs and errors; `bbox_patch_limits`.
fp32, within 1e-5·max|ref|: `patched_apply_bbox` on a tiny UNet (weights
carried across) with an embedding table as the cond stage. The commands: `bench_serve --smoke`
in-process (one row, 2 clients × 1 request), its row's keys those of
`scripts/bench_serve.py run_row` (run against a stub pipeline on the port's
server); `eval_steering` end to end on a narrow copy of
`ldm_32_catdog_cond_config()` trained one step by `python -m
sd_tpu_torch.train` (the FID's ViT tower narrowed too), both on the CPU.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import flax_init, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.data import imagenet_utils as jimagenet
from sd_tpu.data import loader as jloader
from sd_tpu.diffusion import latent as jlatent
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.utils import debug as jdebug
from sd_tpu_torch import bench_serve, eval_steering
from sd_tpu_torch.data import imagenet_utils, loader
from sd_tpu_torch.diffusion import latent
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.utils import debug

TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]
BBOX_UNET = dict(in_channels=4, model_channels=16, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1,), num_heads=2, context_dim=32)


def close(got, ref, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, bound = np.abs(got - ref).max(), tol * np.abs(ref).max()
    assert err <= bound, f"max|Δ| = {err:.3g} > {bound:.3g}"


# -- utils/debug.py --------------------------------------------------------------------------


def test_tree_finite_summary_counts():
    nest = {"a": np.array([1.0, np.nan, np.inf, -np.inf], np.float32),
            "b": [np.array([[np.nan, 2.0]], np.float32), np.arange(3)], "c": "text"}
    ref = jdebug.tree_finite_summary(jax.tree.map(
        lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, nest))
    got = debug.tree_finite_summary({"a": to_torch(nest["a"]), "b": [
        to_torch(nest["b"][0]), torch.arange(3)], "c": "text"})
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in ref.items()} == {
        "finite": 0, "num_nan": 2, "num_inf": 2}
    clean = debug.tree_finite_summary([torch.ones(3), (torch.zeros(2, 2),)])
    assert bool(clean["finite"]) and int(clean["num_nan"]) == int(clean["num_inf"]) == 0
    assert debug.tree_finite_summary({"n": torch.arange(4)}) == {
        "finite": True, "num_nan": 0, "num_inf": 0}


@pytest.mark.parametrize("case,x,flagged", [
    ("0/0", [0.0, 1.0], "division by zero"), ("log(-1)", [-1.0, 1.0], "nan generated"),
    ("x/0", [1.0, 2.0], "division by zero"), ("finite", [1.0, 2.0], None)])
def test_nan_check_flags_what_checkify_flags(case, x, flagged):
    fns = {"0/0": (lambda a: a[:1] / a[:1] * 0.0 + a / jnp.where(a > 0.5, a, 0.0),
                   lambda a: a[:1] / a[:1] * 0.0 + a / torch.where(a > 0.5, a, 0.0)),
           "log(-1)": (lambda a: jnp.log(a) * 2.0, lambda a: torch.log(a) * 2.0),
           "x/0": (lambda a: a / (a - a), lambda a: a / (a - a)),
           "finite": (lambda a: jnp.log(a) / a, lambda a: torch.log(a) / a)}
    jfn, tfn = fns[case]
    jerr, jout = jax.jit(jdebug.nan_check(jfn))(jnp.asarray(x, jnp.float32))
    err, out = debug.nan_check(tfn)(torch.tensor(x))
    assert (jerr.get() is None) == (err.get() is None) == (flagged is None), (jerr.get(),
                                                                               err.get())
    if flagged is None:
        err.throw()
        close(out, jout)
    else:
        assert flagged in err.get()
        with pytest.raises(FloatingPointError, match=flagged):
            err.throw()


def test_enable_nan_debugging_raises_at_the_op():
    try:
        debug.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([1.0, 4.0])
        assert torch.equal(torch.sqrt(x), torch.tensor([1.0, 2.0]))
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x - 2.0)
        assert torch.isnan(torch.tensor([float("nan")]) + 1.0).all()    # carried, not made
        w = torch.tensor([1.0, -1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(w.detach().abs()) * w).sum().backward(torch.tensor(float("nan")))
    finally:
        debug.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all()


# -- data/imagenet_utils.py, parallel_data_prefetch --------------------------------------------


def test_imagenet_utils_match(tmp_path):
    cfg = {"a": {"b": [10, {"c": 42}], "f": lambda: {"g": 7}}}
    for key in ("a/b/1/c", "a/b/0", "a/f/g", "a/x", "a/b/5", "a/b/z"):
        assert imagenet_utils.retrieve(cfg, key, default=-1) == jimagenet.retrieve(
            cfg, key, default=-1)
    assert imagenet_utils.retrieve(cfg, "a/f", expand=False) is cfg["a"]["f"]
    root = tmp_path / "prep"
    assert not imagenet_utils.is_prepared(str(root))
    imagenet_utils.mark_prepared(str(root))
    assert imagenet_utils.is_prepared(str(root)) and jimagenet.is_prepared(str(root))
    yml = tmp_path / "synsets.yaml"
    yml.write_text("0: n01440764\n1: n01443537\n2: n01484850\n")
    assert imagenet_utils.synset2idx(str(yml)) == jimagenet.synset2idx(str(yml)) == {
        "n01440764": 0, "n01443537": 1, "n01484850": 2}
    assert imagenet_utils.str_to_indices("0,3-5,9") == jimagenet.str_to_indices("0,3-5,9")
    with pytest.raises(AssertionError):
        imagenet_utils.str_to_indices("1,")
    assert (imagenet_utils.give_synsets_from_indices([2, 0], str(yml))
            == jimagenet.give_synsets_from_indices([2, 0], str(yml)))
    assert imagenet_utils.give_synsets_from_indices(None, str(yml)) is None
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for name in ("b.JPEG", "a.JPEG", "c.png"):
        (imgs / name).write_bytes(b"")
    n = imagenet_utils.write_filelist(str(imgs), str(tmp_path / "port.txt"))
    assert n == jimagenet.write_filelist(str(imgs), str(tmp_path / "jax.txt")) == 2
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


@pytest.mark.parametrize("data,kind,n_proc", [
    (list(range(10)), "ndarray", 3), ({"a": 1, "b": 2, "c": 3}, "list", 4),
    (np.arange(5), "ndarray", 8), (list(range(7)), "list", 1)])
def test_parallel_data_prefetch_matches(data, kind, n_proc):
    fn = lambda x: np.full(2, x * 3)
    got = loader.parallel_data_prefetch(fn, data, n_proc, kind)
    ref = jloader.parallel_data_prefetch(fn, data, n_proc, kind)
    assert type(got) is type(ref)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    for bad in (dict(target_data_type="tuple"), dict(target_data_type="list")):
        with pytest.raises(ValueError):
            loader.parallel_data_prefetch(fn, np.arange(3), **bad)


# -- diffusion/latent.py -------------------------------------------------------------------------


@pytest.mark.parametrize("hw,ks,stride,orig,rescale", [
    ((8, 8), 4, 2, (64, 64), 8), ((10, 6), 4, 2, (80, 48), 8), ((16, 12), 8, 4, (64, 48), 4)])
def test_bbox_patch_limits_match(hw, ks, stride, orig, rescale):
    assert (latent.bbox_patch_limits(hw, ks, stride, orig, rescale)
            == jlatent.bbox_patch_limits(hw, ks, stride, orig, rescale))


def test_patched_apply_bbox_matches():
    """A 12×10 latent in 8×8 windows at stride 2 (2 × 2 windows), batch 2,
    each window's 16 tokens: the base's first 12 and its box's 4; a
    one-level UNet, and for the cond stage an embedding table (the apply's
    wiring is what is held, at a small compile)."""
    uparams = flax_init(JUNet(**BBOX_UNET), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 16, 32)), seed=21)
    unet = port(UNetModel(**BBOX_UNET, device="cpu"), uparams)
    table = nprand(1000, 32, seed=22)
    x, t = nprand(2, 12, 10, 4, seed=23), np.array([5, 800], np.int32)
    tokens = np.random.default_rng(24).integers(1, 1000, (2, 14)).astype(np.int32)
    crop = lambda box: [int(round(v * 100)) + 600 for v in box]
    kw = dict(ks=8, stride=2, original_image_size=(96, 80), rescale_latent=8, crop_encoder=crop)
    jld = jlatent.LatentDiffusion(
        process=None, unet_apply=lambda p, *a: JUNet(**BBOX_UNET).apply({"params": p}, *a))
    ref = jax.jit(lambda up, x_, t_, tok: jlatent.patched_apply_bbox(
        jld, up, x_, t_, tok, encode_tokens=lambda ids: jnp.asarray(table)[ids], **kw))(
        uparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tokens))
    ld = latent.LatentDiffusion(process=None, unet_apply=unet)
    with torch.no_grad():
        got = latent.patched_apply_bbox(ld, to_torch(x), torch.from_numpy(t).long(),
                                        torch.from_numpy(tokens).long(),
                                        encode_tokens=lambda ids: to_torch(table)[ids], **kw)
    assert got.shape == (2, 12, 10, 4) and got.dtype == torch.float32
    close(got, ref)


# -- the commands -----------------------------------------------------------------------------


def _jax_run_row():
    """`scripts/bench_serve.py`'s `run_row` (the script imports JAX only in
    its `main`)."""
    spec = importlib.util.spec_from_file_location("_jax_bench_serve",
                                                  REPO / "scripts" / "bench_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_row


class _StubPipeline:
    def generate(self, prompts, **kw):
        return np.zeros((len(prompts), 8, 8, 3), np.uint8)


def test_bench_serve_smoke_rows_have_run_rows_keys(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert bench_serve.main(["--smoke", "--device", "cpu", "--rows", "ddim50", "--clients", "2",
                             "--requests", "1", "--max-batch", "2", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 1 and json.loads(capsys.readouterr().out.splitlines()[1]) == rows[0]
    row = rows[0]
    assert (row["row"], row["steps"], row["sampler"], row["requests"]) == ("ddim50", 3, "ddim", 2)
    assert row["img_per_s"] > 0 and 1 <= row["mean_batch"] <= 2
    batcher, server, port_, thread = bench_serve.start_server(_StubPipeline(), 2, 20)
    try:
        ref = _jax_run_row()("ddim50", port_, batcher, dict(bench_serve.ROWS["ddim50"]), 2, 1)
    finally:
        bench_serve.stop_server(batcher, server, thread)
    assert list(row) == list(ref)


def test_eval_steering_runs_end_to_end(tmp_path, monkeypatch):
    """At narrow widths throughout: the LDM, and the FID's ViT tower (16
    features), whose float64 eigendecompositions at 512 features would
    cost seconds."""
    from sd_tpu_torch.core.config import ldm_32_catdog_cond_config
    from sd_tpu_torch.data.image_io import write_png
    from sd_tpu_torch.models import conditioners
    from sd_tpu_torch.train import __main__ as train_cli

    monkeypatch.setattr(conditioners, "ClipVisionTransformer", functools.partial(
        conditioners.ClipVisionTransformer, patch_size=32, width=32, layers=2, heads=4,
        output_dim=16))

    rng = np.random.default_rng(28)
    data = tmp_path / "data"
    data.mkdir()
    for c in ("cat", "dog"):
        for i in range(3):
            write_png(str(data / f"{c}.{i}.png"), rng.integers(0, 256, (16, 16, 3), np.uint8))
    cfg = ldm_32_catdog_cond_config()
    cfg["latent"]["image_size"] = 4
    cfg["unet"]["params"].update(model_channels=8, channel_mult=[1, 2], num_res_blocks=1,
                                 attention_resolutions=[2], context_dim=16)
    cfg["first_stage"]["params"].update(ch=8, ch_mult=[1, 2, 4], num_res_blocks=1,
                                        resolution=16)
    cfg["cond_stage"]["params"].update(vocab_size=256, hidden_size=16, num_heads=2)
    cfg["train"].update(image_size=16, batch_size=2, total_steps=1, checkpoint_every=1,
                        eval_every=10**6)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    run = tmp_path / "run"
    assert train_cli.main(["--config", str(path), "--data", str(data), "--out", str(run),
                           "--device", "cpu"]) == 0
    out = tmp_path / "steer"
    assert eval_steering.main([
        "--config", str(path), "--ckpt", str(run / "ckpt"), "--data", str(data),
        "--guidance-scales", "1", "3", "--per-class", "2", "--steps", "4", "--probe-steps", "2",
        "--real-per-class", "3", "--fid-batch", "4", "--out", str(out), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in (out / "steering.jsonl").read_text().splitlines()]
    assert [r["guidance_scale"] for r in rows] == [1.0, 3.0]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("acc_cat", "conf_cat", "acc_dog", "conf_dog",
                                               "acc_mean", "fid_surrogate"))
        assert os.path.exists(r["grid"])
    with np.load(out / "samples_cfg3_ddim4.npz") as npz:
        assert npz["samples"].shape == (4, 16, 16, 3) and list(npz["target"]) == [0, 0, 1, 1]
