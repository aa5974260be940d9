"""LoRA, ControlNet and IP-Adapter in the port against the JAX package, fp32
on the CPU at the tiny widths of `tests/test_torch_slice.py`, every weight
random and carried across (`load_flax_params`), every draw injected:

* LoRA: `lora_targets` alike, `merge_lora` exact in fp32 and within 1 bf16
  ulp in bf16 (the JAX package's eager merge), a LoRA file that the JAX
  package saved loads into the port (`load_lora`), the port's file byte for
  byte the JAX package's;
* ControlNet: its residuals within 1e-5·max|ref|, the controlled UNet within
  1e-4·max(1, max|ref|), `init_controlnet_from_unet` alike, and
  `generate(control_image=…)` over 4 DDIM steps within 1 uint8 level;
  `edge_hint` alike;
* IP-Adapter: `cross_attention_paths`, `init_ip_adapter` and
  `project_image_embed` alike, the ViT tower at a tiny width,
  `clip_image_preprocess` against `jax.image.resize(..., "bicubic")` at
  sizes above and below 224, and `generate(ip_image=…)` within 1 uint8
  level (both packages' image embedders a tiny tower of the same weights);
  `load_ip_adapter` of a run directory.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import (MODULE_TOL, assert_close, flax_init, jax_pipeline, nprand, port,
                                port_pipeline, to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_image_edit import _normal, _split, assert_within_a_level
from test_torch_models import TINY_UNET
from test_torch_slice import PROMPTS, tiny_config

from sd_tpu.data import hints as jhints
from sd_tpu.models import conditioners as jcond
from sd_tpu.models import controlnet as jcn
from sd_tpu.models import ip_adapter as jip
from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.train import lora as jlora
from sd_tpu_torch.data import hints
from sd_tpu_torch.models import conditioners, controlnet, ip_adapter
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.train import lora
from sd_tpu_torch.train.checkpoint import save_checkpoint
from sd_tpu_torch.weights import init_params_

STEPS = 4
TINY_VIT = dict(patch_size=8, width=32, layers=2, heads=4, output_dim=16, image_size=32)


@pytest.fixture(scope="module")
def pipes():
    cfg = tiny_config()
    jpipe = jax_pipeline(cfg, seed=31)
    return cfg, jpipe, port_pipeline(cfg, jpipe)


def _tt(tree):
    """A JAX tree as nested dicts of torch tensors."""
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x_T(seed: int):
    return _normal(_split(jax.random.PRNGKey(seed), 2)[1], (2, 16, 16, 4))


# -- LoRA ------------------------------------------------------------------------------


def _factors(unet_params, seed: int):
    tree = jlora.init_lora(unet_params, 4, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return {k: {"a": np.asarray(p["a"]),
                "b": (0.05 * rng.standard_normal(p["b"].shape)).astype(np.float32)}
            for k, p in tree.items()}


def test_lora_merge_matches_and_files_carry_across(pipes, tmp_path):
    """fp32: the merged weights equal the JAX package's merged tree carried
    across, bit for bit; the JAX package's LoRA file loads into the
    pipeline to the same weights; the port's file is the same bytes."""
    cfg, jpipe, pipe = pipes
    assert lora.lora_targets(pipe.unet) == jlora.lora_targets(jpipe.unet_params)
    factors = _factors(jpipe.unet_params, 3)
    merged = lora.merge_lora(pipe.unet, _tt(factors), 0.7)
    ref = port(UNetModel(**TINY_UNET, device="cpu"),
               jax.device_get(jlora.merge_lora(jpipe.unet_params, factors, 0.7)))
    for name, p in ref.named_parameters():
        assert torch.equal(merged[name], p), name
    untouched = dict(pipe.unet.named_parameters())
    assert merged["in_0_0_res.in_conv.weight"] is untouched["in_0_0_res.in_conv.weight"]
    jlora.save_lora_safetensors(str(tmp_path / "jax.safetensors"), factors, {"rank": 4})
    lora.save_lora_safetensors(str(tmp_path / "port.safetensors"), _tt(factors), {"rank": 4})
    assert ((tmp_path / "jax.safetensors").read_bytes()
            == (tmp_path / "port.safetensors").read_bytes())
    fresh = port_pipeline(cfg, jpipe)
    fresh.load_lora(str(tmp_path / "jax.safetensors"), 0.7)
    for name, p in ref.named_parameters():
        assert torch.equal(dict(fresh.unet.named_parameters())[name], p), name


def test_lora_merge_in_bf16_within_an_ulp(pipes):
    _, jpipe, pipe = pipes
    factors = _factors(jpipe.unet_params, 4)
    bf = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), t)
    ref = jlora.merge_lora(bf(jpipe.unet_params), bf(factors), 1.0)
    unet = port(UNetModel(**TINY_UNET, device="cpu"), jpipe.unet_params).to(torch.bfloat16)
    merged = lora.merge_lora(unet, {k: {n: v.bfloat16() for n, v in p.items()}
                                    for k, p in _tt(factors).items()}, 1.0)
    want = port(UNetModel(**TINY_UNET, device="cpu"),
                jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), ref))
    for name, p in want.named_parameters():
        got, exp = merged[name].float(), p.float()
        ulp = torch.pow(2.0, torch.floor(torch.log2(exp.abs().clamp(min=2.0 ** -126))) - 7)
        assert ((got - exp).abs() <= ulp).all(), name


def test_lora_file_checks_and_init():
    with pytest.raises(ValueError, match="no Dense kernels"):
        lora.init_lora(UNetModel(**TINY_UNET, device="cpu"), 4, torch.Generator(),
                       targets=[r"nothing"])
    tree = lora.init_lora(UNetModel(**TINY_UNET, device="cpu"), 2, torch.Generator())
    pair = tree["in_1_0_attn_block_0_attn1_to_q_kernel"]
    assert pair["a"].shape == (64, 2) and not pair["b"].any()


# -- ControlNet ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def control_net():
    cn = jcn.controlnet_from_unet_config(dict(TINY_UNET), hint_downsamples=1)
    x, hint = nprand(2, 16, 16, 4, seed=1), np.random.default_rng(2).random((2, 32, 32, 3))
    t, ctx = np.array([3, 700], np.int32), nprand(2, 16, 32, seed=3)
    cparams = flax_init(cn, jnp.asarray(x), jnp.asarray(hint, jnp.float32), jnp.asarray(t),
                        jnp.asarray(ctx), seed=5)
    return cn, cparams, (x, hint.astype(np.float32), t, ctx)


def test_controlnet_residuals_and_controlled_unet_match(control_net, pipes):
    cn, cparams, (x, hint, t, ctx) = control_net
    _, jpipe, pipe = pipes
    ref = jax.jit(cn.apply)({"params": cparams}, x, hint, t, ctx)
    mod = port(controlnet.controlnet_from_unet_config(TINY_UNET, hint_downsamples=1,
                                                      device="cpu"), cparams)
    with torch.no_grad():
        got = mod(to_torch(x), to_torch(hint), torch.from_numpy(t), to_torch(ctx))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-5)
    # the JAX controlled apply at scale 0.5 is the UNet on the halved residuals
    ref = jax.jit(lambda p, res: JUNet(**TINY_UNET).apply({"params": p}, x, t, ctx,
                                                           control=res))(
        jpipe.unet_params, tuple(r * 0.5 for r in ref))
    with torch.no_grad():
        got = controlnet.controlled_apply_fn(pipe.unet, mod, 0.5)(
            to_torch(x), torch.from_numpy(t), to_torch(ctx), control=to_torch(hint))
        assert torch.equal(controlnet.controlled_apply_fn(pipe.unet, mod)(
            to_torch(x), torch.from_numpy(t), to_torch(ctx)),
            pipe.unet(to_torch(x), torch.from_numpy(t), to_torch(ctx)))
    assert_close(got, ref, MODULE_TOL)
    with pytest.raises(ValueError, match="control expects 5 residuals"):
        pipe.unet(to_torch(x), torch.from_numpy(t), to_torch(ctx), control=got[:3])


def test_init_controlnet_from_unet_matches(control_net, pipes):
    cn, cparams, _ = control_net
    _, jpipe, pipe = pipes
    ref = jcn.init_controlnet_from_unet(cparams, jax.device_get(jpipe.unet_params))
    got = controlnet.init_controlnet_from_unet(
        port(controlnet.controlnet_from_unet_config(TINY_UNET, hint_downsamples=1,
                                                    device="cpu"), cparams), pipe.unet)
    want = port(controlnet.controlnet_from_unet_config(TINY_UNET, hint_downsamples=1,
                                                       device="cpu"), jax.device_get(ref))
    for (name, p), (_, q) in zip(got.named_parameters(), want.named_parameters()):
        assert torch.equal(p, q), name


def test_generate_with_control_image_matches(control_net, pipes):
    """`generate(control_image=…)`, 4 DDIM steps, CFG 5: the JAX pipeline's
    images against the port's `sample` on its x_T with the same hint (a
    uint8 image, so the normalisation is the port's `control_hint`)."""
    _, cparams, _ = control_net
    _, jpipe, pipe = pipes
    hint = np.random.default_rng(6).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    jpipe.load_controlnet(cparams, control_scale=0.8)
    pipe.load_controlnet(cparams, control_scale=0.8)
    try:
        ref = jpipe.generate(PROMPTS, num_steps=STEPS, guidance_scale=5.0, seed=2,
                             control_image=hint)
        img = pipe.sample(PROMPTS, _x_T(2), num_steps=STEPS, guidance_scale=5.0,
                          control=pipe.control_hint(hint, 2))
        assert_within_a_level(to_uint8(img), ref)
        for kw in (dict(sag_scale=0.5), dict(ip_image=hint)):
            with pytest.raises(ValueError, match="cannot combine"):
                pipe.generate(PROMPTS, num_steps=STEPS, control_image=hint, **kw)
        with pytest.raises(ValueError, match=r"\(32, 32\) pixels"):
            pipe.generate(PROMPTS, num_steps=STEPS, control_image=hint[:16])
    finally:
        pipe.controlnet = jpipe.controlnet = None


def to_uint8(img):
    from sd_tpu_torch.pipeline import to_uint8 as port_to_uint8

    return port_to_uint8(img)


def test_edge_hint_matches():
    img = np.random.default_rng(7).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(hints.edge_hint(img), jhints.edge_hint(img))
    np.testing.assert_array_equal(hints.HINT_FNS["identity"](img[0]),
                                  jhints.HINT_FNS["identity"](img[0]))


# -- IP-Adapter ------------------------------------------------------------------------------


class _JaxTinyEmbedder(fnn.Module):
    """The JAX package's embedder with a tiny tower: preprocess to 32², ViT."""

    @fnn.compact
    def __call__(self, x):
        return jcond.ClipVisionTransformer(**TINY_VIT, name="visual")(
            jcond.clip_image_preprocess(x, 32))


class _TinyEmbedder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.visual = conditioners.ClipVisionTransformer(**TINY_VIT, device="cpu")

    def forward(self, x):
        return self.visual(conditioners.clip_image_preprocess(x, 32))


@pytest.mark.parametrize("hw", [(300, 180), (100, 224)])
def test_clip_image_preprocess_matches_jax_resize(hw):
    """Down and up along one axis each, and an axis left at 224: against the
    JAX package's preprocessing within MODULE_TOL, and the resize within 1e-6
    of JAX's own weight matrices applied in float64 (XLA's fp32 contraction
    on the CPU is itself ~2e-5 from that)."""
    from jax._src.image import scale as jscale

    x = np.random.default_rng(hw[0]).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    ref = jax.jit(jcond.clip_image_preprocess)(jnp.asarray(x))
    assert_close(conditioners.clip_image_preprocess(to_torch(x)), ref, MODULE_TOL)
    weights = [np.asarray(jscale.compute_weight_mat(n, 224, 224 / n, 0.0,
                                                    jscale._fill_keys_cubic_kernel, True),
                          np.float64) if n != 224 else np.eye(224) for n in hw]
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64), *weights, optimize=True)
    assert_close(conditioners.bicubic_resize(to_torch(x), 224, 224), exact, 1e-6)


def test_vision_tower_matches():
    x = np.random.default_rng(8).uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    params = flax_init(_JaxTinyEmbedder(), jnp.asarray(x), seed=9)
    ref = jax.jit(_JaxTinyEmbedder().apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(_TinyEmbedder(), params)(to_torch(x))
    assert_close(got, ref, MODULE_TOL)


def test_adapter_tree_matches(pipes):
    _, jpipe, pipe = pipes
    assert (ip_adapter.cross_attention_paths(pipe.unet)
            == jip.cross_attention_paths(jax.device_get(jpipe.unet_params)))
    ref = jip.init_ip_adapter(jax.device_get(jpipe.unet_params), jax.random.PRNGKey(0),
                              embed_dim=16)
    got = ip_adapter.init_ip_adapter(pipe.unet, torch.Generator(), embed_dim=16)
    assert sorted(got["layers"]) == sorted(ref["layers"])
    for key, kernels in got["layers"].items():
        for n, v in kernels.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref["layers"][key][n]))
    emb = nprand(2, 16, seed=10)
    proj = jax.tree_util.tree_map(lambda v: v + nprand(*v.shape, seed=11, scale=0.1),
                                  jax.device_get(ref["proj"]))
    assert_close(ip_adapter.project_image_embed(_tt(proj), to_torch(emb)),
                 jip.project_image_embed(proj, jnp.asarray(emb)), 1e-5)
    assert ip_adapter.nest_layers(got["layers"]).keys() == jip.nest_layers(ref["layers"]).keys()


def test_generate_with_ip_image_matches(pipes):
    """`generate(ip_image=…)`, 4 DDIM steps, CFG 5, scale 0.6: the JAX
    pipeline (adapter and a tiny image embedder set on it) against the
    port's `sample` on its x_T with the port's embedding of the image."""
    _, jpipe, pipe = pipes
    ip = jip.init_ip_adapter(jax.device_get(jpipe.unet_params), jax.random.PRNGKey(1),
                             embed_dim=16)
    ip = jax.tree_util.tree_map(lambda v: np.asarray(v) + nprand(*v.shape, seed=12, scale=0.05),
                                jax.device_get(ip))
    image = np.random.default_rng(13).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    eparams = flax_init(_JaxTinyEmbedder(), jnp.zeros((1, 40, 48, 3)), seed=14)
    jpipe.ip_params, jpipe.ip_scale = ip, 0.6
    jpipe._ip_embedder, jpipe._ip_embedder_params = _JaxTinyEmbedder(), eparams
    pipe.ip_params, pipe.ip_scale, pipe.ip_embedder = _tt(ip), 0.6, port(_TinyEmbedder(), eparams)
    try:
        ref = jpipe.generate(PROMPTS, num_steps=STEPS, guidance_scale=5.0, seed=3,
                             ip_image=image)
        img = pipe.sample(PROMPTS, _x_T(3), num_steps=STEPS, guidance_scale=5.0,
                          ip_embed=pipe.embed_ip_image(image, 2))
        assert_within_a_level(to_uint8(img), ref)
        # the probe pass carries no image payload: refused before any work
        with pytest.raises(ValueError, match="sag_scale and ip_image cannot combine"):
            pipe.generate(PROMPTS, num_steps=STEPS, ip_image=image, sag_scale=0.5)
    finally:
        pipe.ip_params = pipe.ip_embedder = jpipe.ip_params = None
        del jpipe._ip_embed_fn


def test_load_ip_adapter_reads_a_run_directory(pipes, tmp_path):
    """The adapter tree (EMA shadow preferred) in the weights' dtype, and the
    ViT-B/32 embedder by parameter name; an image before loading raises."""
    cfg, jpipe, _ = pipes
    pipe = port_pipeline(cfg, jpipe)
    with pytest.raises(ValueError, match="load_ip_adapter"):
        pipe.generate(PROMPTS, num_steps=STEPS, ip_image=np.zeros((8, 8, 3), np.uint8))
    ip = ip_adapter.init_ip_adapter(pipe.unet, torch.Generator().manual_seed(2))
    embedder = conditioners.FrozenClipImageEmbedder(device="cpu")
    init_params_(embedder, torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path / "run" / "ckpt"),
                    {"params": {}, "ema": {"shadow": ip, "num_updates": 1}}, 5)
    save_checkpoint(str(tmp_path / "run" / "ip_embedder"), dict(embedder.named_parameters()), 5)
    pipe.load_ip_adapter(str(tmp_path / "run"), ip_scale=0.5)
    assert pipe.ip_scale == 0.5
    for key, kernels in ip["layers"].items():
        for n, v in kernels.items():
            assert torch.equal(pipe.ip_params["layers"][key][n], v)
    for (name, p), (_, q) in zip(pipe.ip_embedder.named_parameters(),
                                 embedder.named_parameters()):
        assert torch.equal(p, q), name
    assert pipe.embed_ip_image(np.zeros((64, 64, 3), np.uint8), 2).shape == (2, 512)


def test_ip_payload_stays_off_the_fused_cross_attention(monkeypatch):
    """With the fused cross-attention's gate open (`SD_TPU_PALLAS_XATTN=1`'s
    route), a cross-attention call takes the kernel without an image payload
    and the plain path with one, as in the TPU package (the image tokens
    would be dropped otherwise)."""
    from sd_tpu_torch.kernels import cross_attention as xattn_k
    from sd_tpu_torch.nn.attention import CrossAttention

    attn = CrossAttention(32, 24, heads=4, dim_head=8)
    init_params_(attn, torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(xattn_k, "crossattn_kv_wants_pallas", lambda *a: True)
    monkeypatch.setattr(xattn_k, "crossattn_kv_trainable",
                        lambda *a: calls.append(a) or torch.zeros(2, 6, 32))
    x, ctx = to_torch(nprand(2, 6, 32, seed=1)), to_torch(nprand(2, 5, 24, seed=2))
    ip = (to_torch(nprand(24, 32, seed=3)), to_torch(nprand(24, 32, seed=4)),
          to_torch(nprand(2, 4, 24, seed=5)), 0.5)
    with torch.no_grad():
        attn(x, ctx)
        assert len(calls) == 1
        out = attn(x, ctx, ip_kv=ip)
    assert len(calls) == 1 and out.abs().max() > 0
