"""The codec's per-level attention and the UNet's self-attention block
against the JAX package's, on the CPU in fp32 at tiny widths.

`make_attn` (vanilla `AttnBlock`, `LinearAttention`, none) and
`SelfAttentionBlock2D` (with `num_heads` and with `num_head_channels`) take
the same random weights and inputs as the JAX modules and agree within
1e-5·max|ref| (`BLOCK_TOL`). The Encoder and Decoder with attention at two
levels (ch 16, mult (1, 2, 2), 32², attention at 16² and 8²) agree within
1e-4·max|ref| (`CODEC_TOL`) under each `attn_type`; the strict carry-over
(`load_flax_params`) checks that every block carries the TPU package's
auto-name (`AttnBlock_k`, `LinearAttention_k`; the encoder's mid block the
last index, the decoder's index 0). Also: the SD-v1 checkpoint walk
through the per-level blocks, `kl_f32` and `vq_gumbel_f8` (their configs
equal to their YAML) built and trained one step at tiny widths, and the
errors.
"""

from __future__ import annotations

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_helpers import flax_init, init_shapes, nprand, port, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.models import codec as jcodec
from sd_tpu.models import unet_sd as junet
from sd_tpu.nn import attention as jattn
from sd_tpu_torch.core.config import kl_f32_config, vq_gumbel_f8_config
from sd_tpu_torch.models import codec
from sd_tpu_torch.models.autoencoder import AutoencoderKL, VQModel
from sd_tpu_torch.models.sd_export import export_sd_vae
from sd_tpu_torch.models.sd_import import import_sd_vae
from sd_tpu_torch.models.unet_sd import SelfAttentionBlock2D
from sd_tpu_torch.nn import attention
from sd_tpu_torch.train import runners
from sd_tpu_torch.weights import randomize_params_

REPO = Path(__file__).resolve().parents[1]
BLOCK_TOL = 1e-5
CODEC_TOL = 1e-4
ATTN_TYPES = ("vanilla", "linear", "none")
CODEC = dict(ch=16, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(16, 8),
             resolution=32, z_channels=4)


def assert_rel(got, ref, tol: float) -> None:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, bound = float(np.max(np.abs(got - ref))), tol * float(np.max(np.abs(ref)))
    assert err <= bound, f"max|Δ| = {err:.3g} > {bound:.3g}"


def run_both(flax_mod, torch_mod, x: np.ndarray, seed: int = 0):
    """(port output, JAX output) of the two modules on x with the same random
    weights (the JAX apply jitted; a module without parameters has none)."""
    has = "params" in init_shapes(flax_mod, jnp.asarray(x))
    params = flax_init(flax_mod, jnp.asarray(x), seed=seed) if has else {}
    ref = jax.jit(lambda p, a: flax_mod.apply({"params": p}, a))(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch_mod, params)(to_torch(x))
    return got, ref


# -- blocks ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_make_attn_matches(attn_type):
    x = nprand(2, 4, 6, 64, seed=1)
    got, ref = run_both(jattn.make_attn(attn_type), attention.make_attn(attn_type, 64), x)
    assert_rel(got, ref, BLOCK_TOL)
    want = {"vanilla": attention.AttnBlock, "linear": attention.LinearAttention}
    mod = attention.make_attn(attn_type, 64)
    assert type(mod) is want.get(attn_type, attention._Identity)
    if attn_type == "none":
        assert not list(mod.parameters()) and got.equal(to_torch(x))


def test_linear_attention_sizes_match():
    x = nprand(1, 3, 5, 24, seed=2)
    got, ref = run_both(jattn.LinearAttention(heads=2, dim_head=8),
                        attention.LinearAttention(24, heads=2, dim_head=8), x)
    assert_rel(got, ref, BLOCK_TOL)


@pytest.mark.parametrize("heads", [dict(num_heads=4), dict(num_head_channels=16)])
def test_self_attention_block_matches(heads):
    x = nprand(2, 4, 6, 64, seed=3)
    got, ref = run_both(junet.SelfAttentionBlock2D(**heads),
                        SelfAttentionBlock2D(64, **heads), x)
    assert_rel(got, ref, BLOCK_TOL)
    assert SelfAttentionBlock2D(64, **heads).heads == 4


def test_make_attn_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="attn_type"):
        jattn.make_attn("flash")
    with pytest.raises(ValueError, match="attn_type"):
        attention.make_attn("flash", 64)


# -- the codec ------------------------------------------------------------------------


@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_encoder_and_decoder_with_per_level_attention_match(attn_type):
    x, z = nprand(2, 32, 32, 3, seed=4), nprand(2, 8, 8, 4, seed=5)
    enc = codec.Encoder(**CODEC, attn_type=attn_type, device="cpu")
    got, ref = run_both(jcodec.Encoder(**CODEC, attn_type=attn_type), enc, x, seed=6)
    assert_rel(got, ref, CODEC_TOL)
    dec = codec.Decoder(**CODEC, attn_type=attn_type, device="cpu")
    got, ref = run_both(jcodec.Decoder(**CODEC, attn_type=attn_type), dec, z, seed=7)
    assert_rel(got, ref, CODEC_TOL)
    cls = {"vanilla": "AttnBlock", "linear": "LinearAttention", "none": "_Identity"}[attn_type]
    # flax's order: the encoder's per-level blocks first, the decoder's mid block first
    assert enc.attn_names == {(1, 0): f"{cls}_0", (2, 0): f"{cls}_1", "mid": f"{cls}_2"}
    assert dec.attn_names == {"mid": f"{cls}_0", (2, 0): f"{cls}_1", (2, 1): f"{cls}_2",
                              (1, 0): f"{cls}_3", (1, 1): f"{cls}_4"}


def test_sd_checkpoint_walk_names_every_per_level_block():
    kw = dict(embed_dim=4, **CODEC)
    src = AutoencoderKL(**kw, device="cpu")
    randomize_params_(src, torch.Generator().manual_seed(8))
    sd = export_sd_vae(src, ch_mult=CODEC["ch_mult"], num_res_blocks=1,
                       attn_resolutions=CODEC["attn_resolutions"], resolution=32)
    assert "first_stage_model.encoder.down.1.attn.0.q.weight" in sd
    assert "first_stage_model.decoder.up.1.attn.1.proj_out.weight" in sd
    dst = import_sd_vae(AutoencoderKL(**kw, device="cpu"), sd, ch_mult=CODEC["ch_mult"],
                        num_res_blocks=1, attn_resolutions=CODEC["attn_resolutions"],
                        resolution=32)
    for (n, a), b in zip(src.named_parameters(), dst.parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("fn,path", [(kl_f32_config, "configs/kl_f32.yaml"),
                                     (vq_gumbel_f8_config, "configs/vq_gumbel_f8.yaml")])
def test_codec_configs_equal_their_yaml(fn, path):
    with open(REPO / path) as f:
        assert fn() == yaml.safe_load(f)


def _tiny(cfg: dict, **model) -> dict:
    """`cfg` at tiny widths: 64² (its attention resolutions scaled with it,
    so the same levels attend), ch 16, no perceptual term, a 2-layer
    PatchGAN, batch 1."""
    cfg = copy.deepcopy(cfg)
    mp = cfg["model"]["params"]
    mp.update(ch=16, resolution=64, attn_resolutions=[r * 64 // 256 for r in
                                                      mp["attn_resolutions"]], **model)
    cfg["loss"]["perceptual"] = "none"
    cfg["discriminator"].update(ndf=8, n_layers=2)
    cfg["train"].update(image_size=64, batch_size=1)
    return cfg


@pytest.mark.parametrize("name,levels", [("kl_f32", {4, 5}), ("vq_gumbel_f8", {3})])
def test_per_level_attention_codecs_build_and_train_a_step(name, levels):
    if name == "kl_f32":
        cfg, cls, train = _tiny(kl_f32_config(), embed_dim=4, z_channels=4), AutoencoderKL, \
            runners.train_kl_vae
    else:
        cfg, cls, train = _tiny(vq_gumbel_f8_config(), n_embed=64, embed_dim=8,
                                z_channels=8), VQModel, runners.train_vq
    model = cls(**cfg["model"]["params"], device="cpu")
    assert {k[0] for k in model.encoder.attn_names if k != "mid"} == levels
    assert {k[0] for k in model.decoder.attn_names if k != "mid"} == levels
    batch = {"image": nprand(1, 64, 64, 3, seed=9).clip(-1, 1)}
    _, history = train(cfg, [batch], max_steps=1, device="cpu")
    assert len(history) == 1
    assert all(np.isfinite(v) for v in history[0].values()), history
