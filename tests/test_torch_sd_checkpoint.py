"""SD-v1 checkpoints between the port and the JAX package, fp32 on the CPU at
the tiny widths of `tests/test_torch_slice.py`, every weight random
(`jax_pipeline`): a synthetic `.ckpt` and `.safetensors` that the JAX
package's `to_sd_checkpoint` wrote load into the port (`from_sd_checkpoint`)
bit for bit equal to `load_flax_params` of the JAX package's import of the
same file; the port's export equals the JAX package's key for key and value
for value, its `.safetensors` byte for byte (fp32 and `half`); an export
round-trips through both packages; `merge_checkpoints` and
`import_torch_clip_text` against the JAX package's; `assert_fully_loaded`
and `load_sd_checkpoint`'s fp16 → fp32.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_torch_helpers import jax_pipeline, port, port_pipeline
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_UNET, TINY_VAE
from test_torch_slice import TINY_CLIP, tiny_config

from sd_tpu.models import sd_export as jexport
from sd_tpu.models import sd_import as jimport
from sd_tpu.models.clip_text import import_torch_clip_text as jimport_clip
from sd_tpu.utils.merge import merge_checkpoints as jmerge
from sd_tpu_torch.models import sd_export, sd_import
from sd_tpu_torch.models.autoencoder import AutoencoderKL
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           import_torch_clip_text)
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.pipeline import Text2ImagePipeline
from sd_tpu_torch.utils.merge import merge_checkpoints

UNET_WALK = dict(channel_mult=TINY_UNET["channel_mult"], num_res_blocks=TINY_UNET["num_res_blocks"],
                 attention_resolutions=TINY_UNET["attention_resolutions"])
VAE_WALK = dict(ch_mult=TINY_VAE["ch_mult"], num_res_blocks=TINY_VAE["num_res_blocks"],
                resolution=TINY_VAE["resolution"])


@pytest.fixture(scope="module")
def pipes():
    cfg = tiny_config()
    jpipe = jax_pipeline(cfg, seed=21)
    return cfg, jpipe, port_pipeline(cfg, jpipe)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _equal_params(module: torch.nn.Module, other: torch.nn.Module) -> None:
    theirs = dict(other.named_parameters())
    for name, p in module.named_parameters():
        assert torch.equal(p, theirs[name]), name


@pytest.mark.parametrize("ext", ["ckpt", "safetensors"])
def test_tpu_packages_export_loads_bit_for_bit(pipes, tmp_path, ext):
    """The JAX package's export, read by both packages: the port's modules
    equal the JAX package's imported trees carried across."""
    cfg, jpipe, _ = pipes
    path = str(tmp_path / f"sd.{ext}")
    jpipe.to_sd_checkpoint(path)
    sd = jimport.load_sd_checkpoint(path)
    jtree_u = jimport.import_sd_unet(_np_tree(jpipe.unet_params), sd, **UNET_WALK)
    jtree_v = jimport.import_sd_vae(_np_tree(jpipe.vae_params), sd, **VAE_WALK)
    got = Text2ImagePipeline.from_sd_checkpoint(cfg, path, param_dtype=None, device="cpu")
    _equal_params(got.unet, port(UNetModel(**TINY_UNET, device="cpu"), jtree_u))
    _equal_params(got.vae, port(AutoencoderKL(**TINY_VAE, device="cpu"), jtree_v))
    state = sd_import.load_sd_checkpoint(path)
    assert sorted(state) == sorted(sd)
    for k, v in state.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), sd[k]), k


def test_export_equals_the_tpu_packages(pipes, tmp_path):
    """Key for key and value for value in fp32; the .safetensors files byte
    for byte, fp32 and fp16; the .ckpt tensor by tensor."""
    _, jpipe, pipe = pipes
    ref = jexport.export_sd_unet(_np_tree(jpipe.unet_params), **UNET_WALK)
    ref.update(jexport.export_sd_vae(_np_tree(jpipe.vae_params), **VAE_WALK))
    got = sd_export.export_sd_unet(pipe.unet, **UNET_WALK)
    got.update(sd_export.export_sd_vae(pipe.vae, **VAE_WALK))
    assert list(got) == list(ref)
    for k, v in got.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), ref[k]), k
    for half in (False, True):
        a, b = tmp_path / f"port{half}.safetensors", tmp_path / f"jax{half}.safetensors"
        pipe.to_sd_checkpoint(str(a), half=half)
        jpipe.to_sd_checkpoint(str(b), half=half)
        assert a.read_bytes() == b.read_bytes()
    pipe.to_sd_checkpoint(str(tmp_path / "port.ckpt"))
    jpipe.to_sd_checkpoint(str(tmp_path / "jax.ckpt"))
    mine = torch.load(tmp_path / "port.ckpt", weights_only=True)["state_dict"]
    theirs = torch.load(tmp_path / "jax.ckpt", weights_only=True)["state_dict"]
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert torch.equal(v, theirs[k]), k


def test_export_round_trips_through_both_packages(pipes, tmp_path):
    """The port's export read back by the JAX package is the JAX package's
    own tree, and by the port its own modules; a full load changes every
    parameter (`assert_fully_loaded`) and a missing key names itself."""
    cfg, jpipe, pipe = pipes
    path = str(tmp_path / "port.safetensors")
    pipe.to_sd_checkpoint(path)
    sd = jimport.load_sd_checkpoint(path)
    back = jimport.import_sd_unet(_np_tree(jpipe.unet_params), sd, **UNET_WALK)
    for (p, a), (_, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0]
                                for t in (back, _np_tree(jpipe.unet_params)))):
        assert np.array_equal(a, b), jax.tree_util.keystr(p)
    fresh = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    before = {n: p.clone() for n, p in fresh.unet.named_parameters()}
    sd_import.import_sd_unet(fresh.unet, sd_import.load_sd_checkpoint(path), **UNET_WALK)
    after = dict(fresh.unet.named_parameters())
    assert sd_import.assert_fully_loaded(before, after) == []
    _equal_params(fresh.unet, pipe.unet)
    assert sd_import.assert_fully_loaded(after, after) == list(after)
    state = sd_import.load_sd_checkpoint(path)
    del state["model.diffusion_model.out.2.bias"]
    with pytest.raises(KeyError, match="out.2.bias"):
        sd_import.import_sd_unet(fresh.unet, state, **UNET_WALK)


def test_half_checkpoint_loads_in_fp32(pipes, tmp_path):
    """A fp16 `.ckpt` (the bare state dict) reads back as fp32 tensors holding
    the fp16 values, as the JAX package's reader gives them."""
    _, jpipe, pipe = pipes
    sd = sd_export.export_sd_unet(pipe.unet, **UNET_WALK)
    torch.save({k: v.half() for k, v in sd.items()}, tmp_path / "half.ckpt")
    got = sd_import.load_sd_checkpoint(str(tmp_path / "half.ckpt"))
    ref = jimport.load_sd_checkpoint(str(tmp_path / "half.ckpt"))
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k], np.float32))


def _dicts():
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3), "b": (3,), "h": (2, 2)}
    make = lambda: {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    a, b, c = make(), make(), make()
    a["h"] = a["h"].astype(np.float16)
    a["only_a"] = rng.standard_normal(5).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("mode,alpha", [("weighted", 0.0), ("weighted", 0.3),
                                        ("weighted", 1.0), ("add_difference", 0.7)])
def test_merge_checkpoints_matches(mode, alpha):
    a, b, c = _dicts()
    del c["b"]
    ref, ref_skipped = jmerge(a, b, alpha=alpha, c=c, mode=mode)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    got, skipped = merge_checkpoints(tt(a), tt(b), alpha=alpha, c=tt(c), mode=mode)
    assert skipped == ref_skipped
    for k, v in got.items():
        assert v.dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
    if mode == "weighted" and alpha == 0.0:
        assert all(torch.equal(got[k], tt(a)[k]) for k in a)


def test_merge_checkpoints_errors():
    a, b, c = (({k: torch.from_numpy(v) for k, v in d.items()}) for d in _dicts())
    with pytest.raises(ValueError, match="unknown merge mode"):
        merge_checkpoints(a, b, mode="sum")
    with pytest.raises(ValueError, match="base checkpoint"):
        merge_checkpoints(a, b, mode="add_difference")
    b["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_checkpoints(a, b)


def test_import_torch_clip_text_matches():
    """A Hugging Face CLIPTextModel state dict (random, the text_model.*
    layout) into both packages' encoders: the port's parameters equal the
    JAX package's tree carried across."""
    from test_torch_helpers import flax_init

    import jax.numpy as jnp

    from sd_tpu.models.clip_text import ClipTextConfig as JConfig
    from sd_tpu.models.clip_text import ClipTextTransformer as JClip

    cfg = JConfig(**TINY_CLIP)
    params = flax_init(JClip(cfg), jnp.zeros((1, 16), jnp.int32), seed=4)
    C, L = TINY_CLIP["hidden_size"], TINY_CLIP["max_length"]
    rng = np.random.default_rng(5)
    hf = {"text_model.embeddings.token_embedding.weight": (TINY_CLIP["vocab_size"], C),
          "text_model.embeddings.position_embedding.weight": (L, C),
          "text_model.final_layer_norm.weight": (C,), "text_model.final_layer_norm.bias": (C,)}
    for i in range(TINY_CLIP["num_layers"]):
        for name, shape in (("self_attn.q_proj", (C, C)), ("self_attn.k_proj", (C, C)),
                            ("self_attn.v_proj", (C, C)), ("self_attn.out_proj", (C, C)),
                            ("mlp.fc1", (4 * C, C)), ("mlp.fc2", (C, 4 * C)),
                            ("layer_norm1", (C,)), ("layer_norm2", (C,))):
            hf[f"text_model.encoder.layers.{i}.{name}.weight"] = shape
            hf[f"text_model.encoder.layers.{i}.{name}.bias"] = shape[:1]
    hf = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in hf.items()}
    ref = jimport_clip(params, hf)
    got = ClipTextTransformer(ClipTextConfig(**TINY_CLIP), device="cpu")
    import_torch_clip_text(got, hf)
    _equal_params(got, port(ClipTextTransformer(ClipTextConfig(**TINY_CLIP), device="cpu"),
                            _np_tree(ref)))
