"""Stable-Diffusion v1 checkpoints into the port's modules.

Counterpart of `sd_tpu/models/sd_import.py`:
  * `import_sd_vae(vae, state_dict, ...)`   — `first_stage_model.*` →
    AutoencoderKL (encoder, decoder, quant convs, attention blocks);
  * `import_sd_unet(unet, state_dict, ...)` — `model.diffusion_model.*` →
    UNetModel (input, middle and output blocks, SpatialTransformers, the
    time MLP);
  * `load_sd_checkpoint(path)`              — a `.ckpt` (torch pickle,
    `weights_only`) or `.safetensors` file as a flat state dict in fp32;
  * `assert_fully_loaded(before, after)`    — the parameters a load left
    unchanged.

The port's parameters carry the TPU package's names and torch's layouts
(Linear [out, in], Conv OIHW), so the map is SD module → port module with no
transposes: SD-v1's 1×1-conv `proj_in` / `proj_out` are 1×1 convs in the
port too. The walk over the blocks (channel_mult, num_res_blocks,
attention_resolutions, transformer_depth; ch_mult, attn_resolutions,
resolution for the first stage) is the TPU package's; `module_pairs_unet` and
`module_pairs_vae` list it once, and `sd_export.py` walks the same lists
backwards. Values are copied into each parameter in its own dtype (fp32 →
bf16 rounds to nearest even, as the TPU package's cast does).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from sd_tpu_torch.utils.safetensors_io import load_safetensors

Pairs = list[tuple[str, str]]      # (port module path, SD module path)
LEAVES = ("weight", "bias")


def _resblock_sd(port: str, sd: str) -> Pairs:
    return [(f"{port}.in_norm", f"{sd}.in_layers.0"), (f"{port}.in_conv", f"{sd}.in_layers.2"),
            (f"{port}.emb_proj", f"{sd}.emb_layers.1"),
            (f"{port}.out_norm", f"{sd}.out_layers.0"),
            (f"{port}.out_conv", f"{sd}.out_layers.3"), (f"{port}.skip", f"{sd}.skip_connection")]


def _transformer(port: str, sd: str, depth: int) -> Pairs:
    out = [(f"{port}.{n}", f"{sd}.{n}") for n in ("norm", "proj_in", "proj_out")]
    for d in range(depth):
        p, s = f"{port}.block_{d}", f"{sd}.transformer_blocks.{d}"
        for attn in ("attn1", "attn2"):
            out += [(f"{p}.{attn}.{n}", f"{s}.{attn}.{n}") for n in ("to_q", "to_k", "to_v")]
            out.append((f"{p}.{attn}.to_out", f"{s}.{attn}.to_out.0"))
        out += [(f"{p}.ff.proj_in", f"{s}.ff.net.0.proj"), (f"{p}.ff.proj_out", f"{s}.ff.net.2")]
        out += [(f"{p}.{n}", f"{s}.{n}") for n in ("norm1", "norm2", "norm3")]
    return out


def module_pairs_unet(channel_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                      attention_resolutions: Sequence[int] = (4, 2, 1),
                      transformer_depth: int = 1) -> Pairs:
    """(port module, SD module) of every UNet block, in the TPU package's
    export order."""
    L = len(channel_mult)
    out = [("time_embed_1", "time_embed.0"), ("time_embed_2", "time_embed.2"),
           ("input_conv", "input_blocks.0.0")]
    n, ds = 1, 1
    for lvl in range(L):
        for i in range(num_res_blocks):
            out += _resblock_sd(f"in_{lvl}_{i}_res", f"input_blocks.{n}.0")
            if ds in attention_resolutions:
                out += _transformer(f"in_{lvl}_{i}_attn", f"input_blocks.{n}.1",
                                    transformer_depth)
            n += 1
        if lvl != L - 1:
            out.append((f"in_{lvl}_down.conv", f"input_blocks.{n}.0.op"))
            n += 1
            ds *= 2
    out += _resblock_sd("mid_res1", "middle_block.0")
    out += _transformer("mid_attn", "middle_block.1", transformer_depth)
    out += _resblock_sd("mid_res2", "middle_block.2")
    n = 0
    for lvl in reversed(range(L)):
        for i in range(num_res_blocks + 1):
            out += _resblock_sd(f"out_{lvl}_{i}_res", f"output_blocks.{n}.0")
            k = 1
            if ds in attention_resolutions:
                out += _transformer(f"out_{lvl}_{i}_attn", f"output_blocks.{n}.{k}",
                                    transformer_depth)
                k += 1
            if lvl != 0 and i == num_res_blocks:
                out.append((f"out_{lvl}_up.conv", f"output_blocks.{n}.{k}.conv"))
                ds //= 2
            n += 1
    return out + [("out_norm", "out.0"), ("out_conv", "out.2")]


def _resblock_codec(port: str, sd: str) -> Pairs:
    return [(f"{port}.{n}", f"{sd}.{n}") for n in ("norm1", "conv1", "norm2", "conv2",
                                                    "temb_proj", "nin_shortcut",
                                                    "conv_shortcut")]


def _attn_codec(port: str, sd: str) -> Pairs:
    return [(f"{port}.{n}", f"{sd}.{n}") for n in ("norm", "q", "k", "v", "proj_out")]


def module_pairs_vae(ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                     attn_resolutions: Sequence[int] = (), resolution: int = 256) -> Pairs:
    """(port module, SD module) of every KL first-stage block, in the TPU
    package's export order."""
    L = len(ch_mult)
    out = [("encoder.conv_in", "encoder.conv_in")]
    attn, res = 0, resolution
    for lvl in range(L):
        for j in range(num_res_blocks):
            out += _resblock_codec(f"encoder.down_{lvl}_block_{j}", f"encoder.down.{lvl}.block.{j}")
            if res in attn_resolutions:
                out += _attn_codec(f"encoder.AttnBlock_{attn}", f"encoder.down.{lvl}.attn.{j}")
                attn += 1
        if lvl != L - 1:
            out.append((f"encoder.down_{lvl}_downsample.conv",
                        f"encoder.down.{lvl}.downsample.conv"))
            res //= 2
    out += _resblock_codec("encoder.mid_block_1", "encoder.mid.block_1")
    out += _attn_codec(f"encoder.AttnBlock_{attn}", "encoder.mid.attn_1")
    out += _resblock_codec("encoder.mid_block_2", "encoder.mid.block_2")
    out += [("encoder.norm_out", "encoder.norm_out"), ("encoder.conv_out", "encoder.conv_out"),
            ("decoder.conv_in", "decoder.conv_in")]
    out += _resblock_codec("decoder.mid_block_1", "decoder.mid.block_1")
    out += _attn_codec("decoder.AttnBlock_0", "decoder.mid.attn_1")
    out += _resblock_codec("decoder.mid_block_2", "decoder.mid.block_2")
    attn, res = 1, resolution // 2 ** (L - 1)
    for lvl in reversed(range(L)):
        for j in range(num_res_blocks + 1):
            out += _resblock_codec(f"decoder.up_{lvl}_block_{j}", f"decoder.up.{lvl}.block.{j}")
            if res in attn_resolutions:
                out += _attn_codec(f"decoder.AttnBlock_{attn}", f"decoder.up.{lvl}.attn.{j}")
                attn += 1
        if lvl != 0:
            out.append((f"decoder.up_{lvl}_upsample.conv", f"decoder.up.{lvl}.upsample.conv"))
            res *= 2
    return out + [("decoder.norm_out", "decoder.norm_out"),
                  ("decoder.conv_out", "decoder.conv_out"),
                  ("quant_conv", "quant_conv"), ("post_quant_conv", "post_quant_conv")]


@torch.no_grad()
def copy_pairs_(module: nn.Module, sd: Mapping[str, torch.Tensor], pairs: Pairs,
                prefix: str = "") -> nn.Module:
    """Copy `sd[prefix + sd_module + "." + leaf]` into every weight and bias
    the port's module has, in place, cast to the parameter's dtype; a key the
    file lacks raises KeyError naming it, a shape that differs ValueError."""
    own = dict(module.named_parameters())
    for port, key in pairs:
        for leaf in LEAVES:
            p = own.get(f"{port}.{leaf}")
            if p is None:
                continue
            src = sd[f"{prefix}{key}.{leaf}"]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{prefix}{key}.{leaf}: shape {tuple(src.shape)} != "
                                 f"{port}.{leaf} {tuple(p.shape)}")
            p.copy_(torch.as_tensor(src))
    return module


def import_sd_vae(vae: nn.Module, sd: Mapping[str, torch.Tensor],
                  ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                  attn_resolutions: Sequence[int] = (), resolution: int = 256,
                  prefix: str = "first_stage_model.") -> nn.Module:
    """An SD first-stage (AutoencoderKL) state dict into the port's
    AutoencoderKL, in place (the config must match the checkpoint)."""
    return copy_pairs_(vae, sd, module_pairs_vae(ch_mult, num_res_blocks, attn_resolutions,
                                                 resolution), prefix)


def import_sd_unet(unet: nn.Module, sd: Mapping[str, torch.Tensor],
                   channel_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                   attention_resolutions: Sequence[int] = (4, 2, 1),
                   transformer_depth: int = 1,
                   prefix: str = "model.diffusion_model.") -> nn.Module:
    """An SD UNet (`model.diffusion_model.*`) state dict into the port's
    UNetModel, in place (the config must match the checkpoint)."""
    return copy_pairs_(unet, sd, module_pairs_unet(channel_mult, num_res_blocks,
                                                   attention_resolutions, transformer_depth),
                       prefix)


def load_sd_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The flat state dict of an SD checkpoint on the CPU, floating values
    in fp32 (distributions store fp16 / bf16): `.safetensors` through the
    port's reader, anything else a torch checkpoint (`{"state_dict": ...}`
    or the bare dict) loaded with `weights_only=True`, memory-mapped."""
    if path.endswith(".safetensors"):
        state = load_safetensors(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        state = ckpt.get("state_dict", ckpt)
    return {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in state.items()}


def assert_fully_loaded(before: Mapping[str, torch.Tensor],
                        after: Mapping[str, torch.Tensor]) -> list[str]:
    """The parameter names whose values a load did NOT change (a load should
    change every one), given snapshots {name: tensor} before and after."""
    unchanged = []
    for name, b in before.items():
        a = after[name]
        if tuple(a.shape) != tuple(b.shape):
            unchanged.append(name + " [SHAPE MISMATCH]")
        elif torch.allclose(b.float().cpu(), a.float().cpu()):
            unchanged.append(name)
    return unchanged
