"""The port's modules back into the Stable-Diffusion v1 checkpoint layout,
the exact inverse of `models/sd_import.py`.

Counterpart of `sd_tpu/models/sd_export.py`:
  * `export_sd_vae(vae, ...)`   — AutoencoderKL → `first_stage_model.*`;
  * `export_sd_unet(unet, ...)` — UNetModel → `model.diffusion_model.*`;
  * `save_sd_checkpoint(path, state_dict, half=False)` — `.safetensors`
    through the port's writer (metadata {"format": "pt"}; the same bytes as
    the TPU package's writer for the same tensors), anything else
    `torch.save({"state_dict": ...})`; `half` writes fp16.

Both exports walk `sd_import`'s block lists, so export ∘ import is the
identity. Values come out as contiguous fp32 CPU tensors.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from sd_tpu_torch.models.sd_import import LEAVES, Pairs, module_pairs_unet, module_pairs_vae
from sd_tpu_torch.utils.safetensors_io import save_safetensors


def export_pairs(module: nn.Module, pairs: Pairs, prefix: str = "") -> dict[str, torch.Tensor]:
    """{prefix + SD module + "." + leaf: fp32 CPU tensor} of every weight and
    bias the port's module has, in the walk's order."""
    own = dict(module.named_parameters())
    out = {}
    for port, key in pairs:
        for leaf in LEAVES:
            p = own.get(f"{port}.{leaf}")
            if p is not None:
                out[f"{prefix}{key}.{leaf}"] = p.detach().float().cpu().contiguous()
    return out


def export_sd_vae(vae: nn.Module, ch_mult: Sequence[int] = (1, 2, 4, 4),
                  num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                  resolution: int = 256,
                  prefix: str = "first_stage_model.") -> dict[str, torch.Tensor]:
    """AutoencoderKL → SD first-stage state dict (fp32)."""
    return export_pairs(vae, module_pairs_vae(ch_mult, num_res_blocks, attn_resolutions,
                                              resolution), prefix)


def export_sd_unet(unet: nn.Module, channel_mult: Sequence[int] = (1, 2, 4, 4),
                   num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4, 2, 1),
                   transformer_depth: int = 1,
                   prefix: str = "model.diffusion_model.") -> dict[str, torch.Tensor]:
    """UNetModel → SD diffusion-model state dict (fp32)."""
    return export_pairs(unet, module_pairs_unet(channel_mult, num_res_blocks,
                                                attention_resolutions, transformer_depth),
                        prefix)


def save_sd_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                       half: bool = False) -> None:
    """Write an SD-layout state dict: `.safetensors` through the port's
    writer, anything else `torch.save({"state_dict": ...})`; fp16 with
    `half`, else fp32."""
    dt = torch.float16 if half else torch.float32
    tensors = {k: torch.as_tensor(v).to(dt) for k, v in state_dict.items()}
    if path.endswith(".safetensors"):
        save_safetensors(path, tensors, metadata={"format": "pt"})
    else:
        torch.save({"state_dict": tensors}, path)
