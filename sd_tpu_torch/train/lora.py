"""LoRA: low-rank updates merged into a module's weights (Hu et al.,
arXiv:2106.09685).

Counterpart of `sd_tpu/train/lora.py` (`lora_targets`, `init_lora`,
`merge_lora`, `count_lora_params`, `save_lora_safetensors`,
`load_lora_safetensors`; `merged_kernels` is the merge that carries
gradients to the factors, for `train_ldm`'s LoRA branch
(`train/runners.py ldm_branch`) and the LCM-LoRA distillation of
`train/distill.py`). A factor
tree maps each adapted kernel's checkpoint key to {"a": [in, r], "b": [r,
out]}, in the TPU package's names and layout: the key is the flax path of
the Dense kernel
(`['in_0_0_attn']['block_0']['attn1']['to_q']['kernel']` →
`in_0_0_attn_block_0_attn1_to_q_kernel`), and a·b is a flax kernel [in,
out], so a file that either package wrote loads into the other. The port's
weight is [out, in]: the merge adds (a·b·scale)ᵀ. The arithmetic is the TPU
package's: the product rounded to the factors' dtype (the pipeline casts
them to the weights' dtype first; the product is accumulated in fp32 and
rounded once, as XLA's bf16 dot is), the sum in fp32, cast back to the
weight's dtype.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch
from torch import nn

from sd_tpu_torch.nn.layers import Dense
from sd_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors

# the standard SD LoRA surface: every attention projection (self and cross)
LORA_DEFAULT_TARGETS = [r".*attn[12].*(to_q|to_k|to_v|to_out).*kernel"]


def _key(name: str) -> str:
    """The checkpoint-safe key of a kernel path (the TPU package's)."""
    return re.sub(r"[^0-9a-zA-Z_]+", "_", name).strip("_")


def dense_kernels(module: nn.Module) -> dict[str, tuple[str, torch.Tensor]]:
    """{flax path string of each Dense kernel: (port parameter name, weight)}
    in the flax tree's order (keys sorted at every level)."""
    out = []
    for name, mod in module.named_modules():
        if isinstance(mod, Dense):
            parts = tuple(name.split(".")) if name else ()
            out.append((parts, name))
    out.sort()
    return {"".join(f"['{p}']" for p in (*parts, "kernel")):
            (f"{name}.weight" if name else "weight", module.get_submodule(name).weight)
            for parts, name in out}


def lora_targets(module: nn.Module, targets: list[str] | None = None) -> list[str]:
    """The flax paths of the kernels the target regexes select."""
    targets = targets or LORA_DEFAULT_TARGETS
    return [path for path in dense_kernels(module)
            if any(re.match(p, path) for p in targets)]


def init_lora(module: nn.Module, rank: int, generator: torch.Generator,
              targets: list[str] | None = None) -> dict:
    """{key: {"a": [in, rank] N(0, 1/rank), "b": zeros [rank, out]}} for every
    targeted kernel, fp32 on the generator's device: b = 0, so the adapted
    model starts exactly at the base model."""
    flat = {}
    kernels = dense_kernels(module)
    for path in lora_targets(module, targets):
        out_f, in_f = kernels[path][1].shape
        a = torch.randn((in_f, rank), generator=generator, device=generator.device) / rank ** 0.5
        flat[_key(path)] = {"a": a, "b": torch.zeros((rank, out_f), device=generator.device)}
    if not flat:
        raise ValueError(f"no Dense kernels matched LoRA targets {targets or LORA_DEFAULT_TARGETS}")
    return flat


def merged_kernels(module: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]],
                   scale: float = 1.0) -> dict[str, torch.Tensor]:
    """{parameter name: base + scale·(a·b)ᵀ} for every adapted kernel of
    `module` (new tensors, differentiable in the factors: the LCM-LoRA
    student's weights, applied with `torch.func.functional_call`)."""
    out = {}
    for path, (name, w) in dense_kernels(module).items():
        pair = lora.get(_key(path))
        if pair is None:
            continue
        a, b = pair["a"].to(w.device), pair["b"].to(w.device)
        delta = (a.float() @ b.float()).to(a.dtype) * scale
        out[name] = (w.detach().float() + delta.float().T).to(w.dtype)
    return out


def merge_lora(module: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]],
               scale: float = 1.0) -> dict[str, torch.Tensor]:
    """{parameter name: tensor} of `module` with base + scale·(a·b)ᵀ on every
    adapted kernel (new tensors) and every other parameter as it is."""
    with torch.no_grad():
        return {**dict(module.named_parameters()), **merged_kernels(module, lora, scale)}


def flat_lora(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """A factor tree as {"<key>.a": a, "<key>.b": b} (a training state's
    parameters by name)."""
    return {f"{k}.{leaf}": pair[leaf] for k, pair in lora.items() for leaf in ("a", "b")}


def nest_lora(flat: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of `flat_lora`; a nested tree is returned as it is."""
    if all(isinstance(v, Mapping) for v in flat.values()):
        return dict(flat)
    out: dict = {}
    for name, v in flat.items():
        base, leaf = name.rsplit(".", 1)
        out.setdefault(base, {})[leaf] = v
    return out


def count_lora_params(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    return sum(t.numel() for pair in lora.values() for t in pair.values())


def save_lora_safetensors(path: str, lora: Mapping[str, Mapping[str, torch.Tensor]],
                          metadata: dict | None = None) -> None:
    """A factor tree as a `.safetensors` LoRA file (`<key>.a` / `<key>.b`,
    fp32, metadata {"sd_tpu": "lora"} and `metadata`)."""
    flat = {}
    for k, pair in lora.items():
        flat[k + ".a"] = torch.as_tensor(pair["a"]).float()
        flat[k + ".b"] = torch.as_tensor(pair["b"]).float()
    meta = {"sd_tpu": "lora"}
    if metadata:
        meta.update({str(a): str(b) for a, b in metadata.items()})
    save_safetensors(path, flat, metadata=meta)


def load_lora_safetensors(path: str) -> dict:
    """A `.safetensors` LoRA file back into a factor tree (CPU tensors)."""
    out: dict = {}
    for name, v in load_safetensors(path).items():
        base, leaf = name.rsplit(".", 1)
        if leaf not in ("a", "b"):
            raise ValueError(f"unexpected LoRA tensor name {name!r}")
        out.setdefault(base, {})[leaf] = v
    for k, pair in out.items():
        if set(pair) != {"a", "b"}:
            raise ValueError(f"LoRA kernel {k!r} missing a/b factor")
        if pair["a"].shape[1] != pair["b"].shape[0]:
            raise ValueError(f"LoRA kernel {k!r} rank mismatch "
                             f"{tuple(pair['a'].shape)} @ {tuple(pair['b'].shape)}")
    return out
