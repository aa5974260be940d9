"""Parameters: carrying the TPU package's param trees across, and seeded
initialisation.

The port's submodules carry the TPU package's parameter names, so a flax
path maps onto a torch parameter name mechanically:
  * `GroupNorm_0` / `LayerNorm_0` levels (the TPU package's norm wrappers)
    drop out;
  * `kernel` becomes `weight`: a Dense kernel [in, out] is transposed to
    [out, in], a conv kernel HWIO is permuted to OIHW;
  * `scale` (norms) and `embedding` (embeddings, the quantizers'
    codebooks) become `weight`;
  * raw leaves (`pos_emb`, `mem_k`, a scalar `g`, `rezero_0`, ...) keep
    their names and shapes.
Non-parameter collections map onto buffers the same way: the
discriminator's `batch_stats` and the EMA quantizer's `codebook`.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_DROPPED = ("GroupNorm_0", "LayerNorm_0")
# the x-transformer's raw leaves, initialised N(0, 0.02²) as in the TPU package
N002_PARAMS = ("mem_k", "mem_v", "pre_softmax_proj", "post_softmax_proj", "pos_emb",
               "memory_tokens")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def torch_name(path: tuple[str, ...], ndim: int) -> tuple[str, tuple | None]:
    """(torch parameter name, axis permutation or None) for a flax path."""
    parts = [p for p in path if p not in _DROPPED]
    leaf = parts[-1]
    perm = None
    if leaf == "kernel":
        leaf = "weight"
        perm = {2: (1, 0), 4: (3, 2, 0, 1)}[ndim]
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), perm


def flax_shapes(params: Mapping) -> dict[str, tuple[int, ...]]:
    """Torch name → torch shape for every leaf of a flax param tree (leaves
    may be arrays or shape structs)."""
    out = {}
    for path, leaf in _flatten(params).items():
        shape = tuple(leaf.shape)
        name, perm = torch_name(path, len(shape))
        out[name] = shape if perm is None else tuple(shape[i] for i in perm)
    return out


def load_flax_params(module: nn.Module, params: Mapping) -> None:
    """Fill `module` from a flax param tree (nested dicts of arrays). Strict:
    raises on a missing, extra or mis-shaped leaf. Values are cast to each
    parameter's dtype and device; memory formats are kept."""
    _load(dict(module.named_parameters()), params)


def load_flax_batch_stats(module: nn.Module, batch_stats: Mapping) -> None:
    """Fill `module`'s buffers from a flax `batch_stats` collection (the
    discriminator's BatchNorm `mean` / `var`), as strictly."""
    _load(dict(module.named_buffers()), batch_stats)


def load_flax_codebook(module: nn.Module, codebook: Mapping) -> None:
    """Fill `module`'s buffers from a flax `codebook` collection (the EMA
    quantizer's `weight`, `cluster_size`, `embed_avg`), as strictly."""
    _load(dict(module.named_buffers()), codebook)


def _load(own: dict[str, torch.Tensor], params: Mapping) -> None:
    converted = {}
    for path, leaf in _flatten(params).items():
        arr = np.asarray(leaf)
        name, perm = torch_name(path, arr.ndim)
        converted[name] = arr if perm is None else arr.transpose(perm)
    missing = sorted(set(own) - set(converted))
    extra = sorted(set(converted) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing[:8]}, "
                       f"extra {extra[:8]}")
    for name, arr in converted.items():
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {arr.shape} != {tuple(p.shape)}")
    with torch.no_grad():
        for name, arr in converted.items():
            # (ascontiguousarray makes a 0-d leaf 1-d: keep its shape)
            own[name].copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)
                                             .reshape(arr.shape)))


def _fan_in(p: torch.Tensor) -> int:
    return int(math.prod(p.shape[1:])) if p.ndim > 1 else int(p.shape[0])


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """The TPU package's initialisers: lecun-normal weights (std
    1/sqrt(fan_in)), zero biases, unit norm scales (ScaleNorm's scalar `g`
    too), zero weights for the convs marked `zero_init` and for the scalar
    rezero gains, N(0, 1/width) embeddings, N(0, 0.01) position embeddings,
    N(0, 0.02²) for the x-transformer's raw leaves (`N002_PARAMS`), and each
    quantizer's codebook from its own distribution (`reset_codebook_`)."""
    for mod in module.modules():
        if hasattr(mod, "reset_codebook_"):
            mod.reset_codebook_(generator)
            continue
        for name, p in mod.named_parameters(recurse=False):
            if getattr(mod, "zero_init", False) or name == "bias":
                p.zero_()
            elif p.ndim == 0:
                p.fill_(0.0 if name.startswith("rezero_") else 1.0)
            elif name in N002_PARAMS:
                _normal_(p, generator, 0.02)
            elif name == "position_embedding":
                _normal_(p, generator, 0.01)
            elif isinstance(mod, nn.Embedding):
                _normal_(p, generator, p.shape[1] ** -0.5)
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                _normal_(p, generator, _fan_in(p) ** -0.5)


@torch.no_grad()
def randomize_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Every parameter random, zero-init ones included: weights N(0,
    1/fan_in), biases N(0, 0.02²), norm scales and scalar gains (rezero's
    too) 1 + N(0, 0.1²); the EMA quantizer's codebook buffers from their
    init. A model so filled moves every residual branch, so a check on its
    output sees every kernel's work."""
    for mod in module.modules():
        if hasattr(mod, "reset_codebook_"):
            mod.reset_codebook_(generator)
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                _normal_(p, generator, 0.02)
            elif p.ndim <= 1:
                _normal_(p, generator, 0.1)
                p.add_(1.0)
            elif isinstance(mod, nn.Embedding):
                _normal_(p, generator, p.shape[1] ** -0.5)
            elif name == "position_embedding":
                _normal_(p, generator, 0.01)
            else:
                _normal_(p, generator, _fan_in(p) ** -0.5)


def _normal_(p: torch.Tensor, generator: torch.Generator, std: float) -> None:
    p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32) * std)
