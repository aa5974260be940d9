"""IP-Adapter: image-prompt conditioning through decoupled cross-attention
(Ye et al., arXiv:2308.06721), the inference half.

Counterpart of `sd_tpu/models/ip_adapter.py`. A frozen CLIP image embedding
is projected to `n_tokens` context-width tokens; every cross-attention of
the UNet reads them in a second attention with adapter-owned K/V kernels,
summed with the text read before the shared output projection:

    z = Attn(Q, K_txt, V_txt) + scale · Attn(Q, K_img, V_img)

The adapter tree keeps the TPU package's layout and names, so a tree that
either package holds carries across as it is: {"proj": {kernel [E, n·Cc],
bias, ln_scale, ln_bias}, "layers": {"in_1_0_attn/block_0/attn2":
{"to_k_ip": [Cc, inner], "to_v_ip": [Cc, inner]}}}, kernels [in, out]. A
training state holds it flat by name (`flat_ip`: "proj.kernel",
"layers.in_1_0_attn/block_0/attn2.to_k_ip", ...; `nest_ip` is the inverse);
`train/runners.py ldm_branch` trains it over the frozen UNet.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from sd_tpu_torch.nn.attention import CrossAttention


def init_image_proj(generator: torch.Generator, embed_dim: int, ctx_dim: int,
                    n_tokens: int = 4) -> dict:
    """{kernel, bias, ln_scale, ln_bias}: [B, embed_dim] CLIP embedding →
    [B, n_tokens, ctx_dim] context tokens (fp32, on the generator's device)."""
    dev = generator.device
    return {"kernel": torch.randn((embed_dim, n_tokens * ctx_dim), generator=generator,
                                  device=dev) * embed_dim ** -0.5,
            "bias": torch.zeros((n_tokens * ctx_dim,), device=dev),
            "ln_scale": torch.ones((ctx_dim,), device=dev),
            "ln_bias": torch.zeros((ctx_dim,), device=dev)}


def project_image_embed(proj: dict, emb: torch.Tensor) -> torch.Tensor:
    """[B, embed_dim] → [B, n_tokens, ctx_dim] in fp32 (linear → reshape →
    LayerNorm with eps 1e-5); n_tokens is the kernel's columns over the
    LayerNorm's width."""
    n = proj["kernel"].shape[1] // proj["ln_scale"].shape[0]
    h = emb.float() @ proj["kernel"].float() + proj["bias"].float()
    h = h.reshape(h.shape[0], n, -1)
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    h = (h - mean) * torch.rsqrt(var + 1e-5)
    return h * proj["ln_scale"].float() + proj["ln_bias"].float()


def cross_attention_paths(unet: nn.Module) -> list[tuple[str, ...]]:
    """The module paths of every cross-attention (".../attn2"), sorted."""
    return sorted(tuple(name.split(".")) for name, mod in unet.named_modules()
                  if isinstance(mod, CrossAttention) and name.split(".")[-1].startswith("attn2"))


@torch.no_grad()
def init_ip_adapter(unet: nn.Module, generator: torch.Generator, embed_dim: int = 512,
                    n_tokens: int = 4) -> dict:
    """The adapter tree, its per-layer kernels copies of the base to_k / to_v
    (in [in, out] layout: the paper's init, the image read starting out as
    the text read), fp32."""
    paths = cross_attention_paths(unet)
    if not paths:
        raise ValueError("no cross-attention (attn2) modules in this UNet")
    layers = {}
    for p in paths:
        attn = unet.get_submodule(".".join(p))
        layers["/".join(p)] = {"to_k_ip": attn.to_k.weight.float().T.clone(),
                               "to_v_ip": attn.to_v.weight.float().T.clone()}
    ctx_dim = attn.to_k.weight.shape[1]
    return {"proj": init_image_proj(generator, embed_dim, ctx_dim, n_tokens), "layers": layers}


def count_ip_params(ip: dict) -> int:
    """Elements of an adapter tree."""
    return sum(t.numel() for t in flat_ip(ip).values())


def flat_ip(ip: dict) -> dict[str, torch.Tensor]:
    """The adapter tree as {"proj.<leaf>": t, "layers.<layer>.<leaf>": t}
    (the same tensors)."""
    return {**{f"proj.{k}": v for k, v in ip["proj"].items()},
            **{f"layers.{layer}.{k}": v for layer, kernels in ip["layers"].items()
               for k, v in kernels.items()}}


def nest_ip(flat: dict) -> dict:
    """The inverse of `flat_ip` (the same tensors); a nested tree is
    returned as it is."""
    if "proj" in flat and "layers" in flat:
        return flat
    out: dict = {"proj": {}, "layers": {}}
    for name, v in flat.items():
        top, rest = name.split(".", 1)
        if top == "proj":
            out["proj"][rest] = v
        else:
            layer, leaf = rest.rsplit(".", 1)
            out["layers"].setdefault(layer, {})[leaf] = v
    return out


def nest_layers(layers: dict) -> dict:
    """Checkpoint-flat {"attn_name/block_i/attn2": kernels} → the nested
    {"attn_name": {"block_i": kernels}} payload `UNetModel(ip=...)` routes."""
    nested: dict = {}
    for key, kernels in layers.items():
        parts = key.split("/")
        attn_name, block = parts[0], parts[1] if len(parts) > 2 else "block_0"
        nested.setdefault(attn_name, {})[block] = kernels
    return nested


def ip_apply_fn(unet: nn.Module, ip: dict, scale: float = 1.0) -> Callable:
    """The UNet apply with the adapter `ip`: `(x, t, ctx, ip_embed=None)`;
    with a [B, embed_dim] image embedding the image tokens go into every
    cross-attention the adapter lists, without one the plain UNet."""

    def apply(x, t, ctx, ip_embed=None, **kw):
        if ip_embed is None:
            return unet(x, t, ctx, **kw)
        payload = {"layers": nest_layers(ip["layers"]),
                   "tokens": project_image_embed(ip["proj"], ip_embed), "scale": scale}
        return unet(x, t, ctx, ip=payload, **kw)

    return apply
