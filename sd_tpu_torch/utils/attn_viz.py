"""Cross-attention token heatmaps: where the UNet looks for each prompt token.

Counterpart of `sd_tpu/utils/attn_viz.py`: `cross_attention_maps` runs one
UNet forward under the cross-attention capture of `nn/attn_probe.py` and
returns every matching map; `token_heatmaps` averages each map over heads,
puts it on its own grid (the stride-2 halving of the latent grid, rounding
up, with that many tokens), resizes it bilinearly to the output size as
`jax.image.resize(..., "bilinear")` does (half-pixel centres, the triangle
kernel renormalised at the edges: `models/conditioners.py float_resize`),
averages the maps and min-max scales each token's map per image;
`overlay_heatmap_grid` draws one red-overlay tile per token (uint8,
truncated). The DAAM / prompt-to-prompt diagnostic (arXiv:2210.04885).

Every attention that is not captured keeps its kernel route.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sd_tpu_torch.models.conditioners import float_resize
from sd_tpu_torch.nn.attn_probe import capture_attention, collect_all_sown_probs


@torch.no_grad()
def cross_attention_maps(unet: torch.nn.Module, x: torch.Tensor, t: torch.Tensor,
                         ctx: torch.Tensor, path_substr: str = "",
                         max_tokens: int = 4096) -> dict[str, torch.Tensor]:
    """One UNet forward on the noised latent x [B, H, W, C] at timesteps t
    [B] under the text embedding ctx [B, M, Cc], capturing every
    cross-attention map whose path matches `path_substr` ("" for every
    block): {module path: probs [B, heads, N_spatial, M]}, raw softmax rows
    (each sums to 1 over the text axis)."""
    with capture_attention(unet, path_substr, max_tokens=max_tokens, kind="cross") as probs:
        unet(x, t, ctx)
    return collect_all_sown_probs(probs, path_substr)


def token_heatmaps(maps: dict[str, torch.Tensor], latent_hw: tuple[int, int],
                   out_hw: tuple[int, int] | None = None,
                   normalize: bool = True) -> np.ndarray:
    """Per-token heatmaps [B, out_h, out_w, M] float32 (`out_hw` defaults to
    `latent_hw`) from captured maps [B, heads, N, M]: each head-averaged,
    reshaped to its own grid, resized bilinearly and averaged over the maps
    (a map on no grid of the latent is skipped); with `normalize`, each
    token's map min-max scaled to [0, 1] per image."""
    lh, lw = latent_hw
    out_hw = out_hw or (lh, lw)
    acc, count = None, 0
    for probs in maps.values():
        B, _, N, M = probs.shape
        hw = _grid_for(N, lh, lw)
        if hw is None:
            continue
        hm = probs.float().mean(dim=1).reshape(B, hw[0], hw[1], M)
        hm = float_resize(hm, out_hw[0], out_hw[1], "bilinear")
        acc = hm if acc is None else acc + hm
        count += 1
    if acc is None:
        raise ValueError("no captured map matches the latent grid — was "
                         "cross_attention_maps run on this latent size?")
    out = (acc / count).cpu().numpy().astype(np.float32)
    if normalize:
        lo = out.min(axis=(1, 2), keepdims=True)
        hi = out.max(axis=(1, 2), keepdims=True)
        out = (out - lo) / np.maximum(hi - lo, 1e-8)
    return out


def _grid_for(n_tokens: int, lh: int, lw: int) -> tuple[int, int] | None:
    """The (h, w) stride-2 downsampling of (lh, lw) with n_tokens tokens."""
    h, w = lh, lw
    while h * w >= n_tokens:
        if h * w == n_tokens:
            return (h, w)
        h, w = -(-h // 2), -(-w // 2)
    return None


def overlay_heatmap_grid(image: np.ndarray, heatmaps: np.ndarray,
                         token_labels: Sequence[str] | None = None,
                         alpha: float = 0.6) -> np.ndarray:
    """Per-token red-overlay tiles of image [H, W, 3] uint8 under heatmaps
    [h, w, M] in [0, 1], side by side: [H, W·M, 3] uint8 (labels are the
    caller's caption; `train/metrics.py log_txt_as_img` renders text)."""
    H, W = image.shape[:2]
    M = heatmaps.shape[-1]
    hm = float_resize(torch.from_numpy(np.asarray(heatmaps, np.float32))[None], H, W,
                      "bilinear")[0].numpy()
    base = image.astype(np.float32)
    red = np.zeros_like(base)
    red[..., 0] = 255.0
    tiles = []
    for m in range(M):
        a = (alpha * hm[..., m:m + 1]).clip(0.0, 1.0)
        tiles.append((base * (1 - a) + red * a).astype(np.uint8))
    return np.concatenate(tiles, axis=1)
