"""Self-Attention Guidance (SAG, arXiv:2210.00939), a parameter-free
sample-quality knob.

Counterpart of `sd_tpu/diffusion/sag.py`. Each DDIM step
(`DDIMSampler.p_sample_ddim_sag`): read the mid-block self-attention map
captured by `nn/attn_probe.py`, build a per-token salience mask, Gaussian-
blur the ε-implied x̂₀ inside it, re-noise it to t with the same ε, run one
extra forward on the degraded input, and guide away from it:

    ε* = ε + s_sag · (ε − ε(x̃_t degraded))

with classifier-free guidance the SAG term rides the unconditional branch.
The mask is a threshold on the probabilities' column mass, computed in fp32
from fp32 logits, as in the TPU package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from sd_tpu_torch.nn.attn_probe import capture_self_attention, collect_sown_probs

# the degradation's Gaussian blur: the TPU package's defaults, which no
# caller of the pipeline changes
BLUR_KERNEL = 9
BLUR_SIGMA = 1.0


def gaussian_blur_2d(x: torch.Tensor, kernel_size: int = 9,
                     sigma: float = 1.0) -> torch.Tensor:
    """Separable depthwise Gaussian blur of x [B, H, W, C] (SAME, zero
    padding) in fp32, returned in x's dtype."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    half = kernel_size // 2
    pts = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k1 = torch.exp(-(pts ** 2) / (2.0 * sigma * sigma))
    k1 = k1 / k1.sum()
    C = x.shape[-1]
    y = x.float().permute(0, 3, 1, 2)
    y = F.conv2d(y, k1.reshape(1, 1, kernel_size, 1).expand(C, 1, kernel_size, 1),
                 padding=(half, 0), groups=C)
    y = F.conv2d(y, k1.reshape(1, 1, 1, kernel_size).expand(C, 1, 1, kernel_size),
                 padding=(0, half), groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def sag_mask_from_probs(probs: torch.Tensor, hm: int, wm: int) -> torch.Tensor:
    """Salience mask [B, hm, wm, 1] in {0, 1} from a self-attention map [B,
    h, N, N] over N = hm·wm tokens: a token is salient where its column
    mass, averaged over heads and summed over queries, exceeds 1.0 (the
    uniform-attention level)."""
    B, _, _, n_k = probs.shape
    if n_k != hm * wm:
        raise ValueError(f"probs cover {n_k} tokens, expected {hm}x{wm}")
    col_mass = probs.float().mean(dim=1).sum(dim=1)
    return (col_mass > 1.0).float().reshape(B, hm, wm, 1)


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")`'s source index of each output
    position: floor((i + 0.5)·n_in / n_out), in fp32 as JAX computes it."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return pos.floor().long()


def make_probs_apply(unet, path_substr: str = "mid_attn") -> Callable:
    """`apply(x, t, ctx, **kw) -> (out, sag_mask)` of a UNet: its output and
    the mid-block salience mask resized (nearest) to the input's grid, [B,
    H, W, 1] fp32 in {0, 1}. The mid-block grid is the input's after
    `len(channel_mult) - 1` stride-2 downsamples (ceil division at odd
    sizes, as the convs pad)."""
    n_down = len(unet.channel_mult) - 1

    def apply_probs(x, t, ctx, **kw):
        B, H, W = x.shape[:3]
        hm, wm = H, W
        for _ in range(n_down):
            hm, wm = -(-hm // 2), -(-wm // 2)
        with capture_self_attention(unet, path_substr, max_tokens=hm * wm) as probs:
            out = unet(x, t, ctx, **kw)
        mask = sag_mask_from_probs(collect_sown_probs(probs, path_substr), hm, wm)
        mask = mask[:, _nearest_index(H, hm, mask.device)][:, :, _nearest_index(W, wm, mask.device)]
        return out, mask

    return apply_probs


def degrade_pred_x0(pred_x0: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """pred_x0 blurred where the salience mask is set (the SAG degradation)."""
    blurred = gaussian_blur_2d(pred_x0, BLUR_KERNEL, BLUR_SIGMA)
    m = mask.to(pred_x0.dtype)
    return blurred * m + pred_x0 * (1.0 - m)
