"""The mask-conditioned inpainting model's conditioning.

Counterpart of `sd_tpu/train/inpaint.py` `mask_to_latent` and
`inpaint_concat_cond` (the SD-inpainting layout: the UNet sees
[z_t | hole mask↓ | E(x·(1 − hole))], `conditioning_key: hybrid`). The
trainer (`train_inpaint`, the synthetic mask menu) is not ported yet.
"""

from __future__ import annotations

import torch


def _nearest_rows(n_in: int, n_out: int, device) -> torch.Tensor:
    # jax.image.resize's "nearest": source ⌊(i + ½)·in/out⌋, computed in fp32
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def mask_to_latent(mask: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    """A pixel hole mask [B, H, W, 1] nearest-downsampled to the latent grid
    by the TPU package's rule (half-pixel centres, not
    `F.interpolate(mode="nearest")`'s ⌊i·in/out⌋)."""
    if mask.shape[1] == lh and mask.shape[2] == lw:
        return mask
    rows = _nearest_rows(mask.shape[1], lh, mask.device)
    cols = _nearest_rows(mask.shape[2], lw, mask.device)
    return mask[:, rows][:, :, cols]


def inpaint_concat_cond(ld, image: torch.Tensor, mask: torch.Tensor, lh: int, lw: int,
                        noise: torch.Tensor | None = None,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """[mask↓ | E(x·(1 − mask))·scale] [B, lh, lw, 1 + z] for the pixel hole
    mask [B, H, W, 1] (1 = hole): the masked image's posterior sample
    (`noise`, else drawn from `generator`) in fp32."""
    masked = image * (1.0 - mask)
    mz = ld.get_first_stage_encoding(ld.encode_first_stage(masked, noise, generator).float())
    return torch.cat([mask_to_latent(mask, lh, lw).to(mz.dtype), mz], dim=-1)
