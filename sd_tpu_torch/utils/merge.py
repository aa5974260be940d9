"""Checkpoint merging: weighted-sum and add-difference merges of flat SD
state dicts (what `models/sd_import.py load_sd_checkpoint` returns for
`.ckpt` and `.safetensors` alike).

Counterpart of `sd_tpu/utils/merge.py`:

    sd, skipped = merge_checkpoints(load_sd_checkpoint(a), load_sd_checkpoint(b),
                                    alpha=0.3)
    save_sd_checkpoint("merged.safetensors", sd)

Modes:
  * weighted:        out = (1-α)·A + α·B
  * add_difference:  out = A + α·(B - C)   (B's fine-tune, measured
                     against its base C, moved onto A)

Keys missing from B (or C) pass through from A and are listed; a shape
mismatch raises. The merge runs in fp32 and returns A's dtype.
"""

from __future__ import annotations

from typing import Mapping

import torch


def merge_checkpoints(a: Mapping[str, torch.Tensor], b: Mapping[str, torch.Tensor],
                      alpha: float = 0.5, c: Mapping[str, torch.Tensor] | None = None,
                      mode: str = "weighted") -> tuple[dict, list[str]]:
    """Merge state dicts. Returns (merged, skipped_keys)."""
    if mode not in ("weighted", "add_difference"):
        raise ValueError(f"unknown merge mode {mode!r}")
    if mode == "add_difference" and c is None:
        raise ValueError("add_difference needs the base checkpoint c")
    out: dict = {}
    skipped: list[str] = []
    for k, va in a.items():
        va = torch.as_tensor(va)
        vb = b.get(k)
        if vb is None or (mode == "add_difference" and k not in c):
            out[k] = va
            skipped.append(k)
            continue
        vb = torch.as_tensor(vb)
        if vb.shape != va.shape:
            raise ValueError(f"{k}: shape mismatch {tuple(va.shape)} vs {tuple(vb.shape)}")
        fa, fb = va.float(), vb.float()
        if mode == "weighted":
            m = (1.0 - alpha) * fa + alpha * fb
        else:
            fc = torch.as_tensor(c[k]).float()
            if fc.shape != va.shape:
                raise ValueError(f"{k}: base shape mismatch {tuple(va.shape)} vs "
                                 f"{tuple(fc.shape)}")
            m = fa + alpha * (fb - fc)
        out[k] = m.to(va.dtype)
    return out, skipped
