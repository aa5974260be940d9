"""Prompt attention weighting: the `(emphasis:1.3)` / `[de-emphasis]`
syntax (copy of `sd_tpu/utils/prompt_weights.py`, host-side numpy, with the
weight application in PyTorch).

Grammar (the community convention):
  * `(text)`      — weight ×1.1 (nesting multiplies: `((x))` = 1.21)
  * `(text:1.3)`  — explicit weight for the parenthesized span
  * `[text]`      — weight ×1/1.1 (nesting divides)
  * `\\(` `\\)` `\\[` `\\]` `\\\\` — literal characters
  * everything else — weight 1.0

`parse_weighted_prompt` gives [(fragment, weight)] with adjacent equal-weight
fragments merged; `tokenize_weighted` tokenizes the fragments chunk-wise and
aligns a weight with every id; `apply_prompt_weights` scales each token's
output embedding by its weight and rescales the sequence to its unweighted
mean (all-ones weights are an exact no-op).
"""

from __future__ import annotations

import numpy as np
import torch


def _num_end(text: str, start: int) -> int | None:
    """If text[start:] begins with a number immediately followed by ')',
    return the index of that ')'; else None."""
    j = start
    n = len(text)
    while j < n and (text[j].isdigit() or text[j] in ".+-"):
        j += 1
    if j > start and j < n and text[j] == ")":
        try:
            float(text[start:j])
        except ValueError:
            return None
        return j
    return None


def parse_weighted_prompt(text: str) -> list[tuple[str, float]]:
    """Parse emphasis syntax → [(fragment, weight)], in order, with
    adjacent equal-weight fragments merged. Unbalanced brackets keep the
    weight they applied (matching frontend behavior)."""
    out: list[tuple[str, float]] = []
    # stack entries: (bracket char, provisional multiplier, index into
    # `out` where the span began — for retroactive explicit weights)
    stack: list[tuple[str, float, int]] = []
    cur: list[str] = []
    weight = 1.0

    def flush():
        nonlocal cur
        if cur:
            frag = "".join(cur)
            if out and abs(out[-1][1] - weight) < 1e-12:
                out[-1] = (out[-1][0] + frag, weight)
            else:
                out.append((frag, weight))
            cur = []

    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "\\" and i + 1 < n and text[i + 1] in "()[]\\":
            cur.append(text[i + 1])
            i += 2
        elif ch in "([":
            flush()
            mult = 1.1 if ch == "(" else 1.0 / 1.1
            stack.append((ch, mult, len(out)))
            weight *= mult
            i += 1
        elif (ch == ":" and stack and stack[-1][0] == "("
              and _num_end(text, i + 1) is not None):
            j = _num_end(text, i + 1)
            w = float(text[i + 1:j])
            flush()
            _, mult, start = stack.pop()
            # fragments in this span carried ×1.1 provisionally → ×w instead
            for idx in range(start, len(out)):
                f, fw = out[idx]
                out[idx] = (f, fw / mult * w)
            weight /= mult
            i = j + 1  # consume through ')'
        elif ch == ")" and stack and stack[-1][0] == "(":
            flush()
            _, mult, _ = stack.pop()
            weight /= mult
            i += 1
        elif ch == "]" and stack and stack[-1][0] == "[":
            flush()
            _, mult, _ = stack.pop()
            weight /= mult
            i += 1
        else:
            cur.append(ch)
            i += 1
    flush()
    if not out:
        out.append(("", 1.0))
    return out


def tokenize_weighted(
    texts: list[str],
    encode_chunk,
    max_length: int,
    bos_id: int,
    eos_id: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Parse + tokenize each prompt chunk-wise → (ids [B,L] int32,
    weights [B,L] float32). `encode_chunk(str) -> list[int]` must tokenize
    WITHOUT special tokens. BOS/EOS/pad positions get weight 1.0."""
    B = len(texts)
    ids = np.full((B, max_length), eos_id, np.int32)
    wts = np.ones((B, max_length), np.float32)
    for b, text in enumerate(texts):
        toks: list[int] = [bos_id]
        ws: list[float] = [1.0]
        for frag, w in parse_weighted_prompt(text):
            for t in encode_chunk(frag):
                toks.append(int(t))
                ws.append(float(w))
        toks = toks[: max_length - 1] + [eos_id]
        ws = ws[: max_length - 1] + [1.0]
        ids[b, : len(toks)] = toks
        wts[b, : len(ws)] = ws
    return ids, wts


def apply_prompt_weights(emb: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Scale token embeddings [B, L, C] by their weights [B, L], keeping each
    sequence's mean activation."""
    orig_mean = emb.mean(dim=(-2, -1), keepdim=True)
    out = emb * weights[..., None].to(emb.dtype)
    new_mean = out.mean(dim=(-2, -1), keepdim=True)
    ratio = torch.where(new_mean == 0, torch.ones_like(new_mean), orig_mean / new_mean)
    return out * ratio.to(emb.dtype)
