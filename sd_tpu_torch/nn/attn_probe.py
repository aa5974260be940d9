"""Capture of softmax attention probabilities from chosen attention calls.

Counterpart of `sd_tpu/nn/attn_probe.py`: inside `capture_attention(root,
path_substr, max_tokens, kind)`, every `CrossAttention` call of `root` of
the chosen kind — "self" (no context: the probe under Self-Attention
Guidance, `diffusion/sag.py`, arXiv:2210.00939), "cross" (a text context:
the token heatmaps of `utils/attn_viz.py`) or "any" — whose module path has
a part containing `path_substr` (the empty string matches every path), at
no more than `max_tokens` query tokens, takes the explicit-logits path and
records its probabilities [B, heads, N, M] (fp32, from fp32 logits) under
its path ("mid_attn/block_0/attn1", the TPU package's sown path). Every
other attention keeps its kernel route. The context manager yields the
record; `collect_all_sown_probs` reads every matching entry and
`collect_sown_probs` the first, raising when nothing was captured, as the
TPU package's collector does for an empty `intermediates` collection (torch
has no `sow`). `capture_self_attention` is the "self" capture.

The switch is a ContextVar, so concurrent callers in other threads do not
see one another's capture.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

import torch
from torch import nn

KINDS = ("self", "cross", "any")


@dataclasses.dataclass
class _Capture:
    path_substr: str
    max_tokens: int
    kind: str
    names: dict[int, str]               # id(module) → "a/b/attn1" under the root
    probs: dict[str, torch.Tensor]


_CAPTURE: contextvars.ContextVar[_Capture | None] = contextvars.ContextVar(
    "sd_tpu_torch_attn_capture", default=None)


@contextlib.contextmanager
def capture_attention(root: nn.Module, path_substr: str = "mid_attn",
                      max_tokens: int = 1024,
                      kind: str = "self") -> Iterator[dict[str, torch.Tensor]]:
    """Capture the probabilities of `root`'s attention calls of `kind`
    ("self", "cross" or "any") while in this context; yields {path: probs}."""
    if kind not in KINDS:
        raise ValueError(f"kind must be self/cross/any, got {kind!r}")
    names = {id(m): name.replace(".", "/") for name, m in root.named_modules() if name}
    cap = _Capture(path_substr, max_tokens, kind, names, {})
    token = _CAPTURE.set(cap)
    try:
        yield cap.probs
    finally:
        _CAPTURE.reset(token)


def capture_self_attention(root: nn.Module, path_substr: str = "mid_attn",
                           max_tokens: int = 1024):
    """Self-attention capture (the SAG probe, diffusion/sag.py)."""
    return capture_attention(root, path_substr, max_tokens, "self")


def wants_capture(module: nn.Module, n_tokens: int, is_self: bool = True) -> str | None:
    """The path under which `module`'s attention call (self-attention, or
    cross-attention with `is_self` False) at `n_tokens` query tokens
    records its probabilities, or None when it is not captured."""
    cap = _CAPTURE.get()
    if cap is None or (cap.kind == "self" and not is_self) or (cap.kind == "cross" and is_self):
        return None
    path = cap.names.get(id(module))
    if path is None or n_tokens > cap.max_tokens:
        return None
    return path if any(cap.path_substr in p for p in path.split("/")) else None


def record(path: str, probs: torch.Tensor) -> None:
    """Keep the first probabilities a captured call gives (`sow` keeps every
    call's in order; the collector reads the first)."""
    _CAPTURE.get().probs.setdefault(path, probs)


def collect_all_sown_probs(probs: dict[str, torch.Tensor],
                           path_substr: str = "") -> dict[str, torch.Tensor]:
    """Every captured array whose path has a part containing `path_substr`
    (empty: all of them), by path."""
    return {path: p for path, p in probs.items()
            if not path_substr or any(path_substr in part for part in path.split("/"))}


def collect_sown_probs(probs: dict[str, torch.Tensor], path_substr: str = "mid_attn"):
    """The first (path-sorted) captured array whose path has a part
    containing `path_substr`; raises if none was captured."""
    hits = collect_all_sown_probs(probs, path_substr)
    if not hits:
        raise ValueError(f"no captured attention probabilities under a path containing "
                         f"{path_substr!r} — was the model called inside "
                         "capture_attention(model, ...)?")
    return hits[min(hits)]
