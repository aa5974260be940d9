"""Capture of softmax self-attention probabilities from chosen attention calls.

Counterpart of the self-attention half of `sd_tpu/nn/attn_probe.py`, the
probe under Self-Attention Guidance (`diffusion/sag.py`, arXiv:2210.00939):
inside `capture_self_attention(root, ...)`, every `CrossAttention`
self-attention call of `root` whose module path has a part containing
`path_substr`, at no more than `max_tokens` query tokens, takes the
explicit-logits path and records its probabilities [B, heads, N, N] (fp32,
from fp32 logits) under its path ("mid_attn/block_0/attn1"). Every other
attention keeps its kernel route. The context manager yields the record;
`collect_sown_probs` reads it and raises when nothing was captured, as the
TPU package's collector does for an empty `intermediates` collection (torch
has no `sow`). The cross-attention capture of the TPU package's attention
visualisation (`sd_tpu/utils/attn_viz.py`) is not ported.

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


@dataclasses.dataclass
class _Capture:
    path_substr: str
    max_tokens: int
    names: dict[int, str]               # id(module) → "a/b/attn1" under the root
    probs: dict[str, torch.Tensor]


_CAPTURE: contextvars.ContextVar[_Capture | None] = contextvars.ContextVar(
    "sd_tpu_torch_attn_capture", default=None)


@contextlib.contextmanager
def capture_self_attention(root: nn.Module, path_substr: str = "mid_attn",
                           max_tokens: int = 1024) -> Iterator[dict[str, torch.Tensor]]:
    """Capture the probabilities of `root`'s self-attention calls while in
    this context; yields {path: probs}."""
    names = {id(m): name.replace(".", "/") for name, m in root.named_modules() if name}
    cap = _Capture(path_substr, max_tokens, names, {})
    token = _CAPTURE.set(cap)
    try:
        yield cap.probs
    finally:
        _CAPTURE.reset(token)


def wants_capture(module: nn.Module, n_tokens: int) -> str | None:
    """The path under which `module`'s self-attention call at `n_tokens`
    query tokens records its probabilities, or None when it is not
    captured."""
    cap = _CAPTURE.get()
    if cap is None:
        return None
    path = cap.names.get(id(module))
    if path is None or n_tokens > cap.max_tokens:
        return None
    return path if any(cap.path_substr in p for p in path.split("/")) else None


def record(path: str, probs: torch.Tensor) -> None:
    """Keep the first probabilities a captured call gives (`sow` keeps every
    call's in order; the collector reads the first)."""
    _CAPTURE.get().probs.setdefault(path, probs)


def collect_sown_probs(probs: dict[str, torch.Tensor], path_substr: str = "mid_attn"):
    """The first (path-sorted) captured array whose path has a part
    containing `path_substr`; raises if none was captured."""
    hits = sorted(path for path in probs
                  if any(path_substr in part for part in path.split("/")))
    if not hits:
        raise ValueError(f"no captured attention probabilities under a path containing "
                         f"{path_substr!r} — was the model called inside "
                         "capture_self_attention(model, ...)?")
    return probs[hits[0]]
