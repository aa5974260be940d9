"""Rematerialization (gradient checkpointing) policies.

Counterpart of `sd_tpu/train/remat.py`, through `torch.utils.checkpoint`
(non-reentrant):
  * "none"    — no remat;
  * "nothing" — save nothing, recompute the whole function in backward;
  * "dots"    — keep the outputs of the weight products (mm / addmm /
                convolution) and recompute the rest, the counterpart of
                `dots_with_no_batch_dims_saveable` (the batched attention
                products are recomputed).
The recompute runs in the training context (`training_trace`) of the
forward, whichever thread autograd runs it on.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from sd_tpu_torch.kernels import conv2d

_SAVED_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.convolution.default,
})

POLICIES = ("none", "dots", "nothing")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _stacked(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def remat_apply(apply_fn: Callable, policy: str = "dots") -> Callable:
    """Wrap `apply_fn` so its backward recomputes activations."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}: one of {POLICIES}")
    if policy == "none":
        return apply_fn

    def context_fn():
        training = conv2d._TRAIN_CTX_VAR.get()
        train_ctx = conv2d.training_trace if training else contextlib.nullcontext
        if policy == "nothing":
            return contextlib.nullcontext(), train_ctx()
        fwd, recompute = create_selective_checkpoint_contexts(_dots_policy)
        return fwd, _stacked(recompute, train_ctx())

    @functools.wraps(apply_fn)
    def wrapped(*args, **kwargs):
        return checkpoint(apply_fn, *args, use_reentrant=False, context_fn=context_fn,
                          **kwargs)

    return wrapped
