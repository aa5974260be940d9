"""Fused GEGLU feed-forward: hand-written CUDA kernels and their plain
PyTorch version. `geglu_ff` launches `csrc/geglu_sm90.cu` (wgmma on a
TMA-resident token tile, weights streamed by TMA from their torch layout, the inner columns
split over a cluster where the token tiles leave the card short of a wave:
`geglu_plan`); `csrc/geglu.cu`, the `mma.sync` form, is its yardstick on the
card. `_geglu_split_ref` is a plain version that follows the Hopper kernel's
split of the inner columns and its order of sums.

Counterpart of `sd_tpu/kernels/geglu.py`. Weights are in torch Linear layout
(w1 [2I, C], w2 [C, I]; the TPU package's are the transposes); activations
keep the [..., C] layout of the TPU package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build
from sd_tpu_torch.kernels.flash_attention import H100_SMS

_KERNEL_WIDTHS = (128, 256, 320, 384, 512, 640)
# what `geglu_plan` reads of csrc/geglu_sm90.cu: 64 tokens a block, chunks of
# 64 inner columns, clusters of 1, 2 or 4 blocks, one block per SM
GEGLU_ROWS = 64
GEGLU_CHUNK = 64
GEGLU_SPLITS = (1, 2, 4)
# the C entry point of each source: the Hopper kernel `geglu_ff` launches,
# and geglu.cu's, the yardstick it is timed against
_GEGLU_ENTRY = {"sm90": ("geglu_sm90", "sd_geglu_fwd_sm90"),
                "template": ("geglu", "sd_geglu_fwd")}


def _geglu_xla(x, w1, b1, w2, b2):
    """Plain version with the kernel's numerics: fp32-accumulated products,
    exact (erf) gelu in fp32, the gated activation rounded to x's dtype."""
    dt = x.dtype
    h = F.linear(x.float(), w1.float()) + b1.float()
    inner = w1.shape[0] // 2
    a, g = h[..., :inner], h[..., inner:]
    y = (a * F.gelu(g)).to(dt)
    out = F.linear(y.float(), w2.float()) + b2.float()
    return out.to(dt)


def geglu_wants_pallas(n_tokens: int, c: int, inner: int,
                       dtype: torch.dtype = torch.bfloat16) -> bool:
    """The TPU gate's shape rule: many tokens, weights of at most 11 MB
    (the TPU kernel kept them whole in VMEM), and the kernel's dtype."""
    if dtype != torch.bfloat16:
        return False
    if n_tokens < 2048 or n_tokens % 256 != 0:
        return False
    weight_bytes = (c * 2 * inner + inner * c) * 2
    return inner % 128 == 0 and weight_bytes <= 11 * 1024 * 1024


class GegluPlan(NamedTuple):
    split: int     # blocks of a cluster that share one token tile's inner columns
    blocks: int    # blocks of the grid
    chunks: int    # chunks of 64 inner columns on the critical path of a block


def geglu_plan(n_tokens: int, c: int, inner: int) -> GegluPlan:
    """The Hopper kernel's grid at [n_tokens, c → inner], decided from the
    shape alone: the split of the inner columns over a cluster of 1, 2 or 4
    blocks with the shortest critical path, in waves of one block per SM
    times the chunks a block sums (the smaller split on a tie: fewer partials
    to add). Raises on a shape the kernel does not take."""
    if c not in _KERNEL_WIDTHS or inner < 32 or inner % 32 or n_tokens < 1:
        raise ValueError(f"geglu_ff: kernel takes C in {_KERNEL_WIDTHS}, inner % 32 == 0 "
                         f"and at least one token, got N={n_tokens}, C={c}, inner={inner}")
    tiles = -(-n_tokens // GEGLU_ROWS)
    n_ch = -(-inner // GEGLU_CHUNK)
    best = None
    for split in GEGLU_SPLITS:
        if split > n_ch:
            break
        plan = GegluPlan(split, tiles * split, -(-n_ch // split))
        if best is None or -(-plan.blocks // H100_SMS) * plan.chunks < \
                -(-best.blocks // H100_SMS) * best.chunks:
            best = plan
    return best


def _geglu_split_ref(x, w1, b1, w2, b2, split: int):
    """Plain version of the Hopper kernel's sums: the inner columns in chunks
    of 64, rank r of `split` taking chunks [r·n/split, (r+1)·n/split); each
    rank's fp32 partial of the second product, the partials added in rank
    order, then b2 in fp32 and one rounding. y is `_geglu_xla`'s."""
    dt = x.dtype
    inner = w1.shape[0] // 2
    h = F.linear(x.float(), w1.float()) + b1.float()
    y = (h[..., :inner] * F.gelu(h[..., inner:])).to(dt).float()
    n_ch = -(-inner // GEGLU_CHUNK)
    out = None
    for r in range(split):
        lo = r * n_ch // split * GEGLU_CHUNK
        hi = min((r + 1) * n_ch // split * GEGLU_CHUNK, inner)
        part = F.linear(y[..., lo:hi], w2[:, lo:hi].float())
        out = part if out is None else out + part
    return (out + b2.float()).to(dt)


def _launch_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, source: str = "sm90") -> torch.Tensor:
    """One launch of the fused feed-forward on `source` (see `_GEGLU_ENTRY`)."""
    C = x.shape[-1]
    inner = w1.shape[0] // 2
    if w1.shape != (2 * inner, C) or w2.shape != (C, inner) \
            or b1.shape != (2 * inner,) or b2.shape != (C,):
        raise ValueError("geglu_ff: weight shapes do not match x")
    xf = x.reshape(-1, C)
    plan = geglu_plan(xf.shape[0], C, inner)
    for t, name in ((x, "x"), (w1, "w1"), (b1, "b1"), (w2, "w2"), (b2, "b2")):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"geglu_ff: {name} must be contiguous, 16-byte aligned "
                             f"bfloat16 on {x.device}")
    out = torch.empty_like(xf)
    lib, symbol = _GEGLU_ENTRY[source]
    ptrs = [xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr()]
    ints = [xf.shape[0], C, inner]
    if source == "sm90":
        ints.append(plan.split)
    fn = _build.function(lib, symbol, [ctypes.c_void_p] * len(ptrs)
                         + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    with _build.on_device(x.device):
        code = fn(*ptrs, *ints, _build.stream_ptr(x.device))
    _build.check(code, symbol)
    return out.view(x.shape)


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused `(x@w1ᵀ+b1) → a·gelu(g) → @w2ᵀ+b2` over flattened tokens. On
    the card the Hopper kernel (`csrc/geglu_sm90.cu`), which takes C in
    `_KERNEL_WIDTHS`, inner % 32 == 0 and any number of tokens, and raises
    on anything else. Forward only: on the card an input that needs a
    gradient raises."""
    if not x.is_cuda:
        return _geglu_xla(x, w1, b1, w2, b2)
    kernels.refuse_grad("geglu_ff", x, w1, b1, w2, b2)
    out = _launch_geglu(x, w1, b1, w2, b2)
    kernels.LAUNCHES["geglu_ff"] += 1
    kernels.LAUNCHES["geglu_sm90"] += 1
    return out


def geglu_ff_trainable(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """`geglu_ff` for inference, the plain version (autograd's own forward
    and backward) when a gradient is wanted: the TPU package's
    `geglu_ff_trainable` (a custom VJP whose training forward is XLA's)."""
    if kernels.needs_grad(x, w1, b1, w2, b2):
        return _geglu_xla(x, w1, b1, w2, b2)
    return geglu_ff(x, w1, b1, w2, b2)
