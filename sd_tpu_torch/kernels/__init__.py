"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a tensor on the card and runs the
plain version for a tensor anywhere else. `LAUNCHES` counts kernel launches
per wrapper (a wrapper adds one where it launches, nowhere else), so a run
can show which kernels its main path went through. Where one wrapper runs
one of several sources, a route counter counts beside its own: the inference
flash forward's `flash_fwd_sm90`, `flash_fwd_sm90_pv8` and `flash_fwd_wide`,
and the training forward's `flash_lse_sm90` and `flash_lse_wide` (the LSE
epilogue of `flash_attention_sm90.cu` and `flash_attention_wide.cu`), with
`flash_lse_combine` for the second launch of a split kv sweep, and the
backward's `flash_bwd_dq_sm90` and `flash_bwd_dkv_sm90`
(`flash_attention_bwd_sm90.cu`, head dims up to 128) and
`flash_bwd_dq_wide_sm90` and `flash_bwd_dkv_wide_sm90`
(`flash_attention_bwd_wide_sm90.cu`, 129-512), and the GEGLU feed-forward's `geglu_sm90`
(`csrc/geglu_sm90.cu`) and the cross-attention's `crossattn_sm90`
(`csrc/cross_attention_sm90.cu`, one count per call of its three launches).
The pipelined sweep at head dims up to 128 counts under
`flash_fwd_sm90_pipe` (the `PIPE` kernel of `csrc/flash_attention_sm90.cu`)
and GroupNorm under `group_norm_sm90` (`csrc/groupnorm_sm90.cu`). The 3×3
conv (`conv3x3_same`) runs `csrc/conv2d_sm90.cu`, and the fused GroupNorm →
SiLU → 3×3 conv (`gn_silu_conv3x3`) `csrc/conv2d_gn_sm90.cu`, counted under
`gn_silu_conv_sm90` too.

Only flash attention has backward kernels (`flash_attention.py`, an
autograd Function). GEGLU, the 3×3 conv, GroupNorm and the fused
cross-attention are forward-only kernels: their `*_trainable` entry points
take the plain version when a gradient is wanted; the fused GroupNorm →
SiLU → 3×3 conv is an autograd Function whose backward recomputes the plain
version. The kernel wrappers themselves refuse, on the card, an input that
needs a gradient (`refuse_grad`), so no gradient is ever dropped.
"""

import torch

LAUNCHES: dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_exp_bf16": 0,
    "flash_attention_pv_int8": 0,
    "flash_attention_exp_bf16_pv_int8": 0,
    "flash_attention_pipelined": 0,
    "flash_attention_pipelined_exp_bf16": 0,
    "flash_attention_hpacked": 0,
    "flash_attention_hpacked_exp_bf16": 0,
    "flash_attention_hpacked_pv_int8": 0,
    "flash_attention_hpacked_exp_bf16_pv_int8": 0,
    "flash_attention_lse": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "geglu_ff": 0,
    "conv3x3_same": 0,
    "gn_silu_conv3x3": 0,
    "group_norm": 0,
    "crossattn_kv": 0,
    # route counters: inference flash launches served by flash_attention_sm90.cu,
    # flash_attention_sm90_pv8.cu and flash_attention_wide.cu (each also counts
    # under its wrapper's name above)
    "flash_fwd_sm90": 0,
    "flash_fwd_sm90_pipe": 0,
    "flash_fwd_sm90_pv8": 0,
    "flash_fwd_wide": 0,
    # ... and training-forward launches (`flash_attention_lse`) served by the
    # LSE epilogue of flash_attention_sm90.cu (head dims up to 128) and of
    # flash_attention_wide.cu (129-512)
    "flash_lse_sm90": 0,
    "flash_lse_wide": 0,
    # ... and the combine launch of a training forward whose kv sweep is split
    # (`flash_attention.lse_split`)
    "flash_lse_combine": 0,
    # ... and the backward's launches (`flash_bwd_dq`, `flash_bwd_dkv`) served
    # by flash_attention_bwd_sm90.cu (head dims up to 128) and by
    # flash_attention_bwd_wide_sm90.cu (129-512)
    "flash_bwd_dq_sm90": 0,
    "flash_bwd_dkv_sm90": 0,
    "flash_bwd_dq_wide_sm90": 0,
    "flash_bwd_dkv_wide_sm90": 0,
    # ... and the GEGLU feed-forward's (`geglu_ff`) and the cross-attention's
    # (`crossattn_kv`, one per call of its three launches) Hopper kernels,
    # geglu_sm90.cu and cross_attention_sm90.cu
    "geglu_sm90": 0,
    "crossattn_sm90": 0,
    # ... and GroupNorm's (`group_norm`) Hopper kernel, groupnorm_sm90.cu
    "group_norm_sm90": 0,
    # ... and the fused GroupNorm → SiLU → 3×3 conv's (`gn_silu_conv3x3`, one
    # per call of its launches), conv2d_gn_sm90.cu
    "gn_silu_conv_sm90": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a forward-only kernel would be handed an input that needs
    a gradient: its output would carry no autograd history, and backward
    would drop every gradient through it without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward and an input requires grad; "
            "call the differentiable entry point (or run under torch.no_grad())")
