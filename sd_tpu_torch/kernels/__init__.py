"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a tensor on the card and runs the
plain version for a tensor anywhere else. `LAUNCHES` counts kernel launches
per wrapper (a wrapper adds one where it launches, nowhere else), so a run
can show which kernels its main path went through.

Only flash attention has backward kernels (`flash_attention.py`, an
autograd Function). GEGLU and the 3×3 conv are forward-only kernels: their
`*_trainable` entry points take the plain version when a gradient is
wanted, and the kernel wrappers themselves refuse, on the card, an input
that needs a gradient (`refuse_grad`), so no gradient is ever dropped.
"""

import torch

LAUNCHES: dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_hpacked": 0,
    "flash_attention_lse": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "geglu_ff": 0,
    "conv3x3_same": 0,
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
