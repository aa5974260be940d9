"""Numerics debugging: NaN tracing and health checks.

Counterpart of `sd_tpu/utils/debug.py`:
  * `enable_nan_debugging` is `jax_debug_nans`: a global switch after which
    the first operator that makes a NaN from inputs that hold none raises,
    naming the operator — in the forward through a `TorchDispatchMode`
    (every ATen operator, on any device), in the backward through
    `torch.autograd.set_detect_anomaly`, which names the forward operator
    whose gradient went NaN;
  * `nan_check(fn)` is checkify's `float_checks`: the wrapped fn returns
    (err, out); `err.throw()` raises for the first operator whose output
    holds a NaN, or that divided by zero (a division or remainder whose
    divisor has a zero, whatever its dtype), and `err.get()` gives the
    message or None. The flags stay on the device until they are read;
  * `tree_finite_summary` counts NaN and Inf over a nest of tensors on
    their device.
A hand-written kernel is called through pointers, not as an ATen operator:
its output is checked where the next operator reads it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DIVISIONS = ("div", "div_", "remainder", "remainder_", "fmod", "fmod_",
              "floor_divide", "floor_divide_")


def _floating(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def _any_nan(tensors: list[torch.Tensor]) -> torch.Tensor | None:
    flags = [torch.isnan(t).any().to(tensors[0].device) for t in tensors]
    return torch.stack(flags).any() if flags else None


class _NanRaise(TorchDispatchMode):
    """Raises at the first operator whose floating output holds a NaN while
    its floating inputs hold none."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        made = _any_nan(_floating(out))
        if made is not None and bool(made):
            had = _any_nan(_floating((args, kwargs)))
            if had is None or not bool(had):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


_DEBUG: list[_NanRaise] = []


def enable_nan_debugging(enable: bool = True) -> None:
    """Global NaN tracing, forward and backward: the first operator that
    makes a NaN raises FloatingPointError naming it (`jax_debug_nans`)."""
    torch.autograd.set_detect_anomaly(enable)
    if enable and not _DEBUG:
        mode = _NanRaise()
        mode.__enter__()
        _DEBUG.append(mode)
    elif not enable and _DEBUG:
        _DEBUG.pop().__exit__(None, None, None)


class FloatError:
    """The first float error a `nan_check`-wrapped call met: `get()` its
    message or None, `throw()` raises it."""

    def __init__(self, found: list[tuple[str, torch.Tensor]]):
        self._found = found

    def get(self) -> str | None:
        for what, flag in self._found:
            if bool(flag):
                return what
        return None

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


class _FloatChecks(TorchDispatchMode):
    """Records, per operator, a device flag for a NaN in its floating output
    and, for a division, a zero in its divisor."""

    def __init__(self):
        super().__init__()
        self.found: list[tuple[str, torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _DIVISIONS and len(args) > 1:
            divisor = args[1]
            zero = (divisor == 0).any() if isinstance(divisor, torch.Tensor) else \
                torch.tensor(divisor == 0)
            self.found.append((f"division by zero in {func}", zero))
        out = func(*args, **(kwargs or {}))
        made = _any_nan(_floating(out))
        if made is not None:
            self.found.append((f"nan generated by primitive: {func}", made))
        return out


def nan_check(fn: Callable) -> Callable:
    """`fn` wrapped to return (err, out): `err` holds the first NaN an
    operator made or the first division by zero (checkify's `float_checks`)."""

    def checked(*args, **kwargs) -> tuple[FloatError, Any]:
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        return FloatError(mode.found), out

    return checked


def tree_finite_summary(tree) -> dict:
    """{'finite': bool, 'num_nan': int, 'num_inf': int} over the floating
    tensors of a nest of dicts, lists and tuples, the counts reduced on the
    first tensor's device (0-dim tensors there)."""
    leaves = _floating(tree)
    if not leaves:
        return {"finite": True, "num_nan": 0, "num_inf": 0}
    dev = leaves[0].device
    num_nan = sum(torch.isnan(x).sum().to(dev) for x in leaves)
    num_inf = sum(torch.isinf(x).sum().to(dev) for x in leaves)
    return {"finite": (num_nan + num_inf) == 0, "num_nan": num_nan, "num_inf": num_inf}
