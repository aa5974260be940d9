"""Checkpoints of a training state: save, restore in place, auto-resume, and
the small helpers of torch-checkpoint import.

Counterpart of `sd_tpu/train/checkpoint.py`, in the port's own torch
format (not Orbax: the port does not read the TPU package's checkpoints).
A checkpoint directory holds one file per step, `step_<N>.pt`: the state
as a nested dict of tensors and Python numbers (`state_tree`), written with
`torch.save` under a temporary name and moved into place with `os.replace`,
so a run killed while saving never leaves a half file that `latest_step`
would take. The newest `max_to_keep` are kept.

The tree keys are the TPU package's state fields: `params`, `opt_state`,
`ema` (`shadow`, `num_updates`, `decay`), `step` and `logvar` of a
`TrainState`; `params_g` (the autoencoder's parameters by name and
`logvar`), `params_d`, `batch_stats_d`, `opt_state_g`, `opt_state_d`,
`step` and `model_state` (the generator's buffers: the EMA codebook) of a
`GanTrainState`. An Adam state is {count, mu, nu}, its moments listed in
the order of the parameters they follow. Everything a bitwise resume needs
is there: the Adam counts, the EMA's update count, the running statistics
and the codebook buffers.

Files load with `torch.load(weights_only=True, mmap=True)` onto the CPU:
`restore_checkpoint` copies each mapped tensor into the live state in
place, so a restore never holds a second device copy of the state.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable

import torch

_FILE = re.compile(r"^step_(\d+)\.pt$")


def state_tree(state: Any) -> Any:
    """A training state (dataclasses, dicts, lists, tensors, numbers) as a
    nested dict of tensors and numbers: each dataclass becomes the dict of
    its fields."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: state_tree(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: state_tree(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [state_tree(v) for v in state]
    if torch.is_tensor(state):
        return state.detach()
    return state


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step)}.pt")


def all_steps(ckpt_dir: str) -> list[int]:
    """The steps saved under `ckpt_dir`, oldest first (temporary files are
    not steps)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: Any, step: int, max_to_keep: int = 3) -> str:
    """Write `state` as step `step` (temporary name, then an atomic rename)
    and drop all but the newest `max_to_keep` steps. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".step_{int(step)}.pt.tmp.{os.getpid()}")
    try:
        torch.save(state_tree(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in all_steps(ckpt_dir)[:-max_to_keep] if max_to_keep > 0 else []:
        os.remove(_path(ckpt_dir, old))
    return path


def restore_tree(ckpt_dir: str, step: int | None = None) -> dict:
    """The saved tree of `step` (default the latest) without a live state,
    memory-mapped on the CPU: the cross-run reader (a first stage out of a
    KL run, a UNet's EMA weights out of an LDM run)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True, mmap=True)


def trained_weights(tree: dict):
    """A run checkpoint's weights: the EMA shadow where it keeps one, else
    its parameters."""
    ema = tree.get("ema")
    return (ema["shadow"] if isinstance(ema, dict) and ema.get("shadow") is not None
            else tree["params"])


def _copy_into(live: Any, saved: Any, where: str) -> Any:
    """Copy `saved` into `live` in place where it holds tensors; returns
    the value the parent should hold (the saved number for numbers)."""
    if dataclasses.is_dataclass(live) and not isinstance(live, type):
        _check_keys([f.name for f in dataclasses.fields(live)], saved, where)
        for f in dataclasses.fields(live):
            setattr(live, f.name, _copy_into(getattr(live, f.name), saved[f.name],
                                             f"{where}.{f.name}"))
        return live
    if isinstance(live, dict):
        _check_keys(list(live), saved, where)
        for k in live:
            live[k] = _copy_into(live[k], saved[k], f"{where}[{k!r}]")
        return live
    if isinstance(live, list):
        if not isinstance(saved, list) or len(saved) != len(live):
            raise ValueError(f"checkpoint {where}: {len(live)} entries expected")
        for i, v in enumerate(live):
            live[i] = _copy_into(v, saved[i], f"{where}[{i}]")
        return live
    if torch.is_tensor(live):
        if not torch.is_tensor(saved) or saved.shape != live.shape or saved.dtype != live.dtype:
            raise ValueError(
                f"checkpoint {where}: {getattr(saved, 'dtype', type(saved))} "
                f"{tuple(getattr(saved, 'shape', ()))} cannot restore into {live.dtype} "
                f"{tuple(live.shape)} — wrong checkpoint for this config?")
        with torch.no_grad():
            live.copy_(saved)
        return live
    if live is None or saved is None:
        if live is not saved:
            raise ValueError(f"checkpoint {where}: {saved!r} cannot restore into {live!r}")
        return None
    return type(live)(saved)


def _check_keys(want: list, saved: Any, where: str) -> None:
    if not isinstance(saved, dict) or sorted(map(str, saved)) != sorted(map(str, want)):
        got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
        raise ValueError(f"checkpoint {where}: keys {got} != the state's {sorted(want)}")


def restore_checkpoint(ckpt_dir: str, state: Any, step: int | None = None) -> Any:
    """Restore step `step` (default the latest) INTO the live `state`, in
    place, tensor by tensor from the memory-mapped file. Returns `state`."""
    return _copy_into(state, restore_tree(ckpt_dir, step), "state")


def auto_resume(ckpt_dir: str, fresh_state: Callable[[], Any]) -> tuple[Any, int]:
    """(state, start step): the fresh state of `fresh_state()`, with the
    latest checkpoint under `ckpt_dir` copied into it when there is one."""
    step = latest_step(ckpt_dir)
    state = fresh_state()
    if step is None:
        return state, 0
    restore_checkpoint(ckpt_dir, state, step)
    print(f"[ckpt] resumed from {_path(ckpt_dir, step)}")
    return state, step


# -- torch-checkpoint import helpers ------------------------------------------------


def strip_prefix(state_dict: dict, prefix: str = "model.") -> dict:
    """Drop a leading module prefix from the keys."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()}


def filter_ignore_keys(state_dict: dict, ignore_keys: list[str]) -> dict:
    """Drop the keys that start with any of `ignore_keys`."""
    return {k: v for k, v in state_dict.items()
            if not any(k.startswith(ik) for ik in ignore_keys)}


def cast_tree(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The floating tensors of a nested dict / list cast to `dtype`."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, dtype) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def check_tree_health(tree: Any) -> dict[str, list[str]]:
    """NaN / Inf audit of a nested dict / list of tensors: {'nan': [paths],
    'inf': [paths]}, paths as `['params']['conv.weight']`."""
    bad = {"nan": [], "inf": []}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif torch.is_tensor(node) and node.is_floating_point():
            if bool(torch.isnan(node).any()):
                bad["nan"].append(path)
            if bool(torch.isinf(node).any()):
                bad["inf"].append(path)

    walk(tree, "")
    return bad
