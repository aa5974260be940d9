"""Process-group bring-up and the per-process data rules.

Counterpart of `sd_tpu/parallel/multihost.py`. Where the TPU package runs
one process per host that sees all of its chips, the port runs one process
per rank (a GPU, or a CPU rank under gloo) and joins them in a
`torch.distributed` process group:

  1. bring-up: `initialize()` reads what torchrun sets (`MASTER_ADDR`,
     `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`)
     or takes the same values as arguments, and is a no-op returning False
     when nothing says "multi-process", so one script runs everywhere;
  2. data: `process_local_batch` is the divisibility rule, and
     `node_index` / `node_count` are the hosts over which a run's batches go
     round-robin (`data/loader.py DataLoader(rank=, world=)`, the TPU
     package's rule with a process being a host); within a host the ranks
     split each batch by rows (`parallel/mesh.py local_rows`);
  3. `host_local_to_global`: a rank's rows as its `Shard(0)` piece of one
     global tensor (a DTensor over the mesh's data axis).

The backend is NCCL on the card and gloo when the caller asks for the CPU.
An explicit `backend="gloo"` with `device="cuda:0"` puts several ranks on
one card (NCCL refuses two ranks on one device); gloo carries `all_reduce`
and `broadcast` of CUDA tensors, which is what the data-parallel step and
the tensor-parallel forward need. The rank's device is the one named, else
`cuda:<LOCAL_RANK>`; it is never chosen modulo the device count.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_STATE: dict[str, Any] = {"device": None, "local_world": 1}


def initialize(backend: str | None = None, device: str | torch.device | None = None, *,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None, local_rank: int | None = None,
               local_world_size: int | None = None) -> bool:
    """Join the process group. Returns True when a group is (or already
    was) up, False for the single-process no-op: no `WORLD_SIZE` in the
    environment and none given.

    `backend`: "nccl" or "gloo"; default NCCL unless `device` is the CPU.
    `device`: the rank's device; default `cuda:<local rank>` (raises when
    that card does not exist, whatever the backend); the CPU only when the
    caller passes `device="cpu"`.
    `init_method` default `env://` (`MASTER_ADDR` / `MASTER_PORT`)."""
    env = os.environ
    if dist.is_initialized():
        return True
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if world_size is None:
        return False
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world {world_size}")
    dev = torch.device("cuda", local_rank) if device is None else torch.device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (and backend='gloo') "
                               "to run the process group on the CPU")
        index = dev.index if dev.index is not None else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants cuda:{index} but this host has "
                               f"{torch.cuda.device_count()} card(s): launch at most that "
                               "many ranks per host, or name the device")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device; use backend='gloo' on the CPU")
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    _STATE.update(device=dev, local_world=local_world_size)
    return True


def local_device() -> torch.device | None:
    """The device `initialize` gave this rank (None before it ran)."""
    return _STATE["device"]


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def node_count() -> int:
    """The hosts of the group: world size / ranks per host."""
    _, w = rank_and_world()
    return max(1, w // _STATE["local_world"])


def node_index() -> int:
    """This rank's host: rank // ranks per host (torchrun numbers the ranks
    host by host)."""
    r, _ = rank_and_world()
    return r // _STATE["local_world"]


def process_local_batch(global_batch_size: int, world: int | None = None) -> int:
    """Per-process batch size; the global one must divide evenly (anything
    else silently changes the effective LR and batch statistics)."""
    world = rank_and_world()[1] if world is None else world
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{world} processes")
    return global_batch_size // world


def host_local_to_global(batch: Any, mesh, axis: str = "data") -> Any:
    """Each tensor (or array) of `batch`, this rank's rows, as its `Shard(0)`
    piece of one DTensor over the mesh's `axis`: the global tensor has the
    rows of every rank of that axis, in rank order."""
    from torch.distributed.tensor import DTensor, Shard

    sub = mesh.device_mesh()[axis]

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return DTensor.from_local(t, sub, [Shard(0)], run_check=False)

    return put(batch)
