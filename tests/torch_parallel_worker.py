"""One rank of the parallel-layer tests' process groups (gloo on the CPU).

`tests/test_torch_parallel.py` and `tests/test_torch_parallel_serve.py`
start `world` copies of this script, each with the rank variables torchrun
would set (`RANK`, `WORLD_SIZE`, ...) and a file store to meet through
(`PARALLEL_TEST_STORE`), and read back what each rank wrote:

    python tests/torch_parallel_worker.py <case> <directory>

The case reads its inputs from `<directory>/inputs.pt` (written by the test)
and writes `<directory>/<case>.rank<r>.pt`. The script imports the port and
torch only (no JAX), so a rank starts in a few seconds.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from sd_tpu_torch.parallel import mesh as pm
from sd_tpu_torch.parallel import multihost
from sd_tpu_torch.train.diffusion import ddpm_optimizer, init_train_state

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def dense_loss(batch, generator, logvar):
    """The JAX package's ZeRO / FSDP test loss over {dense, to_q}."""
    p = DENSE
    out = torch.tanh(batch @ p["dense.weight"].t() + p["dense.bias"])
    return (out ** 2).mean() + (p["to_q.weight"] ** 2).mean(), {}


DENSE: dict = {}


def dense_step(inputs: dict, mesh, mode: str) -> dict:
    """One ZeRO / FSDP step of the dense model on this rank's rows."""
    DENSE.clear()
    DENSE.update({k: v.clone() for k, v in inputs["dense"].items()})
    opt = ddpm_optimizer(1e-2)
    state = init_train_state(DENSE, opt, ema_decay=0.99)
    sharded = pm.shard_train_state_(state, mesh, mode)
    held = {n: (state.opt_state.mu[i].numel(), state.params[n].numel())
            for i, n in enumerate(state.params)}
    step = pm.make_parallel_train_step(dense_loss, opt, mesh, sharded, list(state.params))
    logs = step(state, pm.shard_batch(mesh, inputs["dense_x"]))
    whole = pm.whole_train_state(state, sharded)
    return {"params": whole.params, "ema": whole.ema.shadow, "held": held,
            "grad_norm": float(logs["grad_norm"])}


def unet_step(inputs: dict, axes: dict) -> dict:
    """One FSDP step of the tiny UNet (the JAX package's
    `test_fsdp_unet_train_step_matches`) over `axes`."""
    from sd_tpu_torch.models.unet_sd import UNetModel

    mesh = pm.make_mesh(axes)
    unet = UNetModel(**inputs["unet_cfg"], device="cpu")
    with torch.no_grad():
        for n, p in unet.named_parameters():
            p.copy_(inputs["unet"][n])
    opt = ddpm_optimizer(1e-3)
    state = init_train_state(dict(unet.named_parameters()), opt, ema_decay=0.99)
    split = pm.shard_module_(unet, mesh)
    sharded = pm.shard_train_state_(state, mesh, "fsdp", split)
    local = sum(p.numel() for p in state.params.values())
    x = pm.shard_batch(mesh, inputs["unet_x"])

    def loss_fn(batch, generator, logvar):
        t = torch.zeros(batch.shape[0], dtype=torch.int64)
        ctx = torch.zeros(batch.shape[0], 7, 32)
        return (unet(batch, t, ctx) ** 2).mean(), {}

    step = pm.make_parallel_train_step(loss_fn, opt, mesh, sharded, list(state.params))
    logs = step(state, x)
    whole = pm.whole_train_state(state, sharded)
    return {"params": whole.params, "mu": whole.opt_state.mu,
            "grad_norm": float(logs["grad_norm"]), "local": local, "split": sorted(split)}


@case
def steps(inputs: dict) -> dict:
    world = dist.get_world_size()
    out = {}
    mesh = pm.make_mesh()
    out["mesh"] = (mesh.axis_names, mesh.shape, mesh.coord)
    for mode in ("zero1", "fsdp"):
        out[f"dense_{mode}"] = dense_step(inputs, mesh, mode)
    out["rows"] = pm.shard_batch(mesh, {"image": torch.arange(16)})["image"]
    if world == 4:
        out["mesh_2x2"] = pm.make_mesh({"data": 2, "model": 2}).shape
        try:
            pm.make_mesh({"data": 3})
        except ValueError as e:
            out["mesh_3"] = str(e)
        out["prefix"] = pm.make_mesh({"data": 2}, ranks=[0, 1]).coord
        out["unet_data4"] = unet_step(inputs, {"data": 4})
        out["unet_data2_model2"] = unet_step(inputs, {"data": 2, "model": 2})
    else:
        g = multihost.host_local_to_global(
            {"x": inputs["dense_x"][dist.get_rank() * 4:(dist.get_rank() + 1) * 4]}, mesh)
        out["global_x"] = g["x"].full_tensor()
    return out


@case
def trainers(inputs: dict) -> dict:
    import importlib

    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.train import runners

    out = {}
    for name, (module, fn) in inputs["trainers"].items():
        run = getattr(importlib.import_module(module), fn)
        cfg = copy.deepcopy(inputs[f"{name}_cfg"])
        _, history = run(cfg, inputs[f"{name}_batches"], out_dir=inputs[f"{name}_dir"],
                         max_steps=2, device="cpu")
        out[name] = history
    # a group of 2 and a config without a `parallel:` block
    cfg = copy.deepcopy(inputs["ldm_zero1_cfg"])
    del cfg["parallel"]
    try:
        runners.train_ldm(cfg, inputs["ldm_zero1_batches"], max_steps=1, device="cpu")
    except ValueError as e:
        out["no_block"] = str(e)
    out["cli_ti"] = train_cli._train(argparse.Namespace(
        config="ti_smoke", data=inputs["ldm_zero1_dir"], annotations=None,
        out=inputs["ldm_zero1_dir"] + "_ti", max_steps=1, device="cpu"))
    return out


@case
def serve_dp(inputs: dict) -> dict:
    from sd_tpu_torch import serve

    out = pipeline_images(inputs, {"data": 2})
    pipe = make_pipeline(inputs)
    pipe.shard_for_serving(pm.make_mesh({"data": 2}))
    try:
        pipe.generate(["one prompt"], num_steps=2)
    except ValueError as e:
        out["divide"] = str(e)
    # the server over the group: rank 0 serves HTTP, rank 1 follows
    servers, answers = [], []
    real = serve.make_http_server

    def capture(*a, **kw):
        servers.append(real(*a, **kw))
        return servers[-1]

    serve.make_http_server = capture

    def client():
        while not servers:
            threading.Event().wait(0.05)
        port = servers[0].server_address[1]
        for body in inputs["requests"]:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                         data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append(json.loads(r.read()))
        servers[0].shutdown()

    if dist.get_rank() == 0:
        threading.Thread(target=client, daemon=True).start()
    serve.main(["--config", inputs["config_path"], "--shard", "--device", "cpu",
                "--port", "0", "--max-batch", "2", "--batch-window-ms", "1"])
    out["answers"] = answers
    return out


@case
def serve_tp(inputs: dict) -> dict:
    return pipeline_images(inputs, {"data": 2, "model": 2})


def make_pipeline(inputs: dict):
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.weights import randomize_params_

    pipe = Text2ImagePipeline(inputs["config"], device="cpu", param_dtype=torch.float32)
    randomize_params_(pipe.unet, torch.Generator().manual_seed(11))
    return pipe


def pipeline_images(inputs: dict, axes: dict) -> dict:
    """The sharded pipeline's images and the UNet leaves it split."""
    pipe = make_pipeline(inputs)
    pipe.shard_for_serving(pm.make_mesh(axes))
    return {"images": pipe.generate(inputs["prompts"], **inputs["generate"]),
            "split": len(pipe._unet_split)}


def main() -> None:
    name, directory = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    multihost.initialize(backend="gloo", device="cpu",
                         init_method="file://" + os.environ["PARALLEL_TEST_STORE"])
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    rank = dist.get_rank()
    result = CASES[name](inputs)
    torch.save(result, os.path.join(directory, f"{name}.rank{rank}.pt"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
