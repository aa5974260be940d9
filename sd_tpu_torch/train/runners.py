"""Config-driven training runs: latent diffusion, pixel-space DDPM and the KL
and VQ first stages.

Counterpart of `sd_tpu/train/runners.py`: `train_ddpm`, `train_kl_vae`,
`train_vq` and `train_ldm(config, data, out_dir, max_steps)` build the
models of a config, resume from the latest checkpoint under
`out_dir/ckpt`, and run the host loop (`_run_loop`) over a directory of
images (the config's dataset through `data/loader.py DataLoader`, epoch
after epoch): each step's randomness from a generator of its own derived
from (seed, step) (the TPU package's `fold_in(rng, step)`), the step's
logs appended to `out_dir/metrics.jsonl`, a checkpoint every
`train.checkpoint_every` steps and at the end, and every `train.eval_every`
steps the eval sampler's grid under `out_dir/samples/` (its generator from
(seed, 0x5EED, step)): the EMA `p_sample_loop` of `train_ddpm`, the
reconstruction of a fixed batch with its PSNR and SSIM (`eval_psnr`,
`eval_ssim` in the metrics file) of the codec trainers. A resumed run draws
at each step what an unbroken run draws there. Where the TPU runners are
odd, the port keeps it: a resumed run's loader starts again at epoch 1, and
`train_ldm`'s caption-dropout stream starts again from its seed.

`data` may also be an iterable of batches ({'image': [B, H, W, 3] in
[-1, 1]}, and 'txt_raw' captions for `train_ldm`), read once, with
`out_dir=None`: no files, no resume, no eval. Every trainer returns the
training state and one dict of floats per step: the step's logs and
`seconds` (host clock, the step's results read back).

`train_ldm` is the TPU package's (the SD-v1 recipe,
`configs/sd512_catdog.yaml`): CLIP text embedding with caption dropout, the
frozen first stage (a KL posterior sample or a VQ model's latent before
quantization; trained weights from `first_stage.ckpt`, a KL or VQ run's
checkpoint directory), `scale_factor: auto` calibrated on the first batch
and written to `out_dir/calibration.json`, the process's loss through the
UNet (the DDPM ε / v / x0 loss, or the rectified-flow velocity loss of
`diffusion.type: flow`; `build_process`) with `train.noise_offset`,
gradient accumulation, global-norm clip, Adam or AdamW
(`train.weight_decay`; fp32 moments under bf16 parameters), fp32 EMA,
remat, the learned logvar (`train.learn_logvar`). What it trains is one of
`ldm_branch`'s: the UNet; LoRA factors over the frozen UNet (`lora:`,
`lora.safetensors` from the EMA factors at the end); a ControlNet over it
(`controlnet:`, its hint from `data/hints.py`); an IP-Adapter (`ip_adapter:`,
the frozen image embedder saved to `out_dir/ip_embedder`); or the UNet and
the text encoder together (`cond_stage.trainable`). A ControlNet or
IP-Adapter run may start from a trained base UNet (`base_run`: a
`train_ldm` run directory or its `ckpt/`, the EMA weights). `train_ddpm` trains the
pixel-space UNetDDPM under the DDPM ε-loss (capability config #1),
`train_kl_vae` the KL autoencoder against L1 + LPIPS + KL + a PatchGAN
(#3), `train_vq` the VQ model (argmin, Gumbel or EMA codebook) against L1 +
LPIPS + the codebook loss + a PatchGAN (#4), both with two Adam optimizers
under the same bf16 parameter policy. The other capability runners are not
ported yet.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from sd_tpu_torch.core.config import load_config, resolve_device, split_dtype
from sd_tpu_torch.core.ema import ema_copy_to
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.diffusion.ddpm import DDPMProcess, draw_training_noise
from sd_tpu_torch.diffusion.flow import FlowProcess, FlowSchedule
from sd_tpu_torch.diffusion.latent import LatentDiffusion, calibrate_scale_factor
from sd_tpu_torch.losses.gan import GanLossConfig
from sd_tpu_torch.models.autoencoder import AutoencoderKL, IdentityFirstStage, VQModel
from sd_tpu_torch.models.clip_text import (ClipTextConfig, ClipTextTransformer,
                                           SimpleHashTokenizer)
from sd_tpu_torch.models.discriminator import NLayerDiscriminator, init_discriminator_
from sd_tpu_torch.models.lpips import make_lpips_fn
from sd_tpu_torch.models.unet_ddpm import UNetDDPM
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.nn.layers import dropout_rng
from sd_tpu_torch.parallel import mesh as pmesh
from sd_tpu_torch.parallel.mesh import global_draw
from sd_tpu_torch.parallel.multihost import node_count, node_index, rank_and_world
from sd_tpu_torch.train.checkpoint import (auto_resume, restore_tree, save_checkpoint,
                                           trained_weights)
from sd_tpu_torch.train.diffusion import (TrainState, cast_floating, ddpm_optimizer,
                                          float32_moments, init_train_state,
                                          make_diffusion_train_step)
from sd_tpu_torch.train.gan import (GanTrainState, gan_adam, gumbel_temp_schedule,
                                    init_gan_state, make_kl_gan_train_step,
                                    make_vq_gan_train_step)
from sd_tpu_torch.train.lr_schedules import cosine_annealing, lambda_linear_schedule
from sd_tpu_torch.train.metrics import (MetricsLogger, count_params, psnr,
                                        save_image_grid, ssim)
from sd_tpu_torch.train.remat import remat_apply
from sd_tpu_torch.weights import init_params_

# the host-side numpy streams, seeded (seed, key) as in the TPU package
CAPTION_DROPOUT_KEY = 0xCFD
IP_DROPOUT_KEY = 0x1BAD2

# the eval sampler's generator is derived from (seed, EVAL_KEY, step)
EVAL_KEY = 0x5EED


def make_lr(train_cfg: dict) -> float | Callable[[int], float]:
    """The config's learning rate: a constant, the cosine annealing from lr
    to 0 over `total_steps` (default 10000) for `lr_schedule: cosine`, or
    lr · the lambda-linear schedule of a dict `lr_schedule`."""
    lr = train_cfg.get("lr", 1e-4)
    sched = train_cfg.get("lr_schedule")
    if sched is None:
        return lr
    if sched == "cosine":
        return cosine_annealing(lr, train_cfg.get("total_steps", 10000))
    if not isinstance(sched, dict):
        raise ValueError(f"unknown lr_schedule {sched!r}")
    lam = lambda_linear_schedule(**sched)
    return lambda step: lr * lam(step)


def step_generator(device, *key: int) -> torch.Generator:
    """A generator on `device` seeded from the integers `key`, e.g. (seed,
    step): the counterpart of `jax.random.fold_in`."""
    state = np.random.SeedSequence([int(k) & 0xFFFFFFFF for k in key]).generate_state(2)
    return torch.Generator(device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def _load_cfg(config: dict | str) -> dict:
    """A deep copy of a config dict, or the config `load_config` names."""
    return copy.deepcopy(config) if isinstance(config, dict) else load_config(config)


# -- data ---------------------------------------------------------------------------


def _build_loader(data_dir: str, cfg: dict, batch_size: int, rows=None):
    """The config's dataset over `data_dir` (COCO captions with
    `annotation_file`, HR/LR pairs with `data.sr: {sf, degradation}`, class
    captions with `data.captions: class`, else the image folder) in a
    DataLoader. Each host of a process group reads its own share of every
    epoch (round-robin, the TPU package's rule with a process per host);
    `rows`: only those positions of each batch are read (a data-parallel
    rank's)."""
    from sd_tpu_torch.data.datasets import (ClassCaptionDataset, CocoCaptionDataset,
                                            ImageFolderDataset, SRDataset)
    from sd_tpu_torch.data.loader import DataLoader

    ann = cfg.get("annotation_file")
    size = cfg.get("train", {}).get("image_size", 256)
    dcfg = cfg.get("data", {})
    if ann:
        ds = CocoCaptionDataset(data_dir, ann, image_size=size)
    elif dcfg.get("sr"):
        # the degradation runs on the host, in the loader's threads
        sr = dcfg["sr"]
        ds = SRDataset(data_dir, image_size=size, sf=int(sr.get("sf", 4)),
                       degradation=sr.get("degradation", "bicubic"))
    elif dcfg.get("captions") == "class":
        ds = ClassCaptionDataset(data_dir, image_size=size,
                                 label_from=dcfg.get("label_from", "filename_prefix"),
                                 template=dcfg.get("template", "a photo of a {}"))
    else:
        ds = ImageFolderDataset(data_dir, image_size=size)
    return DataLoader(ds, batch_size=batch_size, rank=node_index(), world=node_count(),
                      rows=rows)


def _take_rows(batch: dict, rows: np.ndarray) -> dict:
    """The rows `rows` of every field of a batch (arrays, tensors, lists)."""
    return {k: ([v[i] for i in rows] if isinstance(v, (list, tuple))
                else v[torch.as_tensor(rows)] if torch.is_tensor(v) else np.asarray(v)[rows])
            for k, v in batch.items()}


# -- the parallel layer ---------------------------------------------------------------


class ParallelRun:
    """A run's `parallel:` block over the process group:

        parallel:
          mesh: {data: 4, model: 2}   # default: every rank on "data"
          state_sharding: zero1       # zero1 (default) | fsdp

    `train.batch_size` is the global batch of a host; each of its
    `grad_accum` microbatches splits by rows over the host's ranks of the
    data axis (`loader_rows`, the positions this rank reads). Across hosts
    the global microbatch is the hosts' microbatches in host order, and
    every draw of a step is made for it with this rank's rows kept (`rows`).
    Rank 0 writes the checkpoints (the
    whole state, gathered), the metrics and the samples; the other ranks
    wait. The step makers (`_maybe_parallel_step`, `_maybe_parallel_gan_step`)
    lay the state out and set `whole` / `local_state`."""

    def __init__(self, cfg: dict, grad_accum: int = 1):
        pcfg = cfg["parallel"]
        self.mode = pcfg.get("state_sharding", "zero1")
        if self.mode not in ("zero1", "fsdp"):
            raise ValueError(f"parallel.state_sharding={self.mode!r}: expected one of "
                             "['fsdp', 'zero1']")
        self.mesh = _parallel_mesh(pcfg)
        self.grad_accum = grad_accum
        self.main = rank_and_world()[0] == 0
        self.sharded: list = []
        self.whole: Callable = lambda st: st
        self.local_state: Callable = lambda st: st
        if self.main:
            print(f"[parallel] mesh={self.mesh.axes()} state_sharding={self.mode}")

    def rows(self, batch_size: int) -> np.ndarray:
        """This rank's positions in a global batch of `batch_size` rows."""
        n, r = self.mesh.size("data"), self.mesh.index("data")
        return pmesh.local_rows(batch_size, self.grad_accum, r, n)

    def loader_rows(self, batch_size: int) -> np.ndarray:
        """This rank's positions in its host's batch of `batch_size` rows:
        the host's ranks of the data axis, in torchrun's host-by-host rank
        order, split each microbatch (one host: `rows`)."""
        n, d, hosts = self.mesh.size("data"), self.mesh.index("data"), node_count()
        if n % hosts or d // (n // hosts) != node_index():
            raise ValueError(f"the data axis ({n} ranks) must run host by host over the "
                             f"{hosts} hosts (torchrun's rank order)")
        per = n // hosts
        return pmesh.local_rows(batch_size, self.grad_accum, d % per, per)

    def batch_rows(self, batch: dict):
        """The whole-batch draw context of a step on this rank's `batch`."""
        total = len(batch["image"]) * self.mesh.size("data")
        return pmesh.batch_rows(self.rows(total), total)

    @contextlib.contextmanager
    def eval_view(self, state):
        """`state` as this rank's modules can run it (the parameters whole
        over the data axis for the step's duration, the EMA shadow too)."""
        for sh in self.sharded:
            sh.gather_()
        try:
            yield self.local_state(state)
        finally:
            for sh in self.sharded:
                sh.restore_()

    def save(self, ckpt_dir: str, state, step: int) -> None:
        whole = self.whole(state)
        if self.main:
            save_checkpoint(ckpt_dir, whole, step)
        torch.distributed.barrier()


def _parallel_mesh(pcfg: dict) -> pmesh.Mesh:
    """The mesh of a `parallel:` block: its axes over every rank of the
    process group (raises without one, or where they do not cover it)."""
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        raise RuntimeError(f"parallel: {pcfg} needs a torch.distributed process group: launch "
                           "with torchrun (python -m sd_tpu_torch.train calls "
                           "multihost.initialize())")
    world = torch.distributed.get_world_size()
    axes = dict(pcfg.get("mesh") or {"data": world})
    n = int(np.prod(list(axes.values())))
    if n != world:
        raise ValueError(f"parallel.mesh {axes} covers {n} ranks, the process group has "
                         f"{world}: launch {n} processes (torchrun --nproc-per-node {n})")
    return pmesh.make_mesh(axes)


def _parallel_run(cfg: dict, grad_accum: int = 1) -> ParallelRun | None:
    """The run's `ParallelRun`, None on one process without a `parallel:`
    block. A process group of several ranks without the block raises: each
    rank would train the whole run on the same batches into one directory."""
    if cfg.get("parallel"):
        return ParallelRun(cfg, grad_accum)
    world = rank_and_world()[1]
    if world > 1:
        raise ValueError(f"the process group has {world} ranks and the config has no "
                         f"`parallel:` block: add `parallel: {{mesh: {{data: {world}}}}}` to "
                         "split each batch over the ranks, or launch one process")
    return None


def _maybe_parallel_step(par: ParallelRun | None, loss_fn: Callable, opt, state,
                         grad_accum: int = 1, tp: tuple | None = None) -> Callable:
    """The train step: `make_diffusion_train_step` without a `parallel:`
    block, else `parallel/mesh.py make_parallel_train_step` with the state
    laid out by `state_sharding` (ZeRO-1 or FSDP), in place. `tp`: (module,
    name prefix) whose parameters the state trains: its attention and
    feed-forward blocks split over a "model" axis (`TP_RULES_UNET`)."""
    if par is None:
        return make_diffusion_train_step(loss_fn, opt, grad_accum=grad_accum)
    split = {}
    if tp is not None:
        module, prefix = tp
        split = {prefix + n: leaf for n, leaf in
                 pmesh.shard_module_(module, par.mesh, pmesh.TP_RULES_UNET).items()}
    sharded = pmesh.shard_train_state_(state, par.mesh, par.mode, split)
    par.sharded = [sharded]
    par.whole = lambda st: pmesh.whole_train_state(st, sharded)
    par.local_state = lambda st: pmesh.ema_over_data(st, sharded)
    return pmesh.make_parallel_train_step(loss_fn, opt, par.mesh, sharded,
                                          pmesh._trained_names(state), grad_accum)


def _maybe_parallel_gan_step(par: ParallelRun | None, build_step: Callable, state,
                             opt_g, opt_d) -> Callable:
    """The GAN step `build_step(None)` without a `parallel:` block; else
    `build_step((opt_g, opt_d))` over `ShardedAdam`s of the laid-out state
    (`gan_state_sharding`'s layouts), run with this rank's rows: its draws
    the whole batch's, the discriminator's batch statistics, the EMA
    codebook's counts and the adaptive weight's gradients over the data
    axis, the logs the axis's mean."""
    if par is None:
        return build_step(None)
    mesh, mode = par.mesh, par.mode
    specs = pmesh.gan_state_sharding(state, mesh, mode=mode)
    sg = pmesh.shard_tensors_(list(state.params_g.values()), list(state.params_g),
                              specs.opt_state_g.mu, [state.opt_state_g], mesh, mode)
    sd = pmesh.shard_tensors_(list(state.params_d.values()), list(state.params_d),
                              specs.opt_state_d.mu, [state.opt_state_d], mesh, mode)
    par.sharded = [sg, sd]
    par.whole = lambda st: pmesh.whole_gan_state(st, sg, sd)
    step = build_step((pmesh.ShardedAdam(opt_g, sg), pmesh.ShardedAdam(opt_d, sd)))
    n, r = mesh.size("data"), mesh.index("data")

    def pstep(st: GanTrainState, x: torch.Tensor, generator=None) -> dict:
        sg.gather_()
        sd.gather_()
        b = x.shape[0]
        with pmesh.data_axis(mesh), pmesh.batch_rows(np.arange(r * b, (r + 1) * b), b * n):
            logs = step(st, x, generator)
        return pmesh.mean_logs(logs, mesh)

    return pstep


class _Batches:
    """A run's data: a directory (the config's dataset, epoch after epoch)
    or an iterable of batches (read once); with a `ParallelRun`, this
    rank's rows of each (`peek` stays the whole batch)."""

    def __init__(self, data: str | os.PathLike | Iterable[dict], cfg: dict,
                 par: ParallelRun | None = None):
        self.cfg = cfg
        self.par = par
        self.dir = os.fspath(data) if isinstance(data, (str, os.PathLike)) else None
        if self.dir is None:
            self._it = iter(data)
            self._first = next(self._it, None)

    def peek(self) -> dict:
        """The run's fixed batch: a fresh loader's first batch of 4 (the
        first epoch's order) for a directory, else the iterable's first."""
        if self.dir is None:
            if self._first is None:
                raise RuntimeError("empty dataset")
            return self._first
        it = iter(_build_loader(self.dir, self.cfg, 4))
        try:
            return next(it)
        except StopIteration:
            raise RuntimeError(f"empty dataset: {self.dir}") from None
        finally:
            it.close()

    def __iter__(self):
        if self.dir is None:
            if self._first is not None:
                for b in itertools.chain([self._first], self._it):
                    yield b if self.par is None else _take_rows(
                        b, self.par.loader_rows(len(b["image"])))
            return
        size = self.cfg["train"].get("batch_size", 4)
        loader = _build_loader(self.dir, self.cfg, size,
                               rows=None if self.par is None else self.par.loader_rows(size))
        while True:
            n = 0
            for batch in loader:
                n += 1
                yield batch
            if n == 0:
                raise RuntimeError(f"empty dataset: {self.dir}")


def _image(batch: dict, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch["image"]), dtype=torch.float32).to(device)


# -- the loop -----------------------------------------------------------------------


def _run_loop(step_fn: Callable, state, cfg: dict, batches: _Batches, out_dir: str | None,
              start_step: int, *, seed: int, device, max_steps: int | None = None,
              sampler: Callable | None = None) -> list[dict]:
    """Run `step_fn(state, batch, generator)` from `start_step` to
    `max_steps` (default `train.total_steps`), fewer if an iterable of
    batches runs out; each step's generator from (seed, step). With
    `out_dir`: the logs to `metrics.jsonl`, a checkpoint every
    `train.checkpoint_every` steps and at the end, and every
    `train.eval_every` steps `sampler(state, generator)` (images, or
    (images, {metric: value}) logged as `eval_<metric>`) as
    `samples/step_<N>.png`, its generator from (seed, EVAL_KEY, step).
    Under a `parallel:` block (`batches.par`) every rank steps on its rows
    and runs the sampler (the modules may be split over its ranks); rank 0
    writes the files, a checkpoint from the whole state."""
    tc = cfg["train"]
    par = batches.par
    main = par is None or par.main
    total = max_steps if max_steps is not None else tc.get("total_steps", 1000)
    ckpt_every = tc.get("checkpoint_every", 1000)
    eval_every = tc.get("eval_every", ckpt_every)
    ckpt_dir = os.path.join(out_dir, "ckpt") if out_dir else None
    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl") if out_dir and main else None)
    save = save_checkpoint if par is None else par.save
    history, step, saved = [], start_step, None
    it = iter(batches)
    try:
        while step < total:
            batch = next(it, None)
            if batch is None:
                break
            t0 = time.perf_counter()
            with contextlib.nullcontext() if par is None else par.batch_rows(batch):
                logs = step_fn(state, batch, step_generator(device, seed, step))
            row = {k: float(v) for k, v in logs.items()}
            seconds = time.perf_counter() - t0
            logger.log(step, row)
            history.append({**row, "seconds": seconds})
            step += 1
            if ckpt_dir and step % ckpt_every == 0:
                save(ckpt_dir, state, step)
                saved = step
            if out_dir and sampler is not None and step % eval_every == 0:
                with torch.no_grad(), (contextlib.nullcontext(state) if par is None
                                       else par.eval_view(state)) as st:
                    imgs = sampler(st, step_generator(device, seed, EVAL_KEY, step))
                if isinstance(imgs, tuple):
                    imgs, eval_logs = imgs
                    logger.log(step, {f"eval_{k}": v for k, v in eval_logs.items()})
                if main:
                    save_image_grid(imgs.float().cpu().numpy(),
                                    os.path.join(out_dir, "samples", f"step_{step}.png"))
    finally:
        it.close()
        logger.close()
    if ckpt_dir and saved != step:
        save(ckpt_dir, state, step)
    return history


def _resume(out_dir: str | None, fresh_state: Callable[[], Any]) -> tuple[Any, int]:
    """auto_resume under `out_dir/ckpt`, or the fresh state without a run
    directory."""
    if not out_dir:
        return fresh_state(), 0
    return auto_resume(os.path.join(out_dir, "ckpt"), fresh_state)


def ema_eval_params(state: TrainState) -> dict[str, torch.Tensor]:
    """The EMA shadow cast to the parameters' dtypes where an EMA is kept,
    else the parameters."""
    if state.ema is not None:
        return ema_copy_to(state.ema, state.params)
    return state.params


def _recon_eval_sampler(batches: _Batches, device, recon_fn: Callable) -> Callable:
    """The codec trainers' eval: `recon_fn(state, x, generator)` of the
    run's fixed batch, and its PSNR and SSIM against it."""
    ref: list[torch.Tensor] = []

    def sampler(state, generator):
        if not ref:
            ref.append(_image(batches.peek(), device))
        out = recon_fn(state, ref[0], generator)
        a, b = out.float().cpu().numpy(), ref[0].cpu().numpy()
        return out, {"psnr": psnr(a, b), "ssim": ssim(a, b)}

    return sampler


# -- the first stage ----------------------------------------------------------------


def first_stage_factor(fs_cfg: dict) -> int:
    """The pixel / latent downsampling of a first-stage config: 2^(levels −
    1), 1 for the identity first stage."""
    if _first_stage_class(fs_cfg) is IdentityFirstStage:
        return 1
    return 2 ** (len(fs_cfg["params"].get("ch_mult", [1, 2, 4, 4])) - 1)


def _first_stage_class(fs_cfg: dict):
    target = fs_cfg.get("target", "AutoencoderKL")
    for cls in (AutoencoderKL, VQModel, IdentityFirstStage):
        if target.split(".")[-1] == cls.__name__:
            return cls
    raise ValueError(f"unknown first stage {target!r} (AutoencoderKL, VQModel or "
                     "IdentityFirstStage)")


def copy_named_(own: dict[str, torch.Tensor], loaded: dict, what: str) -> None:
    """Copy `loaded[name]` into each tensor of `own`, in place, cast to its
    dtype; the names and shapes must match (a readable error names the
    first that does not)."""
    if sorted(loaded) != sorted(own):
        raise ValueError(f"{what}: its tensors {sorted(set(loaded) ^ set(own))[:6]} differ "
                         "from the model's — wrong checkpoint for this config?")
    with torch.no_grad():
        for name, t in own.items():
            if tuple(loaded[name].shape) != tuple(t.shape):
                raise ValueError(f"{what}: leaf {name} shape {tuple(loaded[name].shape)} != "
                                 f"model shape {tuple(t.shape)} — wrong checkpoint for this "
                                 "config?")
            t.copy_(loaded[name].to(t.dtype))


def load_first_stage_(model: torch.nn.Module, ckpt: str) -> None:
    """Copy a trained first stage into `model`, in place: the autoencoder
    parameters of a KL or VQ run's checkpoint directory (`params_g` without
    its `logvar`; the generator's buffers, an EMA codebook, from
    `model_state`), each checked against the model's shape and cast to its
    dtype."""
    tree = restore_tree(ckpt)
    loaded = tree["params_g"] if "params_g" in tree else tree
    loaded = {**{k: v for k, v in loaded.items() if k != "logvar"},
              **tree.get("model_state", {})}
    copy_named_({**dict(model.named_parameters()), **dict(model.named_buffers())}, loaded,
                f"first-stage ckpt {ckpt}")


def build_first_stage(fs_cfg: dict, generator: torch.Generator,
                      dtype: torch.dtype = torch.float32, device=None) -> torch.nn.Module:
    """The first stage of `first_stage` (`target` AutoencoderKL, VQModel or
    IdentityFirstStage), in eval mode, every weight drawn from `generator`
    and stored in `dtype`, computing in the config's pinned `dtype` (else
    in `dtype`); the trained weights of `ckpt` copied over them where the
    config names one (the draws are made either way, so what is drawn after
    them does not move)."""
    cls = _first_stage_class(fs_cfg)
    params, compute = split_dtype(fs_cfg.get("params") or {})
    model = cls(**params, dtype=dtype, compute_dtype=compute, device=device).eval()
    init_params_(model, generator)
    if fs_cfg.get("ckpt"):
        load_first_stage_(model, fs_cfg["ckpt"])
        print(f"[ldm] first stage loaded from {fs_cfg['ckpt']}")
    return model


def first_stage_fns(model: torch.nn.Module) -> tuple[Callable, Callable]:
    """(encode_fn, decode_fn) of a first stage: a KL model's posterior and
    decode; a VQ model's latent before quantization, and quantize-then-decode."""
    if isinstance(model, VQModel):
        return model.encode_pre_quant, model.decode_with_quantize
    return model.encode, model.decode


def apply_calibration(ld: LatentDiffusion, cfg: dict, ckpt_dir: str | None) -> LatentDiffusion:
    """`ld` with the scale factor `train_ldm` wrote to calibration.json
    beside `ckpt_dir`, when the config says `scale_factor: auto`; a missing
    file warns and keeps the factor."""
    if not ckpt_dir or cfg["latent"].get("scale_factor") != "auto":
        return ld
    cal = os.path.join(os.path.dirname(str(ckpt_dir).rstrip("/")), "calibration.json")
    if not os.path.exists(cal):
        print(f"[sample] WARNING: scale_factor=auto but {cal} missing; "
              f"using {ld.scale_factor} (decode will be mis-scaled)")
        return ld
    with open(cal) as f:
        sf = float(json.load(f)["scale_factor"])
    print(f"[sample] scale_factor from {cal}: {sf:.4f}")
    return dataclasses.replace(ld, scale_factor=sf)


# -- latent diffusion ---------------------------------------------------------------


class TextEmbedder:
    """Frozen text conditioner: captions → [B, 77, C] CLIP embeddings (the
    TPU package's `FrozenClipTextEmbedder`)."""

    def __init__(self, clip: ClipTextTransformer, tokenizer: SimpleHashTokenizer):
        self.clip = clip
        self.tokenizer = tokenizer

    @torch.no_grad()
    def __call__(self, texts: list[str]) -> torch.Tensor:
        device = next(self.clip.parameters()).device
        ids = torch.from_numpy(self.tokenizer(list(texts)).astype(np.int64))
        return self.clip(ids.to(device))


def build_process(cfg: dict, device=None) -> DDPMProcess | FlowProcess:
    """The latent-diffusion process of the config's `diffusion:` block, as
    `build_ldm` and `Text2ImagePipeline` both build it: `type: flow` the
    rectified-flow objective (`timesteps`, `shift`, `timestep_density`,
    `logit_mean`, `logit_std`), else the DDPM schedule (`given_betas` and
    `zero_terminal_snr` among its keys) with x0 unclamped and the optional
    min-SNR-γ weight; the tables on `device` (default the CPU)."""
    diff = dict(cfg.get("diffusion", {}))
    min_snr = diff.pop("min_snr_gamma", None)
    if diff.pop("type", "ddpm") == "flow":
        return FlowProcess(
            FlowSchedule(num_timesteps=diff.get("timesteps", 1000),
                         shift=float(diff.get("shift", 1.0))),
            timestep_density=diff.get("timestep_density", "uniform"),
            logit_mean=float(diff.get("logit_mean", 0.0)),
            logit_std=float(diff.get("logit_std", 1.0)))
    sched = DiffusionSchedule.create(**diff)
    return DDPMProcess(sched if device is None else sched.to(device), clip_denoised=False,
                       parameterization=diff.get("parameterization", "eps"),
                       min_snr_gamma=min_snr)


def build_ldm(cfg: dict, generator: torch.Generator,
              param_dtype: torch.dtype = torch.float32, device=None):
    """The text-to-image latent-diffusion stack of `cfg`, every weight from
    `generator` (the first stage's trained ones from `first_stage.ckpt`):
    (ld, unet, first_stage, embed_texts). The UNet holds its parameters in
    `param_dtype` and computes in the config's pinned `dtype`, else in
    `param_dtype`; the first stage and text tower are fp32 and frozen
    (`requires_grad` off)."""
    device = resolve_device(device)
    lat = cfg["latent"]
    ucfg, compute = split_dtype(cfg["unet"]["params"])
    unet = UNetModel(**ucfg, dtype=param_dtype, compute_dtype=compute, device=device)
    init_params_(unet, generator)
    vae = build_first_stage(cfg["first_stage"], generator, device=device).requires_grad_(False)
    clip_cfg = ClipTextConfig(**(cfg.get("cond_stage", {}).get("params") or {}))
    clip = ClipTextTransformer(clip_cfg, device=device).eval().requires_grad_(False)
    init_params_(clip, generator)

    encode_fn, decode_fn = first_stage_fns(vae)
    ld = LatentDiffusion(
        process=build_process(cfg, device), unet_apply=unet, encode_fn=encode_fn, decode_fn=decode_fn,
        conditioning_key=lat.get("conditioning_key", "crossattn"),
        # "auto": std-rescaled on the first batch, in train_ldm
        scale_factor=(1.0 if lat.get("scale_factor") == "auto"
                      else lat.get("scale_factor", 0.18215)))
    embed = TextEmbedder(clip, SimpleHashTokenizer(clip_cfg.max_length,
                                                   clip_cfg.vocab_size))
    return ld, unet, vae, embed


def params_apply(module: torch.nn.Module, params: dict[str, torch.Tensor]) -> Callable:
    """`module`'s apply (x, t, ctx, **kw) with `params` in place of its own
    (those it names); the module itself where `params` are its own."""
    own = dict(module.named_parameters())
    if params.keys() == own.keys() and all(params[n] is p for n, p in own.items()):
        return module
    return lambda x, t, ctx, **kw: torch.func.functional_call(module, params, (x, t, ctx), kw)


def load_base_unet_(unet: UNetModel, run: str) -> str:
    """Copy a trained base UNet into `unet`, in place: the EMA weights (else
    the parameters) of the latest checkpoint of `run`, a `train_ldm` run
    directory or its `ckpt/`, read on the CPU from the mapped file, each
    checked against the module's shape and cast to its dtype. Returns the
    checkpoint directory (its calibration.json sits beside it)."""
    ckpt_dir = os.path.join(run, "ckpt") if os.path.isdir(os.path.join(run, "ckpt")) else run
    copy_named_(dict(unet.named_parameters()), trained_weights(restore_tree(ckpt_dir)),
                f"base UNet of {ckpt_dir}")
    return ckpt_dir


def caption_dropper(cfg: dict) -> Callable[[list], list]:
    """The caption dropout of `train.cond_dropout`: each caption the empty
    one at that rate, drawn from the (seed, 0xCFD) numpy stream."""
    rate = float(cfg["train"].get("cond_dropout", 0.0))
    rng = np.random.default_rng((cfg.get("seed", 0), CAPTION_DROPOUT_KEY))

    def drop(texts):
        if rate <= 0.0:
            return list(texts)
        draws = global_draw(lambda n: [rng.random() for _ in range(n)], len(texts))
        return ["" if u < rate else t for u, t in zip(draws, texts)]

    return drop


@dataclasses.dataclass
class LdmBranch:
    """What `train_ldm` trains and how: `params` (the trained tensors, by
    name), `loss_fn(batch, generator, logvar) -> (loss, logs)` over the
    batches `embed_batch` makes from the loader's, the model `ld` the loss
    runs, the branch's own modules, and `finish(state)` (the run's
    distribution file at the end, or None)."""

    params: dict[str, torch.Tensor]
    loss_fn: Callable
    embed_batch: Callable[[dict], dict]
    ld: LatentDiffusion
    modules: dict = dataclasses.field(default_factory=dict)
    finish: Callable[[TrainState], None] | None = None
    tp: tuple | None = None     # (module, name prefix) of the trained tensors a model axis splits


def ldm_branch(cfg: dict, ld: LatentDiffusion, unet: UNetModel, embed: TextEmbedder,
               out_dir: str | None = None, param_dtype: torch.dtype = torch.float32
               ) -> LdmBranch:
    """`train_ldm`'s branch of `cfg`: its trained tensors (in `param_dtype`),
    loss and batch transform. Every branch embeds the captions with caption
    dropout; the adapter branches freeze the UNet (`requires_grad` off) and
    initialise their tensors from generators seeded as the TPU package's
    keys: LoRA (seed ^ 0x10AA), ControlNet (seed ^ 0xC077), the IP-Adapter's
    image embedder (seed ^ 0x1BAD) and adapter (seed ^ 0x1BAD1). `lora`,
    `controlnet` and `ip_adapter` exclude each other and a trainable cond
    stage. The loss runs the UNet under `train.remat`."""
    from sd_tpu_torch.data.hints import HINT_FNS
    from sd_tpu_torch.models.conditioners import FrozenClipImageEmbedder
    from sd_tpu_torch.models.controlnet import (controlled_apply_fn,
                                                controlnet_from_unet_config,
                                                init_controlnet_from_unet)
    from sd_tpu_torch.models.ip_adapter import (count_ip_params, flat_ip, init_ip_adapter,
                                                ip_apply_fn, nest_ip)
    from sd_tpu_torch.train.lora import (count_lora_params, flat_lora, init_lora,
                                         merged_kernels, nest_lora, save_lora_safetensors)

    tc = cfg["train"]
    seed = cfg.get("seed", 0)
    device = next(unet.parameters()).device
    remat = tc.get("remat", "none")
    cond_trainable = bool(cfg.get("cond_stage", {}).get(
        "trainable", tc.get("cond_stage_trainable", False)))
    lora_cfg, cn_cfg, ip_cfg = cfg.get("lora"), cfg.get("controlnet"), cfg.get("ip_adapter")
    if sum(map(bool, (lora_cfg, cn_cfg, ip_cfg))) > 1:
        raise ValueError("lora / controlnet / ip_adapter training are mutually exclusive")
    drop = caption_dropper(cfg)
    gen = lambda key: torch.Generator(device).manual_seed(seed ^ key)

    def embed_texts(batch):
        return {"image": _image(batch, device),
                "txt_emb": embed(drop(batch.get("txt_raw", [""] * len(batch["image"]))))}

    def base_from(run_cfg):
        nonlocal ld
        if run_cfg.get("base_run"):
            # the paper's setup: control a TRAINED base model (its EMA weights)
            ckpt_dir = load_base_unet_(unet, run_cfg["base_run"])
            ld = apply_calibration(ld, cfg, ckpt_dir)
            print(f"[ldm] base UNet loaded from {ckpt_dir} (scale_factor={ld.scale_factor:.4f})")

    def plain_loss(model):
        apply = remat_apply(model.unet_apply, remat)
        model = dataclasses.replace(model, unet_apply=apply)
        return lambda b, g, logvar: model.training_loss(b, g, logvar), model

    if cn_cfg:
        if cond_trainable:
            raise ValueError("controlnet and cond_stage.trainable are exclusive")
        base_from(cn_cfg)
        hint_fn = HINT_FNS[cn_cfg.get("hint", "canny")]
        f_vae = first_stage_factor(cfg["first_stage"])
        cn = controlnet_from_unet_config(cfg["unet"]["params"],
                                         hint_channels=int(cn_cfg.get("hint_channels", 3)),
                                         hint_downsamples=f_vae.bit_length() - 1,
                                         dtype=param_dtype, device=device)
        init_params_(cn, gen(0xC077))
        init_controlnet_from_unet(cn, unet)
        unet.requires_grad_(False)
        print(f"[ldm] controlnet: {count_params(cn) / 1e6:.1f}M trainable params "
              f"(base frozen: {count_params(unet) / 1e6:.1f}M)")
        loss_fn, model = plain_loss(dataclasses.replace(
            ld, unet_apply=controlled_apply_fn(unet, cn)))

        def embed_batch(batch):
            out = embed_texts(batch)
            out["hint"] = torch.as_tensor(hint_fn(np.asarray(batch["image"])),
                                          dtype=torch.float32).to(device)
            return out

        return LdmBranch(dict(cn.named_parameters()), loss_fn, embed_batch, model,
                         {"controlnet": cn}, tp=(cn, ""))
    if ip_cfg:
        if cond_trainable:
            raise ValueError("ip_adapter and cond_stage.trainable are exclusive")
        base_from(ip_cfg)
        embedder = FrozenClipImageEmbedder(device=device).eval().requires_grad_(False)
        init_params_(embedder, gen(0x1BAD))
        if out_dir and rank_and_world()[0] == 0:
            # the frozen embedder beside the run, so serving embeds as training did
            save_checkpoint(os.path.join(out_dir, "ip_embedder"),
                            dict(embedder.named_parameters()), 0, max_to_keep=1)
        pix = tc.get("image_size", 256)
        with torch.no_grad():
            embed_dim = int(embedder(torch.zeros((1, pix, pix, 3), device=device)).shape[-1])
        ip = cast_floating(flat_ip(init_ip_adapter(
            unet, gen(0x1BAD1), embed_dim=embed_dim, n_tokens=int(ip_cfg.get("n_tokens", 4)))),
            param_dtype)
        unet.requires_grad_(False)
        print(f"[ldm] ip_adapter: {count_ip_params(nest_ip(ip)) / 1e6:.2f}M trainable params over "
              f"{len(nest_ip(ip)['layers'])} cross-attn layers (base frozen: "
              f"{count_params(unet) / 1e6:.1f}M)")
        loss_fn, model = plain_loss(dataclasses.replace(
            ld, unet_apply=ip_apply_fn(unet, nest_ip(ip), float(ip_cfg.get("scale", 1.0)))))
        img_dropout = float(ip_cfg.get("image_dropout", 0.05))
        ip_rng = np.random.default_rng((seed, IP_DROPOUT_KEY))

        @torch.no_grad()
        def embed_batch(batch):
            out = embed_texts(batch)
            emb = embedder(out["image"])
            if img_dropout > 0.0:
                keep = torch.as_tensor(global_draw(ip_rng.random, emb.shape[0]) >= img_dropout)
                emb = emb * keep.to(emb.dtype).to(device)[:, None]
            out["ip_embed"] = emb
            return out

        return LdmBranch(ip, loss_fn, embed_batch, model, {"embedder": embedder})
    if lora_cfg:
        if cond_trainable:
            raise ValueError("lora and cond_stage.trainable are exclusive")
        scale = float(lora_cfg.get("scale", 1.0))
        rank = int(lora_cfg.get("rank", 8))
        factors = cast_floating(flat_lora(init_lora(unet, rank, gen(0x10AA),
                                                    lora_cfg.get("targets"))), param_dtype)
        unet.requires_grad_(False)
        print(f"[ldm] lora: {count_lora_params(nest_lora(factors)) / 1e3:.1f}K trainable "
              f"params over {len(factors) // 2} kernels (base frozen: "
              f"{count_params(unet) / 1e6:.1f}M)")

        def loss_fn(batch, generator, logvar):
            # the merge inside the loss: the adapted weights carry gradients to the factors
            merged = merged_kernels(unet, nest_lora(factors), scale)
            model = dataclasses.replace(
                ld, unet_apply=remat_apply(params_apply(unet, merged), remat))
            return model.training_loss(batch, generator, logvar)

        def finish(state):
            # the distribution file beside the resume checkpoint: the EMA factors
            save_lora_safetensors(os.path.join(out_dir, "lora.safetensors"),
                                  nest_lora(ema_eval_params(state)),
                                  metadata={"rank": str(rank), "scale": str(scale)})

        return LdmBranch(factors, loss_fn, embed_texts, ld, finish=finish if out_dir else None)
    if cond_trainable:
        # the text encoder trains with the UNet, in the UNet's dtype; the
        # optimizer, EMA and checkpoint hold {unet, cond}
        clip = embed.clip.to(param_dtype).requires_grad_(True)
        print(f"[ldm] cond-stage params in optimizer: {count_params(clip) / 1e6:.1f}M")
        params = {**{f"unet.{n}": p for n, p in unet.named_parameters()},
                  **{f"cond.{n}": p for n, p in clip.named_parameters()}}
        loss, model = plain_loss(ld)

        def loss_fn(batch, generator, logvar):
            return loss({**batch, "txt_emb": clip(batch["txt_ids"])}, generator, logvar)

        def embed_batch(batch):
            texts = drop(batch.get("txt_raw", [""] * len(batch["image"])))
            ids = torch.from_numpy(embed.tokenizer(texts).astype(np.int64))
            return {"image": _image(batch, device), "txt_ids": ids.to(device)}

        return LdmBranch(params, loss_fn, embed_batch, model, {"cond": clip}, tp=(unet, "unet."))
    loss_fn, model = plain_loss(ld)
    return LdmBranch(dict(unet.named_parameters()), loss_fn, embed_texts, model, tp=(unet, ""))


def auto_scale_factor(ld: LatentDiffusion, cfg: dict, batches: _Batches, out_dir: str | None,
                      generator: torch.Generator, tag: str = "ldm") -> LatentDiffusion:
    """`ld` at the config's scale factor: under `scale_factor: auto` 1/std of
    the run's fixed batch's latents (the reference's scale_by_std), written
    to `out_dir/calibration.json`; a resumed run calibrates again on the
    same batch."""
    if cfg["latent"].get("scale_factor") != "auto":
        return ld
    z = ld.encode_first_stage(_image(batches.peek(), generator.device), generator=generator)
    ld = dataclasses.replace(ld, scale_factor=calibrate_scale_factor(z))
    print(f"[{tag}] scale_factor (std-rescale): {ld.scale_factor:.4f}")
    if out_dir and rank_and_world()[0] == 0:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "calibration.json"), "w") as f:
            json.dump({"scale_factor": float(ld.scale_factor)}, f)
    return ld


def train_ldm(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
              max_steps: int | None = None, device=None) -> tuple[TrainState, list[dict]]:
    """Train `ldm_branch`'s tensors of `config` on `data` (see the module
    docstring) for `max_steps` optimizer steps (default
    `train.total_steps`). With `scale_factor: auto` the factor is 1/std of
    the first batch's latents (`calibration.json` under `out_dir`; a
    `base_run`'s own calibration replaces it); a resumed run calibrates
    again on the same batch. The caption-dropout and image-dropout streams
    start from the seed on every start, a resumed run's too, as in the TPU
    package. A `parallel:` block runs it over the process group
    (`ParallelRun`)."""
    cfg = _load_cfg(config)
    tc = cfg["train"]
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    param_dtype = getattr(torch, tc.get("param_dtype") or "float32")
    par = _parallel_run(cfg, tc.get("grad_accum", 1))
    ld, unet, _, embed = build_ldm(cfg, gen, param_dtype, device)
    print(f"[ldm] unet params: {count_params(unet) / 1e6:.1f}M"
          + (f" ({tc['param_dtype']})" if tc.get("param_dtype") else ""))
    if tc.get("noise_offset"):
        ld = dataclasses.replace(ld, noise_offset=float(tc["noise_offset"]))
    batches = _Batches(data, cfg, par)
    ld = auto_scale_factor(ld, cfg, batches, out_dir, gen)
    branch = ldm_branch(cfg, ld, unet, embed, out_dir, param_dtype)

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0),
                         weight_decay=tc.get("weight_decay", 0.0))
    if param_dtype != torch.float32:
        opt = float32_moments(opt)
    learn_logvar = bool(tc.get("learn_logvar", False))
    state, start = _resume(out_dir, lambda: init_train_state(
        branch.params, opt, tc.get("ema_decay", 0.9999),
        num_timesteps=branch.ld.schedule.num_timesteps, learn_logvar=learn_logvar))
    step_fn = _maybe_parallel_step(par, branch.loss_fn, opt, state, tc.get("grad_accum", 1),
                                   tp=branch.tp)
    history = _run_loop(lambda st, b, g: step_fn(st, branch.embed_batch(b), g), state, cfg,
                        batches, out_dir, start, seed=seed, device=device,
                        max_steps=max_steps)
    if branch.finish is not None:
        whole = state if par is None else par.whole(state)
        if par is None or par.main:
            branch.finish(whole)
    return state, history


# -- the GAN trainers ---------------------------------------------------------------


def _resolve_lpips(loss_cfg: GanLossConfig, mode: str, device, tag: str):
    """The perceptual term of `loss.perceptual`: auto (here always the
    fixed-seed random-VGG surrogate: no VGG16 weights are in the
    repository), calibrated, random or none; None when its weight is 0.
    Says which it built."""
    if loss_cfg.perceptual_weight <= 0:
        return None
    fn = make_lpips_fn(mode=mode, device=device)
    if fn is not None:
        kind = "calibrated" if fn.calibrated else "random-VGG surrogate"
        print(f"[{tag}] perceptual loss: {kind} LPIPS (weight={loss_cfg.perceptual_weight})")
    else:
        print(f"[{tag}] perceptual loss disabled (perceptual: none)")
    return fn


def _gan_setup(cfg: dict, model, device, gen, tag: str):
    """The GAN trainers' common part: the discriminator of `cfg` and both
    networks initialised from `gen`, the loss configuration and perceptual
    function (the perceptual weight dropped to 0 with `perceptual: none`),
    the two GAN Adams (fp32 moments under `train.param_dtype`) and a thunk
    of the training state. Returns (disc, loss_cfg, lpips_fn, opt_g, opt_d,
    fresh_state)."""
    tc = cfg["train"]
    param_dtype = getattr(torch, tc["param_dtype"]) if tc.get("param_dtype") else None
    disc = NLayerDiscriminator(**cfg.get("discriminator", {}), device=device)
    init_params_(model, gen)
    init_discriminator_(disc, gen)
    loss_kwargs = dict(cfg.get("loss", {}))
    lpips_mode = loss_kwargs.pop("perceptual", "auto")
    loss_cfg = GanLossConfig(**loss_kwargs)
    lpips_fn = _resolve_lpips(loss_cfg, lpips_mode, device, tag)
    if lpips_fn is None and loss_cfg.perceptual_weight > 0:
        loss_cfg = dataclasses.replace(loss_cfg, perceptual_weight=0.0)
    opt_g, opt_d = gan_adam(tc.get("lr", 4.5e-6)), gan_adam(tc.get("lr", 4.5e-6))
    if param_dtype not in (None, torch.float32):
        opt_g, opt_d = float32_moments(opt_g), float32_moments(opt_d)
    fresh = lambda: init_gan_state(model, disc, opt_g, opt_d, param_dtype=param_dtype)
    return disc, loss_cfg, lpips_fn, opt_g, opt_d, fresh


def _gan_params(state: GanTrainState) -> int:
    return count_params({n: p for n, p in state.params_g.items() if n != "logvar"})


def train_kl_vae(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
                 max_steps: int | None = None, device=None
                 ) -> tuple[GanTrainState, list[dict]]:
    """Train the KL autoencoder of `config` (e.g. `kl_f8_256_train_config()`)
    with its PatchGAN on `data` (see the module docstring). Every weight is
    random from the config's seed, each step's posterior noise from the
    step's generator. With `train.param_dtype` (e.g. "bfloat16") the
    generator and discriminator parameters are stored in it and the Adam
    moments are fp32. The eval reconstructs the run's fixed batch with a
    posterior sample."""
    cfg = _load_cfg(config)
    target = cfg["model"].get("target", "")
    if not target.endswith("AutoencoderKL"):
        raise ValueError(f"train_kl_vae trains an AutoencoderKL, not {target!r}")
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    par = _parallel_run(cfg)
    mp, compute = split_dtype(cfg["model"]["params"])
    vae = AutoencoderKL(**mp, compute_dtype=compute, device=device)
    disc, loss_cfg, lpips_fn, opt_g, opt_d, fresh = _gan_setup(cfg, vae, device, gen, "kl-vae")
    state, start = _resume(out_dir, fresh)
    print(f"[kl-vae] params: {_gan_params(state) / 1e6:.1f}M")

    down = 2 ** (len(mp.get("ch_mult", (1, 2, 4, 4))) - 1)
    embed_dim = mp.get("embed_dim", 4)

    def ae_apply(x, generator):
        b, h, w, _ = x.shape
        noise = global_draw(lambda n: torch.randn((n, h // down, w // down, embed_dim),
                                                  generator=generator, device=x.device), b)
        return vae(x, noise)

    step_fn = _maybe_parallel_gan_step(
        par, lambda opts: make_kl_gan_train_step(ae_apply, disc, lpips_fn,
                                                 *(opts or (opt_g, opt_d)), loss_cfg),
        state, opt_g, opt_d)
    batches = _Batches(data, cfg, par)
    sampler = _recon_eval_sampler(batches, device, lambda st, x, g: ae_apply(x, g)[0])
    history = _run_loop(lambda st, b, g: step_fn(st, _image(b, device), g), state, cfg,
                        batches, out_dir, start, seed=seed, device=device,
                        max_steps=max_steps, sampler=sampler)
    return state, history


def train_vq(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
             max_steps: int | None = None, device=None) -> tuple[GanTrainState, list[dict]]:
    """Train the VQ model of `config` (e.g. `vq_128_train_config()`,
    `vq_64_train_config()`) with its PatchGAN on `data` (see the module
    docstring). Every weight is random from the config's seed.
    `model.params.quantizer_type` picks the codebook: "vq" (argmin, trained
    by its gradient), "gumbel" (its noise drawn from the step's generator,
    its temperature `gumbel_temp_schedule(temp_init, **gumbel_schedule)` of
    the step) or "ema" (fp32 buffers updated once a step, never seen by
    Adam). With `train.param_dtype` (e.g. "bfloat16") the generator's and
    the discriminator's parameters are stored in it and the Adam moments are
    fp32. The eval reconstructs the run's fixed batch (deterministic
    quantization at `temp_init`, no codebook update)."""
    cfg = _load_cfg(config)
    target = cfg["model"].get("target", "")
    if not target.endswith("VQModel"):
        raise NotImplementedError(f"first stage {target!r} is not a VQ model")
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device).manual_seed(seed)
    par = _parallel_run(cfg)
    mp, compute = split_dtype(cfg["model"]["params"])
    vq = VQModel(**mp, compute_dtype=compute, device=device)
    disc, loss_cfg, lpips_fn, opt_g, opt_d, fresh = _gan_setup(cfg, vq, device, gen, "vq")
    state, start = _resume(out_dir, fresh)
    print(f"[vq] params: {_gan_params(state) / 1e6:.1f}M")

    temp_fn = None
    if vq.quantizer_type == "gumbel":
        temp_fn = gumbel_temp_schedule(temp_init=mp.get("temp_init", 1.0),
                                       **cfg.get("gumbel_schedule", {}))

    def vq_apply(x, generator, temp):
        # dropout (`model.params.dropout`) in the gumbel and ema families'
        # steps, as in the TPU package, its masks from the step's generator
        with dropout_rng(generator if vq.quantizer_type != "vq" else None):
            return vq(x, temp=temp, update=True, deterministic=False, generator=generator)

    def recon(st, x, generator):
        return vq(x, temp=mp.get("temp_init", 1.0), update=False, deterministic=True)[0]

    step_fn = _maybe_parallel_gan_step(
        par, lambda opts: make_vq_gan_train_step(vq_apply, disc, lpips_fn,
                                                 *(opts or (opt_g, opt_d)), loss_cfg,
                                                 temp_fn=temp_fn),
        state, opt_g, opt_d)
    batches = _Batches(data, cfg, par)
    history = _run_loop(lambda st, b, g: step_fn(st, _image(b, device), g), state, cfg,
                        batches, out_dir, start, seed=seed, device=device,
                        max_steps=max_steps,
                        sampler=_recon_eval_sampler(batches, device, recon))
    return state, history


# -- pixel-space DDPM ---------------------------------------------------------------


def _ddpm_parts(cfg: dict, model: UNetDDPM):
    """(fresh_state thunk, loss_fn, optimizer, process) of `make_ddpm_trainer`."""
    tc = cfg["train"]
    diff = dict(cfg.get("diffusion", {}))
    min_snr = diff.pop("min_snr_gamma", None)
    device = next(model.parameters()).device
    process = DDPMProcess(DiffusionSchedule.create(**diff).to(device), clip_denoised=True,
                          parameterization=diff.get("parameterization", "eps"),
                          min_snr_gamma=min_snr)
    noise_offset = tc.get("noise_offset", 0.0)

    def loss_fn(batch, generator, logvar):
        x = batch["image"]
        t = batch.get("t")
        if t is None:
            t = global_draw(lambda n: torch.randint(0, process.schedule.num_timesteps, (n,),
                                                    generator=generator, device=x.device),
                            x.shape[0])
        noise = batch.get("noise")
        if noise is None:
            noise = draw_training_noise(tuple(x.shape), noise_offset, generator=generator,
                                        device=x.device)
        # the model's dropout masks from the step's generator, after t and noise
        with dropout_rng(generator):
            return process.p_losses(lambda x_t, t_, _: model(x_t, t_), x, t, noise,
                                    learned_logvar=logvar)

    opt = ddpm_optimizer(make_lr(tc), tc.get("grad_clip", 1.0))
    fresh = lambda: init_train_state(dict(model.named_parameters()), opt,
                                     tc.get("ema_decay", 0.9999))
    return fresh, loss_fn, opt, process


def make_ddpm_trainer(cfg: dict, model: UNetDDPM):
    """The pixel-space DDPM recipe of `cfg` over `model`: (state, step).
    `state` is the training state over the model's parameters (Adam moments,
    fp32 EMA at `train.ema_decay`); `step(state, batch, generator)` one
    optimizer step on {'image': [B, H, W, 3]}: the ε-loss of
    `DDPMProcess(clip_denoised=True)` on the config's schedule, clip + Adam
    on the config's lr, `train.grad_accum` microbatches; its timesteps
    (uniform in [0, T)) and noise from the batch's `t` and `noise` where it
    has them, else from `generator`, then the model's dropout masks from
    `generator`."""
    fresh, loss_fn, opt, _ = _ddpm_parts(cfg, model)
    return fresh(), make_diffusion_train_step(loss_fn, opt,
                                              grad_accum=cfg["train"].get("grad_accum", 1))


def train_ddpm(config: dict | str, data: str | Iterable[dict], out_dir: str | None = None,
               max_steps: int | None = None, device=None) -> tuple[TrainState, list[dict]]:
    """Train the pixel-space DDPM of `config` (e.g. `ddpm_256_train_config()`)
    on `data` (see the module docstring) with `make_ddpm_trainer`. Every
    weight is random from the config's seed, each step's timesteps, noise
    and dropout masks (`model.params.dropout`) from the step's generator.
    fp32 parameters, Adam moments and EMA; the model computes in
    `model.params.dtype` where the config pins it (e.g. "bfloat16": the
    level-3 attention then takes the flash training kernels), else in fp32.
    The config's lr is a constant or `lr_schedule: cosine`. The eval samples
    `sample.num_images` images (default 4) with `p_sample_loop` under the
    EMA weights, x_T from the eval generator."""
    cfg = _load_cfg(config)
    mp, compute = split_dtype(cfg["model"]["params"])
    device = resolve_device(device)
    seed = cfg.get("seed", 0)
    model = UNetDDPM(**mp, compute_dtype=compute, device=device)
    init_params_(model, torch.Generator(device).manual_seed(seed))
    fresh, loss_fn, opt, process = _ddpm_parts(cfg, model)
    state, start = _resume(out_dir, fresh)
    print(f"[ddpm] params: {count_params(state.params) / 1e6:.1f}M")
    grad_accum = cfg["train"].get("grad_accum", 1)
    par = _parallel_run(cfg, grad_accum)
    step_fn = _maybe_parallel_step(par, loss_fn, opt, state, grad_accum, tp=(model, ""))
    size = cfg["train"].get("image_size", 256)

    def sample_with_ema(st, generator):
        params = ema_eval_params(st)
        shape = (cfg.get("sample", {}).get("num_images", 4), size, size, model.out_channels)
        x_T = torch.randn(shape, generator=generator, device=device)
        fn = lambda x, t, c: torch.func.functional_call(model, params, (x, t))
        return process.p_sample_loop(fn, shape, x_T, generator=generator)

    history = _run_loop(lambda st, b, g: step_fn(st, {"image": _image(b, device)}, g), state,
                        cfg, _Batches(data, cfg, par), out_dir, start, seed=seed, device=device,
                        max_steps=max_steps, sampler=sample_with_ema)
    return state, history
