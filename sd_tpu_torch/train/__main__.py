"""Train a configuration: `python -m sd_tpu_torch.train`.

Counterpart of `scripts/train.py`: dispatches on the config's `task` to
`train_ddpm`, `train_kl_vae`, `train_vq`, `train_ldm` (a flow model's
too, `diffusion.type: flow`; its LoRA, ControlNet, IP-Adapter and
trainable-text-encoder branches by the config's blocks), `distill_ldm`
(`task: distill`: a finished LDM run, `distill.teacher_run`, distilled into
a few-step consistency student, or into an LCM-LoRA with
`distill.lora_rank`), `train_textual_inversion`, `train_dreambooth` or
`train_ldm_inpaint`, or `train_ldm_sr` (`task: ldm_sr`: concat-conditioned
super-resolution over HR/LR pairs that `SRDataset` degrades on the host),
reads images from `--data`, writes the run
(checkpoints under `ckpt/`, `metrics.jsonl`, `samples/`,
`calibration.json`, and the config it ran as `config.json`; a LoRA run's
`lora.safetensors`, an IP-Adapter run's `ip_embedder/`, a textual
inversion's `embedding.safetensors` and `ti.json`, DreamBooth's
`class_images/`) to `--out` (default `runs/<task>`), and resumes from its
latest checkpoint. Runs on the card unless `--device cpu` (the counterpart
of `--platform`).

    python -m sd_tpu_torch.train --config kl_f8_256_train --data imgs/ --out runs/kl
    python -m sd_tpu_torch.train --config runs/ldm.json --data imgs/ --out runs/ldm
    python -m sd_tpu_torch.train --config runs/lcm.json --data imgs/ --out runs/lcm
    python -m sd_tpu_torch.train --config ti_smoke --data concept/ --out runs/ti

`--config` is a config function's name (`core/config.py`, e.g.
`lcm512_distill`, whose `distill.teacher_run` a .json copy sets) or a .json
/ .yaml file. A task that is none of these exits with 2.

Under torchrun the process group comes up first (`parallel/multihost.py
initialize`: NCCL, one card per rank; `--backend gloo` with `--device
cuda:0` puts the ranks on one card, `--device cpu` runs them on the CPU),
and a config's `parallel:` block (`mesh: {data: N, model: M}`,
`state_sharding: zero1 | fsdp`) spreads `ddpm`, `kl_vae`, `vq`, `ldm`,
`ldm_inpaint` and `ldm_sr` over it; rank 0 writes the run's files. A
group of several ranks without the block, or with another task, exits
with 2 (or raises) rather than train the same run on every rank:

    torchrun --nproc-per-node 4 -m sd_tpu_torch.train --config runs/ldm_dp.json \
        --data imgs/ --out runs/ldm_dp
"""

from __future__ import annotations

import argparse
import json
import os
import sys


# the tasks whose trainers read a `parallel:` block (the others run on one process)
PARALLEL_TASKS = frozenset({"ddpm", "kl_vae", "vq", "ldm", "ldm_inpaint", "ldm_sr"})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sd_tpu_torch.train",
                                 description="Train a configuration on the GPU.")
    ap.add_argument("--config", required=True,
                    help="a config function's name or a .json / .yaml file")
    ap.add_argument("--data", required=True, help="image directory")
    ap.add_argument("--annotations", default=None, help="COCO captions json (ldm task)")
    ap.add_argument("--out", default=None, help="run directory (default runs/<task>)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; cuda:K to pin every rank to card K")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend under torchrun (default nccl on the "
                         "card, gloo on the CPU)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from sd_tpu_torch.parallel import multihost

    if multihost.initialize(backend=args.backend, device=args.device):
        rank, world = multihost.rank_and_world()
        print(f"[multihost] rank {rank}/{world} on {multihost.local_device()} "
              f"({dist.get_backend()})")
    try:
        return _train(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> int:
    from sd_tpu_torch.core.config import load_config
    from sd_tpu_torch.parallel import multihost
    from sd_tpu_torch.train import (distill, dreambooth, inpaint, runners, sr,
                                    textual_inversion)

    cfg = load_config(args.config)
    if args.annotations:
        cfg["annotation_file"] = args.annotations
    task = cfg.get("task")
    run = {"ddpm": runners.train_ddpm, "kl_vae": runners.train_kl_vae,
           "vq": runners.train_vq, "ldm": runners.train_ldm,
           "ldm_inpaint": inpaint.train_ldm_inpaint,
           "textual_inversion": textual_inversion.train_textual_inversion,
           "dreambooth": dreambooth.train_dreambooth,
           "distill": distill.distill_ldm, "ldm_sr": sr.train_ldm_sr}.get(task)
    if run is None:
        print(f"sd_tpu_torch.train: unknown task {task!r}", file=sys.stderr)
        return 2
    world = multihost.rank_and_world()[1]
    if world > 1 and task not in PARALLEL_TASKS:
        print(f"sd_tpu_torch.train: task {task!r} runs on one process (a `parallel:` block "
              f"is read by {sorted(PARALLEL_TASKS)}); this group has {world} ranks",
              file=sys.stderr)
        return 2
    out = args.out or f"runs/{task}"
    os.makedirs(out, exist_ok=True)
    if multihost.rank_and_world()[0] == 0:
        with open(os.path.join(out, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
    device = multihost.local_device() if args.device is None else args.device
    run(cfg, args.data, out_dir=out, max_steps=args.max_steps, device=device)
    print(f"[done] task={task} out={out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
