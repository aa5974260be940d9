"""Super-resolution sampling from the command line: `python -m sd_tpu_torch.sample_sr`.

Counterpart of `scripts/sample_sr.py`: LR images → the concat-conditioned
SR model (`train/sr.py super_resolve`) → the first-stage decode → one PNG
grid of the nearest-upsampled LR inputs, the SR outputs and, where the
inputs were full-size, the HR images, with PSNR and SSIM against them.
`--input` is a PNG or a directory of PNGs: full-size HR images degraded on
the host first (`--degrade`, bicubic by default, or a BSRGAN composite drawn
from `--seed`), or with `--degrade none` images that already are the LR
input. Weights are random from `--seed`, or a port run's (`--ckpt`: its
`ckpt/` directory; the EMA weights where it keeps them, and the run's
`calibration.json` under `scale_factor: auto`). Runs on the card unless
`--device cpu`.

    python -m sd_tpu_torch.sample_sr --config configs/ldm_sr_catdog.yaml \\
        --ckpt runs/ldmsr_catdog/ckpt --input imgs/ --out sr_samples.png
"""

from __future__ import annotations

import argparse
import os
import sys

from sd_tpu_torch.data.datasets import SR_DEGRADATIONS

DEGRADATIONS = (*SR_DEGRADATIONS, "none")

# the sampling generator's key after the seed: (seed, SAMPLE_KEY)
SAMPLE_KEY = 1


def degrade(images, how: str, sf: int, seed: int):
    """HR images in [-1, 1] → their LR images in [-1, 1], each degraded in
    [0, 1] in turn by `how`, the BSRGAN draws from one numpy generator
    seeded with `seed`."""
    import numpy as np

    from sd_tpu_torch.data.datasets import degrade_to_lr

    rng = np.random.default_rng(seed)
    return np.stack([np.clip(degrade_to_lr(im, how, sf, rng), 0, 1) * 2.0 - 1.0
                     for im in (images + 1.0) * 0.5]).astype(np.float32)


def main(argv: list[str] | None = None) -> int:
    from sd_tpu_torch.train.sr import SR_SAMPLERS

    ap = argparse.ArgumentParser(prog="python -m sd_tpu_torch.sample_sr",
                                 description="Super-resolution sampling on the GPU.")
    ap.add_argument("--config", required=True,
                    help="a config function's name or a .json / .yaml file")
    ap.add_argument("--ckpt", default=None, help="a run's ckpt/ directory (else random)")
    ap.add_argument("--input", required=True, help="a PNG or a directory of PNGs")
    ap.add_argument("--n", type=int, default=4, help="max images")
    ap.add_argument("--degrade", default="bicubic", choices=DEGRADATIONS,
                    help="degradation applied to --input to make the LR conditioning; "
                         "'none': the input already is the LR image")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sampler", default="ddim", choices=SR_SAMPLERS)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="sr_samples.png")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sd_tpu_torch.core.config import load_config, resolve_device
    from sd_tpu_torch.data.datasets import ImageFolderDataset, ImagePathsDataset
    from sd_tpu_torch.train.checkpoint import restore_tree, trained_weights
    from sd_tpu_torch.train.metrics import psnr, save_image_grid, ssim
    from sd_tpu_torch.train.runners import apply_calibration, copy_named_, step_generator
    from sd_tpu_torch.train.sr import build_ldm_sr, nearest_up, super_resolve

    cfg = load_config(args.config)
    lat, scfg = cfg["latent"], cfg.get("sample", {})
    steps = args.steps or scfg.get("num_steps", 50)
    eta = args.eta if args.eta is not None else scfg.get("eta", 0.0)
    sf = int(cfg.get("data", {}).get("sr", {}).get("sf", 4))
    hr_size = cfg["train"]["image_size"]
    device = resolve_device(args.device)

    ld, unet, _ = build_ldm_sr(cfg, torch.Generator(device).manual_seed(args.seed), device)
    if args.ckpt:
        copy_named_(dict(unet.named_parameters()), trained_weights(restore_tree(args.ckpt)),
                    f"SR UNet of {args.ckpt}")
        print(f"[sample_sr] restored {args.ckpt}")
    ld = apply_calibration(ld, cfg, args.ckpt)

    size = hr_size if args.degrade != "none" else hr_size // sf
    if os.path.isdir(args.input):
        ds = ImageFolderDataset(args.input, image_size=size, random_flip=False)
        items = [ds[i]["image"] for i in range(min(args.n, len(ds)))]
    else:
        items = [ImagePathsDataset([args.input], image_size=size)[0]["image"]]
    x = np.stack(items)
    hr = None if args.degrade == "none" else x
    lr = x if hr is None else degrade(x, args.degrade, sf, args.seed)

    sr = super_resolve(ld, lr, lat, num_steps=steps, eta=eta, sampler=args.sampler,
                       generator=step_generator(device, args.seed, SAMPLE_KEY))
    rows = [nearest_up(lr, hr_size), sr] + ([hr] if hr is not None else [])
    save_image_grid(np.concatenate(rows, axis=0), args.out, rows=len(rows))
    msg = f"[done] {sr.shape[0]} images -> {args.out}"
    if hr is not None:
        msg += f"  psnr={psnr(sr, hr):.2f} ssim={ssim(sr, hr):.3f}"
    print(msg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
