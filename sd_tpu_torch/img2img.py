"""img2img / inpainting from the command line: `python -m sd_tpu_torch.img2img`.

Counterpart of `scripts/img2img.py`: an init image (and optionally a keep
mask: white pixels kept, black regenerated) → its latent re-noised to
`--strength`·`--steps` → the CFG DDIM decode (with a mask, the DDIM
inpainting blend) → a PNG, through `Text2ImagePipeline.img2img`. The init
image is resized (bicubic) to the config's image size, the mask converted
to gray and resized (nearest) to the latent grid, as the TPU package's
script does; both are read, and the result written, by the port's own PNG
codec. fp32 weights, random from the config's seed, or a `train_ldm` run's
(`--ckpt`: its `ckpt/` directory, read as `Text2ImagePipeline.from_run`
reads it). Runs on the card unless `--device cpu`.

    python -m sd_tpu_torch.img2img --config sd_v1 --init-image in.png \\
        --prompt "oil painting" --strength 0.6 --out out.png
    python -m sd_tpu_torch.img2img ... --mask mask.png
"""

from __future__ import annotations

import argparse
import os
import sys


def load_pipeline(cfg: dict, ckpt: str | None, param_dtype, device):
    """The pipeline of `cfg`: random weights, or the run whose `ckpt/`
    directory `ckpt` names."""
    from sd_tpu_torch.pipeline import Text2ImagePipeline

    if ckpt:
        return Text2ImagePipeline.from_run(cfg, os.path.dirname(ckpt.rstrip("/")),
                                           param_dtype=param_dtype, device=device)
    return Text2ImagePipeline(cfg, device=device, param_dtype=param_dtype)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sd_tpu_torch.img2img",
                                 description="img2img / inpainting on the GPU.")
    ap.add_argument("--config", required=True,
                    help="a config function's name or a .json / .yaml file")
    ap.add_argument("--init-image", required=True, help="PNG")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--mask", default=None, help="inpaint mask PNG (white = keep)")
    ap.add_argument("--strength", type=float, default=0.75,
                    help="0..1 fraction of the schedule to re-noise")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance-scale", type=float, default=7.5)
    ap.add_argument("--ckpt", default=None, help="a train_ldm run's ckpt/ directory")
    ap.add_argument("--out", default="img2img.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    args = ap.parse_args(argv)

    import torch

    from sd_tpu_torch.core.config import load_config
    from sd_tpu_torch.data.image_io import read_rgb, resize, to_gray, write_png
    from sd_tpu_torch.train.metrics import make_grid

    cfg = load_config(args.config)
    pipe = load_pipeline(cfg, args.ckpt, torch.float32, args.device)
    lat = cfg["latent"]
    size = lat["image_size"] * (cfg["train"].get("image_size", 512) // lat["image_size"]
                                if "train" in cfg else 8)
    init = resize(read_rgb(args.init_image), size, size, "bicubic")[None]
    mask = None
    if args.mask:
        from sd_tpu_torch.data.image_io import decode_png

        with open(args.mask, "rb") as f:
            gray = to_gray(decode_png(f.read()))[..., None]
        mask = resize(gray, lat["image_size"], lat["image_size"], "nearest")[None, ..., 0]
    out = pipe.img2img([args.prompt], init, strength=args.strength,
                       negative_prompt=args.negative_prompt, num_steps=args.steps,
                       guidance_scale=args.guidance_scale, seed=args.seed, mask=mask)
    write_png(args.out, make_grid(out))
    t_start = max(1, min(int(args.strength * args.steps), args.steps))
    print(f"[done] wrote {args.out} (strength={args.strength}, "
          f"t_start={t_start}/{args.steps}, mask={'yes' if args.mask else 'no'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
