"""Text-to-image sampling from the command line: `python -m sd_tpu_torch.sample`.

Counterpart of `scripts/sample.py`: prompts → CLIP → the sampler with CFG →
decode → one PNG grid, through `Text2ImagePipeline.generate`; for a
pixel-space DDPM config (`task: ddpm`) the UNet's ancestral sampling (or
DDIM with `--sampler ddim`) from x_T. Weights are random from the config's
seed, or a run's (`--ckpt`: its `ckpt/` directory, EMA weights where it
keeps them, as `Text2ImagePipeline.from_run` reads them); in the precision
of the config's `train.param_dtype`, else fp32. The grid is written by the
port's own PNG codec. Runs on the card unless `--device cpu`.

    python -m sd_tpu_torch.sample --config sd_v1 --prompt "a red cube" --steps 30

ControlNet: `--controlnet RUN --control-image FILE` (the image resized to
the output size with the bicubic filter, then `edge_hint` unless
`--control-extract none`; `--control-scale`). IP-Adapter: `--ip-adapter RUN
--ip-image FILE` (`--ip-scale`). Self-attention guidance: `--sag-scale`
(ddim). Each goes through `Text2ImagePipeline` (`load_controlnet`,
`load_ip_adapter`, `generate`); images are read by the port's PNG decoder.
"""

from __future__ import annotations

import argparse
import os
import sys

SAMPLERS = ("ddpm", "ddim", "dpm", "dpm_sde", "unipc", "plms", "euler", "euler_a", "heun",
            "lcm", "flow", "flow_midpoint")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sd_tpu_torch.sample",
                                 description="Text-to-image sampling on the GPU.")
    ap.add_argument("--config", required=True,
                    help="a config function's name or a .json / .yaml file")
    ap.add_argument("--prompt", default=[""], nargs="+",
                    help="text prompt(s) (ldm task; ignored for task: ddpm)")
    ap.add_argument("--sampler", default=None, choices=SAMPLERS,
                    help="ddpm task: ancestral (default) or ddim; ldm task: ddim "
                         "(default; flow for a flow model) or another of the "
                         "pipeline's samplers (lcm for a distilled student)")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--ckpt", default=None, help="a run's ckpt/ directory (else random)")
    ap.add_argument("--out", default="samples.png")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--guidance-scale", type=float, default=None)
    ap.add_argument("--guidance-rescale", type=float, default=0.0)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--sag-scale", type=float, default=0.0,
                    help="Self-Attention Guidance strength (typical 0.5-0.75, ddim only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    ap.add_argument("--controlnet", default=None,
                    help="a ControlNet run directory (ldm task): the controlled UNet")
    ap.add_argument("--ip-adapter", default=None,
                    help="an IP-Adapter run directory (ldm task); needs --ip-image")
    ap.add_argument("--ip-image", default=None, help="the image prompt (PNG) for --ip-adapter")
    ap.add_argument("--ip-scale", type=float, default=1.0)
    ap.add_argument("--control-image", default=None,
                    help="the conditioning image (PNG) for --controlnet; by default "
                         "edge_hint() extracts edges from it first")
    ap.add_argument("--control-extract", default="canny", choices=["canny", "none"],
                    help="hint extraction applied to --control-image ('none': the file "
                         "already is the hint map)")
    ap.add_argument("--control-scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    if args.controlnet and not args.control_image:
        print("sd_tpu_torch.sample: --controlnet needs --control-image", file=sys.stderr)
        return 2
    if args.controlnet and args.sag_scale > 0.0:
        print("sd_tpu_torch.sample: --sag-scale cannot combine with --controlnet (the SAG "
              "probe pass has no control branch)", file=sys.stderr)
        return 2
    if args.ip_adapter and not args.ip_image:
        print("sd_tpu_torch.sample: --ip-adapter needs --ip-image", file=sys.stderr)
        return 2

    import torch

    from sd_tpu_torch.core.config import load_config
    from sd_tpu_torch.data.image_io import write_png
    from sd_tpu_torch.train.metrics import make_grid, save_image_grid

    cfg = load_config(args.config)
    pd = cfg.get("train", {}).get("param_dtype")
    dtype = getattr(torch, pd) if pd else torch.float32
    if cfg.get("task") == "ddpm":
        img = _sample_ddpm(cfg, args, dtype)
        save_image_grid(img.float().cpu().numpy(), args.out)
        return 0

    from sd_tpu_torch.diffusion.flow import FlowProcess
    from sd_tpu_torch.img2img import load_pipeline

    pipe = load_pipeline(cfg, args.ckpt, dtype, args.device)
    prompts = args.prompt
    b = args.batch or len(prompts)
    if len(prompts) == 1 and b > 1:
        prompts = prompts * b
    sc = cfg.get("sample", {})
    steps = args.steps or sc.get("num_steps", 50)
    gs = args.guidance_scale if args.guidance_scale is not None else sc.get("guidance_scale",
                                                                             7.5)
    eta = args.eta if args.eta is not None else sc.get("eta", 0.0)
    sampler = args.sampler or ("flow" if isinstance(pipe.ld.process, FlowProcess)
                               else sc.get("sampler", "ddim"))
    adapters = {}
    if args.controlnet:
        from sd_tpu_torch.data.hints import edge_hint
        from sd_tpu_torch.data.image_io import read_rgb, resize

        pix = cfg["latent"]["image_size"] * pipe._vae_factor()
        im = resize(read_rgb(args.control_image), pix, pix, method="bicubic")
        hint = edge_hint(im) if args.control_extract == "canny" else im.astype("float32") / 255.0
        pipe.load_controlnet(args.controlnet, control_scale=args.control_scale)
        adapters["control_image"] = hint
    if args.ip_adapter:
        from sd_tpu_torch.data.image_io import read_rgb

        pipe.load_ip_adapter(args.ip_adapter, ip_scale=args.ip_scale)
        adapters["ip_image"] = read_rgb(args.ip_image)
    if args.sag_scale > 0.0:
        adapters["sag_scale"] = args.sag_scale
    images = pipe.generate(prompts, negative_prompt=args.negative_prompt, num_steps=steps,
                           guidance_scale=gs, eta=eta, seed=args.seed, sampler=sampler,
                           guidance_rescale=args.guidance_rescale, **adapters)
    write_png(args.out, make_grid(images))
    print(f"[done] wrote {args.out} ({len(prompts)} images, {steps} steps, cfg={gs}, "
          f"sampler={sampler})")
    return 0


def _sample_ddpm(cfg: dict, args, dtype):
    """A pixel-space DDPM config's samples in [-1, 1]: `sample.num_images`
    (or `--batch`) at `train.image_size`, x_T and every draw from one
    generator seeded with `--seed`."""
    import torch

    from sd_tpu_torch.core.config import resolve_device, split_dtype
    from sd_tpu_torch.core.schedules import DiffusionSchedule
    from sd_tpu_torch.diffusion.ddim import DDIMSampler
    from sd_tpu_torch.diffusion.ddpm import DDPMProcess
    from sd_tpu_torch.models.unet_ddpm import UNetDDPM
    from sd_tpu_torch.train.checkpoint import restore_tree
    from sd_tpu_torch.train.runners import copy_named_
    from sd_tpu_torch.weights import init_params_

    device = resolve_device(args.device)
    mp, compute = split_dtype(cfg["model"]["params"])
    model = UNetDDPM(**mp, dtype=dtype, compute_dtype=compute, device=device).eval()
    init_params_(model, torch.Generator(device).manual_seed(cfg.get("seed", 0)))
    if args.ckpt:
        tree = restore_tree(args.ckpt)
        ema = tree.get("ema")
        copy_named_(dict(model.named_parameters()),
                    ema["shadow"] if isinstance(ema, dict) and ema.get("shadow") is not None
                    else tree["params"], f"UNet of {args.ckpt}")
    diff = {k: v for k, v in cfg.get("diffusion", {}).items() if k != "min_snr_gamma"}
    sched = DiffusionSchedule.create(**diff).to(device)
    param = diff.get("parameterization", "eps")
    n = args.batch or cfg.get("sample", {}).get("num_images", 4)
    size = cfg["train"].get("image_size", 256)
    shape = (n, size, size, model.out_channels)
    gen = torch.Generator(device).manual_seed(args.seed)
    x_T = torch.randn(shape, generator=gen, device=device)
    fn = lambda x, t, c: model(x.to(dtype), t)
    with torch.no_grad():
        if args.sampler == "ddim":
            img = DDIMSampler(sched, parameterization=param).sample(
                fn, shape, x_T, num_steps=args.steps or 50,
                eta=args.eta if args.eta is not None else 0.0, generator=gen)
        else:
            img = DDPMProcess(sched, clip_denoised=True, parameterization=param).p_sample_loop(
                fn, shape, x_T, generator=gen)
    print(f"[done] wrote {args.out} ({n} images, task=ddpm, sampler={args.sampler or 'ddpm'})")
    return img


if __name__ == "__main__":
    sys.exit(main())
