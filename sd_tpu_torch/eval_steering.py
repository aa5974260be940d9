"""Quantitative classifier-free-guidance evaluation of a trained
class-conditional LDM.

    python -m sd_tpu_torch.eval_steering --config ldm_32_catdog_cond \\
        --ckpt runs/ldm32_cond/ckpt --data images/ --classes cat dog \\
        --guidance-scales 1.0 3.0 6.0 --out runs/ldm32_cond/steering

Counterpart of `scripts/eval_steering.py`: trains the probe classifier
(`eval/classifier.py`) on the labelled real images (`ClassCaptionDataset`:
"cat.12.png" is a cat), restores the LDM of a `python -m sd_tpu_torch.train`
run (`restore_checkpoint` into a fresh train state, the EMA shadow where the
run keeps one, the `calibration.json` scale factor under `scale_factor:
auto`), samples it at each guidance scale with one prompt per class
(`data.template`), and reports the probe's accuracy and confidence on the
requested class (the steering score) and the surrogate CLIP Fréchet distance
of each sample batch to the real set (`eval/fid.py`, random ViT-B/32 weights
from seed 0). Appends one JSON row a scale to `<out>/steering.jsonl` and
writes each scale's grid PNG and its samples (`.npz`, fp16). Guidance steers
when the accuracy at a scale above 1 clears both chance and the scale-1 row.
Runs on the card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="a config name, .json or .yaml")
    ap.add_argument("--ckpt", required=True, help="the run's ckpt/ directory")
    ap.add_argument("--data", required=True, help="labelled real-image root")
    ap.add_argument("--classes", nargs="+", default=["cat", "dog"])
    ap.add_argument("--guidance-scales", type=float, nargs="+", default=[1.0, 3.0, 6.0])
    ap.add_argument("--per-class", type=int, default=8,
                    help="samples per class per guidance scale")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "dpm", "plms"],
                    help="dpm = DPM-Solver++(2M) (pair with --steps 15 against the "
                    "DDIM-50 rows); plms = 4th-order pseudo linear multistep")
    ap.add_argument("--guidance-rescale", type=float, default=0.0,
                    help="CFG std-rescale (arXiv:2305.08891)")
    ap.add_argument("--real-per-class", type=int, default=200,
                    help="real images per class for probe training")
    ap.add_argument("--probe-steps", type=int, default=400)
    ap.add_argument("--fid-batch", type=int, default=8)
    ap.add_argument("--no-fid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="steering_eval")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from sd_tpu_torch.core.config import load_config, resolve_device
    from sd_tpu_torch.data.datasets import ClassCaptionDataset
    from sd_tpu_torch.eval import (classifier_fn, clip_feature_fn, extract_features,
                                   frechet_distance, gaussian_stats, steering_score,
                                   train_image_classifier)
    from sd_tpu_torch.train.checkpoint import restore_checkpoint
    from sd_tpu_torch.train.diffusion import ddpm_optimizer, init_train_state
    from sd_tpu_torch.train.metrics import save_image_grid
    from sd_tpu_torch.train.runners import (apply_calibration, build_ldm, params_apply,
                                            step_generator)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    os.makedirs(args.out, exist_ok=True)
    pix = cfg["train"].get("image_size", 128)
    template = cfg.get("data", {}).get("template", "a photo of a {}")
    label_from = cfg.get("data", {}).get("label_from", "filename_prefix")

    # -- the labelled real set: the probe's training set and the FID reference --
    ds = ClassCaptionDataset(args.data, image_size=pix, random_flip=False,
                             label_from=label_from, template=template)
    by_class = {c: [] for c in args.classes}
    for i in range(len(ds)):
        lab = ds.label(i)
        if lab in by_class and len(by_class[lab]) < args.real_per_class:
            by_class[lab].append(i)
        if all(len(v) >= args.real_per_class for v in by_class.values()):
            break
    for c in args.classes:
        if not by_class[c]:
            raise SystemExit(f"no images labeled '{c}' under {args.data}")
    print({c: len(v) for c, v in by_class.items()}, "real images", flush=True)
    images = np.stack([ds[i]["image"] for c in args.classes for i in by_class[c]])
    images = images.astype(np.float32)
    labels = np.asarray([ci for ci, c in enumerate(args.classes) for _ in by_class[c]],
                        np.int64)

    # -- the probe --
    t0 = time.time()
    probe, pout = train_image_classifier(images, labels, num_classes=len(args.classes),
                                         steps=args.probe_steps, seed=args.seed,
                                         device=device)
    pfn = classifier_fn(probe, pout["params"])
    # the probe's own accuracy per class on its (small) training set, so that
    # a degenerate probe shows
    per_class_acc = {c: steering_score(pfn, images[labels == ci], ci)["accuracy"]
                     for ci, c in enumerate(args.classes)}
    print(f"probe trained in {time.time() - t0:.0f}s: final_acc={pout['final_acc']:.3f} "
          f"per-class={per_class_acc}", flush=True)

    # -- the LDM --
    ld, unet, _, clip = build_ldm(cfg, torch.Generator(device).manual_seed(args.seed),
                                  device=device)
    state = init_train_state(dict(unet.named_parameters()), ddpm_optimizer(1e-4),
                             num_timesteps=ld.schedule.num_timesteps)
    state = restore_checkpoint(args.ckpt, state)
    uparams = state.ema.shadow if state.ema is not None else state.params
    uparams = {n: s.to(state.params[n].dtype) for n, s in uparams.items()}
    ld = dataclasses.replace(apply_calibration(ld, cfg, args.ckpt),
                             unet_apply=params_apply(unet, uparams))
    lat = cfg["latent"]

    prompts = [template.format(c) for c in args.classes for _ in range(args.per_class)]
    target = np.repeat(np.arange(len(args.classes)), args.per_class)
    c_emb = clip(prompts)
    uc_emb = clip([""] * len(prompts))
    shape = (len(prompts), lat["image_size"], lat["image_size"], lat["channels"])

    feat_fn = None if args.no_fid else clip_feature_fn(seed=0, device=device)
    real_stats = None
    if feat_fn is not None:
        real_stats = gaussian_stats(extract_features(feat_fn, images, args.fid_batch))

    results = []
    log_path = os.path.join(args.out, "steering.jsonl")
    with open(log_path, "a") as log:
        for gs in args.guidance_scales:
            t0 = time.time()
            gen = step_generator(device, args.seed, int(gs * 1000))
            x_T = torch.randn(shape, generator=gen, device=device)
            with torch.no_grad():
                img = ld.sample(shape, x_T, cond={"c_crossattn": [c_emb]},
                                uncond={"c_crossattn": [uc_emb]}, guidance_scale=gs,
                                num_steps=args.steps, eta=0.0, generator=gen,
                                sampler=args.sampler, guidance_rescale=args.guidance_rescale)
            img = img.float().cpu().numpy()
            row = {"guidance_scale": gs, "steps": args.steps, "sampler": args.sampler,
                   "guidance_rescale": args.guidance_rescale,
                   "sample_seconds": round(time.time() - t0, 1)}
            for ci, c in enumerate(args.classes):
                s = steering_score(pfn, img[target == ci], ci)
                row[f"acc_{c}"] = round(s["accuracy"], 4)
                row[f"conf_{c}"] = round(s["confidence"], 4)
            row["acc_mean"] = round(float(np.mean([row[f"acc_{c}"] for c in args.classes])), 4)
            if feat_fn is not None:
                gf = extract_features(feat_fn, img, args.fid_batch)
                row["fid_surrogate"] = round(frechet_distance(*real_stats,
                                                              *gaussian_stats(gf)), 3)
            tag = ("" if args.sampler == "ddim" and args.steps == 50
                   else f"_{args.sampler}{args.steps}")
            if args.guidance_rescale:
                tag += f"_gr{args.guidance_rescale:g}"
            grid = os.path.join(args.out, f"samples_cfg{gs:g}{tag}.png")
            save_image_grid(img, grid, rows=len(args.classes))
            row["grid"] = grid
            # the raw samples (fp16), so that grids and metrics can be
            # recomputed without sampling again
            np.savez_compressed(os.path.join(args.out, f"samples_cfg{gs:g}{tag}.npz"),
                                samples=img.astype(np.float16), target=target,
                                classes=np.asarray(args.classes))
            print(row, flush=True)
            log.write(json.dumps(row) + "\n")
            log.flush()
            results.append(row)

    print(f"\nchance accuracy = {1.0 / len(args.classes):.3f}")
    for row in results:
        print(f"  cfg={row['guidance_scale']:<4} acc_mean={row['acc_mean']}"
              + (f" fid={row['fid_surrogate']}" if "fid_surrogate" in row else ""))
    print(f"[done] wrote {log_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
