#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sd_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    nvcc builds of every kernel from `sd_tpu_torch/csrc`, in parallel;
  kernel   each hand-written kernel at every shape the 512² text-to-image and
           training paths give it (plus a ragged case), against its plain PyTorch version
           computed in fp32 from the same bf16 inputs: max|Δ| ≤ 1e-2·max|ref|
           (bf16 output rounding at 2^-8 plus p rounded to bf16); the flash
           training kernels: lse2 within 1e-3 absolute, dq/dk/dv within
           2e-2·max|ref| and ‖Δ‖₂ ≤ 1e-2·‖ref‖₂ (p and dS round to bf16, sums
           over up to 4096 rows), and dK/dV bitwise equal on a second run;
           with the kernel's, the plain version's and one PyTorch library
           call's time (CUDA events) and the least time the card could take
           (bound);
  parity   the SD-v1-width UNet (latent 32², batch 2) and KL-f8 decoder
           (latent 32²) with every parameter random: bf16 with the kernels on
           the card against fp32 plain on the CPU, same (bf16-rounded) weights
           and inputs, relative-error bounds stated below;
  e2e      Text2ImagePipeline(sd_v1_config()) with every weight random from a
           seed: generate() of 2 prompts, 512², 50 DDIM steps, CFG 7.5; checks
           the uint8 [2, 512, 512, 3] output, a finite and non-constant image
           before quantisation, and the kernels' launch counts on that run.
  train_parity  the SD-v1-width UNet (latent 32², batch 1: level 0 has 1024
           tokens and trains through the flash kernels) under a training step,
           MSE to a fixed target: bf16 with the kernels on the card against
           fp32 plain on the CPU, same (bf16-rounded) weights; the global
           gradient and each level-0 attn1 q/k/v weight gradient within
           ‖Δg‖₂ ≤ 0.1·‖g‖₂ (a dropped gradient reads ≈ 1.0);
  train    train_ldm(sd512_train_config()) at full width, every weight random
           from the config's seed, on seeded uint8-range 512² images with
           class captions: 1 warm-up and 3 timed optimizer steps (batch 4 as
           4 microbatches, bf16 params, fp32 Adam moments and EMA, remat
           "dots"); checks finite losses, grad_norm > 0, changed bf16 params,
           fp32 moments and a moved fp32 EMA shadow, and the launch counts.
  profile  (only with `--profile`) the layers' times and the device time of
           one generate by kernel family, against its wall time, and the same
           for one optimizer step of train_ldm.
Then the kernel table as one JSON line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero; without
a CUDA device, or without the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# peak rates of one H100 SXM (dense bf16 tensor cores, HBM3)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# launches of one generate() at 512², 50 steps: 10 self-attention and 10
# GEGLU calls per UNet step, the decoder's mid-block attention and 18 convs
EXPECTED_LAUNCHES = {"flash_attention": 1, "flash_attention_hpacked": 500,
                     "flash_attention_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                     "geglu_ff": 500, "conv3x3_same": 18}
# launches of one optimizer step of train_ldm(sd512_train_config()): 10
# self-attentions (UNet levels 0 and 1) per microbatch forward, again in the
# remat recompute, one dQ and one dK/dV each in backward, 4 microbatches
# (tests/test_torch_structure.py derives these from the shape rules)
EXPECTED_TRAIN_LAUNCHES = {"flash_attention": 0, "flash_attention_hpacked": 0,
                           "flash_attention_lse": 80, "flash_bwd_dq": 40,
                           "flash_bwd_dkv": 40, "geglu_ff": 0, "conv3x3_same": 0}
KERNEL_TOL = 1e-2
LSE_TOL = 1e-3                                   # absolute, base-2 units
GRAD_TOL = {"max_rel": 2e-2, "l2_rel": 1e-2}     # flash dq, dk, dv
UNET_TOL = {"max_rel": 0.1, "l2_rel": 0.03}      # stated before measuring
DECODER_TOL = {"max_rel": 0.1, "l2_rel": 0.03}
TRAIN_GRAD_TOL = 0.1                             # ‖Δg‖₂ / ‖g‖₂, stated before measuring
TRAIN_STEPS = 3                                  # timed, after one warm-up step


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(flops: int, nbytes: int) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# operations and bytes each kernel's work needs (inputs read once, outputs
# written once), for its bound
def attention_cost(b, sq, skv, h, d):
    return 4 * b * h * sq * skv * d, 2 * b * h * d * (2 * sq + 2 * skv)


def attention_lse_cost(b, sq, skv, h, d):
    return 4 * b * h * sq * skv * d, b * h * (2 * d * (2 * sq + 2 * skv) + 4 * sq)


def attention_dq_cost(b, sq, skv, h, d):
    # reads q, k, v, o, dO, lse2; writes dq, delta
    return 6 * b * h * sq * skv * d, b * h * (2 * d * (4 * sq + 2 * skv) + 8 * sq)


def attention_dkv_cost(b, sq, skv, h, d):
    # reads q, k, v, dO, lse2, delta; writes dk, dv
    return 8 * b * h * sq * skv * d, b * h * (2 * d * (2 * sq + 4 * skv) + 8 * sq)


def geglu_cost(n, c, inner):
    return 6 * n * c * inner, 2 * (2 * n * c + 3 * c * inner + 2 * inner + c)


def conv3x3_cost(b, h, w, c, o):
    return 18 * b * h * w * c * o, 2 * (b * h * w * (c + o) + 9 * c * o + o)


def time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(out, ref) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def l2_rel(out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


# ---------------------------------------------------------------------------


def kernel_cases(gen):
    """One case per main-path shape of every kernel: callables for the
    kernel, its plain version (bf16 in), the fp32 reference and the library
    call, with the operations and bytes the work needs."""
    import torch
    import torch.nn.functional as F

    from sd_tpu_torch.kernels import conv2d, flash_attention as fa, geglu

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    cases = []
    # row 3: UNet self-attention, projection-native [2B, S, H·D], B = 2
    for S, H, D in ((4096, 8, 40), (1024, 8, 80)):
        q, k, v = (rnd(4, S, H * D) for _ in range(3))
        split = lambda t, S=S, H=H, D=D: t.view(4, S, H, D)
        heads = lambda t, split=split: split(t).transpose(1, 2)
        cases.append(dict(
            name="flash_attention_hpacked", shape=[4, S, H * D, H],
            kernel=lambda q=q, k=k, v=v, H=H: fa.flash_attention_hpacked(q, k, v, H),
            plain=lambda q=q, k=k, v=v, s=split, D=D: fa._xla_ref(s(q), s(k), s(v), D**-0.5),
            ref=lambda q=q, k=k, v=v, s=split, D=D: fa._xla_ref(
                s(q).float(), s(k).float(), s(v).float(), D**-0.5),
            library=lambda q=q, k=k, v=v, h=heads: F.scaled_dot_product_attention(h(q), h(k), h(v)),
            view=lambda o, s=split: s(o),
            cost=attention_cost(4, S, S, H, D)))
    # row 1: VAE mid-block single-head attention [B, 4096, 1, 512], B = 2,
    # and a ragged-kv case (kv not a multiple of the 64-row kv tile)
    for B, S, Skv in ((2, 4096, 4096), (1, 512, 700)):
        q, k, v = rnd(B, S, 1, 512), rnd(B, Skv, 1, 512), rnd(B, Skv, 1, 512)
        heads = lambda t: t.transpose(1, 2)
        cases.append(dict(
            name="flash_attention", shape=[B, S, Skv, 1, 512],
            kernel=lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v: fa._xla_ref(q, k, v, 512**-0.5),
            ref=lambda q=q, k=k, v=v: fa._xla_ref(q.float(), k.float(), v.float(), 512**-0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)),
            view=lambda o: o,
            cost=attention_cost(B, S, Skv, 1, 512)))
    # row 7: GEGLU at UNet levels 0 and 1, tokens = 2B·S
    for N, C in ((16384, 320), (4096, 640)):
        I = 4 * C
        x = rnd(N, C)
        w1, b1 = rnd(2 * I, C, scale=C**-0.5), rnd(2 * I, scale=0.1)
        w2, b2 = rnd(C, I, scale=I**-0.5), rnd(C, scale=0.1)
        args = (x, w1, b1, w2, b2)
        cases.append(dict(
            name="geglu_ff", shape=[N, C, I],
            kernel=lambda a=args: geglu.geglu_ff(*a),
            plain=lambda a=args: geglu._geglu_xla(*a),
            ref=lambda a=args: geglu._geglu_xla(*(t.float() for t in a)),
            library=None, view=lambda o: o,
            cost=geglu_cost(N, C, I)))
    # row 8: the decoder's ResnetBlock convs at 128², 256², 512², B = 2
    for Hs, C, O in ((128, 512, 512), (256, 512, 256), (256, 256, 256),
                     (512, 256, 128), (512, 128, 128)):
        x = rnd(2, Hs, Hs, C)
        w = rnd(O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        b = rnd(O, scale=0.1)
        cases.append(dict(
            name="conv3x3_same", shape=[2, Hs, Hs, C, O],
            kernel=lambda x=x, w=w, b=b: conv2d.conv3x3_same(x, w, b),
            plain=lambda x=x, w=w, b=b: conv2d._xla_conv3x3(x, w, b),
            ref=lambda x=x, w=w, b=b: conv2d._xla_conv3x3(x.float(), w.float(), b.float()),
            library=lambda x=x, w=w, b=b: F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1),
            view=lambda o: o,
            cost=conv3x3_cost(2, Hs, Hs, C, O)))
    return cases


def phase_kernels(gen) -> dict:
    import torch

    best = {}
    for case in kernel_cases(gen):
        out = case["view"](case["kernel"]())
        torch.cuda.synchronize()
        ref = case["ref"]()
        err, rel = rel_err(out, ref)
        del ref
        b_ms, b_by = bound_ms(*case["cost"])
        row = {
            "phase": "kernel", "name": case["name"], "shape": case["shape"],
            "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(case["kernel"]), "plain_ms": time_ms(case["plain"], 3),
            "library_ms": (time_ms(case["library"]) if case["library"] else None),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        require(rel <= KERNEL_TOL, f"{case['name']} {case['shape']}: max|Δ| = "
                f"{rel:.3g}·max|ref| > {KERNEL_TOL}")
        # the kernel table reports each kernel at its heaviest main-path shape
        if case["name"] not in best or case["cost"][0] > best[case["name"]][0]:
            best[case["name"]] = (case["cost"][0], row)
        torch.cuda.empty_cache()
    return {name: row for name, (_, row) in best.items()}


def phase_train_kernels(gen) -> dict:
    """The flash training kernels (LSE forward, dQ, dK/dV) at the training
    path's self-attention shapes ([1, 4096, 8, 40] at UNet level 0,
    [1, 1024, 8, 80] at level 1, microbatch 1) and a ragged case, against
    their plain versions in fp32 from the same bf16 inputs; dK/dV run twice
    must give the same bits. Library: `scaled_dot_product_attention`, its
    forward for the LSE row and its backward (fwd+bwd − fwd) for the dQ and
    dK/dV rows together."""
    import torch
    import torch.nn.functional as F

    from sd_tpu_torch.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    best = {}
    for b, sq, skv, h, d in ((1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80),
                             (1, 1000, 1300, 8, 40)):
        scale = d**-0.5
        q, k, v, do = rnd(b, sq, h, d), rnd(b, skv, h, d), rnd(b, skv, h, d), rnd(b, sq, h, d)
        f32 = lambda *ts: [t.float() for t in ts]
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa._flash_lse_ref(*f32(q, k, v), scale)
        dq_ref, dk_ref, dv_ref, _ = fa._flash_bwd_ref(*f32(q, k, v, o), lse, do.float(), scale)
        errs = {"o": rel_err(o, o_ref), "dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref),
                "dv": rel_err(dv, dv_ref)}
        l2 = {"dq": l2_rel(dq, dq_ref), "dk": l2_rel(dk, dk_ref), "dv": l2_rel(dv, dv_ref)}
        lse_err = (lse - lse_ref).abs().max().item()
        deterministic = torch.equal(dk, dk2) and torch.equal(dv, dv2)
        del o_ref, lse_ref, dq_ref, dk_ref, dv_ref, dk2, dv2

        heads = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        do_h = do.transpose(1, 2)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(*heads))
        lib_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*heads), heads, do_h))
        shape = [b, sq, skv, h, d]
        rows = {
            "flash_attention_lse": dict(
                max_abs_err=errs["o"][0], rel_err=errs["o"][1], lse_abs_err=lse_err,
                ms=time_ms(lambda: fa.flash_attention_lse(q, k, v, scale)),
                plain_ms=time_ms(lambda: fa._flash_lse_ref(q, k, v, scale), 3),
                library_ms=lib_fwd, library_call="scaled_dot_product_attention forward",
                cost=attention_lse_cost(*shape)),
            "flash_bwd_dq": dict(
                max_abs_err=errs["dq"][0], rel_err=errs["dq"][1], l2_rel=l2["dq"],
                ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, scale)),
                plain_ms=time_ms(lambda: fa._flash_bwd_dq_ref(q, k, v, o, lse, do, scale), 3),
                library_ms=lib_both - lib_fwd,
                library_call="scaled_dot_product_attention backward (fwd+bwd - fwd), "
                             "dq and dk/dv together",
                cost=attention_dq_cost(*shape)),
            "flash_bwd_dkv": dict(
                max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                rel_err=max(errs["dk"][1], errs["dv"][1]), l2_rel=max(l2["dk"], l2["dv"]),
                deterministic=deterministic,
                ms=time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)),
                plain_ms=time_ms(lambda: fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale), 3),
                library_ms=lib_both - lib_fwd,
                library_call="scaled_dot_product_attention backward (fwd+bwd - fwd), "
                             "dq and dk/dv together",
                cost=attention_dkv_cost(*shape)),
        }
        for name, r in rows.items():
            cost = r.pop("cost")
            b_ms, b_by = bound_ms(*cost)
            row = {"phase": "kernel", "name": name, "shape": shape, **r,
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            if name not in best or cost[0] > best[name][0]:
                best[name] = (cost[0], row)
        require(errs["o"][1] <= KERNEL_TOL and lse_err <= LSE_TOL,
                f"LSE forward {shape}: o {errs['o'][1]:.3g}·max|ref|, lse2 {lse_err:.3g}")
        for g in ("dq", "dk", "dv"):
            require(errs[g][1] <= GRAD_TOL["max_rel"] and l2[g] <= GRAD_TOL["l2_rel"],
                    f"{g} {shape}: max {errs[g][1]:.3g}·max|ref|, l2 {l2[g]:.3g}·‖ref‖")
        require(deterministic, f"dK/dV {shape} gives the same bits twice")
        del q, k, v, do, o, lse, dq, delta, dk, dv, heads
        torch.cuda.empty_cache()
    return {name: row for name, (_, row) in best.items()}


def _parity(name, build, inputs_fn, run, tol, gen_cpu):
    """bf16 + kernels on the card vs fp32 plain on the CPU, same weights."""
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.weights import randomize_params_

    cpu = build(torch.float32, "cpu")
    randomize_params_(cpu, gen_cpu)
    with torch.no_grad():
        for p in cpu.parameters():  # the card's weights are these, in bf16
            p.copy_(p.bfloat16().float())
    gpu = build(torch.bfloat16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    inputs = inputs_fn()
    kernels.reset_launches()
    with torch.no_grad():
        out = run(gpu, *(t.cuda().bfloat16() if t.is_floating_point() else t.cuda()
                         for t in inputs))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        ref = run(cpu, *inputs)
        cpu_s = time.perf_counter() - t0
    out = out.float().cpu()
    d = out - ref
    max_rel = (d.abs().max() / ref.abs().max()).item()
    l2_rel = (d.norm() / ref.norm()).item()
    emit({"phase": "parity", "model": name, "shape": list(out.shape),
          "max_rel": max_rel, "l2_rel": l2_rel, "bound": tol,
          "launches": launches, "cpu_seconds": cpu_s})
    require(bool(torch.isfinite(out).all()) and max_rel <= tol["max_rel"]
            and l2_rel <= tol["l2_rel"], f"{name} parity within {tol}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return launches


def phase_parity() -> None:
    import torch

    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.models.autoencoder import AutoencoderKL
    from sd_tpu_torch.models.unet_sd import UNetModel

    cfg = sd_v1_config()
    g = torch.Generator().manual_seed(1)
    rounded = lambda t: t.bfloat16().float()

    def unet_inputs():
        return (rounded(torch.randn(2, 32, 32, 4, generator=g)),
                torch.tensor([999, 501]),
                rounded(torch.randn(2, 77, 768, generator=g)))

    launches = _parity(
        "unet", lambda dt, dev: UNetModel(**cfg["unet"]["params"], dtype=dt, device=dev),
        unet_inputs, lambda m, x, t, c: m(x, t, c), UNET_TOL, g)
    # latent 32² puts 1024 tokens through level 0: both UNet kernels run
    require(launches["flash_attention_hpacked"] == 5 and launches["geglu_ff"] == 5,
            f"UNet parity launches {launches}")

    launches = _parity(
        "decoder", lambda dt, dev: AutoencoderKL(**cfg["first_stage"]["params"],
                                                 dtype=dt, device=dev),
        lambda: (rounded(torch.randn(1, 32, 32, 4, generator=g)),),
        lambda m, z: m.decode(z), DECODER_TOL, g)
    require(launches["flash_attention"] == 1 and launches["conv3x3_same"] == 12,
            f"decoder parity launches {launches}")


def phase_e2e() -> dict:
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.pipeline import Text2ImagePipeline, to_uint8
    from sd_tpu_torch.weights import randomize_params_

    t0 = time.perf_counter()
    pipe = Text2ImagePipeline(sd_v1_config())
    gen = torch.Generator("cuda").manual_seed(0)
    for module in (pipe.unet, pipe.vae, pipe.clip):
        randomize_params_(module, gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = ["a photograph of an astronaut riding a horse",
               "a watercolor painting of a lighthouse at dusk"]
    pipe.generate(prompts, num_steps=2)          # warm-up, not counted

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe.generate(prompts, num_steps=50, guidance_scale=7.5, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    # the same run's image before quantisation: same seed, same noise
    g = torch.Generator("cuda").manual_seed(0)
    x_T = torch.randn((2,) + pipe.latent_shape, generator=g, device="cuda")
    pre = pipe.sample(prompts, x_T, num_steps=50, guidance_scale=7.5, generator=g)
    pre32 = pre.float()
    row = {"phase": "e2e", "images": list(images.shape), "dtype": str(images.dtype),
           "seconds_per_generate": secs, "images_per_second": len(prompts) / secs,
           "pipeline_build_seconds": build_s, "launches": launches,
           "pre_quant_min": pre32.min().item(), "pre_quant_max": pre32.max().item(),
           "pre_quant_std": pre32.std().item(),
           "uint8_mismatch_vs_rerun": int((to_uint8(pre) != images).sum()),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    require(images.shape == (2, 512, 512, 3) and images.dtype.name == "uint8",
            f"uint8 [2, 512, 512, 3] images, got {images.dtype} {images.shape}")
    require(bool(torch.isfinite(pre32).all()), "finite image before quantisation")
    require(pre32.std().item() > 0 and images.std() > 0, "non-constant image")
    total = launches["flash_attention"] + launches["flash_attention_hpacked"]
    require(launches == EXPECTED_LAUNCHES and total == 501,
            f"launches {launches} == {EXPECTED_LAUNCHES}")
    return launches, pipe, prompts


def phase_train_parity() -> dict:
    """Gradients of the full-width UNet through the flash training kernels:
    bf16 on the card against fp32 plain on the CPU, same bf16-rounded
    weights, inputs and target, inside a training step's context."""
    import math
    import re

    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.kernels.conv2d import training_trace
    from sd_tpu_torch.models.unet_sd import UNetModel
    from sd_tpu_torch.weights import randomize_params_

    params = sd_v1_config()["unet"]["params"]
    g = torch.Generator().manual_seed(2)
    rounded = lambda t: t.bfloat16().float()
    cpu = UNetModel(**params, dtype=torch.float32, device="cpu")
    randomize_params_(cpu, g)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(rounded(p))
    gpu = UNetModel(**params, dtype=torch.bfloat16, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x, ctx = rounded(torch.randn(1, 32, 32, 4, generator=g)), rounded(torch.randn(1, 77, 768, generator=g))
    t, target = torch.tensor([500]), torch.randn(1, 32, 32, 4, generator=g)

    def run(model, dev, dtype):
        model.requires_grad_(True)
        with training_trace():
            out = model(x.to(dev, dtype), t.to(dev), ctx.to(dev, dtype))
            loss = ((out.float() - target.to(dev)) ** 2).mean()
            loss.backward()
        return loss.item(), {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    kernels.reset_launches()
    loss_gpu, g_gpu = run(gpu, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    loss_cpu, g_cpu = run(cpu, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    d2 = sum(((g_gpu[n] - g_cpu[n]) ** 2).sum().item() for n in g_cpu)
    n2 = sum((g_cpu[n] ** 2).sum().item() for n in g_cpu)
    level0 = re.compile(r"^(in|out)_0_\d_attn\.block_0\.attn1\.to_[qkv]\.weight$")
    per = {n: l2_rel(g_gpu[n], g_cpu[n]) for n in g_cpu if level0.match(n)}
    row = {"phase": "train_parity", "latent": [1, 32, 32, 4], "loss_gpu": loss_gpu,
           "loss_cpu": loss_cpu, "grad_l2_rel": math.sqrt(d2 / n2), "attn1_qkv_l2_rel": per,
           "bound": TRAIN_GRAD_TOL, "launches": launches, "cpu_seconds": cpu_s}
    emit(row)
    require(len(per) == 15, f"15 level-0 attn1 q/k/v weights, found {sorted(per)}")
    require(math.isfinite(loss_gpu) and row["grad_l2_rel"] <= TRAIN_GRAD_TOL
            and max(per.values()) <= TRAIN_GRAD_TOL,
            f"UNet gradients within {TRAIN_GRAD_TOL}: global {row['grad_l2_rel']:.3g}, "
            f"attn1 q/k/v up to {max(per.values()):.3g}")
    # latent 32²: level 0 has 1024 tokens (5 self-attentions), level 1 256
    require(launches["flash_attention_lse"] == 5 and launches["flash_bwd_dq"] == 5
            and launches["flash_bwd_dkv"] == 5 and launches["flash_attention_hpacked"] == 0
            and launches["geglu_ff"] == 0, f"train parity launches {launches}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return row


def _train_batches(cfg, n: int, seed: int = 0):
    """n batches of the config's size: uint8-range images scaled to [-1, 1],
    as the image loaders give them, with class captions."""
    import numpy as np

    tc = cfg["train"]
    rng = np.random.default_rng(seed)
    classes = ("cat", "dog")
    for _ in range(n):
        img = rng.integers(0, 256, (tc["batch_size"], tc["image_size"], tc["image_size"], 3),
                           dtype=np.uint8)
        labels = rng.integers(0, len(classes), tc["batch_size"])
        yield {"image": img.astype(np.float32) / 127.5 - 1.0,
               "txt_raw": [cfg["data"]["template"].format(classes[i]) for i in labels]}


def phase_train() -> dict:
    """train_ldm(sd512_train_config()) at full width: 1 warm-up and
    TRAIN_STEPS timed optimizer steps, launch counts over the whole run."""
    import math

    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import sd512_train_config
    from sd_tpu_torch.train.runners import build_ldm, train_ldm

    cfg = sd512_train_config()
    steps = 1 + TRAIN_STEPS
    # the weights train_ldm starts from: the same build from the same seed
    _, unet, _, _ = build_ldm(cfg, torch.Generator("cuda").manual_seed(cfg["seed"]),
                              torch.bfloat16, "cuda")
    init = {n: p.detach().cpu() for n, p in unet.named_parameters()}
    del unet
    torch.cuda.empty_cache()

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = train_ldm(cfg, _train_batches(cfg, steps), max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    changed = sum(int((p.detach().cpu() != init[n]).sum()) for n, p in state.params.items())
    moments = state.opt_state.mu + state.opt_state.nu
    ema_moved = sum(int((s.cpu() != init[n].float()).sum()) for n, s in state.ema.shadow.items())
    timed = [r["seconds"] for r in hist[1:]]
    sec = sum(timed) / len(timed)
    bsz = cfg["train"]["batch_size"]
    row = {"phase": "train", "steps": len(hist), "timed_step_seconds": timed,
           "seconds_per_step": sec, "images_per_second": bsz / sec,
           "run_seconds": run_s, "peak_memory_gb": peak_gb,
           "losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
           "params": sum(p.numel() for p in state.params.values()),
           "param_elements_changed": changed, "ema_elements_moved": ema_moved,
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()}}
    emit(row)
    require(len(hist) == steps, f"{steps} optimizer steps, ran {len(hist)}")
    require(all(math.isfinite(r["loss"]) and r["grad_norm"] > 0 and math.isfinite(r["grad_norm"])
                for r in hist), "finite loss and grad_norm > 0 on every step")
    require(all(p.dtype == torch.bfloat16 for p in state.params.values()) and changed > 0,
            "bf16 params that changed")
    require(all(m.dtype == torch.float32 for m in moments)
            and any(bool(m.abs().sum() > 0) for m in state.opt_state.mu), "fp32 Adam moments")
    require(all(s.dtype == torch.float32 for s in state.ema.shadow.values()) and ema_moved > 0,
            "an fp32 EMA shadow that moved")
    want = {k: v * steps for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    require(launches == want, f"train launches {launches} == {want}")
    del state
    torch.cuda.empty_cache()
    return row


def _family(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name and "true>" in name:
        return "flash LSE forward (port)"
    for key, fam in (("flash_fwd_kernel", "flash (port)"), ("flash_bwd_dq", "flash dQ (port)"),
                     ("flash_bwd_dkv", "flash dK/dV (port)"), ("geglu_kernel", "geglu (port)"),
                     ("conv3x3_kernel", "conv3x3 (port)")):
        if key in name:
            return fam
    if "conv" in low or "fprop" in low or "cudnn" in low:
        return "conv (cuDNN)"
    if "gemm" in low or "cutlass" in low or "matmul" in low:
        return "matmul (cuBLAS)"
    if "reduce" in low or "norm" in low:
        return "reductions"
    return "elementwise/other"


def phase_profile(pipe, prompts) -> None:
    """Where one generate's time goes (`--profile`): the layers' times from
    CUDA events, and device time by kernel family from torch.profiler over
    a whole 50-step generate, against its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    c, uc = pipe.encode_prompts(prompts)
    ctx = torch.cat([uc, c])
    x = torch.randn((4,) + pipe.latent_shape, device="cuda").bfloat16()
    t = torch.full((4,), 501, device="cuda")
    z = torch.randn((2,) + pipe.latent_shape, device="cuda").bfloat16()
    with torch.no_grad():
        layers = {"clip_ms": time_ms(lambda: pipe.encode_prompts(prompts)),
                  "unet_call_ms": time_ms(lambda: pipe.unet(x, t, ctx)),
                  "decode_ms": time_ms(lambda: pipe.vae.decode(z), 3)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(prompts, num_steps=50, guidance_scale=7.5, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit({"phase": "profile", "of": "generate", "layers": layers,
          **_device_breakdown(prof, wall)})


def _device_breakdown(prof, wall: float) -> dict:
    """Device time by kernel family and the top kernels of a profile,
    against the wall time of the profiled window."""
    from collections import Counter

    import torch

    fam_us, kernels = Counter(), []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if us <= 0:
            continue
        fam_us[_family(ev.key)] += us
        kernels.append((us, ev.count, ev.key[:90]))
    device_s = sum(fam_us.values()) / 1e6
    kernels.sort(reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.self_cpu_time_total > 0), reverse=True)
    return {"wall_seconds": wall, "device_seconds": device_s,
            "device_busy_share": device_s / wall,
            "kernel_launches": sum(cnt for _, cnt, _ in kernels),
            "families_ms": {k: v / 1e3 for k, v in fam_us.most_common()},
            "top_kernels": [{"name": n, "ms": us / 1e3, "count": cnt}
                            for us, cnt, n in kernels[:15]],
            "top_host_ops": [{"name": n[:60], "self_ms": us / 1e3, "count": cnt}
                             for us, cnt, n in host[:12]]}


def phase_train_profile() -> None:
    """Where one optimizer step of train_ldm goes (`--profile`): the second
    step of a two-step run under torch.profiler, by kernel family. The
    profiler starts when train_ldm asks for the second batch, which it does
    once the first step's results are read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sd_tpu_torch.core.config import sd512_train_config
    from sd_tpu_torch.train.runners import train_ldm

    cfg = sd512_train_config()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = []

    def batches():
        first, second = _train_batches(cfg, 2, seed=1)
        yield first
        torch.cuda.synchronize()
        prof.start()
        start.append(time.perf_counter())
        yield second

    _, hist = train_ldm(cfg, batches(), max_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start[0]
    prof.stop()
    emit({"phase": "profile", "of": "optimizer step", "step_seconds": hist[1]["seconds"],
          "layers": _train_layers(cfg), **_device_breakdown(prof, wall)})


def _train_layers(cfg) -> dict:
    """CUDA-event times of the parts of one optimizer step, built from the
    same public pieces train_ldm uses: the fp32 KL encode of one image, the
    UNet forward + remat recompute + backward of one microbatch, the CLIP
    embedding of the batch's captions, and clip + Adam and the EMA update
    over the UNet's parameters."""
    import torch

    from sd_tpu_torch.core.ema import ema_update
    from sd_tpu_torch.kernels.conv2d import training_trace
    from sd_tpu_torch.train.diffusion import (ddpm_optimizer, float32_moments,
                                              init_train_state)
    from sd_tpu_torch.train.remat import remat_apply
    from sd_tpu_torch.train.runners import build_ldm

    tc = cfg["train"]
    ld, unet, vae, embed = build_ldm(cfg, torch.Generator("cuda").manual_seed(cfg["seed"]),
                                     torch.bfloat16, "cuda")
    batch = next(_train_batches(cfg, 1, seed=2))
    image = torch.as_tensor(batch["image"][:1]).cuda()
    lat = cfg["latent"]["image_size"]
    x = torch.randn(1, lat, lat, 4, device="cuda")
    t = torch.tensor([500], device="cuda")
    ctx = embed(batch["txt_raw"][:1])
    params = dict(unet.named_parameters())
    opt = float32_moments(ddpm_optimizer(tc["lr"], tc.get("grad_clip", 1.0)))
    state = init_train_state(params, opt, tc["ema_decay"], num_timesteps=1000)

    def fwd_bwd(policy):
        apply = remat_apply(unet, policy)

        def run():
            with training_trace():
                apply(x, t, ctx).float().pow(2).mean().backward()
        return run

    with torch.no_grad():
        encode_ms = time_ms(lambda: vae.encode(image), 3)
    # the config's policy, then the others on the same microbatch
    policies = [tc["remat"]] + [p for p in ("none", "nothing", "dots") if p != tc["remat"]]
    layers = {"encode_ms": encode_ms,
              "unet_fwd_bwd_ms_by_remat": {p: time_ms(fwd_bwd(p), 3) for p in policies},
              "clip_ms": time_ms(lambda: embed(batch["txt_raw"]), 3)}
    grads = [p.grad for p in params.values()]
    layers["clip_adam_ms"] = time_ms(
        lambda: opt.update_(list(params.values()), grads, state.opt_state), 3)
    layers["ema_ms"] = time_ms(lambda: ema_update(state.ema, params), 3)
    del ld, unet, vae, embed, state, params, grads
    torch.cuda.empty_cache()
    return layers


def main() -> int:
    if not (HERE / "sd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the sd_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False       # fp32 references in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from sd_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    per_lib = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library": per_lib})

    gen = torch.Generator("cuda").manual_seed(0)
    table = {**phase_kernels(gen), **phase_train_kernels(gen)}
    phase_parity()
    launches, pipe, prompts = phase_e2e()
    profiling = "--profile" in sys.argv[1:]
    if profiling:
        phase_profile(pipe, prompts)
    del pipe
    torch.cuda.empty_cache()
    phase_train_parity()
    train = phase_train()
    if profiling:
        phase_train_profile()

    # each kernel's launches on its main path: generate for the inference
    # kernels, the train_ldm run for the training kernels
    train_kernels = ("flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv")
    src = "sd_tpu_torch/csrc/"
    tpu = "sd_tpu/kernels/"
    sources = {"flash_attention": (src + "flash_attention.cu", tpu + "flash_attention.py:66"),
               "flash_attention_hpacked": (src + "flash_attention.cu",
                                           tpu + "flash_attention.py:293"),
               "flash_attention_lse": (src + "flash_attention.cu", tpu + "flash_attention.py:421"),
               "flash_bwd_dq": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:465"),
               "flash_bwd_dkv": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:511"),
               "geglu_ff": (src + "geglu.cu", tpu + "geglu.py:48"),
               "conv3x3_same": (src + "conv2d.cu", tpu + "conv2d.py:30")}
    rows = []
    for name, (source, rep) in sources.items():
        r = table[name]
        path = "train_ldm" if name in train_kernels else "generate"
        n = train["launches"][name] if name in train_kernels else launches[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": rep,
                     "launches": n, "launches_path": path, "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "shape": r["shape"]})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
