#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sd_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    nvcc builds of every kernel from `sd_tpu_torch/csrc`, in parallel;
  kernel   each hand-written kernel at every shape the 512² text-to-image and
           training paths give it, the opt-in configuration's included (plus a
           ragged case), against its plain PyTorch version
           computed in fp32 from the same bf16 inputs: max|Δ| ≤ 1e-2·max|ref|
           (bf16 output rounding at 2^-8 plus p rounded to bf16); the flash
           training kernels: lse2 within 1e-3 absolute, dq/dk/dv within
           2e-2·max|ref| and ‖Δ‖₂ ≤ 1e-2·‖ref‖₂ (p and dS round to bf16, sums
           over up to 4096 rows), and dK/dV bitwise equal on a second run;
           the pipelined flash sweep against the serial kernel too (max|Δ|,
           same bits expected); the fused GroupNorm → SiLU → 3×3 conv, which
           no path calls, at the decoder's conv shapes;
           with the kernel's, the plain version's and one PyTorch library
           call's time (CUDA events) and the least time the card could take
           (bound: the larger of the bytes at 3.35 TB/s, the tensor
           operations at their peak and, for attention, one exp2 per logit at
           3.9e12/s); each Hopper flash forward with the template's sweep
           timed beside it at the same shapes (`generic_ms`), its route
           counter checked and the same bits on a second run:
           `flash_attention_sm90.cu` (d ≤ 128: the head-packed shapes at
           batch 4 and, with the bf16 exponential, 8, a ragged case through
           `impl="pallas"`, a strided d = 64 view, d = 128), its int8-PV
           form `flash_attention_sm90_pv8.cu` (the served head-packed shapes
           at batch 8, the contract shape; `ms` includes the pre-pass) and
           `flash_attention_wide.cu` (d = 512 at batch 2 and 4, a ragged
           case, d = 136 and 256; serial, pipelined, both variants); the
           int8 PV against the plain sweep at the TPU package's kv tile;
           the training (LSE) forward on its Hopper route at every training
           shape (the LSE epilogue of `flash_attention_sm90.cu` at d ≤ 128,
           of `flash_attention_wide.cu` above; its kv sweep split in two
           where the grid is under one wave, with the combine launch held
           against its plain version as its own row), the template's LSE
           sweep timed beside it (`generic_ms`), the same bits twice; the
           3×3 conv (`conv2d_sm90.cu`) at the decoder's five shapes and a
           ragged one, `conv2d.cu` timed beside it, the same bits twice;
           the LSE rows also carry `device_ms` (torch.profiler's device
           time per call) beside the template's and SDPA's, since at tens
           of microseconds the host's enqueue time sets `ms`;
  attention_switches  one level-0 attention block under each value of
           `SD_TPU_ATTN_IMPL`, `SD_TPU_ATTN_HPACKED`, `SD_TPU_ATTN_PACKED`,
           `SD_TPU_FLASH_BWD`: which launch counters move, and the output (and
           input gradient) against the fp32 block;
  parity   the SD-v1-width UNet (latent 32², batch 2) and KL-f8 decoder
           (latent 32²) with every parameter random: bf16 with the kernels on
           the card against fp32 plain on the CPU, same (bf16-rounded) weights
           and inputs, relative-error bounds stated below;
  parity_optin  the same with the opt-in switches set (`SD_TPU_PALLAS_GN=1
           SD_TPU_PALLAS_XATTN=1 SD_TPU_FLASH_PIPE=1`), under the same bounds,
           with the launches of GroupNorm, fused cross-attention and the
           pipelined flash sweep;
  e2e      Text2ImagePipeline(sd_v1_config()) with every weight random from a
           seed: generate() of 2 prompts, 512², 50 DDIM steps, CFG 7.5; checks
           the uint8 [2, 512, 512, 3] output, a finite and non-constant image
           before quantisation, and the kernels' launch counts on that run.
  e2e_optin  the same generate with the opt-in switches set in the
           environment for the phase (restored after it): image checks, the
           opt-in launch counts, and s/generate of the two configurations
           timed in turns (default, opt-in, opt-in, default).
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
  klvae_parity  one KL GAN step (train/gan.py) of the full-width KL-f8 codec,
           PatchGAN and random-VGG LPIPS at 256², batch 2, `disc_start` 0,
           every weight random: bf16 parameters with the kernels on the card
           against fp32 plain on the card (TF32 off), same bf16-rounded
           weights, images and posterior noise; each loss term within 5e-2
           relative, d_weight within 0.1, the generator's gradients (global
           and each mid-block AttnBlock q/k/v/proj_out weight) within
           ‖Δg‖₂ ≤ 0.1·‖g‖₂, and 2/2/2 training-kernel launches;
  klvae_train  train_kl_vae(kl_f8_256_train_config(), bf16 parameters) on
           seeded 256² images, batch 4: 1 warm-up and 4 timed steps; checks
           finite losses, the dtype policy and 2/2/2 launches per step, and
           prints s/step, img/s and peak memory.
  profile  (only with `--profile`) the layers' times and the device time of
           one generate by kernel family, against its wall time, for the
           default and the opt-in configuration, the serve phase's grouped
           bucket-4 generate, and the same for one optimizer step of
           train_ldm and one step of train_kl_vae.
The build line carries the registers and spills of the flash kernels' head
dim 256 and 512 instantiations, of the inference forwards at the path's
head dims, and their dynamic shared memory. The flash training kernels are also held at
head dim 512 ([4, 1024, 1, 512], train_kl_vae's shape, [1, 4096, 1, 512]
and a ragged [1, 1000, 1300, 1, 512]), with the backend
`scaled_dot_product_attention` ran there; their row in the kernel table is
train_kl_vae's shape and launches, with train_ldm's launches and the other
shapes beside them.
Then the kernel table as one JSON line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero; without
a CUDA device, or without the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent

# peak rates of one H100 SXM (dense bf16 and int8 tensor cores, fp32 outside
# the tensor cores, HBM3), and its special-function units' exp2 results per
# second (16 per clock per SM x 132 SMs x 1.83 GHz)
PEAK_FLOPS = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 3.9e12

# every kernel wrapper's launch counter (`sd_tpu_torch.kernels.LAUNCHES`)
KERNELS = ("flash_attention", "flash_attention_pipelined", "flash_attention_hpacked",
           "flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv", "geglu_ff",
           "conv3x3_same", "gn_silu_conv3x3", "group_norm", "crossattn_kv",
           # the inference variants (SD_TPU_FLASH_EXP=bf16, SD_TPU_FLASH_PV=int8)
           "flash_attention_exp_bf16", "flash_attention_pv_int8",
           "flash_attention_exp_bf16_pv_int8", "flash_attention_pipelined_exp_bf16",
           "flash_attention_hpacked_exp_bf16", "flash_attention_hpacked_pv_int8",
           "flash_attention_hpacked_exp_bf16_pv_int8",
           # routes: inference flash launches served by flash_attention_sm90.cu,
           # flash_attention_sm90_pv8.cu and flash_attention_wide.cu, and
           # training-forward launches served by the LSE epilogue of
           # flash_attention_sm90.cu and flash_attention_wide.cu
           "flash_fwd_sm90", "flash_fwd_sm90_pv8", "flash_fwd_wide",
           "flash_lse_sm90", "flash_lse_wide",
           # the combine launch of a training forward whose kv sweep is split
           "flash_lse_combine")


def launches_of(**nonzero) -> dict:
    return {**dict.fromkeys(KERNELS, 0), **nonzero}


# launches of one generate() at 512², 50 steps: 10 self-attention and 10
# GEGLU calls per UNet step, the decoder's mid-block attention and 18 convs;
# the head-packed launches (d = 40, 80) on the Hopper route, the decoder's
# (d = 512) on the wide kernel
EXPECTED_LAUNCHES = launches_of(flash_attention=1, flash_attention_hpacked=500,
                                flash_fwd_sm90=500, flash_fwd_wide=1, geglu_ff=500,
                                conv3x3_same=18)
# the opt-in configuration: the TPU package's switches that reach kernels
OPT_IN = {"SD_TPU_PALLAS_GN": "1", "SD_TPU_PALLAS_XATTN": "1", "SD_TPU_FLASH_PIPE": "1"}
# ... and its launches per generate: 57 of the UNet's 61 GroupNorms and 15 of
# its 16 cross-attentions per step, the decoder's mid-block attention through
# the pipelined sweep (tests/test_torch_structure.py derives these)
EXPECTED_LAUNCHES_OPTIN = launches_of(
    flash_attention_pipelined=1, flash_attention_hpacked=500, flash_fwd_sm90=500,
    flash_fwd_wide=1, geglu_ff=500, conv3x3_same=18, group_norm=2850, crossattn_kv=750)
# the serving phase's switches, and the launches of one grouped batch of
# requests (bucket 4, 30 DDIM steps, CFG, 512²): the variant kernels in place
# of the head-packed and the decoder's flash kernel (the int8-PV Hopper
# kernel and the wide kernel)
SERVE = {"SD_TPU_FLASH_EXP": "bf16", "SD_TPU_FLASH_PV": "int8"}
SERVE_STEPS = 30
# UNet calls of 30 DDIM steps: the "uniform" striding of both packages,
# range(0, 1000, 1000 // 30), has 31 entries
SERVE_UNET_CALLS = 31
EXPECTED_SERVE_LAUNCHES = launches_of(
    flash_attention_hpacked_exp_bf16_pv_int8=10 * SERVE_UNET_CALLS,
    flash_fwd_sm90_pv8=10 * SERVE_UNET_CALLS, flash_attention_exp_bf16_pv_int8=1,
    flash_fwd_wide=1, geglu_ff=10 * SERVE_UNET_CALLS, conv3x3_same=18)
# launches of one optimizer step of train_ldm(sd512_train_config()): 10
# self-attentions (UNet levels 0 and 1) per microbatch forward, again in the
# remat recompute, one dQ and one dK/dV each in backward, 4 microbatches
# (tests/test_torch_structure.py derives these from the shape rules); the
# training forward at d = 40 and 80 on flash_attention_sm90.cu's LSE epilogue
EXPECTED_TRAIN_LAUNCHES = launches_of(flash_attention_lse=80, flash_lse_sm90=80,
                                      flash_bwd_dq=40, flash_bwd_dkv=40)
# launches of one step of train_kl_vae(kl_f8_256_train_config()), 256²: the
# codec's two mid-block attentions (encoder, decoder; [4, 1024, 1, 512])
# in the one generator forward and its backward, no inference kernel; the
# training forward at d = 512 on flash_attention_wide.cu's LSE epilogue, its
# kv sweep split (64 blocks) and combined
EXPECTED_KLVAE_LAUNCHES = launches_of(flash_attention_lse=2, flash_lse_wide=2,
                                      flash_lse_combine=2, flash_bwd_dq=2, flash_bwd_dkv=2)
# launches of the opt-in parity runs (UNet latent 32² batch 2, decoder latent 32²)
PARITY_OPTIN_LAUNCHES = {
    "unet": launches_of(flash_attention_hpacked=5, flash_fwd_sm90=5, geglu_ff=5, group_norm=46,
                        crossattn_kv=10),
    "decoder": launches_of(flash_attention_pipelined=1, flash_fwd_wide=1, conv3x3_same=12,
                           group_norm=11)}
# ... and of the serving parity runs, every flash call through its variant
PARITY_SERVE_LAUNCHES = {
    "unet": launches_of(flash_attention_hpacked_exp_bf16_pv_int8=5, flash_fwd_sm90_pv8=5,
                        geglu_ff=5),
    "decoder": launches_of(flash_attention_exp_bf16_pv_int8=1, flash_fwd_wide=1,
                           conv3x3_same=12)}
# [B, S, C] of every GroupNorm and [B, N, M, heads, d, C] of every fused
# cross-attention one opt-in generate of 2 prompts launches
GN_SHAPES = [(4, 4096, 320), (4, 1024, 320), (4, 1024, 640), (4, 1024, 960),
             (4, 1024, 1280), (4, 256, 640), (4, 256, 1280), (4, 256, 1920),
             (4, 256, 2560), (4, 64, 1280), (4, 64, 2560)]
XATTN_SHAPES = [(4, 4096, 77, 8, 40, 320), (4, 1024, 77, 8, 80, 640),
                (4, 256, 77, 8, 160, 1280)]
# the decoder's ResnetBlock convs at 128², 256², 512² (B, H = W, C, O), B = 2,
# and the launches of each per generate (18 in all). models/codec.py Decoder
# (ch 128, ch_mult (1, 2, 4, 4), 3 ResnetBlocks of 2 convs per up level) sends
# only the ResnetBlocks' 3×3 convs (nn/layers.py Conv3x3) through the shape
# rule (C, O multiples of 128, H·W ≥ 128², W ≥ 128): the mid block and up
# level 3 at 64² fail it; up level 2 at 128² gives 6 [512 → 512]; up level 1
# at 256² one [512 → 256] (its first conv) and 5 [256 → 256]; up level 0 at
# 512² one [256 → 128] and 5 [128 → 128]. conv_in, the upsample convs and
# conv_out are plain Conv2d layers, as in sd_tpu.
DECODER_CONVS = [(2, 128, 512, 512), (2, 256, 512, 256), (2, 256, 256, 256),
                 (2, 512, 256, 128), (2, 512, 128, 128)]
DECODER_CONV_LAUNCHES = (6, 1, 5, 1, 5)
KERNEL_TOL = 1e-2
LSE_TOL = 1e-3                                   # absolute, base-2 units
GRAD_TOL = {"max_rel": 2e-2, "l2_rel": 1e-2}     # flash dq, dk, dv
UNET_TOL = {"max_rel": 0.1, "l2_rel": 0.03}      # stated before measuring
DECODER_TOL = {"max_rel": 0.1, "l2_rel": 0.03}
TRAIN_GRAD_TOL = 0.1                             # ‖Δg‖₂ / ‖g‖₂, stated before measuring
TRAIN_STEPS = 3                                  # timed, after one warm-up step
# [B, Sq, Skv, H, D] of the flash training kernels' checks: train_ldm's
# self-attention at UNet levels 0 and 1, a ragged case, train_kl_vae's codec
# mid-block at 256², a 512² codec's, and a ragged case at d = 512
KLVAE_ATTN_SHAPE = (4, 1024, 1024, 1, 512)
TRAIN_KERNEL_SHAPES = ((1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80), (1, 1000, 1300, 8, 40),
                       KLVAE_ATTN_SHAPE, (1, 4096, 4096, 1, 512), (1, 1000, 1300, 1, 512))
# the KL-VAE parity gates, stated before measuring: each loss term within
# 5e-2 relative, d_weight within 0.1 relative (a ratio of two bf16 gradient
# norms), generator gradients ‖Δg‖₂ ≤ 0.1·‖g‖₂ (a dropped gradient reads ≈ 1.0)
KLVAE_LOSS_TOL = 5e-2
KLVAE_DWEIGHT_TOL = 0.1
KLVAE_GRAD_TOL = 0.1
KLVAE_STEPS = 4                                  # timed, after one warm-up step
# the inference variants' kernel checks: the serving path's shapes (bucket 4:
# the UNet at batch 8, the decoder at batch 4), a ragged d = 512 case, and
# the shape where the TPU package states the int8 contract
# (tests/test_flash_attention.py:206); [B, Sq, Skv, H, D]
SERVE_HPACKED_SHAPES = ((8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80))
SERVE_DECODER_SHAPE = (4, 4096, 4096, 1, 512)
CONTRACT_SHAPE = (1, 256, 256, 2, 40)
VARIANT_SHAPES = (SERVE_DECODER_SHAPE, (1, 512, 700, 1, 512), CONTRACT_SHAPE)
PIPE_EXP_SHAPES = (SERVE_DECODER_SHAPE, (1, 1000, 1300, 8, 40))
# against exact fp32 attention, stated before measuring: the mean error
# everywhere, the worst element at CONTRACT_SHAPE (the TPU package's measured
# contract); at the other shapes the kernel may not add more than KERNEL_TOL
# to its plain version's worst error (the quantization's own error grows
# with the sequence: the plain version carries it too)
EXACT_TOL = {"mean": 1e-2, "int8_max": 8e-2, "bf16_max": 1e-2}
# (softmax in bf16, PV in int8) of each inference variant
VARIANTS = ((True, False), (False, True), (True, True))
# each Hopper route of the inference flash forward and its counter
# (`kernels/flash_attention.py ROUTE_COUNTERS`); the template has none
ROUTE_COUNTER = {"sm90": "flash_fwd_sm90", "sm90_pv8": "flash_fwd_sm90_pv8",
                 "wide": "flash_fwd_wide"}
ROUTE_COUNTERS = tuple(ROUTE_COUNTER.values())
# ... and of the training forward (`kernels/flash_attention.py LSE_ROUTE_COUNTERS`)
LSE_ROUTE_COUNTER = {"sm90": "flash_lse_sm90", "wide": "flash_lse_wide"}
# the kv tile of the pipelined sweeps (csrc/flash_attention.cu's and
# csrc/flash_attention_wide.cu's): its plain version runs at it, since its
# bf16 p depends on the running max of each tile
TEMPLATE_KV_TILE = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(flops: int, nbytes: int, peak: float = PEAK_FLOPS,
             exps: int = 0) -> tuple[float, str, str | None]:
    """(least ms, "operations" or "bytes", which operations: "tensor",
    "fp32" or "exp2"): the larger of the operations at their peak rate (the
    products at `peak`, the exponentials at PEAK_EXP2) and the bytes."""
    t_ops, t_exp, t_bytes = flops / peak, exps / PEAK_EXP2, nbytes / PEAK_BYTES
    t = max(t_ops, t_exp, t_bytes)
    if t == t_bytes:
        return t * 1e3, "bytes", None
    return t * 1e3, "operations", ("exp2" if t_exp > t_ops
                                   else "fp32" if peak == PEAK_FP32 else "tensor")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# operations and bytes each kernel's work needs (inputs read once, outputs
# written once), for its bound: (tensor flops, bytes, their peak, exp2 calls);
# every flash kernel takes one exp2 per logit
def attention_cost(b, sq, skv, h, d):
    return (4 * b * h * sq * skv * d, 2 * b * h * d * (2 * sq + 2 * skv), PEAK_FLOPS,
            b * h * sq * skv)


def attention_lse_cost(b, sq, skv, h, d):
    return (4 * b * h * sq * skv * d, b * h * (2 * d * (2 * sq + 2 * skv) + 4 * sq),
            PEAK_FLOPS, b * h * sq * skv)


def attention_dq_cost(b, sq, skv, h, d):
    # reads q, k, v, o, dO, lse2; writes dq, delta
    return (6 * b * h * sq * skv * d, b * h * (2 * d * (4 * sq + 2 * skv) + 8 * sq),
            PEAK_FLOPS, b * h * sq * skv)


def attention_dkv_cost(b, sq, skv, h, d):
    # reads q, k, v, dO, lse2, delta; writes dk, dv
    return (8 * b * h * sq * skv * d, b * h * (2 * d * (2 * sq + 4 * skv) + 8 * sq),
            PEAK_FLOPS, b * h * sq * skv)


def variant_bound(b, sq, skv, h, d, pv_int8) -> tuple[float, str, str | None]:
    """The least time of flash attention with the PV product on the int8
    tensor cores (QKᵀ at the bf16 rate) or the bf16 ones: the tensor flops
    at their blended rate, the exponentials, the bytes."""
    flops, nbytes, _, exps = attention_cost(b, sq, skv, h, d)
    rate = flops / (flops / 2 / PEAK_FLOPS + flops / 2 / (PEAK_INT8 if pv_int8 else PEAK_FLOPS))
    return bound_ms(flops, nbytes, rate, exps)


def geglu_cost(n, c, inner):
    return 6 * n * c * inner, 2 * (2 * n * c + 3 * c * inner + 2 * inner + c)


def conv3x3_cost(b, h, w, c, o):
    return 18 * b * h * w * c * o, 2 * (b * h * w * (c + o) + 9 * c * o + o)


def gn_silu_conv_cost(b, h, w, c, o):
    # the conv's, plus the GroupNorm scale and bias read
    flops, nbytes = conv3x3_cost(b, h, w, c, o)
    return flops, nbytes + 4 * c


def group_norm_cost(b, s, c, silu):
    # fp32 outside the tensor cores: sum and square-sum (3), x·a + c (2),
    # SiLU (4); x read once, y written once, bf16 scale and bias
    return (5 + 4 * silu) * b * s * c, 2 * (2 * b * s * c + 2 * c), PEAK_FP32


def crossattn_cost(b, n, m, heads, d, c):
    # q and out projections, QKᵀ and PV over the m context tokens
    hd = heads * d
    return 4 * b * n * c * hd + 4 * b * n * m * hd, 2 * (2 * b * n * c + 2 * c * hd
                                                         + 2 * b * m * hd + c)


def switches(env: dict):
    """Environment variables set for a block and restored after it."""
    return mock.patch.dict(os.environ, env)


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn`: the self device time of every kernel
    it launches, summed over `reps` calls under torch.profiler, per call.
    Unlike `time_ms` it leaves out the host's time to enqueue them, which
    sets the pace of a call whose kernels take tens of microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()) / reps / 1e3


def rel_err(out, ref) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def l2_rel(out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def route_forward(q, k, v, route: str = "template", exp_bf16: bool = False,
                  pv_int8: bool = False, pipelined: bool = False, block_k: int = 0):
    """One sweep of one source over [B, S, H, D] views, launched through its
    plan: the template (`csrc/flash_attention.cu`), which served every
    inference launch the Hopper kernels serve now and is timed beside them in
    the same run (`generic_ms`), or a Hopper route's serial sweep (the
    pipelined sweep's yardstick of bits). `block_k` is the int8 PV's tile."""
    import torch

    from sd_tpu_torch.kernels import flash_attention as fa

    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    name = "flash_attention_pipelined" if pipelined else "flash_attention"
    fa._launch(q, k, v, out, q.shape[-1] ** -0.5,
               fa.Plan(fa.launch_name(name, exp_bf16, pv_int8), route, pipelined, exp_bf16,
                       pv_int8, block_k))
    return out


# ---------------------------------------------------------------------------


def kernel_cases(gen):
    """One case per main-path shape of every kernel: callables for the
    kernel, its plain version (bf16 in), the fp32 reference and the library
    call, with the operations and bytes the work needs."""
    import torch
    import torch.nn.functional as F

    from sd_tpu_torch.kernels import conv2d, cross_attention as xattn
    from sd_tpu_torch.kernels import flash_attention as fa, geglu, groupnorm as gn

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()

    from sd_tpu_torch.kernels import attention as attn_k

    cases = []
    # rows 1 and 3 at head dims up to 128: the Hopper kernel
    # (flash_attention_sm90.cu), with the template's serial sweep timed
    # beside it. UNet self-attention, projection-native [2B, S, H·D], B = 2
    for S, H, D in ((4096, 8, 40), (1024, 8, 80)):
        q, k, v = (rnd(4, S, H * D) for _ in range(3))
        split = lambda t, S=S, H=H, D=D: t.view(4, S, H, D)
        heads = lambda t, split=split: split(t).transpose(1, 2)
        cases.append(dict(
            name="flash_attention_hpacked", shape=[4, S, H * D, H], route="sm90",
            kernel=lambda q=q, k=k, v=v, H=H: fa.flash_attention_hpacked(q, k, v, H),
            plain=lambda q=q, k=k, v=v, s=split, D=D: fa._xla_ref(s(q), s(k), s(v), D**-0.5),
            ref=lambda q=q, k=k, v=v, s=split, D=D: fa._xla_ref(
                s(q).float(), s(k).float(), s(v).float(), D**-0.5),
            library=lambda q=q, k=k, v=v, h=heads: F.scaled_dot_product_attention(h(q), h(k), h(v)),
            generic=lambda q=q, k=k, v=v, s=split: route_forward(s(q), s(k), s(v)),
            view=lambda o, s=split: s(o),
            cost=attention_cost(4, S, S, H, D)))
    # ... [B, S, H, D]: a ragged case through the forced route
    # (`impl="pallas"`: Sq = 1000 fails the shape rule), a strided d = 64
    # view (every other 64 columns of a d = 128 tensor) and d = 128
    for B, S, Skv, H, D, how in ((1, 1000, 1000, 8, 40, "forced"), (2, 512, 700, 4, 64, "strided"),
                                 (1, 300, 257, 2, 128, "")):
        wide = 2 if how == "strided" else 1
        q, k, v = (rnd(B, n, H, wide * D)[..., :D] for n in (S, Skv, Skv))
        heads = lambda t: t.transpose(1, 2)
        cases.append(dict(
            name="flash_attention", shape=[B, S, Skv, H, D], route="sm90", how=how,
            kernel=(lambda q=q, k=k, v=v: attn_k.dot_product_attention(q, k, v, impl="pallas"))
            if how == "forced" else (lambda q=q, k=k, v=v: fa.flash_attention(q, k, v)),
            plain=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q, k, v, D**-0.5),
            ref=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q.float(), k.float(), v.float(), D**-0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)),
            generic=lambda q=q, k=k, v=v: route_forward(q, k, v),
            view=lambda o: o, table=False,
            cost=attention_cost(B, S, Skv, H, D)))
    # row 1 above head dim 128: the wide kernel (flash_attention_wide.cu),
    # with the template's serial sweep timed beside it. VAE mid-block
    # single-head attention [B, 4096, 1, 512], B = 2, a ragged-kv case (kv
    # not a multiple of the 64-row kv tile), d = 136 and 256
    for B, S, Skv, H, D in ((2, 4096, 4096, 1, 512), (1, 512, 700, 1, 512),
                            (1, 300, 257, 2, 136), (1, 1000, 1000, 2, 256)):
        q, k, v = rnd(B, S, H, D), rnd(B, Skv, H, D), rnd(B, Skv, H, D)
        heads = lambda t: t.transpose(1, 2)
        cases.append(dict(
            name="flash_attention", shape=[B, S, Skv, H, D], route="wide",
            kernel=lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q, k, v, D**-0.5),
            ref=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q.float(), k.float(), v.float(), D**-0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)),
            generic=lambda q=q, k=k, v=v: route_forward(q, k, v),
            view=lambda o: o, table=D == 512,
            cost=attention_cost(B, S, Skv, H, D)))
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
    # row 8: the decoder's ResnetBlock convs at 128², 256², 512², B = 2, and
    # a ragged case (H and W not multiples of the 2 x 128 tile): the Hopper
    # conv (conv2d_sm90.cu), with conv2d.cu's timed beside it
    for B, Hs, Ws, C, O in [(b, h, h, c, o) for b, h, c, o in DECODER_CONVS] + [
            (1, 137, 200, 128, 128)]:
        x = rnd(B, Hs, Ws, C)
        w = rnd(O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        b = rnd(O, scale=0.1)
        cases.append(dict(
            name="conv3x3_same", shape=[B, Hs, Ws, C, O], table=Hs == Ws,
            kernel=lambda x=x, w=w, b=b: conv2d.conv3x3_same(x, w, b),
            plain=lambda x=x, w=w, b=b: conv2d._xla_conv3x3(x, w, b),
            ref=lambda x=x, w=w, b=b: conv2d._xla_conv3x3(x.float(), w.float(), b.float()),
            library=lambda x=x, w=w, b=b: F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1),
            generic=lambda x=x, w=w, b=b: conv2d._launch_conv(x, w, b, "template"),
            view=lambda o: o,
            cost=conv3x3_cost(B, Hs, Ws, C, O)))
    # row 2 (opt-in): the pipelined kv sweep, at the decoder's mid-block
    # attention and two ragged cases; also held against the serial sweep of
    # its source (the wide kernel at d = 512, the template at d = 40), with
    # the template's pipelined sweep timed beside the wide kernel
    for B, S, Skv, H, D in ((2, 4096, 4096, 1, 512), (1, 512, 700, 1, 512),
                            (1, 1000, 1300, 8, 40)):
        q, k, v = rnd(B, S, H, D), rnd(B, Skv, H, D), rnd(B, Skv, H, D)
        heads = lambda t: t.transpose(1, 2)
        route = "wide" if D > 128 else "template"

        def vs_serial(out, q=q, k=k, v=v, route=route):
            serial = route_forward(q, k, v, route)
            return {"serial_max_abs_diff": rel_err(out, serial)[0],
                    "same_bits_as_serial": bool(torch.equal(out, serial))}

        wide = {} if route == "template" else {"generic": lambda q=q, k=k, v=v: route_forward(
            q, k, v, pipelined=True)}
        cases.append(dict(
            name="flash_attention_pipelined", shape=[B, S, Skv, H, D],
            kernel=lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
            env={"SD_TPU_FLASH_PIPE": "1"}, route=route, **wide,
            plain=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q, k, v, D**-0.5),
            ref=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q.float(), k.float(), v.float(),
                                                       D**-0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)),
            view=lambda o: o, extra=vs_serial,
            cost=attention_cost(B, S, Skv, H, D)))
    # row 10 (opt-in): GroupNorm at every opt-in generate shape (eps 1e-5, the
    # resblocks'), the transformer norms' eps 1e-6, the SiLU epilogue (no
    # model path uses it) and a ragged case with 8 groups
    gn_cases = [(b, s_, c, 32, 1e-5, None, True) for b, s_, c in GN_SHAPES]
    gn_cases += [(4, 4096, 320, 32, 1e-6, None, False), (4, 1024, 640, 32, 1e-6, None, False),
                 (4, 256, 1280, 32, 1e-6, None, False), (4, 4096, 320, 32, 1e-6, "silu", False),
                 (3, 100, 136, 8, 1e-6, "silu", False)]
    for B, S, C, G, eps, act, table in gn_cases:
        x = rnd(B, S, C, scale=3.0) + 0.5
        sc, bi = 1 + rnd(C, scale=0.2), rnd(C, scale=0.3)
        kw = dict(groups=G, eps=eps, act=act)
        cases.append(dict(
            name="group_norm", shape=[B, S, C, G, eps, act],
            kernel=lambda x=x, sc=sc, bi=bi, kw=kw: gn.group_norm(x, sc, bi, **kw),
            plain=lambda x=x, sc=sc, bi=bi, kw=kw: gn.group_norm_xla(x, sc, bi, **kw),
            ref=lambda x=x, sc=sc, bi=bi, kw=kw: gn.group_norm_xla(
                x.float(), sc.float(), bi.float(), **kw),
            library=(None if act else lambda x=x, sc=sc, bi=bi, G=G, eps=eps:
                     F.group_norm(x.transpose(1, 2), G, sc, bi, eps)),
            view=lambda o: o, table=table, cost=group_norm_cost(B, S, C, act == "silu")))
    # row 11 (opt-in): the fused cross-attention at UNet levels 0-2 over the
    # 77 CLIP tokens, and a ragged case (rows past a q tile, 33 tokens, d = 24)
    for B, N, M, H, D, C in XATTN_SHAPES + [(1, 1000, 33, 4, 24, 96)]:
        HD = H * D
        args = (rnd(B, N, C), rnd(HD, C, scale=C**-0.5), rnd(B, M, HD), rnd(B, M, HD),
                rnd(C, HD, scale=HD**-0.5), rnd(C, scale=0.1))
        cases.append(dict(
            name="crossattn_kv", shape=[B, N, M, H, D, C],
            kernel=lambda a=args, H=H: xattn.crossattn_kv(*a, H),
            plain=lambda a=args, H=H: xattn.crossattn_kv_xla(*a, H),
            ref=lambda a=args, H=H: xattn.crossattn_kv_xla(*(t.float() for t in a), H),
            library=None, view=lambda o: o, cost=crossattn_cost(B, N, M, H, D, C)))
    # row 9 (no model path): GroupNorm → SiLU → 3×3 conv at the decoder's
    # conv shapes, and a ragged one
    for B, Hs, Ws, C, O in [(b, h, h, c, o) for b, h, c, o in DECODER_CONVS] + [
            (1, 37, 50, 64, 128)]:
        x = rnd(B, Hs, Ws, C, scale=2.0) + 0.5
        sc, bi = 1 + rnd(C, scale=0.1), rnd(C, scale=0.1)
        w = rnd(O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        b = rnd(O, scale=0.1)
        args = (x, sc, bi, w, b)
        cases.append(dict(
            name="gn_silu_conv3x3", shape=[B, Hs, Ws, C, O],
            kernel=lambda a=args: conv2d.gn_silu_conv3x3(*a),
            plain=lambda a=args: conv2d._gn_silu_conv_xla(*a),
            ref=lambda a=args: conv2d._gn_silu_conv_xla(*(t.float() for t in a)),
            library=None, view=lambda o: o, cost=gn_silu_conv_cost(B, Hs, Ws, C, O)))
    return cases


def route_moves(run) -> tuple[object, dict]:
    """(run(), how far each flash route counter moved in it)."""
    from sd_tpu_torch import kernels

    before = {c: kernels.LAUNCHES[c] for c in ROUTE_COUNTERS}
    out = run()
    return out, {c: kernels.LAUNCHES[c] - before[c] for c in ROUTE_COUNTERS}


def require_route(moved: dict, route: str, what: str) -> None:
    """One launch on `route`'s counter (none on the template), none on another."""
    want = {c: int(c == ROUTE_COUNTER.get(route)) for c in ROUTE_COUNTERS}
    require(moved == want, f"{what} on the {route} route: counters moved {moved}")


def phase_kernels(gen) -> dict:
    import torch

    best, hopper_rows = {}, {c: [] for c in ROUTE_COUNTERS}
    for case in kernel_cases(gen):
        # a case's switches are set once around it, not around each timed call
        with switches(case.get("env", {})):
            best_row = _kernel_case(case, hopper_rows)
        if case.get("table", True) and (case["name"] not in best
                                        or case["cost"][0] > best[case["name"]][0]):
            best[case["name"]] = (case["cost"][0], best_row)
        torch.cuda.empty_cache()
    table = {name: row for name, (_, row) in best.items()}
    return table, hopper_rows


def _kernel_case(case, hopper_rows) -> dict:
    """One case of the kernel phase: its checks and its row."""
    import torch

    out, moved = route_moves(lambda: case["view"](case["kernel"]()))
    torch.cuda.synchronize()
    ref = case["ref"]()
    err, rel = rel_err(out, ref)
    del ref
    b_ms, b_by, b_op = bound_ms(*case["cost"])
    row = {
        "phase": "kernel", "name": case["name"], "shape": case["shape"],
        "max_abs_err": err, "rel_err": rel, **case.get("extra", lambda o: {})(out),
        "ms": time_ms(case["kernel"]), "plain_ms": time_ms(case["plain"], 3),
        "library_ms": (time_ms(case["library"]) if case["library"] else None),
        "bound_ms": b_ms, "bound_by": b_by, "bound_op": b_op,
    }
    if "route" in case:
        row.update(route=case["route"], how=case.get("how", ""))
        require_route(moved, case["route"], f"{case['name']} {case['shape']}")
    if "generic" in case:
        row["generic_ms"] = time_ms(case["generic"])
        row["same_bits_twice"] = bool(torch.equal(out, case["view"](case["kernel"]())))
        require(rel_err(case["view"](case["generic"]()), out)[1] <= KERNEL_TOL
                and row["same_bits_twice"],
                f"{case['shape']}: the template agrees with the Hopper kernel, which "
                f"gives the same bits twice")
        # each Hopper flash route's rows under its counter, the conv's under its name
        hopper_rows.setdefault(ROUTE_COUNTER.get(case.get("route"), case["name"]),
                               []).append(row)
    emit(row)
    require(rel <= KERNEL_TOL, f"{case['name']} {case['shape']}: max|Δ| = "
            f"{rel:.3g}·max|ref| > {KERNEL_TOL}")
    return row


def _exact_errs(out, exact) -> tuple[float, float]:
    """(worst, mean) |out − exact| over max|exact|."""
    d = (out.float() - exact).abs()
    scale = max(exact.abs().max().item(), 1e-30)
    return d.max().item() / scale, d.mean().item() / scale


def phase_variant_kernels(gen) -> tuple[dict, list]:
    """The inference variants (bf16 softmax exponential, int8 PV, both) of
    the serial and head-packed flash kernels at the serving path's shapes,
    a ragged case and the TPU package's contract shape; the pipelined sweep
    with the bf16 exponential. Each against its plain tiled version at the
    TPU package's kv tile (the tile the wrapper hands the int8 PV kernel)
    and against exact fp32 attention, with its time, the plain version's,
    `scaled_dot_product_attention`'s (exact attention: no PyTorch call
    computes the quantized function) and its bound; every launch a Hopper
    kernel serves (all of them but the pipelined sweep at d = 40) with the
    template's time beside it (`generic_ms`, the int8 PV at the same tile)
    and the same bits on a second run. Returns the table rows and the
    Hopper rows by route counter."""
    import torch
    import torch.nn.functional as F

    from sd_tpu_torch.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    best, hopper_rows = {}, {c: [] for c in ROUTE_COUNTERS}
    cases = [("flash_attention_hpacked", shape, True) for shape in SERVE_HPACKED_SHAPES]
    cases += [("flash_attention", shape, shape == SERVE_DECODER_SHAPE) for shape in VARIANT_SHAPES]
    for base, (B, Sq, Skv, H, D), table in cases:
        packed = base == "flash_attention_hpacked"
        if packed:
            q, k, v = rnd(B, Sq, H * D), rnd(B, Skv, H * D), rnd(B, Skv, H * D)
            split = lambda t, H=H, D=D: t.unflatten(2, (H, D))
        else:
            q, k, v = rnd(B, Sq, H, D), rnd(B, Skv, H, D), rnd(B, Skv, H, D)
            split = lambda t: t
        exact = fa._xla_ref(*(split(t).float() for t in (q, k, v)), D**-0.5)
        heads = lambda t: split(t).transpose(1, 2)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))
        for exp_bf16, pv_int8 in VARIANTS:
            kw = dict(softmax_dtype=torch.bfloat16 if exp_bf16 else torch.float32,
                      pv_quant="int8" if pv_int8 else "none")
            plan = fa.launch_plan(Sq, Skv, H, D, exp_bf16, pv_int8, packed)
            bk = plan.block_k
            if packed:
                kernel = lambda kw=kw, H=H: fa.flash_attention_hpacked(q, k, v, H, **kw)
                plain = lambda kw=kw, H=H, D=D: fa._flash_hpacked_tiled_ref(
                    q, k, v, H, D**-0.5, bk, kw["softmax_dtype"], kw["pv_quant"])
            else:
                kernel = lambda kw=kw: fa.flash_attention(q, k, v, **kw)
                plain = lambda kw=kw, D=D: fa._flash_tiled_ref(
                    q, k, v, D**-0.5, bk, kw["softmax_dtype"], kw["pv_quant"])
            out, moved = route_moves(lambda: split(kernel()))
            require_route(moved, plan.route, f"{plan.name} {[B, Sq, Skv, H, D]}")
            ref = split(plain())
            torch.cuda.synchronize()
            _, vs_plain = rel_err(out, ref)
            worst, mean = _exact_errs(out, exact)
            plain_worst, plain_mean = _exact_errs(ref, exact)
            b_ms, b_by, b_op = variant_bound(B, Sq, Skv, H, D, pv_int8)
            name = fa.launch_name(base, exp_bf16, pv_int8)
            row = {"phase": "kernel", "name": name, "shape": [B, Sq, Skv, H, D],
                   "max_abs_err": rel_err(out, ref)[0], "rel_err": vs_plain,
                   "vs_exact": {"max": worst, "mean": mean},
                   "plain_vs_exact": {"max": plain_worst, "mean": plain_mean},
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain, 2),
                   "library_ms": library_ms, "library": "scaled_dot_product_attention (exact)",
                   "bound_ms": b_ms, "bound_by": b_by, "bound_op": b_op,
                   "route": plan.route, "kv_tile": bk}
            if plan.route in ROUTE_COUNTER:
                generic = lambda: route_forward(split(q), split(k), split(v), "template",
                                                exp_bf16, pv_int8, block_k=bk)
                row["generic_ms"] = time_ms(generic)
                row["same_bits_twice"] = bool(torch.equal(out, split(kernel())))
                require(rel_err(generic(), out)[1] <= KERNEL_TOL and row["same_bits_twice"],
                        f"{name}: the template agrees with the Hopper kernel, which gives "
                        f"the same bits twice")
                hopper_rows[ROUTE_COUNTER[plan.route]].append(row)
            emit(row)
            what = f"{name} {[B, Sq, Skv, H, D]}"
            require(vs_plain <= KERNEL_TOL, f"{what}: {vs_plain:.3g} from its plain version")
            require(mean < EXACT_TOL["mean"], f"{what}: mean error {mean:.3g} vs exact")
            if (B, Sq, Skv, H, D) == CONTRACT_SHAPE:
                gate = EXACT_TOL["int8_max" if pv_int8 else "bf16_max"]
                require(worst < gate if pv_int8 else worst <= gate,
                        f"{what}: worst error {worst:.3g} vs exact, gate {gate}")
            else:
                require(worst <= plain_worst + KERNEL_TOL,
                        f"{what}: worst error {worst:.3g} vs exact past the plain "
                        f"version's {plain_worst:.3g}")
            if table and (name not in best or B * Sq * Skv * H * D > best[name][0]):
                best[name] = (B * Sq * Skv * H * D, row)
        del exact
        torch.cuda.empty_cache()

    # the pipelined sweep keeps the bf16 exponential and drops the int8 PV:
    # the same bits as the serial kernel with the bf16 exponential alone
    for B, Sq, Skv, H, D in PIPE_EXP_SHAPES:
        q, k, v = rnd(B, Sq, H, D), rnd(B, Skv, H, D), rnd(B, Skv, H, D)
        exact = fa._xla_ref(q.float(), k.float(), v.float(), D**-0.5)

        # (run under SD_TPU_FLASH_PIPE=1, set once around the calls below)
        piped = lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, softmax_dtype=torch.bfloat16,
                                                          pv_quant="int8")
        plain = lambda q=q, k=k, v=v, D=D: fa._flash_tiled_ref(
            q, k, v, D**-0.5, TEMPLATE_KV_TILE, torch.bfloat16, "none", pipelined=True)
        before = kernels_launched("flash_attention_pipelined_exp_bf16")
        route = "wide" if D > 128 else "template"
        with switches({"SD_TPU_FLASH_PIPE": "1"}):
            out, moved = route_moves(piped)
            launched = kernels_launched("flash_attention_pipelined_exp_bf16") - before
            piped_ms = time_ms(piped)
        require(launched == 1,
                "SD_TPU_FLASH_PIPE=1 with both variants runs the pipelined bf16 sweep")
        require_route(moved, route, f"pipelined bf16 flash {[B, Sq, Skv, H, D]}")
        # the serial sweep of the same source (the wide kernel at d = 512; at
        # d = 40 the template, launched through its plan: the Hopper kernel
        # serves the serial launch there)
        serial = route_forward(q, k, v, route, exp_bf16=True)
        ref = plain()
        _, vs_plain = rel_err(out, ref)
        worst, mean = _exact_errs(out, exact)
        plain_worst, plain_mean = _exact_errs(ref, exact)
        b_ms, b_by, b_op = variant_bound(B, Sq, Skv, H, D, False)
        row = {"phase": "kernel", "name": "flash_attention_pipelined_exp_bf16",
               "shape": [B, Sq, Skv, H, D], "max_abs_err": rel_err(out, ref)[0],
               "rel_err": vs_plain, "vs_exact": {"max": worst, "mean": mean},
               "plain_vs_exact": {"max": plain_worst, "mean": plain_mean},
               "serial_exp_bf16_max_abs_diff": rel_err(out, serial)[0],
               "same_bits_as_serial_exp_bf16": bool(torch.equal(out, serial)),
               "ms": piped_ms, "plain_ms": time_ms(plain, 2),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))),
               "library": "scaled_dot_product_attention (exact)",
               "bound_ms": b_ms, "bound_by": b_by, "bound_op": b_op, "route": route}
        if route in ROUTE_COUNTER:
            generic = lambda q=q, k=k, v=v: route_forward(q, k, v, exp_bf16=True,
                                                          pipelined=True)
            row["generic_ms"] = time_ms(generic)
            require(rel_err(generic(), out)[1] <= KERNEL_TOL,
                    "the template's pipelined bf16 sweep agrees with the wide kernel's")
            hopper_rows[ROUTE_COUNTER[route]].append(row)
        emit(row)
        require(vs_plain <= KERNEL_TOL and worst <= plain_worst + KERNEL_TOL
                and mean < EXACT_TOL["mean"] and row["same_bits_as_serial_exp_bf16"],
                f"pipelined bf16 flash {[B, Sq, Skv, H, D]}: within its gates, the same "
                f"bits as the serial sweep")
        if (B, Sq, Skv, H, D) == SERVE_DECODER_SHAPE:
            best[row["name"]] = (0, row)
        del exact
        torch.cuda.empty_cache()
    return {name: row for name, (_, row) in best.items()}, hopper_rows


def kernels_launched(name: str) -> int:
    from sd_tpu_torch import kernels

    return kernels.LAUNCHES[name]


def sdpa_backend(fn) -> dict:
    """Which of PyTorch's attention backends one call of `fn` ran: the
    device kernels of one profiled call, the busiest first, and the backend
    their names belong to."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted(((ev.self_device_time_total, ev.key) for ev in prof.key_averages()
                    if ev.self_device_time_total > 0), reverse=True)
    joined = " ".join(n for _, n in names).lower()
    backend = ("flash" if "pytorch_flash" in joined or "flash_fwd" in joined
               else "cudnn" if "cudnn" in joined
               else "efficient" if "fmha" in joined or "cutlass" in joined
               else "math")
    return {"backend": backend, "kernels": [n[:80] for _, n in names[:3]]}


def phase_train_kernels(gen) -> dict:
    """The flash training kernels (LSE forward, dQ, dK/dV) at the training
    paths' self-attention shapes: train_ldm's [1, 4096, 8, 40] at UNet
    level 0 and [1, 1024, 8, 80] at level 1 (microbatch 1), train_kl_vae's
    codec mid-block [4, 1024, 1, 512] (256², batch 4), a 512² codec's
    [1, 4096, 1, 512], and ragged cases at d = 40 and 512; against their
    plain versions in fp32 from the same bf16 inputs; the LSE forward on its
    route (its counter and, where the sweep is split, the combine's moved by
    one) and the template's LSE sweep beside it (`generic_ms`), the combine
    launch of a split sweep as its own row; the LSE forward and dK/dV run
    twice must give the same bits. Library: `scaled_dot_product_attention`, its forward
    for the LSE row and its backward (fwd+bwd − fwd) for the dQ and dK/dV
    rows together, with the backend that ran it. Returns {name: {shape:
    row}}."""
    import torch
    import torch.nn.functional as F

    from sd_tpu_torch.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    from sd_tpu_torch import kernels

    rows_by_shape = {}
    for b, sq, skv, h, d in TRAIN_KERNEL_SHAPES:
        scale = d**-0.5
        q, k, v, do = rnd(b, sq, h, d), rnd(b, skv, h, d), rnd(b, skv, h, d), rnd(b, sq, h, d)
        f32 = lambda *ts: [t.float() for t in ts]
        # the training forward on its Hopper route: one launch on that
        # route's counter, the same bits twice, the template beside it
        route, n_split = fa.lse_route(d), fa.lse_split(b, sq, skv, h, d)
        counters = (*LSE_ROUTE_COUNTER.values(), fa.LSE_COMBINE_COUNTER)
        before = {c: kernels.LAUNCHES[c] for c in counters}
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        moved = {c: kernels.LAUNCHES[c] - n for c, n in before.items()}
        require(moved == {**{c: int(r == route) for r, c in LSE_ROUTE_COUNTER.items()},
                          fa.LSE_COMBINE_COUNTER: int(n_split > 1)},
                f"LSE forward {[b, sq, skv, h, d]} on the {route} route, {n_split} kv "
                f"part(s): moved {moved}")
        o2, lse2 = fa.flash_attention_lse(q, k, v, scale)
        lse_same_bits = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        o_t, lse_t = fa._launch_lse(q, k, v, scale, "template")
        vs_template = (rel_err(o_t, o)[1], (lse_t - lse).abs().max().item())
        del o2, lse2, o_t, lse_t
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
        lib_fwd_bwd = lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*heads), heads, do_h)
        lib_both = time_ms(lib_fwd_bwd)
        backend = sdpa_backend(lib_fwd_bwd)
        shape = [b, sq, skv, h, d]
        rows = {
            "flash_attention_lse": dict(
                max_abs_err=errs["o"][0], rel_err=errs["o"][1], lse_abs_err=lse_err,
                route=route, kv_split=n_split, same_bits_twice=lse_same_bits,
                template_rel_err=vs_template[0], template_lse_abs_diff=vs_template[1],
                ms=time_ms(lambda: fa.flash_attention_lse(q, k, v, scale)),
                generic_ms=time_ms(lambda: fa._launch_lse(q, k, v, scale, "template")),
                device_ms=device_ms(lambda: fa.flash_attention_lse(q, k, v, scale)),
                generic_device_ms=device_ms(lambda: fa._launch_lse(q, k, v, scale, "template")),
                library_device_ms=device_ms(lambda: F.scaled_dot_product_attention(*heads)),
                plain_ms=time_ms(lambda: fa._flash_lse_ref(q, k, v, scale), 3),
                library_ms=lib_fwd, library_call="scaled_dot_product_attention forward",
                library_backend=backend,
                cost=attention_lse_cost(*shape)),
            "flash_bwd_dq": dict(
                max_abs_err=errs["dq"][0], rel_err=errs["dq"][1], l2_rel=l2["dq"],
                ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, scale)),
                plain_ms=time_ms(lambda: fa._flash_bwd_dq_ref(q, k, v, o, lse, do, scale), 3),
                library_ms=lib_both - lib_fwd,
                library_call="scaled_dot_product_attention backward (fwd+bwd - fwd), "
                             "dq and dk/dv together",
                library_backend=backend, cost=attention_dq_cost(*shape)),
            "flash_bwd_dkv": dict(
                max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                rel_err=max(errs["dk"][1], errs["dv"][1]), l2_rel=max(l2["dk"], l2["dv"]),
                deterministic=deterministic,
                ms=time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)),
                plain_ms=time_ms(lambda: fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale), 3),
                library_ms=lib_both - lib_fwd,
                library_call="scaled_dot_product_attention backward (fwd+bwd - fwd), "
                             "dq and dk/dv together",
                library_backend=backend, cost=attention_dkv_cost(*shape)),
        }
        if n_split > 1:
            rows["flash_lse_combine"] = _lse_combine_case(fa, q, k, v, scale, route, n_split)
        for name, r in rows.items():
            cost = r.pop("cost")
            b_ms, b_by, b_op = bound_ms(*cost)
            row = {"phase": "kernel", "name": name, "shape": shape, **r,
                   "bound_ms": b_ms, "bound_by": b_by, "bound_op": b_op}
            emit(row)
            rows_by_shape.setdefault(name, {})[tuple(shape)] = row
        require(errs["o"][1] <= KERNEL_TOL and lse_err <= LSE_TOL,
                f"LSE forward {shape}: o {errs['o'][1]:.3g}·max|ref|, lse2 {lse_err:.3g}")
        require(lse_same_bits and vs_template[0] <= KERNEL_TOL and vs_template[1] <= LSE_TOL,
                f"LSE forward {shape}: the same bits twice ({lse_same_bits}), the template "
                f"within o {vs_template[0]:.3g}·max|o|, lse2 {vs_template[1]:.3g}")
        for g in ("dq", "dk", "dv"):
            require(errs[g][1] <= GRAD_TOL["max_rel"] and l2[g] <= GRAD_TOL["l2_rel"],
                    f"{g} {shape}: max {errs[g][1]:.3g}·max|ref|, l2 {l2[g]:.3g}·‖ref‖")
        require(deterministic, f"dK/dV {shape} gives the same bits twice")
        del q, k, v, do, o, lse, dq, delta, dk, dv, heads
        torch.cuda.empty_cache()
    return rows_by_shape


def _lse_combine_case(fa, q, k, v, scale, route, n_split) -> dict:
    """The combine launch of a split training forward on the parts of one
    real sweep: against its plain version (fp32 o within KERNEL_TOL, lse2
    within LSE_TOL), the same bits twice; its bound is the bytes."""
    import torch

    b, sq, h, d = q.shape
    _, _, part = fa._lse_sweep(q, k, v, scale, route, n_split)

    def run():
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        fa.lse_combine(part, out, lse, n_split)
        return out, lse

    o1, l1 = run()
    o2, l2 = run()
    o_ref, l_ref = fa._lse_combine_ref(part, b, h, sq, d, n_split, torch.float32)
    err, rel = rel_err(o1, o_ref)
    lse_err = (l1 - l_ref).abs().max().item()
    same = bool(torch.equal(o1, o2) and torch.equal(l1, l2))
    require(rel <= KERNEL_TOL and lse_err <= LSE_TOL and same,
            f"LSE combine {[b, sq, h, d]}: o {rel:.3g}·max|ref|, lse2 {lse_err:.3g}, "
            f"same bits twice {same}")
    rows = b * h * sq
    return dict(max_abs_err=err, rel_err=rel, lse_abs_err=lse_err, route=route,
                kv_split=n_split, same_bits_twice=same, ms=time_ms(run), device_ms=device_ms(run),
                plain_ms=time_ms(lambda: fa._lse_combine_ref(part, b, h, sq, d, n_split,
                                                             q.dtype), 3),
                library_ms=None, library_call=None, library_backend=None,
                # reads the parts, writes o and lse2; ~3 fp32 operations a value
                cost=(3 * n_split * rows * d, 4 * n_split * rows * (d + 2) + rows * (2 * d + 4),
                      PEAK_FP32))


def _parity(name, build, inputs_fn, run, tol, gen_cpu, phase="parity"):
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
    emit({"phase": phase, "model": name, "shape": list(out.shape),
          "max_rel": max_rel, "l2_rel": l2_rel, "bound": tol,
          "launches": launches, "cpu_seconds": cpu_s})
    require(bool(torch.isfinite(out).all()) and max_rel <= tol["max_rel"]
            and l2_rel <= tol["l2_rel"], f"{name} parity within {tol}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return launches


def phase_parity(optin: bool = False, serve: bool = False) -> None:
    """UNet and decoder parity; with `optin`, under the opt-in switches,
    requiring exactly the launches `PARITY_OPTIN_LAUNCHES` lists; with
    `serve`, under the serving switches (the variant kernels)."""
    import torch

    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.models.autoencoder import AutoencoderKL
    from sd_tpu_torch.models.unet_sd import UNetModel

    cfg = sd_v1_config()
    g = torch.Generator().manual_seed(1)
    rounded = lambda t: t.bfloat16().float()
    phase = "parity_optin" if optin else "parity_serve" if serve else "parity"

    def unet_inputs():
        return (rounded(torch.randn(2, 32, 32, 4, generator=g)),
                torch.tensor([999, 501]),
                rounded(torch.randn(2, 77, 768, generator=g)))

    with switches(OPT_IN if optin else SERVE if serve else {}):
        unet = _parity(
            "unet", lambda dt, dev: UNetModel(**cfg["unet"]["params"], dtype=dt, device=dev),
            unet_inputs, lambda m, x, t, c: m(x, t, c), UNET_TOL, g, phase)
        decoder = _parity(
            "decoder", lambda dt, dev: AutoencoderKL(**cfg["first_stage"]["params"],
                                                     dtype=dt, device=dev),
            lambda: (rounded(torch.randn(1, 32, 32, 4, generator=g)),),
            lambda m, z: m.decode(z), DECODER_TOL, g, phase)
    if optin or serve:
        want = PARITY_OPTIN_LAUNCHES if optin else PARITY_SERVE_LAUNCHES
        require({"unet": unet, "decoder": decoder} == want,
                f"{phase} launches {unet}, {decoder} == {want}")
        return
    # latent 32² puts 1024 tokens through level 0: both UNet kernels run
    require(unet["flash_attention_hpacked"] == 5 and unet["flash_fwd_sm90"] == 5
            and unet["geglu_ff"] == 5, f"UNet parity launches {unet}")
    require(decoder["flash_attention"] == 1 and decoder["flash_fwd_wide"] == 1
            and decoder["conv3x3_same"] == 12, f"decoder parity launches {decoder}")


def _timed_generate(pipe, prompts, env: dict) -> tuple[float, dict, object]:
    """Seconds, launches and uint8 images of one 50-step CFG generate under
    the environment `env`."""
    import torch

    from sd_tpu_torch import kernels

    with switches(env):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = pipe.generate(prompts, num_steps=50, guidance_scale=7.5, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return secs, dict(kernels.LAUNCHES), images


def _check_images(pipe, prompts, images, env: dict) -> dict:
    """uint8 [2, 512, 512, 3] images; the same run's image before
    quantisation (same seed, same noise) finite and non-constant, and how
    many of its bytes differ from the images once quantised."""
    import torch

    from sd_tpu_torch.pipeline import to_uint8

    with switches(env):
        g = torch.Generator("cuda").manual_seed(0)
        x_T = torch.randn((2,) + pipe.latent_shape, generator=g, device="cuda")
        pre = pipe.sample(prompts, x_T, num_steps=50, guidance_scale=7.5, generator=g)
    pre32 = pre.float()
    require(images.shape == (2, 512, 512, 3) and images.dtype.name == "uint8",
            f"uint8 [2, 512, 512, 3] images, got {images.dtype} {images.shape}")
    require(bool(torch.isfinite(pre32).all()), "finite image before quantisation")
    require(pre32.std().item() > 0 and images.std() > 0, "non-constant image")
    return {"pre_quant_min": pre32.min().item(), "pre_quant_max": pre32.max().item(),
            "pre_quant_std": pre32.std().item(),
            "uint8_mismatch_vs_rerun": int((to_uint8(pre) != images).sum())}


def phase_e2e() -> dict:
    import torch

    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.pipeline import Text2ImagePipeline
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

    secs, launches, images = _timed_generate(pipe, prompts, {})
    row = {"phase": "e2e", "images": list(images.shape), "dtype": str(images.dtype),
           "seconds_per_generate": secs, "images_per_second": len(prompts) / secs,
           "pipeline_build_seconds": build_s, "launches": launches,
           **_check_images(pipe, prompts, images, {}),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    total = launches["flash_attention"] + launches["flash_attention_hpacked"]
    require(launches == EXPECTED_LAUNCHES and total == 501,
            f"launches {launches} == {EXPECTED_LAUNCHES}")
    return launches, pipe, prompts, images


def phase_e2e_optin(pipe, prompts, default_images) -> dict:
    """The same generate with the opt-in switches set for the phase: image
    checks and launches of its first timed run, then both configurations
    timed in turns (default, opt-in, opt-in, default)."""
    import torch

    with switches(OPT_IN):
        pipe.generate(prompts, num_steps=2)      # warm-up, not counted
    secs, launches, images = _timed_generate(pipe, prompts, OPT_IN)
    checks = _check_images(pipe, prompts, images, OPT_IN)
    turns = {"default": [], "optin": []}
    for which in ("default", "optin", "optin", "default"):
        turns[which].append(_timed_generate(pipe, prompts, OPT_IN if which == "optin" else {})[0])
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    emit({"phase": "e2e_optin", "switches": OPT_IN, "images": list(images.shape),
          "seconds_per_generate": secs, "images_per_second": len(prompts) / secs,
          "launches": launches, **checks,
          "uint8_mismatch_vs_default": int((images != default_images).sum()),
          "turns_seconds": turns, "mean_seconds_per_generate": mean,
          "optin_over_default": mean["optin"] / mean["default"],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    require(launches == EXPECTED_LAUNCHES_OPTIN,
            f"opt-in launches {launches} == {EXPECTED_LAUNCHES_OPTIN}")
    return launches


class _Recording:
    """The served pipeline, keeping the prompts and keywords of every batch
    the server runs (so a direct `generate` can repeat one)."""

    def __init__(self, pipe):
        self.pipe, self.batches = pipe, []

    def generate(self, prompts, **kw):
        self.batches.append((list(prompts), kw))
        return self.pipe.generate(prompts, **kw)


SERVE_PROMPTS = ["a photograph of an astronaut riding a horse",
                 "a watercolor painting of a lighthouse at dusk",
                 "a red cube on a wooden table", "a city street at night in the rain"]
SERVE_WATERMARK = "sd-tpu-torch"


def phase_serve(pipe, smi: str) -> dict:
    """The serving entry point with the variant kernels: `BatchingServer`
    (max_batch 4, a server-wide watermark) behind `make_http_server` on
    127.0.0.1, with SD_TPU_FLASH_EXP=bf16 SD_TPU_FLASH_PV=int8 set for the
    phase. Four same-key requests (30 DDIM steps, CFG 7.5, seed 1234) are
    queued before the batcher starts, so they run as one bucket-4 generate
    (the launch counts are read around it); then one `dpm` request at 20
    steps, one 512×768, one weighted prompt, and GET /healthz. The grouped
    images are held against a direct `generate` of the same batch."""
    import base64
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.serve import BatchingServer, decode_png, make_http_server
    from sd_tpu_torch.utils.watermark import verify_watermark

    rec = _Recording(pipe)
    batcher = BatchingServer(rec, max_batch=4, batch_window_ms=50,
                             default_steps=SERVE_STEPS, watermark=SERVE_WATERMARK)
    server = make_http_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body) -> tuple[int, dict, float]:
        req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0

    def image(out) -> "np.ndarray":
        return decode_png(base64.b64decode(out["image"]))

    try:
        with switches(SERVE):
            pipe.generate(SERVE_PROMPTS, num_steps=2)          # warm-up, not counted
            bodies = [{"prompt": p, "steps": SERVE_STEPS, "guidance_scale": 7.5, "seed": 1234}
                      for p in SERVE_PROMPTS]
            grouped = {}
            threads = [threading.Thread(target=lambda i=i, b=b: grouped.__setitem__(i, post(b)),
                                        daemon=True) for i, b in enumerate(bodies)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while batcher.queue_depth() < len(bodies) and time.monotonic() < deadline:
                time.sleep(0.005)
            require(batcher.queue_depth() == len(bodies), "the four requests queued")
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            batcher.start()
            for t in threads:
                t.join(600)
            torch.cuda.synchronize()
            group_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            require(len(grouped) == len(bodies) and len(rec.batches) == 1,
                    "the four requests answered by one generate")
            prompts, kw = rec.batches[0]
            direct = pipe.generate(prompts, **kw)
            diffs, grouped_rows = [], []
            for i, body in enumerate(bodies):
                status, out, latency = grouped[i]
                img = image(out)
                require(status == 200 and img.shape == (512, 512, 3)
                        and out["batch_size"] == 4 and out["seed"] == 1234,
                        f"grouped request {i}: {status} {img.shape} {out['batch_size']}")
                diffs.append(int(np.abs(img.astype(int)
                                        - direct[prompts.index(body["prompt"])]).max()))
                grouped_rows.append({"latency_s": latency, "batch_size": out["batch_size"]})
            singles = []
            for body, size in (({"prompt": "a lighthouse", "sampler": "dpm", "steps": 20,
                                 "seed": 7}, (512, 512, 3)),
                               ({"prompt": "a wide valley", "height": 512, "width": 768,
                                 "seed": 8}, (512, 768, 3)),
                               ({"prompt": "(cat:1.3)", "seed": 9}, (512, 512, 3))):
                torch.cuda.synchronize()
                status, out, latency = post(body)
                img = image(out)
                require(status == 200 and img.shape == size and out["batch_size"] == 1,
                        f"request {body}: {status} {img.shape}")
                singles.append({"request": body, "latency_s": latency, "shape": list(img.shape),
                                "std": float(img.std())})
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            marked = verify_watermark(image(grouped[0][1]), SERVE_WATERMARK)
    finally:
        batcher.stop()
        server.shutdown()
        server.server_close()
        thread.join(10)
    row = {"phase": "serve", "nvidia_smi": smi, "switches": SERVE,
           "grouped": {"requests": grouped_rows, "seconds": group_s,
                       "images_per_second": len(bodies) / group_s, "steps": SERVE_STEPS},
           "max_uint8_diff_vs_direct_generate": max(diffs),
           "same_bits_as_direct_generate": max(diffs) == 0,
           "singles": singles, "healthz": health, "watermark_verified": bool(marked),
           "launches": launches, "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    require(max(diffs) <= 1, f"served images within 1 uint8 level of a direct generate: "
            f"{max(diffs)}")
    require(health == {"ok": True, "queue_depth": 0, "requests_served": 7, "batches_run": 4},
            f"healthz {health}")
    require(marked, "the server's watermark reads back")
    require(launches == EXPECTED_SERVE_LAUNCHES,
            f"serve launches {launches} == {EXPECTED_SERVE_LAUNCHES}")
    return launches, rec.batches[0]


# the other switch combinations, each with the launches of one serving UNet
# call (bucket 4: batch 8, 512²) and one decode (batch 4)
SWITCH_COMBINATIONS = (
    ({"SD_TPU_FLASH_EXP": "bf16"}, "flash_attention_hpacked_exp_bf16",
     "flash_attention_exp_bf16"),
    ({"SD_TPU_FLASH_PV": "int8"}, "flash_attention_hpacked_pv_int8",
     "flash_attention_pv_int8"),
    ({"SD_TPU_FLASH_EXP": "bf16", "SD_TPU_FLASH_PV": "int8", "SD_TPU_FLASH_PIPE": "1"},
     "flash_attention_hpacked_exp_bf16_pv_int8", "flash_attention_pipelined_exp_bf16"))


def phase_switch_combinations(pipe) -> dict:
    """One UNet call and one decode of the serving shapes under each other
    combination of the switches: which kernel each reaches, and a finite
    output. Returns {kernel: launches} of the variants these reach."""
    import torch

    from sd_tpu_torch import kernels

    c, uc = pipe.encode_prompts(SERVE_PROMPTS)
    ctx = torch.cat([uc, c])
    x = torch.randn((8,) + pipe.latent_shape, device="cuda").bfloat16()
    t = torch.full((8,), 501, device="cuda")
    z = torch.randn((4,) + pipe.latent_shape, device="cuda").bfloat16()
    seen = {}
    for env, hpacked, decoder in SWITCH_COMBINATIONS:
        with switches(env), torch.no_grad():
            kernels.reset_launches()
            out, img = pipe.unet(x, t, ctx), pipe.vae.decode(z)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        emit({"phase": "switches", "switches": env, "launches": launches,
              "finite": bool(torch.isfinite(out).all() and torch.isfinite(img).all())})
        # the head-packed launches take the Hopper route (its int8-PV form with
        # the int8 PV), the decoder's (serial or pipelined) the wide kernel
        route = "flash_fwd_sm90_pv8" if hpacked.endswith("pv_int8") else "flash_fwd_sm90"
        want = {hpacked: 10, decoder: 1, "geglu_ff": 10, "conv3x3_same": 18, route: 10,
                "flash_fwd_wide": 1}
        require(launches == want
                and bool(torch.isfinite(out).all() and torch.isfinite(img).all()),
                f"switches {env}: launches {launches} == {want}")
        seen.setdefault(hpacked, 10)
        seen[decoder] = 1
    return seen


# the attention switches of the TPU package the port reads, each with the
# launches one level-0 transformer attention ([2, 4096, 320], 8 heads of 40)
# makes under it: self-attention at inference ("self"), the 77-token
# cross-attention ("cross") and self-attention forward + backward in a
# training step ("train")
ATTN_SWITCH_CASES = (
    ({}, "self", {"flash_attention_hpacked": 1, "flash_fwd_sm90": 1}),
    ({"SD_TPU_ATTN_HPACKED": "0"}, "self", {"flash_attention": 1, "flash_fwd_sm90": 1}),
    ({"SD_TPU_ATTN_HPACKED": "0", "SD_TPU_ATTN_PACKED": "1"}, "self",
     {"flash_attention": 1, "flash_fwd_sm90": 1}),
    ({"SD_TPU_ATTN_IMPL": "xla"}, "self", {}),
    ({}, "cross", {}),
    ({"SD_TPU_ATTN_IMPL": "pallas"}, "cross", {"flash_attention": 1, "flash_fwd_sm90": 1}),
    ({}, "train", {"flash_attention_lse": 1, "flash_lse_sm90": 1, "flash_bwd_dq": 1,
                   "flash_bwd_dkv": 1}),
    ({"SD_TPU_ATTN_PACKED": "1"}, "train",
     {"flash_attention_lse": 1, "flash_lse_sm90": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
    ({"SD_TPU_FLASH_BWD": "chunked"}, "train", {"flash_attention": 1, "flash_fwd_sm90": 1}),
    ({"SD_TPU_ATTN_IMPL": "xla"}, "train", {}),
)


def phase_attention_switches() -> None:
    """Each of `ATTN_SWITCH_CASES` on the card: the launches that move, and
    the output (and in training the input gradient) of the bf16 block
    against the same block in fp32 (the plain path, by the dtype rule):
    ‖Δ‖₂ ≤ 0.03·‖ref‖₂ forward, ‖Δg‖₂ ≤ 0.1·‖g‖₂ backward."""
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.kernels.conv2d import training_trace
    from sd_tpu_torch.nn.attention import CrossAttention
    from sd_tpu_torch.weights import randomize_params_

    g = torch.Generator("cuda").manual_seed(3)
    blocks = {}
    for kind, ctx_dim in (("self", None), ("cross", 768)):
        f32 = CrossAttention(320, ctx_dim, 8, 40, device="cuda")
        randomize_params_(f32, g)
        with torch.no_grad():
            for p in f32.parameters():
                p.copy_(p.bfloat16().float())
        bf = CrossAttention(320, ctx_dim, 8, 40, dtype=torch.bfloat16, device="cuda")
        bf.load_state_dict(f32.state_dict())
        blocks[kind] = (bf, f32)
    x = torch.randn(2, 4096, 320, generator=g, device="cuda").bfloat16()
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda").bfloat16()
    blocks["train"] = blocks["self"]
    for env, kind, want in ATTN_SWITCH_CASES:
        bf, f32 = blocks[kind]
        c = ctx if kind == "cross" else None
        with switches(env):
            kernels.reset_launches()
            if kind == "train":
                xb, xf = x.clone().requires_grad_(), x.float().requires_grad_()
                with training_trace():
                    out = bf(xb)
                    out.float().pow(2).mean().backward()
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
                ref = f32(xf)
                ref.pow(2).mean().backward()
                grad_l2 = l2_rel(xb.grad, xf.grad)
            else:
                with torch.no_grad():
                    out = bf(x, c)
                    torch.cuda.synchronize()
                    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
                    ref = f32(x.float(), None if c is None else c.float())
                grad_l2 = None
        err = l2_rel(out.detach(), ref.detach())
        emit({"phase": "attention_switches", "switches": env, "call": kind,
              "launches": launches, "l2_rel": err, "grad_l2_rel": grad_l2})
        require(launches == want, f"switches {env} ({kind}): launches {launches} == {want}")
        require(err <= UNET_TOL["l2_rel"] and (grad_l2 is None or grad_l2 <= TRAIN_GRAD_TOL),
                f"switches {env} ({kind}): ‖Δ‖₂ {err:.3g}, ‖Δg‖₂ {grad_l2}")
    del blocks
    torch.cuda.empty_cache()


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
    require(launches["flash_attention_lse"] == 5 and launches["flash_lse_sm90"] == 5
            and launches["flash_bwd_dq"] == 5
            and launches["flash_bwd_dkv"] == 5 and launches["flash_attention_hpacked"] == 0
            and launches["geglu_ff"] == 0, f"train parity launches {launches}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return row


def _image_batches(tc: dict, n: int, rng):
    """n batches of {'image'} of the train config's size: uint8-range images
    scaled to [-1, 1], as the image loaders give them."""
    import numpy as np

    for _ in range(n):
        img = rng.integers(0, 256, (tc["batch_size"], tc["image_size"], tc["image_size"], 3),
                           dtype=np.uint8)
        yield {"image": img.astype(np.float32) / 127.5 - 1.0}


def _train_batches(cfg, n: int, seed: int = 0):
    """n image batches of the config's size with class captions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    classes = ("cat", "dog")
    for batch in _image_batches(cfg["train"], n, rng):
        labels = rng.integers(0, len(classes), cfg["train"]["batch_size"])
        yield {**batch,
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
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "lse_route_launches_per_step": {c: launches[c] / steps for c in (
               *LSE_ROUTE_COUNTER.values(), "flash_lse_combine")}}
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


class _GradRecorder:
    """Stands in for an optimizer: keeps the gradients it is handed (fp32)
    and changes no parameter."""

    def init(self, params):
        return None

    def update_(self, params, grads, state):
        self.grads = [g.detach().float() for g in grads]


def _klvae_config() -> dict:
    """kl_f8_256_train_config() under the bf16 parameter policy."""
    from sd_tpu_torch.core.config import kl_f8_256_train_config

    cfg = kl_f8_256_train_config()
    cfg["train"]["param_dtype"] = "bfloat16"
    return cfg


def phase_klvae_parity() -> dict:
    """One KL GAN step of the full-width KL-f8 codec, PatchGAN and LPIPS at
    256², batch 2, `disc_start` 0, every weight random (bf16-rounded): bf16
    parameters with the kernels on the card against fp32 plain on the card
    (TF32 off), same weights, images and posterior noise. Each loss term,
    d_weight, and the generator's gradients (global and at each mid-block
    AttnBlock q/k/v/proj_out weight) against their gates; launches 2/2/2.
    The bf16 step once more with the attention on its plain version tells
    what the bf16 policy alone moves from what the kernels add."""
    import math

    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.losses.gan import GanLossConfig
    from sd_tpu_torch.models.autoencoder import AutoencoderKL
    from sd_tpu_torch.models.discriminator import NLayerDiscriminator
    from sd_tpu_torch.models.lpips import make_lpips_fn
    from sd_tpu_torch.train.gan import init_gan_state, make_kl_gan_train_step
    from sd_tpu_torch.weights import randomize_params_

    cfg = _klvae_config()
    mp, B, px = cfg["model"]["params"], 2, cfg["train"]["image_size"]
    g = torch.Generator("cuda").manual_seed(5)
    vae = AutoencoderKL(**mp, dtype=torch.float32, device="cuda")
    disc = NLayerDiscriminator(**cfg["discriminator"], dtype=torch.float32, device="cuda")
    for module in (vae, disc):
        randomize_params_(module, g)
        with torch.no_grad():
            for p in module.parameters():  # the bf16 run's weights are these
                p.copy_(p.bfloat16().float())
    lpips_fn = make_lpips_fn(mode="random", device="cuda")
    x = torch.rand(B, px, px, 3, generator=g, device="cuda") * 2 - 1
    lat = px // 2 ** (len(mp["ch_mult"]) - 1)
    noise = torch.randn(B, lat, lat, mp["embed_dim"], generator=g, device="cuda")
    loss_cfg = GanLossConfig(**{**cfg["loss"], "disc_start": 0})

    def run(param_dtype):
        opt_g, opt_d = _GradRecorder(), _GradRecorder()
        state = init_gan_state(vae, disc, opt_g, opt_d, param_dtype=param_dtype)
        step = make_kl_gan_train_step(lambda x, _: vae(x, noise), disc, lpips_fn,
                                      opt_g, opt_d, loss_cfg)
        logs = {k: float(v) for k, v in step(state, x, None).items()}
        return logs, dict(zip(state.params_g, opt_g.grads))

    logs32, grads32 = run(None)
    kernels.reset_launches()
    logs16, grads16 = run(torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the same bf16 step with the attention on its plain version: what the
    # bf16 policy alone moves, and how far the kernels are from it
    with mock.patch("sd_tpu_torch.kernels.attention.flash_ok", lambda q, k: False):
        logs_plain, grads_plain = run(torch.bfloat16)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    terms = ("total_loss", "nll_loss", "kl_loss", "g_loss", "rec_loss", "disc_loss")
    loss_rel = {t: rel(logs16[f"train/{t}"], logs32[f"train/{t}"]) for t in terms}
    dw_rel = rel(logs16["train/d_weight"], logs32["train/d_weight"])
    d2 = sum(((grads16[n] - grads32[n]) ** 2).sum().item() for n in grads32)
    n2 = sum((grads32[n] ** 2).sum().item() for n in grads32)
    attn = {n: l2_rel(grads16[n], grads32[n]) for n in grads32
            if ".AttnBlock_0." in n and n.endswith(("q.weight", "k.weight", "v.weight",
                                                    "proj_out.weight"))}
    global_rel = lambda a, b: math.sqrt(sum(((a[n] - b[n]) ** 2).sum().item() for n in b)
                                        / sum((b[n] ** 2).sum().item() for n in b))
    row = {"phase": "klvae_parity", "images": [B, px, px, 3],
           "logs_bf16": logs16, "logs_fp32": logs32, "loss_rel": loss_rel,
           "d_weight_rel": dw_rel, "grad_l2_rel": math.sqrt(d2 / n2),
           "attn_l2_rel": attn, "launches": launches,
           "bf16_plain_vs_fp32": {
               "loss_rel": {t: rel(logs_plain[f"train/{t}"], logs32[f"train/{t}"]) for t in terms},
               "grad_l2_rel": global_rel(grads_plain, grads32),
               "attn_l2_rel": {n: l2_rel(grads_plain[n], grads32[n]) for n in attn}},
           "kernels_vs_bf16_plain": {
               "grad_l2_rel": global_rel(grads16, grads_plain),
               "attn_l2_rel": {n: l2_rel(grads16[n], grads_plain[n]) for n in attn}},
           "bounds": {"loss_rel": KLVAE_LOSS_TOL, "d_weight_rel": KLVAE_DWEIGHT_TOL,
                      "grad_l2_rel": KLVAE_GRAD_TOL}}
    emit(row)
    require(len(attn) == 8, f"8 mid-block AttnBlock q/k/v/proj_out weights, found {sorted(attn)}")
    require(all(math.isfinite(v) for v in logs16.values()), "finite bf16 logs")
    require(max(loss_rel.values()) <= KLVAE_LOSS_TOL, f"loss terms within {KLVAE_LOSS_TOL}: {loss_rel}")
    require(dw_rel <= KLVAE_DWEIGHT_TOL, f"d_weight within {KLVAE_DWEIGHT_TOL}: {dw_rel:.3g}")
    require(row["grad_l2_rel"] <= KLVAE_GRAD_TOL and max(attn.values()) <= KLVAE_GRAD_TOL,
            f"generator gradients within {KLVAE_GRAD_TOL}: global {row['grad_l2_rel']:.3g}, "
            f"attention up to {max(attn.values()):.3g}")
    require(launches == EXPECTED_KLVAE_LAUNCHES,
            f"KL-VAE parity launches {launches} == {EXPECTED_KLVAE_LAUNCHES}")
    del vae, disc, lpips_fn
    torch.cuda.empty_cache()
    return row


def phase_klvae_train() -> dict:
    """train_kl_vae(kl_f8_256_train_config(), bf16 parameters) at full width,
    every weight random from the config's seed, on seeded uint8-range 256²
    images, batch 4: 1 warm-up and KLVAE_STEPS timed steps, launch counts
    over the whole run."""
    import math

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.train.runners import train_kl_vae

    cfg = _klvae_config()
    tc = cfg["train"]
    steps = 1 + KLVAE_STEPS
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = train_kl_vae(cfg, _image_batches(tc, steps, np.random.default_rng(3)),
                               max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    timed = [r["seconds"] for r in hist[1:]]
    sec = sum(timed) / len(timed)
    moments = (state.opt_state_g.mu + state.opt_state_g.nu
               + state.opt_state_d.mu + state.opt_state_d.nu)
    gen_params = [p for n, p in state.params_g.items() if n != "logvar"]
    row = {"phase": "klvae_train", "steps": len(hist), "timed_step_seconds": timed,
           "seconds_per_step": sec, "images_per_second": tc["batch_size"] / sec,
           "run_seconds": run_s, "peak_memory_gb": peak_gb,
           "losses": {k[len("train/"):]: [r[k] for r in hist] for k in hist[0]
                      if k.startswith("train/")},
           "params_g": sum(p.numel() for p in gen_params),
           "params_d": sum(p.numel() for p in state.params_d.values()),
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "lse_route_launches_per_step": {c: launches[c] / steps for c in (
               *LSE_ROUTE_COUNTER.values(), "flash_lse_combine")}}
    emit(row)
    require(len(hist) == steps, f"{steps} steps, ran {len(hist)}")
    require(all(math.isfinite(v) for r in hist for v in r.values()), "finite losses and logs")
    require(all(p.dtype == torch.bfloat16 for p in gen_params + list(state.params_d.values())),
            "bf16 generator and discriminator parameters")
    require(state.params_g["logvar"].dtype == torch.float32 and hist[-1]["train/logvar"] != 0.0,
            "an fp32 logvar that trains")
    require(all(m.dtype == torch.float32 for m in moments)
            and any(bool(m.abs().sum() > 0) for m in state.opt_state_g.mu), "fp32 Adam moments")
    want = {k: v * steps for k, v in EXPECTED_KLVAE_LAUNCHES.items()}
    require(launches == want, f"KL-VAE train launches {launches} == {want}")
    del state
    torch.cuda.empty_cache()
    return row


def phase_klvae_profile() -> None:
    """Where one train_kl_vae step goes (`--profile`): the second step of a
    two-step run under torch.profiler, by kernel family, and its busy
    share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sd_tpu_torch.train.runners import train_kl_vae

    cfg = _klvae_config()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = []

    def batches():
        first, second = _image_batches(cfg["train"], 2, np.random.default_rng(4))
        yield first
        torch.cuda.synchronize()
        prof.start()
        start.append(time.perf_counter())
        yield second

    _, hist = train_kl_vae(cfg, batches(), max_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start[0]
    prof.stop()
    emit({"phase": "profile", "of": "train_kl_vae step", "step_seconds": hist[1]["seconds"],
          **_device_breakdown(prof, wall)})


def ptxas_report(log: str, keep) -> dict:
    """{kernel: [registers, spill store bytes, spill load bytes]} from an
    `nvcc -Xptxas -v` log, for the mangled kernel names `keep` accepts."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if keep(m.group(1)) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, [None, 0, 0])[0] = int(m.group(1))
    return out


def _flash_fwd_args(mangled: str):
    """(padded head dim, [LSE, PIPE, EXPB]) of a mangled flash_fwd_kernel
    instantiation, or None for another kernel."""
    import re

    m = re.search(r"flash_fwd_kernelILi(\d+)ELi\d+ELi\d+ELi\d+E((?:Lb[01]E)+)", mangled)
    if m is None:
        return None
    return int(m.group(1)), [f == "1" for f in re.findall(r"Lb([01])E", m.group(2))]


def wide_flash_registers() -> dict:
    """Registers and spills of the flash kernels' head-dim 256 and 512
    instantiations (the training forward and the wide dQ, dK/dV kernels),
    from the build's logs."""
    import re

    from sd_tpu_torch.kernels import _build

    def keep(n):
        fwd = _flash_fwd_args(n)
        return (fwd[0] in (256, 512) and fwd[1][0]) if fwd else (
            "wide_kernel" in n and re.search(r"ILi(256|512)E", n))

    short = {}
    for lib in ("flash_attention", "flash_attention_bwd"):
        log = (_build.build_dir() / f"{lib}.log").read_text()
        for mangled, vals in ptxas_report(log, keep).items():
            kind = re.search(r"(flash_bwd_dq_wide|flash_bwd_dkv_wide|flash_fwd)_kernel", mangled)
            dp = re.search(r"ILi(\d+)E", mangled).group(1)
            short[f"{kind.group(1)}<{dp}>" + (" lse" if kind.group(1) == "flash_fwd" else "")] = {
                "registers": vals[0], "spill_stores": vals[1], "spill_loads": vals[2]}
    return short


def variant_flash_registers() -> dict:
    """Registers and spills of the inference forwards' instantiations at the
    path's head dims (40 → 48, 80, 512): the Hopper kernels
    (`flash_fwd_sm90<DP>`, its int8-PV form `flash_fwd_sm90_pv8<DP>`, the
    wide kernel `flash_fwd_wide<DP>`; `lse` marks the training forward's
    instantiations), the template's sweeps and its int8 PV kernel
    (`flash_fwd_pv8<DP>`), variants included; and the 3×3 convs (the Hopper
    kernel, `conv2d.cu`'s plain and `PRO` forms)."""
    import re

    from sd_tpu_torch.kernels import _build

    out = {}
    for lib, kind, pattern, flags in (
            ("flash_attention_sm90", "flash_fwd_sm90",
             r"flash_fwd_sm90_kernelILi(\d+)E((?:Lb[01]E){2})", ("exp_bf16", "lse")),
            ("flash_attention_sm90_pv8", "flash_fwd_sm90_pv8",
             r"flash_fwd_sm90_pv8_kernelILi(\d+)E(Lb[01]E)", ("exp_bf16",)),
            ("flash_attention_wide", "flash_fwd_wide",
             r"flash_fwd_wide_kernelILi(\d+)E((?:Lb[01]E){4})",
             ("exp_bf16", "pipe", "pv_int8", "lse")),
            ("flash_attention", "flash_fwd_pv8", r"flash_fwd_pv8_kernelILi(\d+)E.*(Lb[01]E)E",
             ("exp_bf16",))):
        log = (_build.build_dir() / f"{lib}.log").read_text()

        def keep(n, pattern=pattern):
            m = re.search(pattern, n)
            return bool(m) and int(m.group(1)) in (48, 80, 512)

        for mangled, vals in ptxas_report(log, keep).items():
            m = re.search(pattern, mangled)
            on = [f == "1" for f in re.findall(r"Lb([01])E", m.group(2))]
            out[f"{kind}<{m.group(1)}>" + "".join(" " + f for f, o in zip(flags, on) if o)] = {
                "registers": vals[0], "spill_stores": vals[1], "spill_loads": vals[2]}
    # the 3×3 convs: the Hopper kernel and conv2d.cu's plain and PRO forms
    for lib in ("conv2d_sm90", "conv2d"):
        log = (_build.build_dir() / f"{lib}.log").read_text()
        for mangled, vals in ptxas_report(log, lambda n: "conv3x3" in n).items():
            name = ("conv3x3_sm90" if "sm90" in mangled
                    else "conv3x3 pro" if "ILb1E" in mangled else "conv3x3")
            out[name] = {"registers": vals[0], "spill_stores": vals[1], "spill_loads": vals[2]}

    def keep(n):
        fwd = _flash_fwd_args(n)
        return bool(fwd) and fwd[0] in (48, 80, 512) and not fwd[1][0]

    log = (_build.build_dir() / "flash_attention.log").read_text()
    for mangled, vals in ptxas_report(log, keep).items():
        dp, (_, pipe, expb) = _flash_fwd_args(mangled)
        names = [f for f, on in (("pipe", pipe), ("exp_bf16", expb)) if on]
        out[f"flash_fwd<{dp}>" + "".join(" " + f for f in names)] = {
            "registers": vals[0], "spill_stores": vals[1], "spill_loads": vals[2]}
    return out


def flash_smem() -> dict:
    """Dynamic shared memory (bytes) of the inference forwards at the path's
    head dims: each Hopper kernel where it serves, and the template's
    serial, pipelined and int8 PV sweeps."""
    import ctypes

    from sd_tpu_torch.kernels import _build

    fn = _build.function("flash_attention", "sd_flash_fwd_smem", [ctypes.c_int] * 3)
    sm90 = _build.function("flash_attention_sm90", "sd_flash_fwd_sm90_smem", [ctypes.c_int])
    pv8 = _build.function("flash_attention_sm90_pv8", "sd_flash_fwd_sm90_pv8_smem",
                          [ctypes.c_int])
    wide = _build.function("flash_attention_wide", "sd_flash_fwd_wide_smem", [ctypes.c_int] * 2)
    out = {}
    for d in (40, 80, 512):
        out[d] = ({"sm90": sm90(d), "sm90_pv8": pv8(d)} if d <= 128
                  else {"wide": wide(d, 0), "wide_pv8": wide(d, 1)})
        out[d]["template"] = [fn(d, 0, 0), fn(d, 1, 0), fn(d, 0, 1)]
    return out


def _family(name: str) -> str:
    low = name.lower()
    if "flash_fwd_sm90_kernel<" in name:
        # template arguments <DP, EXPB, LSE>
        lse = name.split("flash_fwd_sm90_kernel<")[1].split(">")[0].split(", ")[2] == "true"
        return "flash LSE forward, Hopper (port)" if lse else "flash Hopper forward (port)"
    if "flash_fwd_sm90_pv8_kernel<" in name:
        return "flash Hopper int8 PV (port)"
    if "flash_fwd_wide_kernel<" in name:
        # template arguments <DP, EXPB, PIPE, PV8, LSE>
        lse = name.split("flash_fwd_wide_kernel<")[1].split(">")[0].split(", ")[4] == "true"
        return "flash LSE forward, wide (port)" if lse else "flash wide forward (port)"
    if "conv3x3_sm90_kernel" in name or "pack_weights_kernel" in name:
        return "conv3x3 Hopper (port)"
    if "lse_combine_kernel" in name:
        return "flash LSE combine (port)"
    if "v_codes_kernel" in name:
        return "flash int8 PV pre-pass (port)"
    if "flash_fwd_pv8_kernel<" in name or "v_scale_kernel" in name:
        return "flash int8 PV, template (port)"
    if "flash_fwd_kernel<" in name:
        # template arguments <DP, BQ, BK, CW, LSE, PIPE>
        args = name.split("flash_fwd_kernel<")[1].split(">")[0].split(", ")
        if args[4] == "true":
            return "flash LSE forward, template (port)"
        return "flash pipelined (port)" if args[5] == "true" else "flash (port)"
    if "conv3x3_kernel<true>" in name:
        return "GN-SiLU-conv3x3 (port)"
    for key, fam in (("flash_bwd_dq", "flash dQ (port)"), ("flash_bwd_dkv", "flash dK/dV (port)"),
                     ("geglu_kernel", "geglu (port)"), ("conv3x3_kernel", "conv3x3 (port)"),
                     ("gn_stats_kernel", "groupnorm (port)"), ("gn_norm_kernel", "groupnorm (port)"),
                     ("crossattn_kernel", "cross-attention (port)")):
        if key in name:
            return fam
    if "conv" in low or "fprop" in low or "cudnn" in low:
        return "conv (cuDNN)"
    if "gemm" in low or "cutlass" in low or "matmul" in low:
        return "matmul (cuBLAS)"
    if "reduce" in low or "norm" in low:
        return "reductions"
    return "elementwise/other"


def phase_profile(pipe, prompts, optin: bool = False) -> None:
    """Where one generate's time goes (`--profile`): the layers' times from
    CUDA events, and device time by kernel family from torch.profiler over
    a whole 50-step generate, against its wall time; with `optin`, under the
    opt-in switches."""
    with switches(OPT_IN if optin else {}):
        _profile_generate(pipe, prompts, "generate (opt-in)" if optin else "generate")


def phase_profile_serve(pipe, grouped) -> None:
    """Where the serve phase's grouped generate goes (`--profile`): the call
    the batcher made for the four grouped requests (bucket 4, 30 DDIM steps,
    CFG 7.5, 512², `grouped` = its prompts and keywords) again under the
    serving switches and torch.profiler: device time by kernel family
    against its wall time, and its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sd_tpu_torch import kernels

    prompts, kw = grouped
    with switches(SERVE):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.generate(prompts, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    emit({"phase": "profile", "of": "serve: grouped bucket-4 generate", "switches": SERVE,
          "launches": launches, **_device_breakdown(prof, wall)})


def _profile_generate(pipe, prompts, of: str) -> None:
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
    emit({"phase": "profile", "of": of, "layers": layers,
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
    for var in (*OPT_IN, *SERVE, "SD_TPU_PALLAS_CONV", "SD_TPU_ATTN_IMPL", "SD_TPU_ATTN_HPACKED",
                "SD_TPU_ATTN_PACKED", "SD_TPU_FLASH_BWD"):   # each phase sets what it measures
        os.environ.pop(var, None)
    torch.backends.cudnn.allow_tf32 = False       # fp32 references in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from sd_tpu_torch.kernels import _build
    from sd_tpu_torch.kernels.flash_attention import launch_name as fa_launch_name

    t0 = time.perf_counter()
    per_lib = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library": per_lib,
          "wide_flash_registers": wide_flash_registers(),
          "flash_variant_registers": variant_flash_registers(),
          "flash_fwd_smem_bytes": flash_smem(),
          "conv3x3_sm90_smem_bytes": _build.function("conv2d_sm90", "sd_conv3x3_fwd_sm90_smem",
                                                     [])()})

    gen = torch.Generator("cuda").manual_seed(0)
    table, hopper_rows = phase_kernels(gen)
    variant_table, hopper_variant_rows = phase_variant_kernels(gen)
    table.update(variant_table)
    train_rows = phase_train_kernels(gen)
    phase_attention_switches()
    phase_parity()
    phase_parity(optin=True)
    phase_parity(serve=True)
    launches, pipe, prompts, images = phase_e2e()
    launches_optin = phase_e2e_optin(pipe, prompts, images)
    launches_serve, grouped = phase_serve(pipe, smi)
    launches_switches = phase_switch_combinations(pipe)
    profiling = "--profile" in sys.argv[1:]
    if profiling:
        phase_profile(pipe, prompts)
        phase_profile(pipe, prompts, optin=True)
        phase_profile_serve(pipe, grouped)
    del pipe
    torch.cuda.empty_cache()
    phase_train_parity()
    train = phase_train()
    if profiling:
        phase_train_profile()
    phase_klvae_parity()
    klvae = phase_klvae_train()
    if profiling:
        phase_klvae_profile()

    # each kernel's launches on its main path: generate for the inference
    # kernels, the opt-in generate for the opt-in ones, the train_ldm run for
    # the training kernels; the fused GN → SiLU → conv is on no path (as in
    # sd_tpu, where no model calls it)
    src = "sd_tpu_torch/csrc/"
    tpu = "sd_tpu/kernels/"
    # (the rows of flash_attention and flash_attention_pipelined are d = 512)
    sources = {"flash_attention": (src + "flash_attention_wide.cu", tpu + "flash_attention.py:66"),
               "flash_attention_pipelined": (src + "flash_attention_wide.cu",
                                             tpu + "flash_attention.py:123"),
               "flash_attention_hpacked": (src + "flash_attention_sm90.cu",
                                           tpu + "flash_attention.py:293"),
               # the route counters: flash_attention_sm90.cu (rows 1 and 3 at
               # head dims up to 128, serial sweep, no int8 PV), its int8-PV
               # form, and flash_attention_wide.cu (rows 1 and 2 above 128)
               "flash_fwd_sm90": (src + "flash_attention_sm90.cu",
                                  tpu + "flash_attention.py:66, :293"),
               "flash_fwd_sm90_pv8": (src + "flash_attention_sm90_pv8.cu",
                                      tpu + "flash_attention.py:66, :293, _pv_int8 :44"),
               "flash_fwd_wide": (src + "flash_attention_wide.cu",
                                  tpu + "flash_attention.py:66, :123"),
               # the training forward: its row is train_kl_vae's d = 512 (the
               # wide kernel's LSE epilogue); its route counters, the Hopper
               # forward's at d <= 128 (train_ldm) and the wide kernel's
               "flash_attention_lse": (src + "flash_attention_wide.cu",
                                       tpu + "flash_attention.py:421"),
               "flash_lse_sm90": (src + "flash_attention_sm90.cu", tpu + "flash_attention.py:421"),
               "flash_lse_wide": (src + "flash_attention_wide.cu", tpu + "flash_attention.py:421"),
               # the combine launch of a split sweep (the wide route)
               "flash_lse_combine": (src + "flash_attention_wide.cu",
                                     tpu + "flash_attention.py:421"),
               "flash_bwd_dq": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:465"),
               "flash_bwd_dkv": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:511"),
               "geglu_ff": (src + "geglu.cu", tpu + "geglu.py:48"),
               "conv3x3_same": (src + "conv2d_sm90.cu", tpu + "conv2d.py:30"),
               "gn_silu_conv3x3": (src + "conv2d.cu", tpu + "conv2d.py:38"),
               "group_norm": (src + "groupnorm.cu", tpu + "groupnorm.py:31"),
               "crossattn_kv": (src + "cross_attention.cu", tpu + "cross_attention.py:41")}
    # the inference variants: at d ≤ 128 on the Hopper kernel (the int8 PV
    # on its int8-PV form), the d = 512 rows on the wide kernel
    for exp_bf16, pv_int8 in VARIANTS:
        sources[fa_launch_name("flash_attention", exp_bf16, pv_int8)] = (
            src + "flash_attention_wide.cu",
            tpu + "flash_attention.py:66" + (", _pv_int8 :44" if pv_int8 else ""))
        sources[fa_launch_name("flash_attention_hpacked", exp_bf16, pv_int8)] = (
            src + ("flash_attention_sm90_pv8.cu" if pv_int8 else "flash_attention_sm90.cu"),
            tpu + "flash_attention.py:293" + (", _pv_int8 :44" if pv_int8 else ""))
    sources["flash_attention_pipelined_exp_bf16"] = sources["flash_attention_pipelined"]
    # each Hopper route's row: its first main-path shape, with every other
    # shape it was held at (the template's time beside each)
    keys = ("shape", "name", "how", "max_abs_err", "ms", "generic_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_op", "library_ms", "kv_tile")
    for counter in ROUTE_COUNTERS:
        rows_ = hopper_rows[counter] + hopper_variant_rows[counter]
        table[counter] = {**rows_[0], "other_shapes": [
            {k: r[k] for k in keys if k in r} for r in rows_[1:]]}
    # the conv's row: its largest decoder shape, with the other shapes (and
    # conv2d.cu's time beside each)
    table["conv3x3_same"]["other_shapes"] = [
        {k: r[k] for k in keys if k in r} for r in hopper_rows["conv3x3_same"]
        if r["shape"] != table["conv3x3_same"]["shape"]]
    # the flash training kernels (rows 4-6) run on two paths: their row is
    # train_kl_vae's shape and launches, with train_ldm's beside them; the
    # training forward's route counters each take their own shapes
    device_keys = ("device_ms", "generic_device_ms", "library_device_ms")
    train_keys = ("shape", "route", "kv_split", "max_abs_err", "lse_abs_err", "ms", "generic_ms",
                  "plain_ms", "bound_ms", "bound_by", "bound_op", "library_ms",
                  "library_backend", *device_keys)
    lse_rows = train_rows["flash_attention_lse"]
    for route, counter in LSE_ROUTE_COUNTER.items():
        train_rows[counter] = {s_: r for s_, r in lse_rows.items() if r["route"] == route}
    for name, by_shape in train_rows.items():
        first = KLVAE_ATTN_SHAPE if KLVAE_ATTN_SHAPE in by_shape else next(iter(by_shape))
        table[name] = {**by_shape[first], "other_shapes": [
            {k: r[k] for k in train_keys if k in r}
            for shape, r in by_shape.items() if shape != first]}
    paths = {"flash_attention_lse": ("train_kl_vae", klvae["launches"]),
             "flash_lse_sm90": ("train_ldm", train["launches"]),
             "flash_lse_wide": ("train_kl_vae", klvae["launches"]),
             "flash_lse_combine": ("train_kl_vae", klvae["launches"]),
             "flash_bwd_dq": ("train_kl_vae", klvae["launches"]),
             "flash_bwd_dkv": ("train_kl_vae", klvae["launches"]),
             "flash_attention_pipelined": ("generate, opt-in", launches_optin),
             "group_norm": ("generate, opt-in", launches_optin),
             "crossattn_kv": ("generate, opt-in", launches_optin),
             "gn_silu_conv3x3": ("none: not wired, as in sd_tpu", launches_optin)}
    for name in launches_switches:
        env = next(e for e, *names in SWITCH_COMBINATIONS if name in names)
        paths[name] = ("one serving UNet call + decode, " + " ".join(
            f"{k}={v}" for k, v in env.items()), launches_switches)
    for name, n in launches_serve.items():
        if n and (name.endswith("pv_int8") or name == "flash_fwd_sm90_pv8"):
            paths[name] = ("serve (4 requests, one bucket-4 generate)", launches_serve)
    rows = []
    for name, (source, rep) in sources.items():
        r = table[name]
        path, counts = paths.get(name, ("generate", launches))
        row = {"name": name, "route": "cuda", "source": source, "replaces": rep,
               "launches": counts[name], "launches_path": path, "nvidia_smi": smi,
               "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "bound_op": r["bound_op"],
               "library_ms": r["library_ms"], "shape": r["shape"]}
        for key in ("generic_ms", "other_shapes", "kv_tile", *device_keys):
            if key in r:
                row[key] = r[key]
        if name == "conv3x3_same":
            row["launches_by_shape"] = [[list(c), n] for c, n in zip(DECODER_CONVS,
                                                                     DECODER_CONV_LAUNCHES)]
        if name in train_rows:
            row.update(launches_by_path={"train_kl_vae": klvae["launches"][name],
                                         "train_ldm": train["launches"][name]},
                       library_backend=r["library_backend"], other_shapes=r["other_shapes"])
        rows.append(row)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
