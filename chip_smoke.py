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
           over up to 4096 rows), and dQ and dK/dV bitwise equal on a second run;
           the pipelined flash sweep against the serial sweep of its source
           too (the same bits required): the wide kernel at d = 512, the PIPE
           kernel of `flash_attention_sm90.cu` (counter `flash_fwd_sm90_pipe`)
           at the UNet's [B, S, H, D] shapes (level 0 at batch 8, where the
           switch combination's launches run, and 4; level 1 at batch 4)
           and a ragged one, with the
           template's pipelined sweep, the serial Hopper kernel and SDPA timed
           beside it (`generic_ms`, `serial_ms`, `library_ms`, each also in
           device time), both exponentials; GroupNorm on `groupnorm_sm90.cu`
           (counter `group_norm_sm90`, the grid `gn_plan` picks) at the 11
           opt-in shapes, with SiLU and a ragged case, `groupnorm.cu` and
           `F.group_norm` timed beside it in host and device time, and its
           bound summed over one opt-in generate's 2850 launches (under
           `--profile`, the device time measured there beside it); the fused
           GroupNorm → SiLU → 3×3 conv, which no path calls, on
           `conv2d_gn_sm90.cu` (counter `gn_silu_conv_sm90`) at the decoder's
           five conv shapes and two ragged ones (GN_CONV_RAGGED), within
           KERNEL_TOL of its fp32 plain version and of `conv2d.cu`'s `PRO`
           form, the same bits twice, its statistics pass within
           GN_STATS_TOL·max|ref| of their plain version and timed apart
           (`stats_ms`, `stats_device_ms`, `stats_bound_ms`), with the unfused
           library form (`unfused_ms`, `unfused_device_ms`) and the port's
           own GroupNorm + conv pair (`pair_ms`, `pair_device_ms`; None where
           `gn_plan` refuses the shape) timed beside it; the 3×3 conv rows
           carry `device_ms` too;
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
           the LSE rows, like every forward row of rows 1-3 and 10, also
           carry `device_ms` (torch.profiler's device time per call) beside
           the template's and the library call's, since at tens of
           microseconds the host's enqueue time sets `ms`; the backward
           at d ≤ 128 on `flash_attention_bwd_sm90.cu` and above on
           `flash_attention_bwd_wide_sm90.cu` (each route counter
           moved once, dq, dk, dv within the gradient bounds of the fp32
           plain version and of the template, the same bits twice), with
           `device_ms`, the template's times (`generic_ms`,
           `generic_device_ms`), at d ≤ 48 the other rows per block than
           `bwd_rows` picks (`alt_rows_ms`), and SDPA's backward in host and device
           time on PyTorch's default dispatch and pinned to one backend
           (flash where it takes the shape, else memory-efficient), each
           with the backend it ran; every training row's library time is
           the faster of the two in device time; the GEGLU feed-forward on
           `geglu_sm90.cu` (both UNet shapes and a ragged one split over a
           cluster of 4) and the cross-attention on
           `cross_attention_sm90.cu` (the three UNet levels and a ragged
           case), each within KERNEL_TOL of its fp32 plain version and of
           its template (`geglu.cu`, `cross_attention.cu`), the same bits
           twice, its route counter (`geglu_sm90`, `crossattn_sm90`) moved
           once per call, with `device_ms`, the template's `generic_ms` and
           `generic_device_ms`, and `unfused_ms`, the unfused bf16 PyTorch
           form (several calls, so not a library time);
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
  serve, switches  the serving path over HTTP, then one serving UNet call
           (batch 8) and one decode under each other combination of the
           switches: the launches each reaches and a finite output; with
           `SD_TPU_ATTN_HPACKED=0 SD_TPU_FLASH_PIPE=1 SD_TPU_PALLAS_GN=1`
           the UNet's 5 level-0 self-attentions take the pipelined sweep's
           PIPE kernel (`flash_fwd_sm90_pipe`), none the template, and its 57
           GroupNorms `group_norm_sm90`.
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
  ddpm_parity  one step of train_ddpm's recipe (`make_ddpm_trainer`) of
           ddpm_256_train_config() at full width, batch 1, fp32: on the card
           (TF32 off) against the CPU, same weights (every parameter random),
           t, noise and cosine lr; the loss within 1e-4 relative, grad_norm
           within 1e-3, the parameters after the step ‖Δ‖₂ ≤ 1e-3·‖ref‖₂; no
           kernel launches (the config is fp32: no kernel takes it);
  ddpm_train  train_ddpm(ddpm_256_train_config()) on seeded 256² images,
           batch 6: 1 warm-up and 3 timed steps; checks finite losses, the lr
           of each step equal to cosine_annealing's, an EMA shadow that moved,
           a conv_out that left zero and no launches, and prints s/step,
           img/s and peak memory;
  vq_parity  one VQ GAN step of the full-width vq_128 model (argmin codebook),
           PatchGAN and random-VGG LPIPS at 128², batch 2, `disc_start` 0,
           every weight random: bf16 parameters with the kernels on the card
           against fp32 plain on the card, every run quantizing to the codes
           the kernel run chose (own choices that differ counted); each loss
           term within 5e-2 relative, d_weight within 0.1, and the generator's
           gradients (global and each mid-block AttnBlock q/k/v/proj_out
           weight) within ‖Δg‖₂ ≤ 0.1·‖g‖₂ in the step without LPIPS and
           discriminator (whose input gradients move ~10% for a 0.17% change
           of the reconstruction; the full step's gradients are printed), and
           2/2/2 training-kernel launches at [2, 1024, 1, 256] plus 2 combines;
  vq_train  train_vq(vq_128_train_config(), bf16 parameters) on seeded 128²
           images, batch 8: 1 warm-up and 3 timed steps with 2/2/2 launches a
           step at [8, 1024, 1, 256]; then train_vq(vq_64_train_config()) (the
           EMA codebook, fp32) for 3 steps: a codebook that moved and
           perplexity > 1; s/step, img/s and peak memory of both.
  train_run  the training run around the trainers, chained as the flagship
           recipe (`configs/sd512_catdog.yaml`'s first stage is a KL-f8 run's
           checkpoint), through `python -m sd_tpu_torch.train`'s `main` at full
           width in a temporary directory: 8 synthetic 512² PNGs (a DataLoader
           batch timed at 512² and resized to 256²); the KL-f8 run (bf16
           policy) for 2 steps with a checkpoint and an eval, then resumed for a
           third (the restored state bit for bit, metrics.jsonl, the eval grid,
           the launches); the SD-v1 LDM run on its checkpoint for 2 steps (the
           first stage bit for bit, calibration.json, the ≈ 12 GB checkpoint,
           the launches); `from_run` + generate (2 prompts, 512², 50 steps, CFG
           7.5) against a pipeline given the same weights by hand, bit for bit,
           and its launches; the new shapes of the path's conv and inference
           flash kernel held against their plain versions; checkpoint save and
           restore seconds, GB and GB/s, the runs' seconds, peak memory and the
           free disk, beside the card's name and power limit.
  image_edit  Text2ImagePipeline's image-editing entry points at SD-v1 full
           width (bf16, every weight random), 2 prompts, each twice through its
           public method (the same bits required, the second run timed, the
           first run's launches as IMAGE_EDIT_LAUNCHES): img2img at 512² (20
           steps, strength 0.75), the DDIM-blend inpaint (20), the
           mask-conditioned inpaint of configs/inpaint_128_catdog.yaml (random
           first stage; the kept pixels bit for bit), generate at 1024² with
           decode_tile 512 (its latent decoded whole too, within SEAM_TOL),
           img2img at 1024² with encode_tile 512, generate_hires 512² → 1024²,
           generate with a tile no smaller than the image and with
           tome_ratio 0 (both the plain images bit for bit), with ToMe +
           FreeU, and after load_textual_inversion; the bf16 encoder with its
           kernels against an fp32 copy within DECODER_TOL; every kernel shape
           the entry points launched held against its plain version (the same
           bits twice, the route counter moved, its time beside its bound);
           seconds and peak memory of each entry point.
  adapters  the loaded and steered served model at SD-v1 full width (bf16,
           every weight random), 2 prompts at 512², ADAPTER_STEPS DDIM steps:
           to_sd_checkpoint as .safetensors and .ckpt (fp32, ≈ 3.8 GB each) and
           from_sd_checkpoint of each, generate on the source's bits, save and
           load GB/s, merge_checkpoints at α = 0; LoRA (scale 0: plain bits;
           scale 1: the merged weights within 1 bf16 ulp of a float64 merge);
           ControlNet (zero projections: plain bits; then random ones); SAG
           (the probe at mid_attn, no flash launch there); IP-Adapter (scale 0
           within 1 level of plain); each steered entry point twice (the same
           bits, ADAPTER_LAUNCHES), every kernel shape held against its plain
           version; seconds and peak memory beside the card.
  few_step  few-step and flow models at SD-v1 full width (bf16, every weight
           random): a teacher run directory (the EMA shadow of a random UNet,
           calibration.json); consistency distillation through `python -m
           sd_tpu_torch.train`'s `main` on lcm512_distill_config() (CFG 7.5
           baked in, batch 4 as 4 microbatches, remat "dots") for 2 steps with a
           checkpoint and a 4-step eval grid: the student before step 1 is the
           teacher bit for bit, the target's first update the warm-up decay's,
           the launches FEW_STEP_LAUNCHES; the same as LCM-LoRA (rank 4: the
           merged weights before step 1 are the teacher's; lora.safetensors
           merges into a `from_run` of the teacher); `from_run` of the student
           and generate(sampler="lcm", 4 steps) twice (the same bits, the
           launches), a served lcm request (generate's image); train_ldm on
           flow512_train_config() for 2 steps; generate with flow (8 steps,
           CFG 7.5) and flow_midpoint (4) twice each, a served flow request;
           every inference kernel shape held against its plain version; s/step,
           s/generate (beside the e2e phase's), peak memory, checkpoint GB/s.
  fine_tune  train_ldm's fine-tuning branches and tasks at SD-v1 full width
           through `python -m sd_tpu_torch.train`, each output served.
  super_resolution  configs/ldm_sr_catdog.yaml at full width through the
           command lines: the KL-f4 first stage's run (2 steps), the SR run over
           its checkpoint (batch 16, bsrgan_light, 2 steps with an eval, then
           resumed for a third), `python -m sd_tpu_torch.sample_sr` on it (20
           steps); the LR batch the run trained on equal to a fresh loader's,
           the SR UNet on the card against its CPU copy in fp32, no launch and
           every attention's route (plain); s/step, peak GB, checkpoint GB/s,
           the loader's seconds per batch of 16 degradations, sample_sr's
           seconds. The device line reports PIL (and its JPEG support) and scipy.
  codec_attention  kl_f32 and vq_gumbel_f8 (per-level attention) at full
           width: one fp32 GAN step each through `python -m sd_tpu_torch.train`
           (no launch, every attention plain), their encode → decode on the card
           against a CPU copy in fp32, and in bf16 (vq_gumbel_f8's 32² level on
           the wide flash kernel, its shapes held against the plain versions).
  model_families  LDM-KL-8-G (BERT 32 × 1280 → 50 DDIM steps, CFG 5.0 → KL-f8
           decode, 2 prompts, 256²) and the ADM ImageNet 256² class-conditional
           UNet (batch 2) at full width in bf16, with their launches (flash and
           GEGLU on every UNet call; the ADM's 32² self-attention flash); the
           full-width BERT and UNets, `UNetCompVis` and `AttentionPool2d` on
           the card against a CPU copy in fp32 (the linear-attention
           `UNetCompVis` against float64), the shapes held.
  training_options  train_ddpm on ddpm_256_train_config() with
           `model.params.dtype: bfloat16` (fp32 parameters, Adam moments and
           EMA, bf16 compute) and dropout 0.1, 256², batch 6: one warm-up and
           TRAINING_OPTIONS_STEPS timed steps (s/step, peak GB, launches by
           route: its level-3 attention on the wide flash training kernels
           at [6, 1024, 1, 256]); the mixed-precision step against its fp32
           step on the card from the same weights, batch, t, noise and
           dropout masks (MIXED_TOL); the fp32 step with dropout on the card
           against the CPU at batch 1 with the same injected masks
           (DDPM_TOL); the path's training kernels at its shape against their
           plain versions.
  bench_serve  `python -m sd_tpu_torch.bench_serve` on SD-v1 at 512² (bf16,
           the default switches): BatchingServer(max_batch 4, 50 ms) over
           loopback HTTP, rows ddim50 (cut to 10 steps, CFG 7.5) and lcm4 (4
           steps), 4 clients × 2 requests after each row's warm-up and
           sequential phase; each row's JSON, every response a 512² PNG, the
           concurrent phase's mean batch above 1, each row's launches by route
           (BENCH_SERVE_LAUNCHES by bucket), seeded grouped requests within 1
           level of a direct generate of their batch (and, reported, their
           distance from themselves alone at batch 1 on their slot's noise).
  eval_tools  the evaluation and diagnostic tools: kl_128_catdog and
           ldm_32_catdog_cond trained 1 step each through `python -m
           sd_tpu_torch.train` on 16 synthetic cat / dog PNGs, `python -m
           sd_tpu_torch.eval_steering` on that run (2 rows, finite scores and
           surrogate FID); the cross-attention heatmaps of SD-v1 at 512²
           (batch 2, 16 maps, rows summing to 1, the other attentions on their
           routes), seconds and peak memory; card against CPU in fp32: the
           probe's forward, a FID feature batch, the heatmaps at a 16² latent;
           `nan_check` on an injected NaN and a clean forward,
           `tree_finite_summary` over the UNet's parameters.
  parallel  the parallel layer (`sd_tpu_torch/parallel/`) on the one card, 8
           512² JPEGs read through PIL: `python -m sd_tpu_torch.train` on the
           train cell's config with a `parallel:` block at world 1 over NCCL
           (ZeRO-1, then FSDP, 2 steps each) and at two ranks on the card over
           gloo (data 2, batch 8 as 4 microbatches of one row per rank, 2
           steps), each against the plain run of the same steps on the same
           rows (PARALLEL_TOL: losses, grad_norm, Adam's first moment, the
           parameters against the update's size); `shard_for_serving` at data 1 ×
           model 2 over gloo (`python chip_smoke.py --tp-rank`, two ranks):
           a UNet call under the default and the opt-in switches against tp =
           1 (UNET_TOL), a 10-step CFG generate's level differences
           (PARALLEL_LEVELS); `python -m sd_tpu_torch.serve --shard` at world
           1 over NCCL, two requests; every rank's launches (PARALLEL_LAUNCHES),
           step seconds and peak memory. The tensor-parallel ranks' kernel
           shapes (4 of 8 heads, half the feed-forward) are held in the kernel
           phase (`how: tp2`); each kernel row carries `parallel_launches`,
           by run and rank.
  profile  (only with `--profile`) the layers' times and the device time of
           one generate by kernel family, against its wall time, for the
           default and the opt-in configuration, the serve phase's grouped
           bucket-4 generate, and the same for one optimizer step of
           train_ldm, train_kl_vae, train_ddpm and train_vq.
The build line carries the registers and spills of the flash kernels' head
dim 256 and 512 instantiations, of the inference forwards (the pipelined
sweep's at d ≤ 128 among them) and the Hopper backward at the path's head
dims, and of every instantiation of the Hopper GEGLU, cross-attention and
GroupNorm kernels and of the wide Hopper backward (any spill there, or a
wgmma serialization warning in the pipelined sweep's or GroupNorm's source,
fails the run), and their dynamic shared memory (GroupNorm's at each opt-in
shape's plan). The flash training kernels are also held at
head dim 512 ([4, 1024, 1, 512], train_kl_vae's shape, [1, 4096, 1, 512]
and a ragged [1, 1000, 1300, 1, 512]) and 256 ([6, 1024, 1, 256] and
train_vq's [8, 1024, 1, 256]), the backward there on
`flash_attention_bwd_wide_sm90.cu`, with the backend
`scaled_dot_product_attention` ran there; their row in the kernel table is
train_kl_vae's shape and launches, with train_ldm's and train_vq's launches
and the other shapes beside them.
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
           "flash_lse_combine",
           # backward launches served by flash_attention_bwd_sm90.cu (head dims
           # up to 128) and flash_attention_bwd_wide_sm90.cu (129-512)
           "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_wide_sm90",
           "flash_bwd_dkv_wide_sm90",
           # GEGLU launches served by geglu_sm90.cu, cross-attention calls by
           # cross_attention_sm90.cu
           "geglu_sm90", "crossattn_sm90",
           # the pipelined sweep at head dims up to 128 on the PIPE kernel of
           # flash_attention_sm90.cu, GroupNorm on groupnorm_sm90.cu
           "flash_fwd_sm90_pipe", "group_norm_sm90",
           # the fused GroupNorm → SiLU → 3×3 conv on conv2d_gn_sm90.cu
           "gn_silu_conv_sm90")


def launches_of(**nonzero) -> dict:
    return {**dict.fromkeys(KERNELS, 0), **nonzero}


# launches of one generate() at 512², 50 steps: 10 self-attention and 10
# GEGLU calls per UNet step, the decoder's mid-block attention and 18 convs;
# the head-packed launches (d = 40, 80) on the Hopper route, the decoder's
# (d = 512) on the wide kernel, every GEGLU on geglu_sm90.cu
EXPECTED_LAUNCHES = launches_of(flash_attention=1, flash_attention_hpacked=500,
                                flash_fwd_sm90=500, flash_fwd_wide=1, geglu_ff=500,
                                geglu_sm90=500, conv3x3_same=18)
# the opt-in configuration: the TPU package's switches that reach kernels
OPT_IN = {"SD_TPU_PALLAS_GN": "1", "SD_TPU_PALLAS_XATTN": "1", "SD_TPU_FLASH_PIPE": "1"}
# ... and its launches per generate: 57 of the UNet's 61 GroupNorms and 15 of
# its 16 cross-attentions per step, the decoder's mid-block attention through
# the pipelined sweep (tests/test_torch_structure.py derives these); every
# cross-attention call on cross_attention_sm90.cu, every GroupNorm on
# groupnorm_sm90.cu
EXPECTED_LAUNCHES_OPTIN = launches_of(
    flash_attention_pipelined=1, flash_attention_hpacked=500, flash_fwd_sm90=500,
    flash_fwd_wide=1, geglu_ff=500, geglu_sm90=500, conv3x3_same=18, group_norm=2850,
    group_norm_sm90=2850, crossattn_kv=750, crossattn_sm90=750)
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
    flash_fwd_wide=1, geglu_ff=10 * SERVE_UNET_CALLS, geglu_sm90=10 * SERVE_UNET_CALLS,
    conv3x3_same=18)
# launches of one optimizer step of train_ldm(sd512_train_config()): 10
# self-attentions (UNet levels 0 and 1) per microbatch forward, again in the
# remat recompute, one dQ and one dK/dV each in backward, 4 microbatches
# (tests/test_torch_structure.py derives these from the shape rules); the
# training forward at d = 40 and 80 on flash_attention_sm90.cu's LSE epilogue,
# the backward on flash_attention_bwd_sm90.cu
EXPECTED_TRAIN_LAUNCHES = launches_of(flash_attention_lse=80, flash_lse_sm90=80,
                                      flash_bwd_dq=40, flash_bwd_dkv=40,
                                      flash_bwd_dq_sm90=40, flash_bwd_dkv_sm90=40)
# launches of one step of train_kl_vae(kl_f8_256_train_config()), 256²: the
# codec's two mid-block attentions (encoder, decoder; [4, 1024, 1, 512])
# in the one generator forward and its backward, no inference kernel; the
# training forward at d = 512 on flash_attention_wide.cu's LSE epilogue, its
# kv sweep split (64 blocks) and combined; the backward on
# flash_attention_bwd_wide_sm90.cu
EXPECTED_KLVAE_LAUNCHES = launches_of(flash_attention_lse=2, flash_lse_wide=2,
                                      flash_lse_combine=2, flash_bwd_dq=2, flash_bwd_dkv=2,
                                      flash_bwd_dq_wide_sm90=2, flash_bwd_dkv_wide_sm90=2)
# launches of one step of train_vq(vq_128_train_config()) under the bf16
# parameter policy, 128², batch 8: the codec's two mid-block attentions
# (encoder, decoder; [8, 1024, 1, 256]: ch 64 × 4 channels over 32² tokens)
# in the one generator forward and its backward, no inference kernel; the
# training forward at d = 256 on flash_attention_wide.cu's LSE epilogue (128
# blocks: its kv sweep is not split), the backward on
# flash_attention_bwd_wide_sm90.cu, one block a 64-row slab
# (tests/test_torch_structure.py derives these)
EXPECTED_VQ_LAUNCHES = launches_of(flash_attention_lse=2, flash_lse_wide=2, flash_bwd_dq=2,
                                   flash_bwd_dkv=2, flash_bwd_dq_wide_sm90=2,
                                   flash_bwd_dkv_wide_sm90=2)
# ... and of the VQ parity step at batch 2, whose LSE sweep (32 blocks) splits
VQ_PARITY_LAUNCHES = {**EXPECTED_VQ_LAUNCHES, "flash_lse_combine": 2}
# the train_run phase (a KL-f8 run, its resume, an SD-v1 LDM run on its
# checkpoint, then `from_run` + generate, all through `python -m
# sd_tpu_torch.train`'s `main` at full width; tests/test_torch_structure.py
# derives these). The KL run (kl_f8_256_train_config() under the bf16
# policy: its kernels take bf16 only) runs 2 steps, evaluates at step 2 and
# saves, then resumes for a third step; its eval reconstructs the fixed
# batch ([4, 256², 3], a posterior sample, no grad): the codec's two
# mid-block attentions on the inference flash kernel at [4, 1024, 1, 512]
# (the wide route) and 20 of its 3×3 convs on the Hopper conv
TRAIN_RUN_KL_STEPS = (2, 3)                      # the first run, then the resumed one
KL_RUN_EVAL_LAUNCHES = launches_of(flash_attention=2, flash_fwd_wide=2, conv3x3_same=20)
# the LDM run's fp32 first stage (the trained KL weights, cast to fp32 as the
# TPU package computes a bf16 tree under fp32 inputs) takes no kernel: its
# encodes (one of the calibration batch, one a step of 4 microbatches) add 0
FIRST_STAGE_ENCODE_LAUNCHES = launches_of()
TRAIN_RUN_LDM_STEPS = 2
TRAIN_RUN_IMAGES = 8                             # cat_0..3, dog_0..3, 512² RGB PNGs
TRAIN_RUN_DISK_GB = 16                           # the LDM run's ≈ 12 GB state + the KL run's
# the image_edit phase: Text2ImagePipeline's image-editing entry points at
# SD-v1 full width (bf16, every weight random), 2 prompts, each run twice
# (the same bits required; the second run timed). Step counts divide 1000, so
# the "uniform" DDIM striding gives as many UNet calls as steps.
IMAGE_EDIT_SEED = 17
EDIT_STEPS = 20                # img2img at strength 0.75 (15 UNet calls), the blend inpaint (20)
EDIT_STRENGTH = 0.75
EDIT_GENERATE_STEPS = 10       # generate: plain, ToMe + FreeU, after textual inversion
EDIT_BIG_STEPS = 8             # at 1024²: generate (8 UNet calls), img2img (6)
HIRES_STEPS = (8, 8)           # generate_hires 512² → 1024²: 8 base calls, then 5 refine
HIRES_STRENGTH = 0.7
EDIT_SIZE, EDIT_BIG = 512, 1024   # the SD-v1 entry points' image sizes
INPAINT_SIZE = 128                # configs/inpaint_128_catdog.yaml's
EDIT_TILE = 512                # decode_tile / encode_tile, pixels: 3 × 3 tiles of 512² at 1024²
TOME_FREEU = {"tome_ratio": 0.5, "freeu": (1.2, 1.4, 0.9, 0.2)}
TI_TOKEN = "<lighthouse-toy>"
# the tiled decode against the whole decode of the same latent at 1024², as
# uint8 images, stated before measuring: the mean |Δ| in levels, and the
# share of pixels more than 32 levels apart (the seams' band)
SEAM_TOL = {"mean_levels": 6.0, "far_share": 0.03}
# launches of each entry point (tests/test_torch_structure.py derives them):
# a UNet call at 64² (batch 4) takes 10 head-packed flash launches (d = 40,
# 80) and 10 GEGLU; at 128² 15 head-packed (level 2's 1024 tokens, d = 160,
# on the wide kernel) and 10 GEGLU (level 2's weights stay above the gate);
# with ToMe the same counts at 2048 and 512 tokens. The KL-f8 encoder takes 1
# flash launch (d = 512) and 12 convs at 512² (20 at 1024²), the decoder 1
# and 18 at 512² (28 at 1024²), in tiles at batch 18 the same as at 512².
# The inpainting model's UNet (16² and 8² attention) takes no kernel, its
# f4 codec 1 flash launch each way (d = 256, 1024 tokens) and no conv.
_EDIT_GENERATE = launches_of(flash_attention_hpacked=10 * EDIT_GENERATE_STEPS,
                             flash_fwd_sm90=10 * EDIT_GENERATE_STEPS,
                             geglu_ff=10 * EDIT_GENERATE_STEPS,
                             geglu_sm90=10 * EDIT_GENERATE_STEPS,
                             flash_attention=1, flash_fwd_wide=1, conv3x3_same=18)
IMAGE_EDIT_LAUNCHES = {
    "img2img": launches_of(flash_attention_hpacked=150, flash_fwd_sm90=150, geglu_ff=150,
                           geglu_sm90=150, flash_attention=2, flash_fwd_wide=2,
                           conv3x3_same=30),
    "inpaint": launches_of(flash_attention_hpacked=200, flash_fwd_sm90=200, geglu_ff=200,
                           geglu_sm90=200, flash_attention=2, flash_fwd_wide=2,
                           conv3x3_same=30),
    "inpaint_128": launches_of(flash_attention=2, flash_fwd_wide=2),
    "generate_tiled": launches_of(flash_attention_hpacked=120, flash_fwd_sm90=80,
                                  flash_fwd_wide=41, flash_attention=1, geglu_ff=80,
                                  geglu_sm90=80, conv3x3_same=18),
    "img2img_tiled": launches_of(flash_attention_hpacked=90, flash_fwd_sm90=60,
                                 flash_fwd_wide=32, flash_attention=2, geglu_ff=60,
                                 geglu_sm90=60, conv3x3_same=40),
    "generate_hires": launches_of(flash_attention_hpacked=155, flash_fwd_sm90=130,
                                  flash_fwd_wide=28, flash_attention=3, geglu_ff=130,
                                  geglu_sm90=130, conv3x3_same=66),
    "generate": _EDIT_GENERATE,
    "generate_tome_freeu": _EDIT_GENERATE,
    "generate_ti": _EDIT_GENERATE,
}
# the adapters phase: the loaded and steered served model at SD-v1 full width
# (bf16, every weight random), 2 prompts at 512², ADAPTER_STEPS DDIM steps
ADAPTERS_SEED = 18
ADAPTER_STEPS = 10
SAG_SCALE = 0.75
LORA_RANK = 4
LORA_B_STD = 4e-3              # the b factors' N(0, σ²): deltas ~10% of the weights
# launches of each entry point (tests/test_torch_structure.py derives them):
# a CFG UNet call (batch 4) takes 10 head-packed flash launches and 10 GEGLU,
# the ControlNet branch (batch 4) 4 and 4 (its level-0 and level-1
# transformers), SAG's degraded pass (the unconditional batch 2) 10 and 10;
# the probed mid-block attention (64 tokens) takes none, as under CFG alone;
# the image embedder (ViT-B/32, 50 tokens) none; the decoder 1 flash
# launch (d = 512) and 18 convs
_ADAPTER_GENERATE = launches_of(flash_attention_hpacked=10 * ADAPTER_STEPS,
                                flash_fwd_sm90=10 * ADAPTER_STEPS,
                                geglu_ff=10 * ADAPTER_STEPS, geglu_sm90=10 * ADAPTER_STEPS,
                                flash_attention=1, flash_fwd_wide=1, conv3x3_same=18)
ADAPTER_LAUNCHES = {
    "generate": _ADAPTER_GENERATE,
    "generate_lora": _ADAPTER_GENERATE,
    "generate_controlnet": launches_of(flash_attention_hpacked=14 * ADAPTER_STEPS,
                                       flash_fwd_sm90=14 * ADAPTER_STEPS,
                                       geglu_ff=14 * ADAPTER_STEPS,
                                       geglu_sm90=14 * ADAPTER_STEPS,
                                       flash_attention=1, flash_fwd_wide=1, conv3x3_same=18),
    "generate_sag": launches_of(flash_attention_hpacked=20 * ADAPTER_STEPS,
                                flash_fwd_sm90=20 * ADAPTER_STEPS,
                                geglu_ff=20 * ADAPTER_STEPS, geglu_sm90=20 * ADAPTER_STEPS,
                                flash_attention=1, flash_fwd_wide=1, conv3x3_same=18),
    "generate_ip": _ADAPTER_GENERATE,
}
# the few_step phase: consistency distillation of a random SD-v1 teacher
# (lcm512_distill_config(): configs/lcm_512_catdog.yaml) and its LCM-LoRA
# through `python -m sd_tpu_torch.train`, the student served with `lcm`, and
# the rectified-flow objective at SD-v1 width (flow512_train_config())
# trained and served with `flow` / `flow_midpoint`
FEW_STEP_SEED = 19
FEW_STEP_STEPS = 2             # optimizer steps of each run
LCM_STEPS = 4                  # the student's sampling steps (distill.sample_steps)
FLOW_STEPS = 8                 # flow generate, CFG 7.5; flow_midpoint takes FLOW_STEPS // 2
FEW_STEP_LORA_RANK = 4
FEW_STEP_DISK_GB = 14          # the distill run's ≈ 10 GB state and the 1.7 GB teacher
# launches (tests/test_torch_structure.py derives them on `meta` tensors): an
# inference UNet call at 64² of 2 rows or more (the teacher's CFG pair at 8,
# the samplers' 2 and 4) takes 10 head-packed flash launches and 10 GEGLU (at
# 1 row, a served request's, level 1's 1024 tokens keep GEGLU plain);
# the target network's no-grad forward inside a training step (a microbatch
# of 1) 10 flash launches on the [B, S, H, D] route and 5 GEGLU (level 0's);
# the student's forward and backward a train_ldm microbatch's 20 / 10 / 10;
# the first stage of the distill run (fp32) none, the pipeline's decoder 1
# flash launch and 18 convs
_UNET_CALL = dict(flash_attention_hpacked=10, flash_fwd_sm90=10, geglu_ff=10, geglu_sm90=10)
_DECODE = dict(flash_attention=1, flash_fwd_wide=1, conv3x3_same=18)


def _unet_calls(n: int, decode: bool = False) -> dict:
    out = launches_of(**{k: n * v for k, v in _UNET_CALL.items()})
    for k, v in (_DECODE.items() if decode else ()):
        out[k] += v
    return out


# one distillation step (batch 4 as 4 microbatches): the teacher's CFG step,
# 4 target forwards, 4 student forwards and backwards
_DISTILL_STEP = launches_of(flash_attention_hpacked=10, flash_attention=40, flash_fwd_sm90=50,
                            geglu_ff=30, geglu_sm90=30, flash_attention_lse=80,
                            flash_lse_sm90=80, flash_bwd_dq=40, flash_bwd_dkv=40,
                            flash_bwd_dq_sm90=40, flash_bwd_dkv_sm90=40)
FEW_STEP_LAUNCHES = {
    "distill_step": _DISTILL_STEP,
    "lora_step": _DISTILL_STEP,
    "distill_eval": _unet_calls(LCM_STEPS),       # the eval grid: batch 4, fp32 decode
    "flow_step": EXPECTED_TRAIN_LAUNCHES,
    "generate_lcm": _unet_calls(LCM_STEPS, decode=True),
    "generate_flow": _unet_calls(FLOW_STEPS, decode=True),
    "generate_flow_midpoint": _unet_calls(2 * (FLOW_STEPS // 2), decode=True),
}
# the fine_tune phase: train_ldm's LoRA, ControlNet, IP-Adapter and
# trainable-text-encoder branches (bf16, batch 4 as 4 microbatches, remat
# "dots") and the textual_inversion, dreambooth and ldm_inpaint tasks (fp32,
# batch 1, as the TPU package builds them) at SD-v1 full width through
# `python -m sd_tpu_torch.train`, each run's output served by its loader
FINE_TUNE_SEED = 20
FINE_TUNE_STEPS = 1            # optimizer steps of each run, one checkpoint at the end
FINE_TUNE_LR = 1.0e-4          # constant: the recipe's warm-up starts at lr·1e-6
FINE_TUNE_GENERATE_STEPS = 5   # each served check: 2 prompts, 512², DDIM + CFG 7.5
FINE_TUNE_CLASS_IMAGES = 2     # DreamBooth's generated prior set ...
FINE_TUNE_CLASS_STEPS = 4      # ... at this many DDIM steps
FINE_TUNE_DISK_GB = 36         # two fp32 runs of ≈ 13.8 GB and a ControlNet run of ≈ 5 GB
# launches (tests/test_torch_structure.py derives them on `meta` tensors):
# the LoRA and trainable-text-encoder steps are train_ldm's (every attention
# trains; the text tower's 77 tokens take no kernel); the ControlNet step
# adds the frozen base encoder's no-grad passes (4 inference flash and 2
# GEGLU launches a pass, twice with the remat recompute, per microbatch) to
# the training kernels of its own encoder copy and the base decoder (10
# attentions a pass); IP-Adapter's first self-attention runs before the
# first image read (no gradient: 1 inference flash launch a pass), the
# other 9 train; the fp32 trainers launch nothing; a served generate is 10
# CFG UNet calls and the decoder, with the ControlNet branch 4 + 4 more
# launches a call, and the mask-conditioned inpaint adds the masked images'
# encode
_FT_TRAIN = {k: v for k, v in EXPECTED_TRAIN_LAUNCHES.items() if v}
FINE_TUNE_LAUNCHES = {
    "lora_step": EXPECTED_TRAIN_LAUNCHES,
    "controlnet_step": launches_of(**_FT_TRAIN, flash_attention=32, flash_fwd_sm90=32,
                                   geglu_ff=16, geglu_sm90=16),
    "ip_adapter_step": launches_of(flash_attention_lse=72, flash_lse_sm90=72, flash_bwd_dq=36,
                                   flash_bwd_dq_sm90=36, flash_bwd_dkv=36,
                                   flash_bwd_dkv_sm90=36, flash_attention=8, flash_fwd_sm90=8),
    "cond_step": EXPECTED_TRAIN_LAUNCHES,
    "fp32_step": launches_of(),
    "generate": _unet_calls(FINE_TUNE_GENERATE_STEPS, decode=True),
    "generate_controlnet": launches_of(
        flash_attention_hpacked=14 * FINE_TUNE_GENERATE_STEPS,
        flash_fwd_sm90=14 * FINE_TUNE_GENERATE_STEPS, geglu_ff=14 * FINE_TUNE_GENERATE_STEPS,
        geglu_sm90=14 * FINE_TUNE_GENERATE_STEPS, **_DECODE),
    "inpaint_conditioned": launches_of(
        **{k: FINE_TUNE_GENERATE_STEPS * v for k, v in _UNET_CALL.items()},
        flash_attention=2, flash_fwd_wide=2, conv3x3_same=30),
}
# the super_resolution and codec_attention phases
SR_SEED = 21
SR_IMAGES = 16                 # synthetic 128² PNGs, one batch of the SR recipe
SR_STEPS = (2, 3)              # the SR run's steps (eval at the first), then its resume
SR_KL_STEPS = 2                # the KL-f4 first stage's run under it
SR_SAMPLE_STEPS = 20           # sample_sr's DDIM steps (the config's own)
SR_SAMPLE_IMAGES = 4
SR_DISK_GB = 8                 # the runs' checkpoints (≈ 1.2 GB SR, ≈ 0.6 GB KL, 2 codecs)
# card fp32 against CPU fp32 (TF32 off), forward: stated before measuring
CARD_CPU_TOL = {"max_rel": 1e-3, "l2_rel": 1e-4}
# where fp32 itself is loose (the linear-attention UNetCompVis), the card's
# fp32 distance from a CPU float64 run at most this times the CPU's fp32 one
F64_RATIO = 1.5
# fp32 throughout: every attention and conv the SR and codec runs make takes
# the plain path (sq < 512 or 4-byte data, the TPU package's gates)
SR_RUN_LAUNCHES = launches_of()
# a bf16 forward of vq_gumbel_f8 at 256², batch 1: its 32² level (1024
# tokens, d = 512) takes the wide flash kernel in 7 blocks (encoder 2
# per-level + mid, decoder mid + 3 per-level); kl_f32's 16² and 8² (256 and
# 64 tokens) stay plain
CODEC_BF16_FLASH = {"kl_f32": 0, "vq_gumbel_f8": 7}
# the encoder's launches at 512², batch 2 (its bf16-vs-fp32 check)
ENCODER_512_LAUNCHES = launches_of(flash_attention=1, flash_fwd_wide=1, conv3x3_same=12)
# the model_families phase: LDM-KL-8-G (CompVis's BERT-conditioned
# txt2img-1p4B) at full width in bf16, 2 prompts, 50 DDIM steps at CFG 5.0
# against the embedding of "" (CompVis's txt2img script), 256² images; the
# guided-diffusion ADM ImageNet 256² class-conditional UNet, one bf16
# forward at batch 2
FAMILY_SEED = 22
FAMILY_PROMPTS = ["a virus monster is playing guitar, oil on canvas",
                  "a squirrel eating a burger"]
FAMILY_STEPS = 50
FAMILY_CFG = 5.0
ADM_BATCH = 2
# the ADM UNet's card-vs-CPU check runs at 64² (it is convolutional; its
# 256² fp32 forward on the CPU would take most of the phase's budget)
ADM_PARITY_SIZE = 64
# a CFG UNet call of LDM-KL-8-G at its 32² latent (batch 4): the 5 level-0
# self-attentions ([4, 1024, 8×40]) on the head-packed Hopper kernel and
# their GEGLUs (4096 tokens × 320); level 1's 256 tokens and level 2's 64
# stay plain, as do BERT's 77-token attention and its 1280-wide FF; the
# decode at 256²: the mid-block attention (1024 tokens, d = 512) on the wide
# kernel and 12 convs; the ADM UNet at 256²: the 5 self-attentions of its
# 32² level ([2, 1024, 8, 64]) on the Hopper kernel, its 16² and 8² plain,
# its convs plain (no Conv3x3 in the guided-diffusion resblocks)
_FAMILY_UNET_CALL = dict(flash_attention_hpacked=5, flash_fwd_sm90=5, geglu_ff=5, geglu_sm90=5)
MODEL_FAMILY_LAUNCHES = {
    "bert": launches_of(),
    "ldm_kl8g_generate": launches_of(
        **{k: FAMILY_STEPS * v for k, v in _FAMILY_UNET_CALL.items()},
        flash_attention=1, flash_fwd_wide=1, conv3x3_same=12),
    "adm_forward": launches_of(flash_attention=5, flash_fwd_sm90=5),
}
# the training_options phase: train_ddpm on ddpm_256_train_config() under
# `model.params.dtype: bfloat16` (fp32 parameters, Adam moments and EMA, bf16
# compute) with dropout 0.1 (the DDPM paper's CIFAR-10 rate, arXiv:2006.11239
# App. B), 256², batch 6: one warm-up and TRAINING_OPTIONS_STEPS timed steps.
# A step's forward runs the 5 level-3 AttnBlocks (32², 256 channels, one head:
# [6, 1024, 1, 256]) on the wide flash training route, the 16² bottleneck's
# 256 tokens plain; no remat, so one LSE forward and one dQ, dK/dV each
TRAINING_OPTIONS_SEED = 23
TRAINING_OPTIONS_DROPOUT = 0.1
TRAINING_OPTIONS_STEPS = 2
DDPM_ATTN_SHAPE = (6, 1024, 1024, 1, 256)
_DDPM_BF16_STEP = dict(flash_attention_lse=5, flash_lse_wide=5, flash_bwd_dq=5,
                       flash_bwd_dkv=5, flash_bwd_dq_wide_sm90=5, flash_bwd_dkv_wide_sm90=5)
TRAINING_OPTIONS_LAUNCHES = {
    "ddpm_bf16_steps": launches_of(**{k: (1 + TRAINING_OPTIONS_STEPS) * v
                                      for k, v in _DDPM_BF16_STEP.items()})}
# the bench_serve phase: `python -m sd_tpu_torch.bench_serve` on SD-v1 at 512²
# (full width, bf16, the default switches) over BatchingServer(max_batch 4,
# window 50 ms) and its HTTP front end: rows ddim50 (cut to 10 steps for time:
# its JSON says 10) and lcm4, each BENCH_SERVE_CLIENTS clients × BENCH_SERVE_REQUESTS
# requests after its warm-up and sequential phase. A served generate's launches
# by row and bucket (tests/test_torch_structure.py derives them on `meta`
# tensors): ddim50's CFG calls see 2, 4 or 8 rows (10 head-packed flash and 10
# GEGLU launches a call), lcm4's calls 1, 2 or 4 (at 1 row level 1's GEGLU stays
# plain: 5); the decode 1 wide flash launch and 18 convs at every batch
BENCH_SERVE_SEED = 24
BENCH_SERVE_STEPS = {"ddim50": 10, "lcm4": 4}
BENCH_SERVE_CLIENTS, BENCH_SERVE_REQUESTS = 4, 2
BENCH_SERVE_BUCKETS = (1, 2, 4)


def _bench_generate(calls: int, geglu_per_call: int = 10) -> dict:
    out = _unet_calls(calls, decode=True)
    out["geglu_ff"] = out["geglu_sm90"] = calls * geglu_per_call
    return out


BENCH_SERVE_LAUNCHES = {
    **{("ddim50", b): _bench_generate(BENCH_SERVE_STEPS["ddim50"]) for b in BENCH_SERVE_BUCKETS},
    ("lcm4", 1): _bench_generate(BENCH_SERVE_STEPS["lcm4"], 5),
    **{("lcm4", b): _bench_generate(BENCH_SERVE_STEPS["lcm4"]) for b in (2, 4)}}
# the eval_tools phase: 16 synthetic 128² PNGs (cat.<i>.png / dog.<i>.png, the
# `filename_prefix` labels), kl_128_catdog trained 1 step and ldm_32_catdog_cond
# 1 step over it by `python -m sd_tpu_torch.train`, then `python -m
# sd_tpu_torch.eval_steering` with EVAL_STEERING_ARGS; the cross-attention
# heatmaps of SD-v1 at 512² (batch 2, every block captured: 16 maps), whose
# forward keeps every other attention's route (one inference UNet call of 2
# rows: 10 head-packed flash, 10 GEGLU); card against CPU at EVAL_PARITY_LATENT
EVAL_TOOLS_SEED = 25
EVAL_TOOLS_IMAGES = 16
EVAL_STEERING_ARGS = ["--guidance-scales", "1", "3", "--per-class", "2", "--steps", "10",
                      "--probe-steps", "20", "--real-per-class", "8", "--fid-batch", "8"]
EVAL_PARITY_LATENT = 16
ATTN_VIZ_LAUNCHES = _unet_calls(1)
ATTN_VIZ_MAPS = 16
# the parallel phase (`sd_tpu_torch/parallel/`): PARALLEL_IMAGES 512² JPEGs
# (cat_0..3, dog_0..3), the train cell's config (sd512_train_config()) with a
# `parallel:` block through `python -m sd_tpu_torch.train` at world 1 over
# NCCL (ZeRO-1 and FSDP, PARALLEL_W1_STEPS each, against the plain run of the
# same steps), then at two ranks on the one card over gloo (data 2,
# train.batch_size PARALLEL_DP_BATCH as 4 microbatches: one row per rank per
# microbatch, PARALLEL_DP_STEPS steps, against the plain run on the same
# rows); `shard_for_serving` at data 1 × model 2 on the card over gloo (one
# UNet call under the default and one under the opt-in switches against tp =
# 1 by UNET_TOL, then a PARALLEL_TP_STEPS-step CFG generate of 2 prompts, its
# level differences within PARALLEL_LEVELS); `serve --shard` at world 1 over
# NCCL for two requests. The gates, stated before measuring: losses within
# 1e-3 relative, grad_norm within 1e-2, Adam's fp32 first moment (the
# averaged gradient) ‖m − m₁‖₂ ≤ 1e-2·‖m₁‖₂, and the updated bf16
# parameters ‖θ − θ₁‖₂ ≤ 0.05·‖θ₁ − θ₀‖₂, the update's own size (a stale
# shard after a ZeRO-1 gather, or a slice that FSDP never wrote back, moves
# that ratio towards 1 while the loss and the moment stay put)
PARALLEL_SEED = 26
PARALLEL_IMAGES = 8
PARALLEL_W1_STEPS = 2
PARALLEL_DP_BATCH = 8
PARALLEL_DP_STEPS = 2                            # 1 warm-up + 1 timed
PARALLEL_TP_STEPS = 10                           # DDIM "uniform": 10 UNet calls
PARALLEL_SERVE_STEPS = 10
PARALLEL_TOL = {"loss_rel": 1e-3, "grad_norm_rel": 1e-2, "moment_rel": 1e-2,
                "update_rel": 0.05}
PARALLEL_LEVELS = {"mean": 6.0}                  # the seam gate's mean
PARALLEL_DISK_GB = 14                            # one ≈ 12 GB checkpoint at a time
PARALLEL_RANK_TIMEOUT = 900
_TRAIN_RUN = lambda steps: launches_of(**{k: steps * v for k, v in
                                          EXPECTED_TRAIN_LAUNCHES.items() if v})
# each rank's launches (tests/test_torch_structure.py derives them): a rank of
# the data-parallel run trains 4 microbatches of 1 row a step, the train
# cell's step; a tensor-parallel rank's UNet call at 4 of its 8 heads and half
# of each feed-forward keeps every kernel gate of tp = 1 (GEGLU's 11 MB weight
# rule takes levels 0 and 1 at inner/2 too); a served request of 1 prompt is
# a CFG pair of rows at every UNet call
PARALLEL_LAUNCHES = {
    "train_zero1_w1": _TRAIN_RUN(PARALLEL_W1_STEPS),
    "train_fsdp_w1": _TRAIN_RUN(PARALLEL_W1_STEPS),
    "train_dp2": _TRAIN_RUN(PARALLEL_DP_STEPS),
    "tp2_unet": _unet_calls(1),
    "tp2_unet_optin": launches_of(
        flash_attention_hpacked=10, flash_fwd_sm90=10, geglu_ff=10, geglu_sm90=10,
        group_norm=57, group_norm_sm90=57, crossattn_kv=15, crossattn_sm90=15),
    "tp2_generate": _unet_calls(PARALLEL_TP_STEPS, decode=True),
    # two requests, one after the other: two generates of one prompt
    "serve_shard_w1": {k: 2 * v for k, v in
                       _unet_calls(PARALLEL_SERVE_STEPS, decode=True).items()},
}
# the per-rank shapes a tensor-parallel UNet call gives the kernels at tp = 2
# (2 prompts, CFG: 4 rows): head-packed flash at 4 of 8 heads, GEGLU at half
# the inner width, the fused cross-attention (opt-in) at 4 heads
TP_FLASH_SHAPES = ((4, 4096, 4, 40), (4, 1024, 4, 80))
TP_GEGLU_SHAPES = [(16384, 320, 640), (4096, 640, 1280)]
TP_XATTN_SHAPES = [(4, 4096, 77, 4, 40, 320), (4, 1024, 77, 4, 80, 640),
                   (4, 256, 77, 4, 160, 1280)]
# the mixed-precision gates, stated before measuring: the bf16-compute step's
# loss within 2e-2 relative of the fp32 step's, its gradient ‖Δg‖₂ ≤ 0.1·‖g‖₂
# (the train_parity gate)
MIXED_TOL = {"loss_rel": 2e-2, "grad_l2_rel": 0.1}
# launches of the opt-in parity runs (UNet latent 32² batch 2, decoder latent 32²)
PARITY_OPTIN_LAUNCHES = {
    "unet": launches_of(flash_attention_hpacked=5, flash_fwd_sm90=5, geglu_ff=5, geglu_sm90=5,
                        group_norm=46, group_norm_sm90=46, crossattn_kv=10, crossattn_sm90=10),
    "decoder": launches_of(flash_attention_pipelined=1, flash_fwd_wide=1, conv3x3_same=12,
                           group_norm=11, group_norm_sm90=11)}
# ... and of the serving parity runs, every flash call through its variant
PARITY_SERVE_LAUNCHES = {
    "unet": launches_of(flash_attention_hpacked_exp_bf16_pv_int8=5, flash_fwd_sm90_pv8=5,
                        geglu_ff=5, geglu_sm90=5),
    "decoder": launches_of(flash_attention_exp_bf16_pv_int8=1, flash_fwd_wide=1,
                           conv3x3_same=12)}
# [B, S, C] of every GroupNorm and [B, N, M, heads, d, C] of every fused
# cross-attention one opt-in generate of 2 prompts launches
GN_SHAPES = [(4, 4096, 320), (4, 1024, 320), (4, 1024, 640), (4, 1024, 960),
             (4, 1024, 1280), (4, 256, 640), (4, 256, 1280), (4, 256, 1920),
             (4, 256, 2560), (4, 64, 1280), (4, 64, 2560)]
# ... the GroupNorm launches of one opt-in generate at each of GN_SHAPES (2850)
GN_LAUNCHES = (650, 50, 550, 50, 50, 50, 550, 50, 100, 600, 150)
XATTN_SHAPES = [(4, 4096, 77, 8, 40, 320), (4, 1024, 77, 8, 80, 640),
                (4, 256, 77, 8, 160, 1280)]
# ... and its ragged case: rows past a q tile, 33 tokens, d = 24
XATTN_RAGGED = (1, 1000, 33, 4, 24, 96)
# [N, C, inner] of every GEGLU feed-forward one generate launches (UNet levels 0
# and 1, batch 4), and a ragged case: tokens past a 64-row tile, a half chunk
# of 64 inner columns, the inner columns split over a cluster of 4
GEGLU_SHAPES = [(16384, 320, 1280), (4096, 640, 2560)]
GEGLU_RAGGED = (1000, 320, 1248)
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
# the fused GroupNorm → SiLU → 3×3 conv's cases beyond the decoder's conv
# shapes [B, H, W, C, O]: the ragged case, and C = 512 with H odd and W past a
# 128-pixel tile (a block's last row and last pixel tile partial), O over two
# blocks; its statistics pass within GN_STATS_TOL·max|ref| of its fp32 plain
# version in the kernel's order of sums (stated before measuring)
GN_CONV_RAGGED = [(1, 37, 50, 64, 128), (1, 75, 200, 512, 256)]
GN_STATS_TOL = 1e-5
LSE_TOL = 1e-3                                   # absolute, base-2 units
GRAD_TOL = {"max_rel": 2e-2, "l2_rel": 1e-2}     # flash dq, dk, dv
UNET_TOL = {"max_rel": 0.1, "l2_rel": 0.03}      # stated before measuring
DECODER_TOL = {"max_rel": 0.1, "l2_rel": 0.03}
TRAIN_GRAD_TOL = 0.1                             # ‖Δg‖₂ / ‖g‖₂, stated before measuring
TRAIN_STEPS = 3                                  # timed, after one warm-up step
# [B, Sq, Skv, H, D] of the flash training kernels' checks: train_ldm's
# self-attention at UNet levels 0 and 1, a ragged case, train_kl_vae's codec
# mid-block at 256², a 512² codec's, a ragged case at d = 512, the 32² level
# of configs/ddpm_256_catdog.yaml (batch 6, 256 channels; the training_options
# phase's bf16-compute train_ddpm), and
# train_vq's codec mid-block under the bf16 policy (vq_128_train_config(),
# batch 8); each added last, so that it shifts no other check's inputs
KLVAE_ATTN_SHAPE = (4, 1024, 1024, 1, 512)
VQ_ATTN_SHAPE = (8, 1024, 1024, 1, 256)
TRAIN_KERNEL_SHAPES = ((1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80), (1, 1000, 1300, 8, 40),
                       KLVAE_ATTN_SHAPE, (1, 4096, 4096, 1, 512), (1, 1000, 1300, 1, 512),
                       (6, 1024, 1024, 1, 256), VQ_ATTN_SHAPE)
# the KL-VAE parity gates, stated before measuring: each loss term within
# 5e-2 relative, d_weight within 0.1 relative (a ratio of two bf16 gradient
# norms), generator gradients ‖Δg‖₂ ≤ 0.1·‖g‖₂ (a dropped gradient reads ≈ 1.0)
KLVAE_LOSS_TOL = 5e-2
KLVAE_DWEIGHT_TOL = 0.1
KLVAE_GRAD_TOL = 0.1
KLVAE_STEPS = 4                                  # timed, after one warm-up step
# the DDPM parity gates (fp32 on the card, TF32 off, against fp32 on the CPU),
# stated before measuring: the loss within 1e-4 relative, grad_norm within
# 1e-3, the parameters after the step ‖Δ‖₂ ≤ 1e-3·‖ref‖₂
DDPM_TOL = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "params_l2_rel": 1e-3}
DDPM_STEPS = 1                                   # timed, after one warm-up step
VQ_STEPS = 3                                     # timed, after one warm-up step
VQ_EMA_STEPS = 3
# the inference variants' kernel checks: the serving path's shapes (bucket 4:
# the UNet at batch 8, the decoder at batch 4), a ragged d = 512 case, and
# the shape where the TPU package states the int8 contract
# (tests/test_flash_attention.py:206); [B, Sq, Skv, H, D]
SERVE_HPACKED_SHAPES = ((8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80))
SERVE_DECODER_SHAPE = (4, 4096, 4096, 1, 512)
CONTRACT_SHAPE = (1, 256, 256, 2, 40)
VARIANT_SHAPES = (SERVE_DECODER_SHAPE, (1, 512, 700, 1, 512), CONTRACT_SHAPE)
# ... the pipelined sweep with the bf16 exponential: the decoder's serving
# shape, the UNet's level 0 under SD_TPU_ATTN_HPACKED=0 at the serving batch
# (8, the switch combination's) and the UNet's [B, S, H, D] shapes at the
# opt-in generate's batch (4), and a ragged case
SERVE_PIPE_SHAPE = (8, 4096, 4096, 8, 40)
PIPE_EXP_SHAPES = (SERVE_DECODER_SHAPE, SERVE_PIPE_SHAPE, (4, 4096, 4096, 8, 40),
                   (4, 1024, 1024, 8, 80), (1, 1000, 1300, 8, 40))
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
ROUTE_COUNTER = {"sm90": "flash_fwd_sm90", "sm90_pipe": "flash_fwd_sm90_pipe",
                 "sm90_pv8": "flash_fwd_sm90_pv8", "wide": "flash_fwd_wide"}
ROUTE_COUNTERS = tuple(ROUTE_COUNTER.values())
# the Hopper kernels of the GEGLU feed-forward, the cross-attention,
# GroupNorm and the fused GroupNorm → SiLU → 3×3 conv, each wrapper's route
# counter (one count per call)
KERNEL_ROUTE_COUNTER = {"geglu_ff": "geglu_sm90", "crossattn_kv": "crossattn_sm90",
                        "group_norm": "group_norm_sm90", "gn_silu_conv3x3": "gn_silu_conv_sm90"}
# every counter a kernel case holds to one count, or none
CASE_ROUTE_COUNTERS = ROUTE_COUNTERS + tuple(KERNEL_ROUTE_COUNTER.values())
# ... and of the training forward (`kernels/flash_attention.py LSE_ROUTE_COUNTERS`)
LSE_ROUTE_COUNTER = {"sm90": "flash_lse_sm90", "wide": "flash_lse_wide"}
# ... and of the backward's Hopper routes (`BWD_ROUTE_COUNTERS`: (kernel, route))
BWD_ROUTE_COUNTER = {("dq", "sm90"): "flash_bwd_dq_sm90", ("dkv", "sm90"): "flash_bwd_dkv_sm90",
                     ("dq", "wide"): "flash_bwd_dq_wide_sm90",
                     ("dkv", "wide"): "flash_bwd_dkv_wide_sm90"}
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


def host_libraries() -> dict:
    """The host libraries the super-resolution data path needs: PIL's and
    scipy's versions and whether PIL can write JPEG (None where missing)."""
    out = {"pil": None, "pil_jpeg": None, "scipy": None}
    try:
        import PIL
        from PIL import features

        out.update(pil=PIL.__version__, pil_jpeg=bool(features.check("jpg")))
    except ImportError:
        pass
    try:
        import scipy

        out["scipy"] = scipy.__version__
    except ImportError:
        pass
    return out


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
    # the conv's, plus the GroupNorm scale and bias read and the statistics'
    # read of x (a whole pass over x before the first output can be formed)
    flops, nbytes = conv3x3_cost(b, h, w, c, o)
    return flops, nbytes + 4 * c + 2 * b * h * w * c


def gn_stats_cost(b, h, w, c):
    # x read once (the sums' fp32 adds are far below the bytes' time)
    return 0, 2 * b * h * w * c


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


# the shapes whose kernel-phase inputs come from a generator of their own,
# and its seed
OWN_STREAMS = {SERVE_PIPE_SHAPE: 8, GN_CONV_RAGGED[1]: 14}


def own_stream(shape):
    """The generator of a shape added to the kernel phases after the others
    (`OWN_STREAMS`: SERVE_PIPE_SHAPE, the fused conv's second ragged case), a
    stream of its own (None for every other shape: the phase's), so that
    every other check's inputs stay as they were."""
    import torch

    seed = OWN_STREAMS.get(tuple(shape))
    return None if seed is None else torch.Generator("cuda").manual_seed(seed)


def kernel_cases(gen):
    """One case per main-path shape of every kernel: callables for the
    kernel, its plain version (bf16 in), the fp32 reference and the library
    call, with the operations and bytes the work needs."""
    import torch
    import torch.nn.functional as F

    from sd_tpu_torch.kernels import conv2d, cross_attention as xattn
    from sd_tpu_torch.kernels import flash_attention as fa, geglu, groupnorm as gn

    def rnd(*shape, scale=1.0, g=None):
        return (torch.randn(shape, generator=g or gen, device="cuda") * scale).bfloat16()

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
            name="flash_attention_hpacked", shape=[4, S, H * D, H], route="sm90", device=True,
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
            name="flash_attention", shape=[B, S, Skv, H, D], route="sm90", how=how, device=True,
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
            name="flash_attention", shape=[B, S, Skv, H, D], route="wide", device=True,
            kernel=lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q, k, v, D**-0.5),
            ref=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q.float(), k.float(), v.float(), D**-0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)),
            generic=lambda q=q, k=k, v=v: route_forward(q, k, v),
            view=lambda o: o, table=D == 512,
            cost=attention_cost(B, S, Skv, H, D)))
    # row 7: GEGLU at UNet levels 0 and 1, tokens = 2B·S, and a ragged case
    # (tokens past a 64-row tile, a half chunk of inner columns, split in 4):
    # the Hopper kernel (geglu_sm90.cu), with geglu.cu's timed beside it, and
    # the unfused bf16 yardstick (two F.linear, F.gelu and the product)
    for N, C, I in GEGLU_SHAPES + [GEGLU_RAGGED]:
        x = rnd(N, C)
        w1, b1 = rnd(2 * I, C, scale=C**-0.5), rnd(2 * I, scale=0.1)
        w2, b2 = rnd(C, I, scale=I**-0.5), rnd(C, scale=0.1)
        args = (x, w1, b1, w2, b2)

        def unfused(a=args):
            h_a, h_g = F.linear(a[0], a[1], a[2]).chunk(2, dim=-1)
            return F.linear(h_a * F.gelu(h_g), a[3], a[4])

        cases.append(dict(
            name="geglu_ff", shape=[N, C, I], counter="geglu_sm90", device=True,
            table=(N, C, I) != GEGLU_RAGGED, split=geglu.geglu_plan(N, C, I).split,
            kernel=lambda a=args: geglu.geglu_ff(*a),
            plain=lambda a=args: geglu._geglu_xla(*a),
            ref=lambda a=args: geglu._geglu_xla(*(t.float() for t in a)),
            generic=lambda a=args: geglu._launch_geglu(*a, source="template"),
            unfused=unfused, library=None, view=lambda o: o,
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
            view=lambda o: o, device=True,
            cost=conv3x3_cost(B, Hs, Ws, C, O)))
    # row 2 (opt-in): the pipelined kv sweep, at the decoder's mid-block
    # attention and a ragged case (the wide kernel, with the template's
    # pipelined sweep timed beside it), and at head dims up to 128 on the PIPE
    # kernel of flash_attention_sm90.cu: the UNet's level 0 under
    # `SD_TPU_ATTN_HPACKED=0` at the switch combination's batch (8, the
    # shape its launches run at, and the row's), the UNet's [B, S, H, D]
    # shapes at batch 4 (at level 1 one TPU kv tile keeps the sweep serial,
    # so that shape is launched through its plan) and a ragged case,
    # with the template's pipelined sweep and the serial Hopper kernel timed
    # beside it. Each is held against the serial sweep of its source: the
    # same bits
    for B, S, Skv, H, D in ((2, 4096, 4096, 1, 512), (1, 512, 700, 1, 512),
                            SERVE_PIPE_SHAPE, (4, 4096, 4096, 8, 40),
                            (4, 1024, 1024, 8, 80), (1, 1000, 1300, 8, 40)):
        g = own_stream((B, S, Skv, H, D))
        q, k, v = rnd(B, S, H, D, g=g), rnd(B, Skv, H, D, g=g), rnd(B, Skv, H, D, g=g)
        heads = lambda t: t.transpose(1, 2)
        route, serial_route = ("wide", "wide") if D > 128 else ("sm90_pipe", "sm90")

        def vs_serial(out, q=q, k=k, v=v, route=serial_route):
            serial = route_forward(q, k, v, route)
            return {"serial_max_abs_diff": rel_err(out, serial)[0],
                    "same_bits_as_serial": bool(torch.equal(out, serial))}

        gated = fa._tpu_kv_tiles(Skv, D) >= 2    # the TPU package's switch holds
        kernel = ((lambda q=q, k=k, v=v: fa.flash_attention(q, k, v)) if gated
                  else (lambda q=q, k=k, v=v, r=route: route_forward(q, k, v, r, pipelined=True)))
        cases.append(dict(
            name="flash_attention_pipelined", shape=[B, S, Skv, H, D], kernel=kernel,
            how="" if gated else "plan", env={"SD_TPU_FLASH_PIPE": "1"}, route=route,
            generic=lambda q=q, k=k, v=v: route_forward(q, k, v, pipelined=True),
            serial=lambda q=q, k=k, v=v, r=serial_route: route_forward(q, k, v, r),
            plain=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q, k, v, D**-0.5),
            ref=lambda q=q, k=k, v=v, D=D: fa._xla_ref(q.float(), k.float(), v.float(),
                                                       D**-0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)),
            view=lambda o: o, extra=vs_serial, device=True, table=D > 128,
            cost=attention_cost(B, S, Skv, H, D)))
    # row 10 (opt-in): GroupNorm at every opt-in generate shape (eps 1e-5, the
    # resblocks'), the transformer norms' eps 1e-6, the SiLU epilogue (no
    # model path uses it) and a ragged case with 8 groups (17 channels a
    # group, rows past a block): the Hopper kernel (groupnorm_sm90.cu, the
    # grid `gn_plan` picks), with groupnorm.cu's timed beside it
    gn_cases = [(b, s_, c, 32, 1e-5, None, True) for b, s_, c in GN_SHAPES]
    gn_cases += [(4, 4096, 320, 32, 1e-6, None, False), (4, 1024, 640, 32, 1e-6, None, False),
                 (4, 256, 1280, 32, 1e-6, None, False), (4, 4096, 320, 32, 1e-6, "silu", False),
                 (3, 100, 136, 8, 1e-6, "silu", False), (3, 100, 136, 8, 1e-5, None, False)]
    for B, S, C, G, eps, act, table in gn_cases:
        x = rnd(B, S, C, scale=3.0) + 0.5
        sc, bi = 1 + rnd(C, scale=0.2), rnd(C, scale=0.3)
        kw = dict(groups=G, eps=eps, act=act)
        cases.append(dict(
            name="group_norm", shape=[B, S, C, G, eps, act], counter="group_norm_sm90",
            device=True, table=table, plan=gn.gn_plan(B, S, C, G)._asdict(),
            kernel=lambda x=x, sc=sc, bi=bi, kw=kw: gn.group_norm(x, sc, bi, **kw),
            plain=lambda x=x, sc=sc, bi=bi, kw=kw: gn.group_norm_xla(x, sc, bi, **kw),
            ref=lambda x=x, sc=sc, bi=bi, kw=kw: gn.group_norm_xla(
                x.float(), sc.float(), bi.float(), **kw),
            generic=lambda x=x, sc=sc, bi=bi, G=G, eps=eps, act=act: gn._launch_gn(
                x, sc, bi, G, eps, act, source="template"),
            library=(None if act else lambda x=x, sc=sc, bi=bi, G=G, eps=eps:
                     F.group_norm(x.transpose(1, 2), G, sc, bi, eps)),
            view=lambda o: o, cost=group_norm_cost(B, S, C, act == "silu")))
    # row 11 (opt-in): the cross-attention at UNet levels 0-2 over the 77 CLIP
    # tokens, and a ragged case (rows past a q tile, 33 tokens, d = 24): the
    # Hopper kernels (cross_attention_sm90.cu), with cross_attention.cu's
    # timed beside them, and the unfused bf16 yardstick (F.linear, SDPA over
    # the context, F.linear)
    for B, N, M, H, D, C in XATTN_SHAPES + [XATTN_RAGGED]:
        HD = H * D
        args = (rnd(B, N, C), rnd(HD, C, scale=C**-0.5), rnd(B, M, HD), rnd(B, M, HD),
                rnd(C, HD, scale=HD**-0.5), rnd(C, scale=0.1))

        def unfused(a=args, B=B, N=N, M=M, H=H, D=D):
            heads = lambda t, n: t.view(B, n, H, D).transpose(1, 2)
            o = F.scaled_dot_product_attention(heads(F.linear(a[0], a[1]), N), heads(a[2], M),
                                               heads(a[3], M))
            return F.linear(o.transpose(1, 2).reshape(B, N, H * D), a[4], a[5])

        plan = xattn.xattn_plan(B, N, M, H, D, C)
        cases.append(dict(
            name="crossattn_kv", shape=[B, N, M, H, D, C], counter="crossattn_sm90",
            device=True, table=(B, N, M, H, D, C) != XATTN_RAGGED,
            plan={"rows": plan.rows},
            kernel=lambda a=args, H=H: xattn.crossattn_kv(*a, H),
            plain=lambda a=args, H=H: xattn.crossattn_kv_xla(*a, H),
            ref=lambda a=args, H=H: xattn.crossattn_kv_xla(*(t.float() for t in a), H),
            generic=lambda a=args, H=H: xattn._launch_xattn(*a, H, None, source="template"),
            unfused=unfused, library=None, view=lambda o: o,
            cost=crossattn_cost(B, N, M, H, D, C)))
    # row 9 (no model path): GroupNorm → SiLU → 3×3 conv at the decoder's
    # conv shapes and the ragged ones (GN_CONV_RAGGED): the Hopper kernel
    # (conv2d_gn_sm90.cu), with conv2d.cu's PRO form timed beside it, its
    # statistics pass checked and timed apart, and two unfused yardsticks:
    # the library's (F.group_norm, F.silu, F.conv2d in bf16 on the same NHWC
    # data) and the port's own pair (group_norm with the SiLU epilogue, then
    # conv3x3_same) where `gn_plan` takes the shape
    for B, Hs, Ws, C, O in [(b, h, h, c, o) for b, h, c, o in DECODER_CONVS] + GN_CONV_RAGGED:
        g = own_stream((B, Hs, Ws, C, O))
        x = rnd(B, Hs, Ws, C, scale=2.0, g=g) + 0.5
        sc, bi = 1 + rnd(C, scale=0.1, g=g), rnd(C, scale=0.1, g=g)
        w = rnd(O, C, 3, 3, scale=(9 * C) ** -0.5, g=g).contiguous(
            memory_format=torch.channels_last)
        b = rnd(O, scale=0.1, g=g)
        args = (x, sc, bi, w, b)

        def unfused(a=args):
            x, sc, bi, w, b = a
            h = F.silu(F.group_norm(x.permute(0, 3, 1, 2), 32, sc, bi, 1e-6))
            return F.conv2d(h, w, b, padding=1)

        try:
            gn.gn_plan(B, Hs * Ws, C, 32)

            def pair(a=args, B=B, Hs=Hs, Ws=Ws, C=C):
                x, sc, bi, w, b = a
                h = gn.group_norm(x.view(B, Hs * Ws, C), sc, bi, groups=32, eps=1e-6,
                                  act="silu")
                return conv2d.conv3x3_same(h.view(B, Hs, Ws, C), w, b)
        except ValueError:
            pair = None
        cases.append(dict(
            name="gn_silu_conv3x3", shape=[B, Hs, Ws, C, O], counter="gn_silu_conv_sm90",
            device=True, table=Hs == Ws,
            plan=conv2d.gn_conv_plan((B, Hs, Ws, C), O, 32)._asdict(),
            kernel=lambda a=args: conv2d.gn_silu_conv3x3(*a),
            plain=lambda a=args: conv2d._gn_silu_conv_xla(*a),
            ref=lambda a=args: conv2d._gn_silu_conv_xla(*(t.float() for t in a)),
            generic=lambda a=args: conv2d._launch_gn_silu_conv(*a, 32, 1e-6, "template"),
            unfused=unfused, pair=pair, extra=lambda out, a=args: gn_stats_fields(*a),
            library=None, view=lambda o: o, cost=gn_silu_conv_cost(B, Hs, Ws, C, O)))
    # the per-rank shapes of a tensor-parallel UNet call at tp = 2 (the
    # parallel phase's): head-packed flash at 4 of the 8 heads, GEGLU at half
    # the inner width, the opt-in cross-attention at 4 heads; inputs from a
    # generator of their own, after every other case's
    # (its lambdas bind their own names: the earlier cases' `heads` is looked up late)
    g_tp = torch.Generator("cuda").manual_seed(15)
    for B, S, H, D in TP_FLASH_SHAPES:
        q, k, v = (rnd(B, S, H * D, g=g_tp) for _ in range(3))
        tp_split = lambda t, B=B, S=S, H=H, D=D: t.view(B, S, H, D)
        tp_heads = lambda t, s=tp_split: s(t).transpose(1, 2)
        cases.append(dict(
            name="flash_attention_hpacked", shape=[B, S, H * D, H], route="sm90", how="tp2",
            device=True, table=False,
            kernel=lambda q=q, k=k, v=v, H=H: fa.flash_attention_hpacked(q, k, v, H),
            plain=lambda q=q, k=k, v=v, s=tp_split, D=D: fa._xla_ref(s(q), s(k), s(v), D**-0.5),
            ref=lambda q=q, k=k, v=v, s=tp_split, D=D: fa._xla_ref(
                s(q).float(), s(k).float(), s(v).float(), D**-0.5),
            library=lambda q=q, k=k, v=v, h=tp_heads: F.scaled_dot_product_attention(
                h(q), h(k), h(v)),
            generic=lambda q=q, k=k, v=v, s=tp_split: route_forward(s(q), s(k), s(v)),
            view=lambda o, s=tp_split: s(o), cost=attention_cost(B, S, S, H, D)))
    for N, C, I in TP_GEGLU_SHAPES:
        args = (rnd(N, C, g=g_tp), rnd(2 * I, C, scale=C**-0.5, g=g_tp),
                rnd(2 * I, scale=0.1, g=g_tp), rnd(C, I, scale=I**-0.5, g=g_tp),
                rnd(C, scale=0.1, g=g_tp))

        def unfused(a=args):
            h_a, h_g = F.linear(a[0], a[1], a[2]).chunk(2, dim=-1)
            return F.linear(h_a * F.gelu(h_g), a[3], a[4])

        cases.append(dict(
            name="geglu_ff", shape=[N, C, I], counter="geglu_sm90", device=True, table=False,
            how="tp2", split=geglu.geglu_plan(N, C, I).split,
            kernel=lambda a=args: geglu.geglu_ff(*a),
            plain=lambda a=args: geglu._geglu_xla(*a),
            ref=lambda a=args: geglu._geglu_xla(*(t.float() for t in a)),
            generic=lambda a=args: geglu._launch_geglu(*a, source="template"),
            unfused=unfused, library=None, view=lambda o: o, cost=geglu_cost(N, C, I)))
    for B, N, M, H, D, C in TP_XATTN_SHAPES:
        HD = H * D
        args = (rnd(B, N, C, g=g_tp), rnd(HD, C, scale=C**-0.5, g=g_tp), rnd(B, M, HD, g=g_tp),
                rnd(B, M, HD, g=g_tp), rnd(C, HD, scale=HD**-0.5, g=g_tp),
                rnd(C, scale=0.1, g=g_tp))
        cases.append(dict(
            name="crossattn_kv", shape=[B, N, M, H, D, C], counter="crossattn_sm90",
            device=True, table=False, how="tp2",
            plan={"rows": xattn.xattn_plan(B, N, M, H, D, C).rows},
            kernel=lambda a=args, H=H: xattn.crossattn_kv(*a, H),
            plain=lambda a=args, H=H: xattn.crossattn_kv_xla(*a, H),
            ref=lambda a=args, H=H: xattn.crossattn_kv_xla(*(t.float() for t in a), H),
            generic=lambda a=args, H=H: xattn._launch_xattn(*a, H, None, source="template"),
            library=None, view=lambda o: o, cost=crossattn_cost(B, N, M, H, D, C)))
    return cases


def gn_stats_fields(x, sc, bi, w, b) -> dict:
    """The fused conv's statistics pass apart: (a, c) against their fp32
    plain version in the kernel's order of sums (GN_STATS_TOL), the same
    bits twice, its time in host and device time and its bound."""
    import torch

    from sd_tpu_torch.kernels import conv2d

    run = lambda: conv2d._launch_gn_stats(x, sc, bi, 32, 1e-6)
    got, again = run(), run()
    ref = conv2d._gn_stats_tiled_ref(x, sc, bi, 32, 1e-6)
    errs = [rel_err(g, r)[1] for g, r in zip(got, ref)]
    same = all(torch.equal(u, v) for u, v in zip(got, again))
    require(max(errs) <= GN_STATS_TOL and same,
            f"gn statistics {list(x.shape)}: max|Δ|/max|ref| (a, c) = {errs}, "
            f"same bits twice {same}")
    return {"stats_rel_err": errs, "stats_same_bits_as_plain":
            all(torch.equal(g, r) for g, r in zip(got, ref)),
            "stats_ms": time_ms(run), "stats_device_ms": device_ms(run),
            "stats_bound_ms": bound_ms(*gn_stats_cost(*x.shape))[0]}


def route_moves(run) -> tuple[object, dict]:
    """(run(), how far each flash route counter and each Hopper GEGLU and
    cross-attention counter moved in it)."""
    from sd_tpu_torch import kernels

    before = {c: kernels.LAUNCHES[c] for c in CASE_ROUTE_COUNTERS}
    out = run()
    return out, {c: kernels.LAUNCHES[c] - before[c] for c in CASE_ROUTE_COUNTERS}


def require_route(moved: dict, route: str, what: str) -> None:
    """One launch on `route`'s counter (a flash route's, none on the
    template, or a counter's own name), none on another."""
    counter = ROUTE_COUNTER.get(route, route)
    want = {c: int(c == counter) for c in CASE_ROUTE_COUNTERS}
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
    if case.get("how"):
        row["how"] = case["how"]
    if "route" in case:
        row.update(route=case["route"], how=case.get("how", ""))
        require_route(moved, case["route"], f"{case['name']} {case['shape']}")
    if "counter" in case:
        row["route_counter"] = case["counter"]
        row.update({k: case[k] for k in ("split", "plan") if k in case})
        require_route(moved, case["counter"], f"{case['name']} {case['shape']}")
    if case.get("device"):
        # the profiler's device time beside the host's, for the kernel, the
        # template and the library call
        row["device_ms"] = device_ms(case["kernel"])
        row["generic_device_ms"] = device_ms(case["generic"])
        if case["library"]:
            row["library_device_ms"] = device_ms(case["library"])
    if "serial" in case:
        # the pipelined sweep: the serial sweep of its source beside it
        row["serial_ms"] = time_ms(case["serial"])
        row["serial_device_ms"] = device_ms(case["serial"])
        require(row["same_bits_as_serial"],
                f"{case['shape']}: the pipelined sweep gives the serial sweep's bits")
    if "unfused" in case:
        row["unfused_ms"] = time_ms(case["unfused"])
        if case.get("device"):
            row["unfused_device_ms"] = device_ms(case["unfused"])
    if "pair" in case:
        # the port's own unfused pair, or None where its GroupNorm refuses the shape
        row["pair_ms"] = time_ms(case["pair"]) if case["pair"] else None
        row["pair_device_ms"] = device_ms(case["pair"]) if case["pair"] else None
    if "generic" in case:
        row["generic_ms"] = time_ms(case["generic"])
        row["same_bits_twice"] = bool(torch.equal(out, case["view"](case["kernel"]())))
        require(rel_err(case["view"](case["generic"]()), out)[1] <= KERNEL_TOL
                and row["same_bits_twice"],
                f"{case['shape']}: the template agrees with the Hopper kernel, which "
                f"gives the same bits twice")
        # each Hopper flash route's rows under its counter, the conv's, GEGLU's
        # and the cross-attention's under their names
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

    def rnd(*shape, g=None):
        return torch.randn(shape, generator=g or gen, device="cuda").bfloat16()

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
        library = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
        library_ms, library_device_ms = time_ms(library), device_ms(library)
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
                   "ms": time_ms(kernel), "device_ms": device_ms(kernel),
                   "plain_ms": time_ms(plain, 2), "library_ms": library_ms,
                   "library_device_ms": library_device_ms,
                   "library": "scaled_dot_product_attention (exact)",
                   "bound_ms": b_ms, "bound_by": b_by, "bound_op": b_op,
                   "route": plan.route, "kv_tile": bk}
            if plan.route in ROUTE_COUNTER:
                generic = lambda: route_forward(split(q), split(k), split(v), "template",
                                                exp_bf16, pv_int8, block_k=bk)
                row["generic_ms"] = time_ms(generic)
                row["generic_device_ms"] = device_ms(generic)
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
    # the same bits as the serial sweep of its source with the bf16
    # exponential alone (the wide kernel at d = 512, flash_attention_sm90.cu's
    # serial kernel at d ≤ 128; the UNet's level-1 shape, one TPU kv tile,
    # through its plan), against the plain sweep at the kernel's kv tile
    for B, Sq, Skv, H, D in PIPE_EXP_SHAPES:
        g = own_stream((B, Sq, Skv, H, D))
        q, k, v = rnd(B, Sq, H, D, g=g), rnd(B, Skv, H, D, g=g), rnd(B, Skv, H, D, g=g)
        exact = fa._xla_ref(q.float(), k.float(), v.float(), D**-0.5)
        route, serial_route = ("wide", "wide") if D > 128 else ("sm90_pipe", "sm90")
        gated = fa._tpu_kv_tiles(Skv, D) >= 2
        # (run under SD_TPU_FLASH_PIPE=1, set once around the calls below)
        piped = ((lambda q=q, k=k, v=v: fa.flash_attention(
            q, k, v, softmax_dtype=torch.bfloat16, pv_quant="int8")) if gated
                 else (lambda q=q, k=k, v=v: route_forward(q, k, v, route, True,
                                                           pipelined=True)))
        tile = TEMPLATE_KV_TILE if D > 128 else fa.sm90_block_k(D)
        plain = lambda q=q, k=k, v=v, D=D, tile=tile: fa._flash_tiled_ref(
            q, k, v, D**-0.5, tile, torch.bfloat16, "none", pipelined=True)
        before = kernels_launched("flash_attention_pipelined_exp_bf16")
        with switches({"SD_TPU_FLASH_PIPE": "1"}):
            out, moved = route_moves(piped)
            launched = kernels_launched("flash_attention_pipelined_exp_bf16") - before
            piped_ms, piped_device_ms = time_ms(piped), device_ms(piped)
            again = piped()
        require(launched == 1,
                "SD_TPU_FLASH_PIPE=1 with both variants runs the pipelined bf16 sweep")
        require_route(moved, route, f"pipelined bf16 flash {[B, Sq, Skv, H, D]}")
        serial = route_forward(q, k, v, serial_route, exp_bf16=True)
        ref = plain()
        _, vs_plain = rel_err(out, ref)
        worst, mean = _exact_errs(out, exact)
        plain_worst, plain_mean = _exact_errs(ref, exact)
        b_ms, b_by, b_op = variant_bound(B, Sq, Skv, H, D, False)
        library = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        generic = lambda q=q, k=k, v=v: route_forward(q, k, v, exp_bf16=True, pipelined=True)
        serial_fn = lambda q=q, k=k, v=v, r=serial_route: route_forward(q, k, v, r, True)
        row = {"phase": "kernel", "name": "flash_attention_pipelined_exp_bf16",
               "shape": [B, Sq, Skv, H, D], "how": "" if gated else "plan",
               "max_abs_err": rel_err(out, ref)[0],
               "rel_err": vs_plain, "vs_exact": {"max": worst, "mean": mean},
               "plain_vs_exact": {"max": plain_worst, "mean": plain_mean},
               "serial_exp_bf16_max_abs_diff": rel_err(out, serial)[0],
               "same_bits_as_serial_exp_bf16": bool(torch.equal(out, serial)),
               "same_bits_twice": bool(torch.equal(out, again)),
               "ms": piped_ms, "device_ms": piped_device_ms, "plain_ms": time_ms(plain, 2),
               "serial_ms": time_ms(serial_fn), "serial_device_ms": device_ms(serial_fn),
               "generic_ms": time_ms(generic), "generic_device_ms": device_ms(generic),
               "library_ms": time_ms(library), "library_device_ms": device_ms(library),
               "library": "scaled_dot_product_attention (exact)",
               "bound_ms": b_ms, "bound_by": b_by, "bound_op": b_op, "route": route,
               "kv_tile": tile}
        require(rel_err(generic(), out)[1] <= KERNEL_TOL,
                "the template's pipelined bf16 sweep agrees with the Hopper one")
        hopper_rows[ROUTE_COUNTER[route]].append(row)
        emit(row)
        require(vs_plain <= KERNEL_TOL and worst <= plain_worst + KERNEL_TOL
                and mean < EXACT_TOL["mean"] and row["same_bits_as_serial_exp_bf16"]
                and row["same_bits_twice"],
                f"pipelined bf16 flash {[B, Sq, Skv, H, D]}: within its gates, the same "
                f"bits as the serial sweep and twice")
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


def pinned_sdpa(heads, do_h):
    """`scaled_dot_product_attention` on one fixed backend: flash where it
    takes the shape, else memory-efficient (`torch.nn.attention.sdpa_kernel`).
    Returns (backend name, forward call, forward + backward call), or (None,
    None, None) where neither takes it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        def fwd(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(*heads)

        def fwd_bwd(backend=backend):
            with sdpa_kernel(backend):
                return torch.autograd.grad(F.scaled_dot_product_attention(*heads), heads, do_h)

        try:
            fwd_bwd()
        except RuntimeError:
            continue
        return backend.name.lower(), fwd, fwd_bwd
    return None, None, None


def sdpa_yardsticks(heads, do_h) -> dict:
    """`scaled_dot_product_attention`'s forward and backward (fwd+bwd − fwd)
    on [B, H, S, D] views, in host time (CUDA events) and device time
    (`device_ms`), on PyTorch's default dispatch ("default") and pinned to
    one backend ("pinned", `pinned_sdpa`), each with the backend it ran."""
    import torch
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(*heads)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), heads, do_h)

    name, p_fwd, p_fwd_bwd = pinned_sdpa(heads, do_h)
    out = {}
    for kind, f, fb in (("default", fwd, fwd_bwd), ("pinned", p_fwd, p_fwd_bwd)):
        if f is None:
            continue
        ms, both = time_ms(f), time_ms(fb)
        dev, dev_both = device_ms(f), device_ms(fb)
        backend = sdpa_backend(fb)
        if kind == "pinned":
            backend["pinned"] = name
        out[kind] = {"fwd_ms": ms, "fwd_device_ms": dev, "bwd_ms": both - ms,
                     "bwd_device_ms": dev_both - dev, "backend": backend}
    return out


def library_fields(sdpa: dict, part: str, call: str) -> dict:
    """A training row's library keys from `sdpa_yardsticks` for its `part`
    ("fwd" or "bwd"): `library_ms`, `library_device_ms` and
    `library_backend` of the faster in device time of the default dispatch
    and the pinned backend, both kept beside it."""
    best = min(sdpa.values(), key=lambda y: y[part + "_device_ms"])
    both = {kind: {"ms": y[part + "_ms"], "device_ms": y[part + "_device_ms"],
                   "backend": y["backend"]["backend"]} for kind, y in sdpa.items()}
    return {"library_ms": best[part + "_ms"], "library_device_ms": best[part + "_device_ms"],
            "library_backend": best["backend"], "library_call": call,
            "library_default": both.get("default"), "library_pinned": both.get("pinned")}


def phase_train_kernels(gen) -> dict:
    """The flash training kernels (LSE forward, dQ, dK/dV) at the training
    paths' self-attention shapes: train_ldm's [1, 4096, 8, 40] at UNet
    level 0 and [1, 1024, 8, 80] at level 1 (microbatch 1), train_kl_vae's
    codec mid-block [4, 1024, 1, 512] (256², batch 4), a 512² codec's
    [1, 4096, 1, 512], ragged cases at d = 40 and 512, and a bf16
    train_ddpm's [6, 1024, 1, 256]; against their plain versions in fp32
    from the same bf16 inputs; the LSE forward on its route (its counter
    and, where the sweep is split, the combine's moved by one) and the
    template's LSE sweep beside it (`generic_ms`), the combine launch of a
    split sweep as its own row; the backward on its route (`bwd_route`: at
    d ≤ 128 `flash_attention_bwd_sm90.cu`, above `flash_attention_bwd_wide_sm90.cu`;
    each route counter moved by one per call, dq, dk and dv within GRAD_TOL
    of the template (`flash_attention_bwd.cu`) too, whose times stand beside
    it as `generic_ms` and `generic_device_ms`); the LSE forward, dQ and
    dK/dV run twice must give the same bits. Every kernel row carries
    `device_ms` (torch.profiler's device time per call) beside its
    CUDA-event `ms`; the Hopper backward rows also, at head dims where both
    are built, the other rows per block than `bwd_rows` picks (`alt_rows_ms`,
    `alt_rows_device_ms`), and on the wide route the blocks a slab
    (`split`). Library:
    `scaled_dot_product_attention` on the default dispatch and on one
    pinned backend (`sdpa_yardsticks`), its
    forward for the LSE row and its backward (fwd+bwd − fwd) for the dQ and
    dK/dV rows, which SDPA computes together; `library_ms` (host clock),
    `library_device_ms` and `library_backend` are the faster's in device
    time, both kept as `library_default` and `library_pinned`. Returns
    {name: {shape: row}}."""
    import torch

    from sd_tpu_torch.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    from sd_tpu_torch import kernels

    rows_by_shape = {}
    bwd_counters = tuple(fa.BWD_ROUTE_COUNTERS.values())
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
        # the backward on its route: each call moves that route's counter by
        # one and no other
        b_route = fa.bwd_route(d)
        hop = int(b_route == "sm90")
        before = {c: kernels.LAUNCHES[c] for c in bwd_counters}
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
        moved_dq = {c: kernels.LAUNCHES[c] - before[c] for c in bwd_counters}
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        moved = {c: kernels.LAUNCHES[c] - before[c] for c in bwd_counters}
        want_dq = {c: int(key == ("dq", b_route)) for key, c in fa.BWD_ROUTE_COUNTERS.items()}
        want = {c: int(key[1] == b_route) for key, c in fa.BWD_ROUTE_COUNTERS.items()}
        require(moved_dq == want_dq and moved == want,
                f"backward {[b, sq, skv, h, d]} on the {b_route} route: moved {moved_dq}, "
                f"then {moved}")
        dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa._flash_lse_ref(*f32(q, k, v), scale)
        dq_ref, dk_ref, dv_ref, _ = fa._flash_bwd_ref(*f32(q, k, v, o), lse, do.float(), scale)
        errs = {"o": rel_err(o, o_ref), "dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref),
                "dv": rel_err(dv, dv_ref)}
        l2 = {"dq": l2_rel(dq, dq_ref), "dk": l2_rel(dk, dk_ref), "dv": l2_rel(dv, dv_ref)}
        lse_err = (lse - lse_ref).abs().max().item()
        same_dq = bool(torch.equal(dq, dq2) and torch.equal(delta, delta2))
        same_dkv = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        del o_ref, lse_ref, dq_ref, dk_ref, dv_ref, dq2, delta2, dk2, dv2
        # the template (flash_attention_bwd.cu) on the same inputs, its dK/dV
        # from the Hopper dQ's delta
        t_dq, _ = fa._launch_bwd("dq", q, k, v, o, lse, do, scale, "template")
        t_dk, t_dv = fa._launch_bwd("dkv", q, k, v, do, lse, delta, scale, "template")
        tpl = {g: (rel_err(x, t)[1], l2_rel(x, t))
               for g, x, t in (("dq", dq, t_dq), ("dk", dk, t_dk), ("dv", dv, t_dv))}
        del t_dq, t_dk, t_dv

        heads = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        do_h = do.transpose(1, 2)
        sdpa = sdpa_yardsticks(heads, do_h)
        dq_call = lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
        dkv_call = lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        lib_bwd = library_fields(sdpa, "bwd", "scaled_dot_product_attention backward "
                                 "(fwd+bwd - fwd), dq and dk/dv together: compare dQ + "
                                 "dK/dV with it")
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
                plain_ms=time_ms(lambda: fa._flash_lse_ref(q, k, v, scale), 3),
                **library_fields(sdpa, "fwd", "scaled_dot_product_attention forward"),
                cost=attention_lse_cost(*shape)),
            "flash_bwd_dq": dict(
                max_abs_err=errs["dq"][0], rel_err=errs["dq"][1], l2_rel=l2["dq"],
                route=b_route, same_bits_twice=same_dq,
                ms=time_ms(dq_call), device_ms=device_ms(dq_call),
                plain_ms=time_ms(lambda: fa._flash_bwd_dq_ref(q, k, v, o, lse, do, scale), 3),
                **lib_bwd, cost=attention_dq_cost(*shape)),
            "flash_bwd_dkv": dict(
                max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                rel_err=max(errs["dk"][1], errs["dv"][1]), l2_rel=max(l2["dk"], l2["dv"]),
                route=b_route, same_bits_twice=same_dkv,
                ms=time_ms(dkv_call), device_ms=device_ms(dkv_call),
                plain_ms=time_ms(lambda: fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale), 3),
                **lib_bwd, cost=attention_dkv_cost(*shape)),
        }
        for part, own, args in (("dq", sq, (q, k, v, o, lse, do)),
                                ("dkv", skv, (q, k, v, do, lse, delta))):
            row = rows["flash_bwd_" + part]
            if not hop:
                # the wide route: blocks of a cluster a slab (`bwd_wide_split`)
                row["split"] = fa.bwd_wide_split(d)
                continue
            row["rows"] = fa.bwd_rows(b, own, h, d)
            if d > fa.BWD_ROWS_128_MAX_D:
                continue
            # where both forms are built, the other rows per block than
            # `bwd_rows` picks (64 <-> 128), on the same inputs
            alt = 3 * 64 - row["rows"]
            call = lambda: fa._launch_bwd(part, *args, scale, "sm90", alt)
            got, ref = call(), ((dq, delta) if part == "dq" else (dk, dv))
            row.update(alt_rows=alt,
                       alt_rows_same_bits=all(map(torch.equal, got, ref)),
                       alt_rows_ms=time_ms(call), alt_rows_device_ms=device_ms(call))
            del got
        t_dq = lambda: fa._launch_bwd("dq", q, k, v, o, lse, do, scale, "template")
        t_dkv = lambda: fa._launch_bwd("dkv", q, k, v, do, lse, delta, scale, "template")
        rows["flash_bwd_dq"].update(
            template_rel_err=tpl["dq"][0], template_l2_rel=tpl["dq"][1],
            generic_ms=time_ms(t_dq), generic_device_ms=device_ms(t_dq))
        rows["flash_bwd_dkv"].update(
            template_rel_err=max(tpl["dk"][0], tpl["dv"][0]),
            template_l2_rel=max(tpl["dk"][1], tpl["dv"][1]),
            generic_ms=time_ms(t_dkv), generic_device_ms=device_ms(t_dkv))
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
            require(tpl[g][0] <= GRAD_TOL["max_rel"] and tpl[g][1] <= GRAD_TOL["l2_rel"],
                    f"{g} {shape}: from the template max {tpl[g][0]:.3g}·max|tpl|, "
                    f"l2 {tpl[g][1]:.3g}·‖tpl‖")
        require(same_dq and same_dkv, f"dQ {shape} ({same_dq}) and dK/dV ({same_dkv}) give the "
                f"same bits twice")
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
            and unet["geglu_ff"] == 5 and unet["geglu_sm90"] == 5,
            f"UNet parity launches {unet}")
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


def phase_e2e() -> tuple:
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
    return launches, pipe, prompts, images, secs


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
# call (bucket 4: batch 8, 512²) and one decode (batch 4), and the kernels
# whose rows take their launches from it. The head-packed launches take the
# Hopper route (its int8-PV form with the int8 PV), the decoder's (serial or
# pipelined) the wide kernel. The last reaches the pipelined sweep at d ≤ 128:
# the [B, S, H, D] route takes the 5 level-0 self-attentions (4096 tokens,
# d = 40: 4 of the TPU package's kv tiles) to the PIPE kernel and the 5 at
# level 1 (1024 tokens: one tile) to the serial one, with the UNet's 57
# GroupNorms (tests/test_torch_structure.py derives these)
_SERVING_CALL = dict(geglu_ff=10, geglu_sm90=10, conv3x3_same=18, flash_fwd_wide=1)
SWITCH_COMBINATIONS = (
    ({"SD_TPU_FLASH_EXP": "bf16"},
     launches_of(flash_attention_hpacked_exp_bf16=10, flash_fwd_sm90=10,
                 flash_attention_exp_bf16=1, **_SERVING_CALL),
     ("flash_attention_hpacked_exp_bf16", "flash_attention_exp_bf16")),
    ({"SD_TPU_FLASH_PV": "int8"},
     launches_of(flash_attention_hpacked_pv_int8=10, flash_fwd_sm90_pv8=10,
                 flash_attention_pv_int8=1, **_SERVING_CALL),
     ("flash_attention_hpacked_pv_int8", "flash_attention_pv_int8")),
    ({"SD_TPU_FLASH_EXP": "bf16", "SD_TPU_FLASH_PV": "int8", "SD_TPU_FLASH_PIPE": "1"},
     launches_of(flash_attention_hpacked_exp_bf16_pv_int8=10, flash_fwd_sm90_pv8=10,
                 flash_attention_pipelined_exp_bf16=1, **_SERVING_CALL),
     ("flash_attention_hpacked_exp_bf16_pv_int8", "flash_attention_pipelined_exp_bf16")),
    ({"SD_TPU_ATTN_HPACKED": "0", "SD_TPU_FLASH_PIPE": "1", "SD_TPU_PALLAS_GN": "1"},
     launches_of(flash_attention_pipelined=6, flash_fwd_sm90_pipe=5, flash_attention=5,
                 flash_fwd_sm90=5, group_norm=57, group_norm_sm90=57, **_SERVING_CALL),
     ("flash_fwd_sm90_pipe",)))


def phase_switch_combinations(pipe) -> dict:
    """One UNet call and one decode of the serving shapes under each other
    combination of the switches: which kernel each reaches, and a finite
    output. Returns {kernel: launches} of the rows these report."""
    import torch

    from sd_tpu_torch import kernels

    c, uc = pipe.encode_prompts(SERVE_PROMPTS)
    ctx = torch.cat([uc, c])
    x = torch.randn((8,) + pipe.latent_shape, device="cuda").bfloat16()
    t = torch.full((8,), 501, device="cuda")
    z = torch.randn((4,) + pipe.latent_shape, device="cuda").bfloat16()
    seen = {}
    for env, want, reports in SWITCH_COMBINATIONS:
        with switches(env), torch.no_grad():
            kernels.reset_launches()
            out, img = pipe.unet(x, t, ctx), pipe.vae.decode(z)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        finite = bool(torch.isfinite(out).all() and torch.isfinite(img).all())
        emit({"phase": "switches", "switches": env, "launches": launches, "finite": finite})
        want = {k: v for k, v in want.items() if v}
        require(launches == want and finite, f"switches {env}: launches {launches} == {want}")
        seen.update({name: launches[name] for name in reports})
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
                   "flash_bwd_dkv": 1, "flash_bwd_dq_sm90": 1, "flash_bwd_dkv_sm90": 1}),
    ({"SD_TPU_ATTN_PACKED": "1"}, "train",
     {"flash_attention_lse": 1, "flash_lse_sm90": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
      "flash_bwd_dq_sm90": 1, "flash_bwd_dkv_sm90": 1}),
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
            and launches["flash_bwd_dq"] == 5 and launches["flash_bwd_dq_sm90"] == 5
            and launches["flash_bwd_dkv"] == 5 and launches["flash_bwd_dkv_sm90"] == 5
            and launches["flash_attention_hpacked"] == 0
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


def _profile_second_step(trainer, cfg: dict, of: str, seed: int) -> None:
    """Where one step of `trainer(cfg, batches)` goes (`--profile`): the
    second step of a two-step run under torch.profiler, by kernel family,
    and its busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = []

    def batches():
        first, second = _image_batches(cfg["train"], 2, np.random.default_rng(seed))
        yield first
        torch.cuda.synchronize()
        prof.start()
        start.append(time.perf_counter())
        yield second

    _, hist = trainer(cfg, batches(), max_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start[0]
    prof.stop()
    emit({"phase": "profile", "of": of, "step_seconds": hist[1]["seconds"],
          **_device_breakdown(prof, wall)})


def phase_trainer_profiles() -> None:
    """The profiled step of train_kl_vae, train_ddpm and train_vq (the bf16
    policy), each `_profile_second_step`."""
    from sd_tpu_torch.core.config import ddpm_256_train_config
    from sd_tpu_torch.train.runners import train_ddpm, train_kl_vae, train_vq

    _profile_second_step(train_kl_vae, _klvae_config(), "train_kl_vae step", 4)
    _profile_second_step(train_ddpm, ddpm_256_train_config(), "train_ddpm step", 8)
    _profile_second_step(train_vq, _vq_config(), "train_vq step", 9)


def phase_ddpm_parity() -> dict:
    """One step of the train_ddpm recipe (`make_ddpm_trainer`) of
    ddpm_256_train_config() at full width, batch 1, fp32: on the card (TF32
    off) against the CPU, same weights (every parameter random, the
    zero-initialised head too, so that the gradient reaches every layer), t,
    noise and cosine lr. The loss, grad_norm and the parameters after clip
    + Adam against DDPM_TOL; no kernel launches (the config is fp32)."""
    import math

    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import ddpm_256_train_config
    from sd_tpu_torch.models.unet_ddpm import UNetDDPM
    from sd_tpu_torch.train.runners import make_ddpm_trainer
    from sd_tpu_torch.weights import randomize_params_

    cfg = ddpm_256_train_config()
    mp, px = cfg["model"]["params"], cfg["train"]["image_size"]
    g = torch.Generator().manual_seed(6)
    cpu = UNetDDPM(**mp, device="cpu")
    randomize_params_(cpu, g)
    gpu = UNetDDPM(**mp, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    batch = {"image": torch.rand(1, px, px, 3, generator=g) * 2 - 1,
             "t": torch.tensor([500]), "noise": torch.randn(1, px, px, 3, generator=g)}

    def run(model, dev):
        state, step = make_ddpm_trainer(cfg, model)
        logs = step(state, {k: v.to(dev) for k, v in batch.items()})
        return ({k: float(v) for k, v in logs.items()},
                {n: p.detach().cpu() for n, p in state.params.items()})

    kernels.reset_launches()
    logs_gpu, p_gpu = run(gpu, "cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    logs_cpu, p_cpu = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    norm = lambda ts: math.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))
    params_rel = norm(p_gpu[n] - p_cpu[n] for n in p_cpu) / norm(p_cpu.values())
    update_rel = (norm((p_gpu[n] - init[n]) - (p_cpu[n] - init[n]) for n in p_cpu)
                  / norm(p_cpu[n] - init[n] for n in p_cpu))
    row = {"phase": "ddpm_parity", "images": [1, px, px, 3], "logs_gpu": logs_gpu,
           "logs_cpu": logs_cpu, "loss_rel": rel(logs_gpu["loss"], logs_cpu["loss"]),
           "grad_norm_rel": rel(logs_gpu["grad_norm"], logs_cpu["grad_norm"]),
           "params_l2_rel": params_rel, "update_l2_rel": update_rel,
           "params": sum(p.numel() for p in p_cpu.values()), "bounds": DDPM_TOL,
           "launches": {k: v for k, v in launches.items() if v}, "cpu_seconds": cpu_s}
    emit(row)
    require(all(math.isfinite(v) for v in logs_gpu.values()), "finite DDPM logs on the card")
    require(row["loss_rel"] <= DDPM_TOL["loss_rel"]
            and row["grad_norm_rel"] <= DDPM_TOL["grad_norm_rel"]
            and params_rel <= DDPM_TOL["params_l2_rel"],
            f"DDPM step within {DDPM_TOL}: loss {row['loss_rel']:.3g}, grad_norm "
            f"{row['grad_norm_rel']:.3g}, params {params_rel:.3g}")
    require(not any(launches.values()), f"no kernel launches in the fp32 DDPM step: {launches}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return row


def phase_ddpm_train() -> dict:
    """train_ddpm(ddpm_256_train_config()) at full width (256², batch 6,
    fp32, cosine lr), every weight random from the config's seed, on seeded
    uint8-range images: 1 warm-up and DDPM_STEPS timed steps. Checks finite
    losses, the lr of each step (the optimizer's calls of the schedule)
    equal to `cosine_annealing`, an fp32 EMA shadow that moved, a
    `conv_out` that left zero, and no kernel launches."""
    import math

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import ddpm_256_train_config
    from sd_tpu_torch.models.unet_ddpm import UNetDDPM
    from sd_tpu_torch.train import runners
    from sd_tpu_torch.train.lr_schedules import cosine_annealing
    from sd_tpu_torch.weights import init_params_

    cfg = ddpm_256_train_config()
    tc = cfg["train"]
    steps = 1 + DDPM_STEPS
    # the weights train_ddpm starts from: the same build from the same seed
    model = UNetDDPM(**cfg["model"]["params"], device="cuda")
    init_params_(model, torch.Generator("cuda").manual_seed(cfg["seed"]))
    init = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model
    lrs, make_lr = [], runners.make_lr

    def recording_lr(train_cfg):
        fn = make_lr(train_cfg)

        def lr(step):
            lrs.append((step, fn(step)))
            return lrs[-1][1]
        return lr

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(runners, "make_lr", recording_lr):
        state, hist = runners.train_ddpm(cfg, _image_batches(tc, steps, np.random.default_rng(5)),
                                         max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    timed = [r["seconds"] for r in hist[1:]]
    sec = sum(timed) / len(timed)
    want_lr = cosine_annealing(tc["lr"], tc["total_steps"])
    ema_moved = sum(int((s.cpu() != init[n]).sum()) for n, s in state.ema.shadow.items())
    row = {"phase": "ddpm_train", "steps": len(hist), "timed_step_seconds": timed,
           "seconds_per_step": sec, "images_per_second": tc["batch_size"] / sec,
           "run_seconds": run_s, "peak_memory_gb": peak_gb,
           "losses": [r["loss"] for r in hist], "grad_norms": [r["grad_norm"] for r in hist],
           "lrs": lrs, "params": sum(p.numel() for p in state.params.values()),
           "ema_elements_moved": ema_moved,
           "launches": {k: v for k, v in launches.items() if v}}
    emit(row)
    require(len(hist) == steps, f"{steps} DDPM steps, ran {len(hist)}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                for r in hist), "finite losses and grad_norm > 0 on every step")
    require(lrs == [(i, want_lr(i)) for i in range(steps)],
            f"the lr of each step is cosine_annealing's: {lrs}")
    require(all(s.dtype == torch.float32 for s in state.ema.shadow.values()) and ema_moved > 0,
            "an fp32 EMA shadow that moved")
    require(bool(state.params["conv_out.weight"].any()), "conv_out left zero")
    require(not any(launches.values()), f"no kernel launches on the fp32 DDPM path: {launches}")
    del state
    torch.cuda.empty_cache()
    return row


def _vq_config() -> dict:
    """vq_128_train_config() under the bf16 parameter policy."""
    from sd_tpu_torch.core.config import vq_128_train_config

    cfg = vq_128_train_config()
    cfg["train"]["param_dtype"] = "bfloat16"
    return cfg


def phase_vq_parity() -> dict:
    """One VQ GAN step of the full-width vq_128 model (argmin codebook),
    PatchGAN and random-VGG LPIPS at 128², batch 2, `disc_start` 0, every
    weight random (bf16-rounded): bf16 parameters with the kernels on the
    card against fp32 plain on the card (TF32 off), same weights and images;
    each loss term and d_weight against the KL-VAE parity's gates, the
    launches of VQ_PARITY_LAUNCHES. The generator's gradients (global and at
    each mid-block AttnBlock q/k/v/proj_out weight) are held to
    KLVAE_GRAD_TOL in the same step without the two terms whose gradient
    with respect to the reconstruction is ill-conditioned (the random-VGG
    LPIPS and the discriminator: a 0.17% change of their input moves it by
    ~10% and ~8%), which the KL step's clamped adaptive weight (1e4·0.5)
    keeps small and the VQ step's mean nll does not; the full step's
    gradients are reported beside them. Each step runs once more in bf16
    with the attention on its plain version: what the bf16 policy alone
    moves, and how far the kernels are from it."""
    import contextlib
    import copy
    import math

    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.losses.gan import GanLossConfig
    from sd_tpu_torch.models import quantize
    from sd_tpu_torch.models.autoencoder import VQModel
    from sd_tpu_torch.models.discriminator import NLayerDiscriminator
    from sd_tpu_torch.models.lpips import make_lpips_fn
    from sd_tpu_torch.train.gan import init_gan_state, make_vq_gan_train_step
    from sd_tpu_torch.weights import randomize_params_

    cfg = _vq_config()
    mp, B, px = cfg["model"]["params"], 2, cfg["train"]["image_size"]
    g = torch.Generator("cuda").manual_seed(7)
    vq = VQModel(**mp, dtype=torch.float32, device="cuda")
    disc = NLayerDiscriminator(**cfg["discriminator"], dtype=torch.float32, device="cuda")
    for module in (vq, disc):
        randomize_params_(module, g)
        with torch.no_grad():
            for p in module.parameters():  # the bf16 runs' weights are these
                p.copy_(p.bfloat16().float())
    lpips_fn = make_lpips_fn(mode="random", device="cuda")
    x = torch.rand(B, px, px, 3, generator=g, device="cuda") * 2 - 1
    full = GanLossConfig(**{**cfg["loss"], "disc_start": 0})
    # the reconstruction and codebook terms alone: no LPIPS, disc_factor 0
    rec_only = GanLossConfig(**{**cfg["loss"], "perceptual_weight": 0.0, "disc_start": 1})

    # every run quantizes to the codes the first kernel run chose (the
    # argmin flips at near-ties under any rounding); each run's own choice
    # differing from them is counted
    own_nearest, codes, flips = quantize._nearest_code, [], []

    def nearest(z, e):
        own = own_nearest(z, e)
        if not codes:
            codes.append(own)
            return own
        flips.append(int((own != codes[0]).sum()))
        return codes[0]

    def run(param_dtype, loss_cfg, plain=False):
        model, d = copy.deepcopy(vq), copy.deepcopy(disc)
        opt_g, opt_d = _GradRecorder(), _GradRecorder()
        state = init_gan_state(model, d, opt_g, opt_d, param_dtype=param_dtype)
        step = make_vq_gan_train_step(
            lambda x, _, temp: model(x, temp=temp, update=True, deterministic=False), d,
            lpips_fn if loss_cfg.perceptual_weight > 0 else None, opt_g, opt_d, loss_cfg)
        with (mock.patch("sd_tpu_torch.kernels.attention.flash_ok", lambda q, k: False)
              if plain else contextlib.nullcontext()), \
                mock.patch.object(quantize, "_nearest_code", nearest):
            logs = {k: float(v) for k, v in step(state, x, None).items()}
        return logs, dict(zip(state.params_g, opt_g.grads))

    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    global_rel = lambda a, b: math.sqrt(sum(((a[n] - b[n]) ** 2).sum().item() for n in b)
                                        / sum((b[n] ** 2).sum().item() for n in b))
    attn_names = [n for n, _ in vq.named_parameters()
                  if ".AttnBlock_0." in n and n.endswith(("q.weight", "k.weight", "v.weight",
                                                          "proj_out.weight"))]
    attn_rel = lambda a, b: {n: l2_rel(a[n], b[n]) for n in attn_names}
    terms = ("total_loss", "nll_loss", "quant_loss", "g_loss", "rec_loss", "disc_loss")

    kernels.reset_launches()
    logs16, grads16 = run(torch.bfloat16, full)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    logs32, grads32 = run(None, full)
    logs_plain, grads_plain = run(torch.bfloat16, full, plain=True)
    rlogs16, rgrads16 = run(torch.bfloat16, rec_only)
    rlogs32, rgrads32 = run(None, rec_only)
    rlogs_plain, rgrads_plain = run(torch.bfloat16, rec_only, plain=True)
    loss_rel = {t: rel(logs16[f"train/{t}"], logs32[f"train/{t}"]) for t in terms}
    row = {"phase": "vq_parity", "images": [B, px, px, 3], "logs_bf16": logs16,
           "logs_fp32": logs32, "loss_rel": loss_rel, "codes": codes[0].numel(),
           # fp32, bf16 plain, bf16 rec-only, fp32 rec-only, bf16 plain rec-only
           "own_code_flips": flips,
           "d_weight_rel": rel(logs16["train/d_weight"], logs32["train/d_weight"]),
           "launches": {k: v for k, v in launches.items() if v},
           "rec_only": {"grad_l2_rel": global_rel(rgrads16, rgrads32),
                        "attn_l2_rel": attn_rel(rgrads16, rgrads32),
                        "loss_rel": {t: rel(rlogs16[f"train/{t}"], rlogs32[f"train/{t}"])
                                     for t in ("total_loss", "nll_loss", "quant_loss")},
                        "bf16_plain_vs_fp32": global_rel(rgrads_plain, rgrads32),
                        "kernels_vs_bf16_plain": global_rel(rgrads16, rgrads_plain),
                        "attn_kernels_vs_bf16_plain": attn_rel(rgrads16, rgrads_plain)},
           "full_step_grads": {"grad_l2_rel": global_rel(grads16, grads32),
                               "attn_l2_rel": attn_rel(grads16, grads32),
                               "bf16_plain_vs_fp32": global_rel(grads_plain, grads32),
                               "kernels_vs_bf16_plain": global_rel(grads16, grads_plain)},
           "bf16_plain_vs_fp32_loss_rel": {
               t: rel(logs_plain[f"train/{t}"], logs32[f"train/{t}"]) for t in terms},
           "bounds": {"loss_rel": KLVAE_LOSS_TOL, "d_weight_rel": KLVAE_DWEIGHT_TOL,
                      "rec_only_grad_l2_rel": KLVAE_GRAD_TOL}}
    emit(row)
    rec = row["rec_only"]
    require(len(attn_names) == 8, f"8 mid-block AttnBlock q/k/v/proj_out weights: {attn_names}")
    require(all(math.isfinite(v) for v in (*logs16.values(), *rlogs16.values())),
            "finite bf16 logs")
    require(max(loss_rel.values()) <= KLVAE_LOSS_TOL, f"loss terms within {KLVAE_LOSS_TOL}: {loss_rel}")
    require(row["d_weight_rel"] <= KLVAE_DWEIGHT_TOL,
            f"d_weight within {KLVAE_DWEIGHT_TOL}: {row['d_weight_rel']:.3g}")
    require(rec["grad_l2_rel"] <= KLVAE_GRAD_TOL and max(rec["attn_l2_rel"].values())
            <= KLVAE_GRAD_TOL, f"generator gradients within {KLVAE_GRAD_TOL}: global "
            f"{rec['grad_l2_rel']:.3g}, attention up to {max(rec['attn_l2_rel'].values()):.3g}")
    require(launches == VQ_PARITY_LAUNCHES, f"VQ parity launches {launches} == {VQ_PARITY_LAUNCHES}")
    del vq, disc, lpips_fn
    torch.cuda.empty_cache()
    return row


def phase_vq_train() -> dict:
    """train_vq(vq_128_train_config(), bf16 parameters) at full width,
    every weight random from the config's seed, on seeded uint8-range 128²
    images, batch 8: 1 warm-up and VQ_STEPS timed steps, launch counts over
    the whole run (EXPECTED_VQ_LAUNCHES a step); then train_vq(
    vq_64_train_config()) (the EMA codebook, fp32 as written) for
    VQ_EMA_STEPS steps: a codebook that moved, fp32 buffers no optimizer
    sees, perplexity > 1 on every step. Prints s/step, img/s and peak memory
    of both."""
    import math

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import vq_64_train_config
    from sd_tpu_torch.models.autoencoder import VQModel
    from sd_tpu_torch.train.runners import train_vq
    from sd_tpu_torch.weights import init_params_

    def run(cfg, steps, seed):
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = train_vq(cfg, _image_batches(cfg["train"], steps,
                                                   np.random.default_rng(seed)),
                               max_steps=steps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        timed = [r["seconds"] for r in hist[1:]]
        sec = sum(timed) / len(timed)
        row = {"config": cfg["model"]["params"].get("quantizer_type", "vq"),
               "images": [cfg["train"]["batch_size"], *[cfg["train"]["image_size"]] * 2, 3],
               "param_dtype": cfg["train"].get("param_dtype") or "float32",
               "steps": len(hist), "timed_step_seconds": timed, "seconds_per_step": sec,
               "images_per_second": cfg["train"]["batch_size"] / sec, "run_seconds": run_s,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
               "losses": {k[len("train/"):]: [r[k] for r in hist] for k in hist[0]
                          if k.startswith("train/")},
               "params_g": sum(p.numel() for n, p in state.params_g.items() if n != "logvar"),
               "launches": launches,
               "launches_per_step": {k: v / steps for k, v in launches.items()}}
        require(len(hist) == steps, f"{steps} VQ steps, ran {len(hist)}")
        require(all(math.isfinite(v) for r in hist for v in r.values()), "finite VQ logs")
        return state, hist, row

    cfg = _vq_config()
    steps = 1 + VQ_STEPS
    state, _, row = run(cfg, steps, 6)
    emit({"phase": "vq_train", **row})
    gen_params = [p for n, p in state.params_g.items() if n != "logvar"]
    moments = (state.opt_state_g.mu + state.opt_state_g.nu
               + state.opt_state_d.mu + state.opt_state_d.nu)
    require(all(p.dtype == torch.bfloat16 for p in gen_params + list(state.params_d.values()))
            and state.params_g["quantize.weight"].dtype == torch.bfloat16,
            "bf16 generator (codebook included) and discriminator parameters")
    require(state.params_g["logvar"].dtype == torch.float32
            and all(m.dtype == torch.float32 for m in moments), "fp32 logvar and Adam moments")
    want = {k: v * steps for k, v in EXPECTED_VQ_LAUNCHES.items()}
    require(row["launches"] == want, f"VQ train launches {row['launches']} == {want}")
    del state
    torch.cuda.empty_cache()

    cfg64 = vq_64_train_config()
    model = VQModel(**cfg64["model"]["params"], device="cuda")
    init_params_(model, torch.Generator("cuda").manual_seed(cfg64["seed"]))
    init = model.quantize.weight.detach().clone()
    del model
    state64, hist64, row64 = run(cfg64, VQ_EMA_STEPS, 7)
    book = state64.model_state
    row64["codebook_elements_moved"] = int((book["quantize.weight"] != init).sum())
    row64["perplexity"] = [r["train/perplexity"] for r in hist64]
    emit({"phase": "vq_train_ema", **row64})
    require(sorted(book) == ["quantize.cluster_size", "quantize.embed_avg", "quantize.weight"]
            and all(b.dtype == torch.float32 for b in book.values())
            and not any(n.startswith("quantize.") for n in state64.params_g),
            "the EMA codebook: fp32 buffers outside the optimizer")
    require(row64["codebook_elements_moved"] > 0 and bool(book["quantize.cluster_size"].any()),
            "an EMA codebook that moved")
    require(all(p > 1 for p in row64["perplexity"]), f"perplexity > 1: {row64['perplexity']}")
    del state64
    torch.cuda.empty_cache()
    return row


class _Tee:
    """stdout that is also kept: the trainers' printed lines, read back."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _flat(tree, path=""):
    """{path: leaf} of a checkpoint tree (dicts, lists, tensors, numbers)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def _cpu_tree(state) -> dict:
    """A training state's checkpoint tree, every tensor copied to the CPU."""
    from sd_tpu_torch.train.checkpoint import state_tree

    return {k: (v.cpu().clone() if hasattr(v, "cpu") else v)
            for k, v in _flat(state_tree(state)).items()}


def _same_tree(a: dict, b: dict) -> list:
    """The paths where two flattened trees differ (dtype, shape or any bit)."""
    import torch

    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    bad = []
    for k, x in a.items():
        y = b[k]
        same = (torch.is_tensor(y) and x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x, y)) if torch.is_tensor(x) else (x == y)
        if not same:
            bad.append(k)
    return bad


def _write_train_run_images(root: str) -> list:
    """TRAIN_RUN_IMAGES 512² RGB PNGs (`cat_0..3`, `dog_0..3`): a seeded
    smooth field (8² noise resized bicubic) plus noise, through the port's
    encoder. Their class label (the file name before its first dot) is the
    stem, so each image has its own caption."""
    import numpy as np

    from sd_tpu_torch.data.image_io import resize, write_png

    rng = np.random.default_rng(16)
    paths = []
    for i in range(TRAIN_RUN_IMAGES):
        low = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        field = resize(low, 512, 512).astype(np.int16) + rng.integers(-12, 13, (512, 512, 3))
        path = os.path.join(root, f"{('cat', 'dog')[i // 4]}_{i % 4}.png")
        write_png(path, np.clip(field, 0, 255).astype(np.uint8))
        paths.append(path)
    return paths


def _hold_path_kernels(convs: set, flashes: set) -> list:
    """Each conv shape [B, H, W, C, O] and inference flash shape [B, S, Skv,
    H, D] a run of this phase gave its kernel that the kernel phase does not
    hold: the kernel on random bf16 inputs (a generator of their own)
    against its fp32 plain version, within KERNEL_TOL."""
    import torch

    from sd_tpu_torch.kernels import conv2d
    from sd_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(16)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=g, device="cuda") * scale).bfloat16()
    rows = []
    for B, H, W, C, O in sorted(convs - {(b, h, h, c, o) for b, h, c, o in DECODER_CONVS}):
        x, b = rnd(B, H, W, C), rnd(O, scale=0.1)
        w = rnd(O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(memory_format=torch.channels_last)
        _, rel = rel_err(conv2d.conv3x3_same(x, w, b),
                         conv2d._xla_conv3x3(x.float(), w.float(), b.float()))
        rows.append({"name": "conv3x3_same", "shape": [B, H, W, C, O], "rel_err": rel})
    for B, S, Skv, H, D in sorted(flashes):
        q, k, v = rnd(B, S, H, D), rnd(B, Skv, H, D), rnd(B, Skv, H, D)
        _, rel = rel_err(fa.flash_attention(q, k, v),
                         fa._xla_ref(q.float(), k.float(), v.float(), D**-0.5))
        rows.append({"name": "flash_attention", "shape": [B, S, Skv, H, D], "rel_err": rel})
    for r in rows:
        require(r["rel_err"] <= KERNEL_TOL, f"{r['name']} {r['shape']} on the train_run path: "
                f"max|Δ| = {r['rel_err']:.3g}·max|ref| > {KERNEL_TOL}")
    return rows


def phase_train_run(smi: str) -> dict:
    """The training run around the trainers, chained as the flagship recipe
    is (configs/sd512_catdog.yaml's first stage is a KL-f8 run's
    checkpoint), through `python -m sd_tpu_torch.train`'s `main` at full
    width, in a temporary directory removed at the end:
      data     TRAIN_RUN_IMAGES synthetic 512² PNGs; one batch of 4 through
               the DataLoader as-is (512²) and resized to 256², timed;
      kl run   kl_f8_256_train_config() (bf16 policy), 2 steps with a
               checkpoint and an eval at step 2, then `--max-steps 3`: it
               resumes at step 2 with the saved state bit for bit,
               metrics.jsonl holds 3 step records and the eval's
               (eval_psnr, eval_ssim), samples/step_2.png decodes, and the
               launches are EXPECTED_KLVAE_LAUNCHES × 3 + KL_RUN_EVAL_LAUNCHES;
      ldm run  sd512_train_config() on the KL run's `ckpt`, 2 steps: its
               first stage equals the KL run's params_g bit for bit,
               calibration.json holds the printed scale factor, 2 records,
               the final checkpoint (≈ 12 GB), EXPECTED_TRAIN_LAUNCHES × 2
               (+ FIRST_STAGE_ENCODE_LAUNCHES × 3);
      from_run `Text2ImagePipeline.from_run` of the LDM run, generate (2
               prompts, 512², 50 steps, CFG 7.5): the images of a pipeline
               given the same EMA shadow, first stage and scale factor by
               hand, bit for bit, and EXPECTED_LAUNCHES.
    The new shapes this path gives the conv and the inference flash kernel
    (the KL eval's) are held against their plain versions. Prints the
    checkpoints' save and restore seconds with GB and GB/s, each run's wall
    seconds and s/step, peak memory and the free disk."""
    import contextlib
    import copy
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import sd512_train_config
    from sd_tpu_torch.data.datasets import ImageFolderDataset
    from sd_tpu_torch.data.image_io import decode_png
    from sd_tpu_torch.data.loader import DataLoader
    from sd_tpu_torch.kernels import conv2d
    from sd_tpu_torch.kernels import flash_attention as fa
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.train import runners
    from sd_tpu_torch.train.checkpoint import restore_tree

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_train_run_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        require(free_gb >= TRAIN_RUN_DISK_GB, f"free disk under {root}: {free_gb:.1f} GB, the "
                f"phase needs {TRAIN_RUN_DISK_GB} GB (the LDM run's ≈ 12 GB checkpoint)")
        data = os.path.join(root, "data")
        os.makedirs(data)
        _write_train_run_images(data)
        loader_s = {}
        for size in (512, 256):
            loader = DataLoader(ImageFolderDataset(data, image_size=size), batch_size=4)
            it = iter(loader)
            t0 = time.perf_counter()
            batch = next(it)
            loader_s[size] = time.perf_counter() - t0
            it.close()
            require(batch["image"].shape == (4, size, size, 3)
                    and np.isfinite(batch["image"]).all(), f"a [4, {size}², 3] batch")

        # every checkpoint save and restore of the runs, timed; the state at
        # each save and at each resume, on the CPU
        saves, resumes = [], []
        save0, resume0 = runners.save_checkpoint, runners.auto_resume

        def save(ckpt_dir, state, step, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save0(ckpt_dir, state, step, **kw)
            sec = time.perf_counter() - t0
            gb = os.path.getsize(path) / 1e9
            saves.append({"step": step, "seconds": sec, "gb": gb, "gb_per_s": gb / sec,
                          "tree": _cpu_tree(state) if gb < 4 else None})
            return path

        def resume(ckpt_dir, fresh):
            t0 = time.perf_counter()
            state, start = resume0(ckpt_dir, fresh)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            if start:
                gb = os.path.getsize(os.path.join(ckpt_dir, f"step_{start}.pt")) / 1e9
                resumes.append({"step": start, "seconds": sec, "gb": gb, "gb_per_s": gb / sec,
                                "tree": _cpu_tree(state)})
            return state, start

        # shapes the conv and the inference flash kernel get on this path
        convs, flashes = set(), set()
        conv0, flash0 = conv2d.conv3x3_same, fa.flash_attention

        def conv_spy(x, w, b):
            convs.add((*x.shape, w.shape[0]))
            return conv0(x, w, b)

        def flash_spy(q, k, v, **kw):
            flashes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
            return flash0(q, k, v, **kw)

        fs_models, scale_factors = [], []
        build0, calibrate0 = runners.build_first_stage, runners.calibrate_scale_factor

        def build_first_stage(*a, **kw):
            fs_models.append(build0(*a, **kw))
            return fs_models[-1]

        def calibrate(z):
            scale_factors.append(calibrate0(z))
            return scale_factors[-1]

        histories = []
        loop0 = runners._run_loop

        def loop(*a, **kw):
            histories.append(loop0(*a, **kw))
            return histories[-1]

        tee = _Tee(sys.stdout)
        patches = contextlib.ExitStack()
        for obj, name, fn in ((runners, "save_checkpoint", save), (runners, "auto_resume", resume),
                              (runners, "_run_loop", loop),
                              (runners, "build_first_stage", build_first_stage),
                              (runners, "calibrate_scale_factor", calibrate),
                              (conv2d, "conv3x3_same", conv_spy),
                              (fa, "flash_attention", flash_spy)):
            patches.enter_context(mock.patch.object(obj, name, fn))
        patches.enter_context(contextlib.redirect_stdout(tee))

        def run(cfg_path, out, *extra):
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            code = train_cli.main(["--config", cfg_path, "--data", data, "--out", out, *extra])
            torch.cuda.synchronize()
            require(code == 0, f"python -m sd_tpu_torch.train {cfg_path}: exit {code}")
            return {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}

        def records(out):
            with open(os.path.join(out, "metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        with patches:
            # -- the KL-f8 run and its resume ----------------------------------
            kl_cfg = _klvae_config()
            kl_cfg["train"].update(total_steps=TRAIN_RUN_KL_STEPS[0],
                                   checkpoint_every=TRAIN_RUN_KL_STEPS[0],
                                   eval_every=TRAIN_RUN_KL_STEPS[0])
            kl_json, kl_dir = os.path.join(root, "kl.json"), os.path.join(root, "kl")
            with open(kl_json, "w") as f:
                json.dump(kl_cfg, f)
            kl1 = run(kl_json, kl_dir)
            kl2 = run(kl_json, kl_dir, "--max-steps", str(TRAIN_RUN_KL_STEPS[1]))
            kl_launches = {k: kl1["launches"][k] + kl2["launches"][k] for k in kl1["launches"]}
            kl_saved = [s_ for s_ in saves if s_["step"] == TRAIN_RUN_KL_STEPS[0]][-1]
            require(len(resumes) == 1 and resumes[0]["step"] == TRAIN_RUN_KL_STEPS[0],
                    f"the KL run resumed at step {TRAIN_RUN_KL_STEPS[0]}: {resumes}")
            differ = _same_tree(kl_saved["tree"], resumes[0]["tree"])
            require(not differ, f"the restored KL state equals the saved one bit for bit: "
                    f"{differ[:5]} differ")
            kl_records = records(kl_dir)
            steps_logged = [r["step"] for r in kl_records if "train/total_loss" in r]
            evals = [r for r in kl_records if "eval_psnr" in r]
            require(steps_logged == list(range(TRAIN_RUN_KL_STEPS[1])),
                    f"metrics.jsonl: step records {steps_logged}")
            require(len(evals) == 1 and evals[0]["step"] == TRAIN_RUN_KL_STEPS[0]
                    and math.isfinite(evals[0]["eval_psnr"])
                    and math.isfinite(evals[0]["eval_ssim"]), f"one eval record: {evals}")
            with open(os.path.join(kl_dir, "samples", f"step_{TRAIN_RUN_KL_STEPS[0]}.png"),
                      "rb") as f:
                grid = decode_png(f.read())
            require(grid.shape == (514, 514, 3), f"the eval grid decodes: {grid.shape}")
            want = {k: TRAIN_RUN_KL_STEPS[1] * v + KL_RUN_EVAL_LAUNCHES[k]
                    for k, v in EXPECTED_KLVAE_LAUNCHES.items()}
            require(kl_launches == want, f"KL run launches {kl_launches} == {want}")
            kl_tree = restore_tree(os.path.join(kl_dir, "ckpt"))
            kl_params = {n: t for n, t in kl_tree["params_g"].items() if n != "logvar"}
            saves[-1]["tree"] = kl_saved["tree"] = resumes[0]["tree"] = None
            torch.cuda.empty_cache()

            # -- the SD-v1 LDM run on the KL run's checkpoint -------------------
            ldm_cfg = sd512_train_config()
            ldm_cfg["first_stage"]["ckpt"] = os.path.join(kl_dir, "ckpt")
            ldm_cfg["train"].update(total_steps=TRAIN_RUN_LDM_STEPS,
                                    checkpoint_every=TRAIN_RUN_LDM_STEPS)
            ldm_json, ldm_dir = os.path.join(root, "ldm.json"), os.path.join(root, "ldm")
            with open(ldm_json, "w") as f:
                json.dump(ldm_cfg, f)
            ldm = run(ldm_json, ldm_dir)
            fs = fs_models[-1]
            fs_differ = [n for n, p in fs.named_parameters()
                         if not (p.dtype == torch.float32
                                 and torch.equal(p.detach().cpu(), kl_params[n].float())
                                 and torch.equal(p.detach().cpu().to(kl_params[n].dtype),
                                                 kl_params[n]))]
            require(sorted(n for n, _ in fs.named_parameters()) == sorted(kl_params)
                    and not fs_differ, f"the LDM run's first stage is the KL run's params_g "
                    f"bit for bit: {fs_differ[:5]} differ")
            with open(os.path.join(ldm_dir, "calibration.json")) as f:
                sf = json.load(f)["scale_factor"]
            printed = [line for line in "".join(tee.lines).splitlines()
                       if line.startswith("[ldm] scale_factor (std-rescale):")]
            require(scale_factors and sf == scale_factors[-1] and printed
                    and printed[-1].endswith(f"{sf:.4f}"),
                    f"calibration.json's scale factor {sf} is the printed one: {printed}")
            ldm_records = records(ldm_dir)
            require([r["step"] for r in ldm_records] == list(range(TRAIN_RUN_LDM_STEPS))
                    and all(math.isfinite(r["loss"]) for r in ldm_records),
                    f"metrics.jsonl: {TRAIN_RUN_LDM_STEPS} finite records")
            ldm_ckpt = os.path.join(ldm_dir, "ckpt", f"step_{TRAIN_RUN_LDM_STEPS}.pt")
            require(os.path.exists(ldm_ckpt), f"the final checkpoint {ldm_ckpt}")
            want = {k: TRAIN_RUN_LDM_STEPS * v + (1 + TRAIN_RUN_LDM_STEPS)
                    * FIRST_STAGE_ENCODE_LAUNCHES[k] for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
            require(ldm["launches"] == want, f"LDM run launches {ldm['launches']} == {want}")
            del fs, fs_models[:]
            torch.cuda.empty_cache()

            # -- from_run, and the same pipeline built by hand ------------------
            prompts = ["a photo of a cat", "a photo of a dog"]
            gen_kw = dict(num_steps=50, guidance_scale=7.5, seed=16)
            t0 = time.perf_counter()
            pipe = Text2ImagePipeline.from_run(ldm_json, ldm_dir)
            torch.cuda.synchronize()
            from_run_load_s = time.perf_counter() - t0
            kernels.reset_launches()
            t0 = time.perf_counter()
            images = pipe.generate(prompts, **gen_kw)
            torch.cuda.synchronize()
            generate_s = time.perf_counter() - t0
            from_run_launches = dict(kernels.LAUNCHES)
            del pipe
            torch.cuda.empty_cache()
            ldm_tree = restore_tree(os.path.join(ldm_dir, "ckpt"))
            hand_cfg = copy.deepcopy(ldm_cfg)
            del hand_cfg["first_stage"]["ckpt"]
            hand = Text2ImagePipeline(hand_cfg)
            with torch.no_grad():
                for n, p in hand.unet.named_parameters():
                    p.copy_(ldm_tree["ema"]["shadow"][n].to(p.dtype))
                for n, p in hand.vae.named_parameters():
                    p.copy_(kl_params[n].to(p.dtype))
            hand.ld = dataclasses.replace(hand.ld, scale_factor=sf)
            by_hand = hand.generate(prompts, **gen_kw)
            del hand, ldm_tree
            torch.cuda.empty_cache()
        require(images.shape == (2, 512, 512, 3) and images.dtype == np.uint8
                and images.std() > 0, f"from_run images {images.shape} {images.dtype}")
        require(np.array_equal(images, by_hand), "from_run's images equal, bit for bit, those "
                "of a pipeline given the same weights and scale factor by hand")
        require(from_run_launches == EXPECTED_LAUNCHES,
                f"from_run generate launches {from_run_launches} == {EXPECTED_LAUNCHES}")
        held = _hold_path_kernels(convs, flashes)

        strip = lambda recs: [{k: v for k, v in r.items() if k != "tree"} for r in recs]
        row = {"phase": "train_run", "nvidia_smi": smi, "free_disk_gb": free_gb,
               "loader_seconds_per_batch": {"512": loader_s[512], "256": loader_s[256]},
               "checkpoint_saves": strip(saves), "checkpoint_restores": strip(resumes),
               "kl_run": {"seconds": [kl1["seconds"], kl2["seconds"]],
                          "steps": list(TRAIN_RUN_KL_STEPS),
                          "peak_memory_gb": max(kl1["peak_memory_gb"], kl2["peak_memory_gb"]),
                          "step_seconds": [r["seconds"] for h in histories[:2] for r in h],
                          "eval": evals[0],
                          "launches": {k: v for k, v in kl_launches.items() if v}},
               "ldm_run": {"seconds": ldm["seconds"], "steps": TRAIN_RUN_LDM_STEPS,
                           "peak_memory_gb": ldm["peak_memory_gb"], "scale_factor": sf,
                           "losses": [r["loss"] for r in ldm_records],
                           "step_seconds": [r["seconds"] for r in histories[2]],
                           "checkpoint_gb": os.path.getsize(ldm_ckpt) / 1e9,
                           "launches": {k: v for k, v in ldm["launches"].items() if v}},
               "from_run": {"load_seconds": from_run_load_s, "generate_seconds": generate_s,
                            "launches": {k: v for k, v in from_run_launches.items() if v}},
               "path_kernels_held": held,
               "phase_seconds": time.perf_counter() - t_phase}
        emit(row)
        return {"kl_run": kl_launches, "ldm_run": ldm["launches"], "from_run": from_run_launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _chunked_attention_ref(q, k, v, rows: int = 1024):
    """The fp32 plain attention of [B, S, H, D] q against k, v, a block of
    q rows at a time (the rows are independent; the whole S × S logits of
    the 1024² shapes would not fit)."""
    import torch

    from sd_tpu_torch.kernels import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    return torch.cat([fa._xla_ref(q[:, i:i + rows].float(), k.float(), v.float(), scale)
                      for i in range(0, q.shape[1], rows)], dim=1)


def _kernel_shape_spies(shapes: dict):
    """Patches (an ExitStack to enter) that record into `shapes` every shape
    the 3×3 conv, flash, head-packed flash and GEGLU wrappers are called at,
    and call through."""
    import contextlib

    from sd_tpu_torch.kernels import conv2d, geglu
    from sd_tpu_torch.kernels import flash_attention as fa

    for name in ("conv3x3_same", "flash_attention", "flash_attention_hpacked", "geglu_ff"):
        shapes.setdefault(name, set())
    conv0, flash0, hpacked0, geglu0 = (conv2d.conv3x3_same, fa.flash_attention,
                                       fa.flash_attention_hpacked, geglu.geglu_ff)

    def conv_spy(x, w, b):
        shapes["conv3x3_same"].add((*x.shape, w.shape[0]))
        return conv0(x, w, b)

    def flash_spy(q, k, v, **kw):
        shapes["flash_attention"].add((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                       q.shape[3]))
        return flash0(q, k, v, **kw)

    def hpacked_spy(q, k, v, heads, **kw):
        shapes["flash_attention_hpacked"].add((q.shape[0], q.shape[1], heads,
                                               q.shape[2] // heads))
        return hpacked0(q, k, v, heads, **kw)

    def geglu_spy(x, w1, b1, w2, b2):
        shapes["geglu_ff"].add((x.numel() // x.shape[-1], x.shape[-1], w2.shape[1]))
        return geglu0(x, w1, b1, w2, b2)

    patches = contextlib.ExitStack()
    for obj, name, fn in ((conv2d, "conv3x3_same", conv_spy), (fa, "flash_attention", flash_spy),
                          (fa, "flash_attention_hpacked", hpacked_spy),
                          (geglu, "geglu_ff", geglu_spy)):
        patches.enter_context(mock.patch.object(obj, name, fn))
    return patches


def _run_twice(runs: dict, name: str, fn, expected: dict):
    """An entry point returning uint8 images, twice: the first run's
    launches (required to be `expected`) and images, the second run's
    seconds, the peak memory of both, the same bits required. Returns the
    first run's images."""
    import numpy as np
    import torch

    from sd_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    first = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    second = fn()
    torch.cuda.synchronize()
    runs[name] = {"seconds": [first_s, time.perf_counter() - t0],
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                  "shape": list(first.shape),
                  "launches": {k: v for k, v in launches.items() if v}}
    require(first.dtype == np.uint8 and first.std() > 0, f"{name}: non-constant uint8 "
            f"images, got {first.dtype} std {first.std()}")
    require(np.array_equal(first, second), f"{name}: the same bits twice")
    require(launches == expected, f"{name} launches {runs[name]['launches']} == "
            f"{ {k: v for k, v in expected.items() if v} }")
    return first


def _hold_edit_kernels(shapes: dict, seed: int = IMAGE_EDIT_SEED,
                       path: str = "image_edit") -> list:
    """Each shape a phase gave a kernel: the kernel on random bf16 inputs
    (a generator of their own, seeded with `seed`) against its fp32 plain
    version within KERNEL_TOL·max|ref|, the same bits on a second call, its
    route counter moved once a call, its time (CUDA events) beside its
    bound."""
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.kernels import conv2d, geglu
    from sd_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=g, device="cuda") * scale).bfloat16()
    cases = []
    for B, H, W, C, O in sorted(shapes["conv3x3_same"]):
        x, b = rnd(B, H, W, C), rnd(O, scale=0.1)
        w = rnd(O, C, 3, 3, scale=(9 * C) ** -0.5).contiguous(memory_format=torch.channels_last)
        cases.append(("conv3x3_same", [B, H, W, C, O], None,
                      lambda x=x, w=w, b=b: conv2d.conv3x3_same(x, w, b),
                      lambda x=x, w=w, b=b: conv2d._xla_conv3x3(x.float(), w.float(), b.float()),
                      conv3x3_cost(B, H, W, C, O) + (PEAK_FLOPS, 0)))
    for B, S, Skv, Hh, D in sorted(shapes["flash_attention"]):
        q, k, v = rnd(B, S, Hh, D), rnd(B, Skv, Hh, D), rnd(B, Skv, Hh, D)
        cases.append(("flash_attention", [B, S, Skv, Hh, D],
                      ROUTE_COUNTER["wide" if D > 128 else "sm90"],
                      lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
                      lambda q=q, k=k, v=v: _chunked_attention_ref(q, k, v),
                      attention_cost(B, S, Skv, Hh, D)))
    for B, S, Hh, D in sorted(shapes["flash_attention_hpacked"]):
        q, k, v = rnd(B, S, Hh * D), rnd(B, S, Hh * D), rnd(B, S, Hh * D)
        split = lambda t, Hh=Hh, D=D: t.unflatten(2, (Hh, D))
        cases.append(("flash_attention_hpacked", [B, S, Hh, D],
                      ROUTE_COUNTER["wide" if D > 128 else "sm90"],
                      lambda q=q, k=k, v=v, Hh=Hh: fa.flash_attention_hpacked(q, k, v, Hh),
                      lambda q=q, k=k, v=v, s=split: _chunked_attention_ref(
                          s(q), s(k), s(v)).flatten(2),
                      attention_cost(B, S, S, Hh, D)))
    for N, C, I in sorted(shapes["geglu_ff"]):
        args = (rnd(N, C), rnd(2 * I, C, scale=C ** -0.5), rnd(2 * I, scale=0.1),
                rnd(C, I, scale=I ** -0.5), rnd(C, scale=0.1))
        cases.append(("geglu_ff", [N, C, I], "geglu_sm90",
                      lambda a=args: geglu.geglu_ff(*a),
                      lambda a=args: geglu._geglu_xla(*(t.float() for t in a)),
                      geglu_cost(N, C, I) + (PEAK_FLOPS, 0)))
    rows = []
    for name, shape, counter, kernel, ref, (flops, nbytes, peak, exps) in cases:
        moved = kernels.LAUNCHES[counter] if counter else None
        out = kernel()
        again = kernel()
        if counter:
            moved = kernels.LAUNCHES[counter] - moved
        err, rel = rel_err(out, ref())
        bound, by, op = bound_ms(flops, nbytes, peak, exps)
        rows.append({"name": name, "shape": shape, "max_abs_err": err, "rel_err": rel,
                     "same_bits_twice": bool(torch.equal(out, again)),
                     "route_counter": counter, "route_launches": moved,
                     "ms": time_ms(kernel, reps=5), "bound_ms": bound, "bound_by": by,
                     "bound_op": op})
        del out, again
    for r in rows:
        what = f"{r['name']} {r['shape']} on the {path} path"
        require(r["rel_err"] <= KERNEL_TOL, f"{what}: max|Δ| = {r['rel_err']:.3g}·max|ref| "
                f"> {KERNEL_TOL}")
        require(r["same_bits_twice"], f"{what}: the same bits twice")
        require(r["route_counter"] is None or r["route_launches"] == 2,
                f"{what}: {r['route_counter']} moved {r['route_launches']} times in 2 calls")
    torch.cuda.empty_cache()
    return rows


def _edit_images(n: int, size: int, seed: int):
    """n uint8 [size, size, 3] pictures: a smooth seeded field (8² noise
    resized bicubic) plus noise."""
    import numpy as np

    from sd_tpu_torch.data.image_io import resize

    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    field = np.stack([resize(im, size, size) for im in low]).astype(np.int16)
    return np.clip(field + rng.integers(-12, 13, field.shape), 0, 255).astype(np.uint8)


def phase_image_edit(smi: str) -> dict:
    """Text2ImagePipeline's image-editing entry points at SD-v1 full width
    (bf16, every weight random from IMAGE_EDIT_SEED; 2 prompts), each run
    twice through its public method, the same bits required, the launches of
    the first run as IMAGE_EDIT_LAUNCHES:
      img2img         512², EDIT_STEPS steps at strength 0.75;
      inpaint         the SD-v1 model: img2img's DDIM blend at strength 1;
      inpaint_128     configs/inpaint_128_catdog.yaml without its first-stage
                      checkpoint (random weights): the mask-conditioned model,
                      the kept pixels bit for bit;
      generate_tiled  1024², decode_tile 512 (the decoder at batch 18); its
                      latent decoded whole as well, the two within SEAM_TOL;
      img2img_tiled   1024², encode_tile 512 (the encoder at batch 18);
      generate_hires  512² → 1024² (bicubic), HIRES_STEPS;
      generate        512², EDIT_GENERATE_STEPS: plain; with decode_tile 512
                      (no smaller than the image: the same bits); with
                      `tome_ratio=0` set (the same bits);
      generate_tome_freeu  with set_unet_options(**TOME_FREEU);
      generate_ti     after load_textual_inversion of an embedding the port's
                      writer wrote, a prompt naming it.
    The KL-f8 encoder (new on an inference path) in bf16 with its kernels
    against an fp32 copy of it (TF32 off, no kernel) at 512² within
    DECODER_TOL; every kernel shape the phase launched held against its
    plain version (`_hold_edit_kernels`). Prints each entry point's seconds
    and peak memory beside the card's name and power limit."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import inpaint_128_config, sd_v1_config
    from sd_tpu_torch.pipeline import Text2ImagePipeline, to_uint8
    from sd_tpu_torch.train.textual_inversion import save_embedding
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    prompts = ["a photograph of an astronaut riding a horse",
               "a watercolor painting of a lighthouse at dusk"]

    def build(cfg):
        pipe = Text2ImagePipeline(cfg)
        gen = torch.Generator("cuda").manual_seed(IMAGE_EDIT_SEED)
        for module in (pipe.unet, pipe.vae, pipe.clip):
            randomize_params_(module, gen)
        return pipe

    pipe, ipipe = build(sd_v1_config()), build(inpaint_128_config())
    n, m = EDIT_SIZE, INPAINT_SIZE
    init512, init1024 = _edit_images(2, n, 1), _edit_images(2, EDIT_BIG, 2)
    init128 = _edit_images(2, m, 3)
    keep512 = np.full((n, n), 255, np.uint8)          # a hole in the middle
    keep512[n // 4:3 * n // 4, 5 * n // 16:13 * n // 16] = 0
    keep128 = np.full((2, m, m), 255, np.uint8)       # a box; the lower half
    keep128[0, m // 4:3 * m // 4, 5 * m // 16:25 * m // 32] = 0
    keep128[1, m // 2:, :] = 0

    # every shape the kernels get on this phase's entry points
    shapes: dict = {}
    runs, checks = {}, {}

    def run(name, fn):
        return _run_twice(runs, name, fn, IMAGE_EDIT_LAUNCHES[name])

    decoded = []
    decode0 = pipe._decode

    def decode_spy(z, tile=None):
        decoded.append((z, tile))
        return decode0(z, tile)

    root = tempfile.mkdtemp(prefix="sd_tpu_torch_image_edit_")
    try:
        with _kernel_shape_spies(shapes):
            run("img2img", lambda: pipe.img2img(prompts, init512, strength=EDIT_STRENGTH,
                                                num_steps=EDIT_STEPS, seed=1))
            run("inpaint", lambda: pipe.inpaint(prompts, init512, keep512,
                                                num_steps=EDIT_STEPS, seed=2))
            out = run("inpaint_128", lambda: ipipe.inpaint(prompts, init128, keep128,
                                                           num_steps=EDIT_STEPS, seed=3))
            kept = np.broadcast_to((keep128 > 127)[..., None], out.shape)
            require(np.array_equal(out[kept], init128[kept]),
                    "inpaint_128 keeps the kept pixels bit for bit")
            checks["inpaint_128_kept_pixels"] = int(kept.sum())
            with mock.patch.object(pipe, "_decode", decode_spy):
                tiled = run("generate_tiled", lambda: pipe.generate(
                    prompts, num_steps=EDIT_BIG_STEPS, height=EDIT_BIG, width=EDIT_BIG,
                    decode_tile=EDIT_TILE, seed=4))
            z, tile = decoded[0]
            require(tile == EDIT_TILE // pipe._vae_factor(),
                    f"generate's decode tile {tile} latent units")
            with torch.no_grad():
                require(np.array_equal(to_uint8(pipe._decode(z, tile)), tiled),
                        "generate_tiled is the tiled decode of its latent")
                whole = to_uint8(pipe._decode(z))
            diff = np.abs(whole.astype(np.int16) - tiled.astype(np.int16))
            checks["seam"] = {"mean_levels": float(diff.mean()),
                              "far_share": float((diff > 32).mean()),
                              "max_levels": int(diff.max()),
                              "whole_std_levels": float(whole.std())}
            require(checks["seam"]["mean_levels"] <= SEAM_TOL["mean_levels"]
                    and checks["seam"]["far_share"] <= SEAM_TOL["far_share"],
                    f"the tiled decode against the whole one {checks['seam']} within {SEAM_TOL}")
            del z, whole, decoded[:]
            run("img2img_tiled", lambda: pipe.img2img(prompts, init1024, strength=EDIT_STRENGTH,
                                                      num_steps=EDIT_BIG_STEPS,
                                                      encode_tile=EDIT_TILE, seed=5))
            run("generate_hires", lambda: pipe.generate_hires(
                prompts, num_steps=HIRES_STEPS[0], hires_steps=HIRES_STEPS[1],
                denoising_strength=HIRES_STRENGTH, seed=6))
            gen_kw = dict(num_steps=EDIT_GENERATE_STEPS, seed=7)
            plain = run("generate", lambda: pipe.generate(prompts, **gen_kw))
            require(np.array_equal(pipe.generate(prompts, decode_tile=EDIT_TILE, **gen_kw),
                                   plain), "decode_tile no smaller than the image: the same "
                    "bits as the whole decode")
            pipe.set_unet_options(tome_ratio=0.0)
            require(np.array_equal(pipe.generate(prompts, **gen_kw), plain),
                    "tome_ratio = 0: the same bits as plain generate")
            pipe.set_unet_options(**TOME_FREEU)
            opts = run("generate_tome_freeu", lambda: pipe.generate(prompts, **gen_kw))
            pipe.set_unet_options(tome_ratio=0.0, freeu=None)
            checks["tome_freeu_levels_moved"] = float(np.abs(
                opts.astype(np.int16) - plain.astype(np.int16)).mean())
            require(checks["tome_freeu_levels_moved"] > 0, "ToMe + FreeU change the images")
            path = os.path.join(root, "embedding.safetensors")
            vec = torch.randn((2, pipe.clip_cfg.hidden_size), generator=torch.Generator()
                              .manual_seed(IMAGE_EDIT_SEED)) * pipe.clip_cfg.hidden_size ** -0.5
            save_embedding(path, TI_TOKEN, vec.numpy())
            require(pipe.load_textual_inversion(path) == [TI_TOKEN], "the embedding loads")
            run("generate_ti", lambda: pipe.generate(
                [f"a photo of {TI_TOKEN} on a table", prompts[1]], **gen_kw))

        # the encoder, new on an inference path: bf16 with its kernels against
        # an fp32 copy of the same (bf16-rounded) weights, no kernel
        x = torch.from_numpy(init512).cuda().float() / 127.5 - 1.0
        ref_vae = copy.deepcopy(pipe.vae).float()
        with torch.no_grad():
            kernels.reset_launches()
            got = pipe.vae.quant_conv(pipe.vae.encoder(x.bfloat16()))
            enc_launches = dict(kernels.LAUNCHES)
            ref = ref_vae.quant_conv(ref_vae.encoder(x.bfloat16().float()))
        del ref_vae
        _, max_rel = rel_err(got, ref)
        checks["encoder_parity"] = {"max_rel": max_rel, "l2_rel": l2_rel(got, ref),
                                    "launches": {k: v for k, v in enc_launches.items() if v}}
        require(enc_launches == ENCODER_512_LAUNCHES,
                f"encoder launches {checks['encoder_parity']['launches']}")
        require(max_rel <= DECODER_TOL["max_rel"]
                and checks["encoder_parity"]["l2_rel"] <= DECODER_TOL["l2_rel"],
                f"the bf16 encoder against fp32: {checks['encoder_parity']} within {DECODER_TOL}")
        del pipe, ipipe, got, ref
        torch.cuda.empty_cache()
        held = _hold_edit_kernels(shapes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "image_edit", "nvidia_smi": smi, "entry_points": runs, "checks": checks,
          "kernel_shapes_held": held, "phase_seconds": time.perf_counter() - t_phase})
    return {name: r_["launches"] for name, r_ in runs.items()}


def _bf16_ulp(x):
    """The bf16 spacing at |x| (float64 in, float64 out; the smallest normal
    spacing below 2^-126)."""
    import torch

    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def phase_adapters(smi: str) -> dict:
    """The loaded and steered served model at SD-v1 full width (bf16, every
    weight random from ADAPTERS_SEED), 2 prompts at 512², ADAPTER_STEPS DDIM
    steps, CFG 7.5; the entry points run twice (the same bits, launches as
    ADAPTER_LAUNCHES, the second run timed, peak memory):
      checkpoints  to_sd_checkpoint in fp32 as .safetensors and .ckpt (≈ 3.8
                   GB each), from_sd_checkpoint of each: generate gives the
                   source pipeline's bits (bf16 → fp32 → bf16 is exact; the
                   text encoder, not in the file, copied across); save and load
                   s and GB/s; merge_checkpoints at α = 0 returns A's tensors,
                   and the two files hold the same tensors;
      LoRA         rank-LORA_RANK factors on lora_targets (b ~ N(0, LORA_B_STD²))
                   through a .safetensors file: at scale 0 plain generate's
                   bits; at scale 1 every merged weight within 1 bf16 ulp (of
                   the larger of the result and the delta) of a float64 host
                   merge of the bf16 factors, and the images change
                   (`generate_lora`); then the base weights put back;
      ControlNet   init_controlnet_from_unet (zero projections): plain
                   generate's bits; the zero projections randomised:
                   `generate_controlnet` on an edge hint;
      SAG          `generate_sag` at SAG_SCALE: the probe captured at
                   mid_attn once per step, no flash launch below 512 tokens;
      IP-Adapter   a random adapter (init_ip_adapter) and image embedder
                   written as a run directory: at ip_scale 0 within 1 uint8
                   level of plain generate; at 1 `generate_ip`.
    Every kernel shape the phase launched held against its plain version
    (`_hold_edit_kernels`). Prints each entry point's seconds and peak memory
    beside the card's name and power limit."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.data.hints import edge_hint
    from sd_tpu_torch.models.conditioners import FrozenClipImageEmbedder
    from sd_tpu_torch.models.controlnet import (controlnet_from_unet_config,
                                                init_controlnet_from_unet)
    from sd_tpu_torch.models.ip_adapter import init_ip_adapter
    from sd_tpu_torch.models.sd_import import load_sd_checkpoint
    from sd_tpu_torch.nn import attn_probe
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.train.checkpoint import save_checkpoint
    from sd_tpu_torch.train.lora import (_key, dense_kernels, init_lora, lora_targets,
                                         save_lora_safetensors)
    from sd_tpu_torch.utils.merge import merge_checkpoints
    from sd_tpu_torch.weights import init_params_, randomize_params_

    t_phase = time.perf_counter()
    prompts = ["a photograph of an astronaut riding a horse",
               "a watercolor painting of a lighthouse at dusk"]
    gen = torch.Generator("cuda").manual_seed(ADAPTERS_SEED)
    pipe = Text2ImagePipeline(sd_v1_config())
    for module in (pipe.unet, pipe.vae, pipe.clip):
        randomize_params_(module, gen)
    kw = dict(num_steps=ADAPTER_STEPS, seed=1)
    shapes, runs, checks, io = {}, {}, {}, {}
    levels = lambda a, b: int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())

    def run(name, fn):
        return _run_twice(runs, name, fn, ADAPTER_LAUNCHES[name])

    root = tempfile.mkdtemp(prefix="sd_tpu_torch_adapters_")
    try:
        with _kernel_shape_spies(shapes):
            plain = run("generate", lambda: pipe.generate(prompts, **kw))

            paths = {ext: os.path.join(root, f"sd_v1.{ext}") for ext in ("safetensors", "ckpt")}
            for ext, path in paths.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.to_sd_checkpoint(path)
                save_s = time.perf_counter() - t0
                gb = os.path.getsize(path) / 1e9
                t0 = time.perf_counter()
                loaded = Text2ImagePipeline.from_sd_checkpoint(sd_v1_config(), path)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                loaded.clip.load_state_dict(pipe.clip.state_dict())
                same = np.array_equal(loaded.generate(prompts, **kw), plain)
                io[ext] = {"gb": gb, "save_s": save_s, "save_gb_per_s": gb / save_s,
                           "load_s": load_s, "load_gb_per_s": gb / load_s,
                           "same_bits_as_source": same}
                require(same, f"from_sd_checkpoint of the {ext} export: the source's bits")
                del loaded
                torch.cuda.empty_cache()
            a, b = load_sd_checkpoint(paths["safetensors"]), load_sd_checkpoint(paths["ckpt"])
            t0 = time.perf_counter()
            merged, skipped = merge_checkpoints(a, b, alpha=0.0)
            io["merge"] = {"seconds": time.perf_counter() - t0, "tensors": len(merged),
                           "skipped": len(skipped),
                           "alpha_0_is_a": all(torch.equal(merged[k], a[k]) for k in a),
                           "files_agree": sorted(a) == sorted(b)
                           and all(torch.equal(a[k], b[k]) for k in a)}
            require(io["merge"]["alpha_0_is_a"] and not skipped, "merge at α = 0 returns A")
            require(io["merge"]["files_agree"], "the .safetensors and .ckpt exports agree")
            del a, b, merged

            targets = lora_targets(pipe.unet)
            lora = init_lora(pipe.unet, LORA_RANK, gen)
            for pair in lora.values():
                pair["b"].normal_(0.0, LORA_B_STD, generator=gen)
            lora_path = os.path.join(root, "lora.safetensors")
            save_lora_safetensors(lora_path, lora)
            weights = dense_kernels(pipe.unet)
            before = {t: weights[t][1].detach().clone() for t in targets}
            pipe.load_lora(lora_path, scale=0.0)
            require(np.array_equal(pipe.generate(prompts, **kw), plain),
                    "LoRA at scale 0: plain generate's bits")
            pipe.load_lora(lora_path, scale=1.0)
            worst = 0.0
            for t in targets:
                pair = lora[_key(t)]
                delta = (pair["a"].bfloat16().double() @ pair["b"].bfloat16().double()).T.cpu()
                ref = before[t].double().cpu() + delta
                err = (weights[t][1].double().cpu() - ref).abs() / _bf16_ulp(
                    torch.maximum(ref.abs(), delta.abs()))
                worst = max(worst, float(err.max()))
            checks["lora"] = {"targets": len(targets), "rank": LORA_RANK,
                              "worst_ulps_from_float64": worst}
            require(worst <= 1.0, f"LoRA merge within 1 bf16 ulp of float64: {worst}")
            lora_img = run("generate_lora", lambda: pipe.generate(prompts, **kw))
            checks["lora"]["levels_moved"] = float(np.abs(lora_img.astype(np.int16) - plain).mean())
            require(not np.array_equal(lora_img, plain), "LoRA at scale 1 changes the images")
            with torch.no_grad():
                for t in targets:
                    weights[t][1].copy_(before[t])
            del before

            cn = controlnet_from_unet_config(
                pipe.cfg["unet"]["params"], hint_downsamples=pipe._vae_factor().bit_length() - 1,
                dtype=torch.bfloat16)
            init_params_(cn, gen)
            pipe.load_controlnet(dict(init_controlnet_from_unet(cn, pipe.unet)
                                      .named_parameters()))
            del cn
            hint = edge_hint(_edit_images(1, EDIT_SIZE, 4)[0])
            require(np.array_equal(pipe.generate(prompts, control_image=hint, **kw), plain),
                    "a ControlNet with zero projections: plain generate's bits")
            for mod in pipe.controlnet.modules():
                if getattr(mod, "zero_init", False):
                    randomize_params_(mod, gen)
            ctl = run("generate_controlnet",
                      lambda: pipe.generate(prompts, control_image=hint, **kw))
            checks["controlnet_levels_moved"] = float(np.abs(ctl.astype(np.int16) - plain).mean())
            require(checks["controlnet_levels_moved"] > 0, "the ControlNet changes the images")
            pipe.controlnet = None
            torch.cuda.empty_cache()

            probes, record0 = [], attn_probe.record

            def record_spy(path, probs):
                probes.append((path, tuple(probs.shape)))
                record0(path, probs)

            with mock.patch.object(attn_probe, "record", record_spy):
                sag = run("generate_sag", lambda: pipe.generate(prompts, sag_scale=SAG_SCALE,
                                                                 **kw))
            checks["sag"] = {"probes": len(probes), "probed": sorted({p for p, _ in probes}),
                             "probe_shapes": sorted({s_ for _, s_ in probes}),
                             "levels_moved": float(np.abs(sag.astype(np.int16) - plain).mean())}
            require(checks["sag"]["probed"] == ["mid_attn/block_0/attn1"]
                    and len(probes) == 2 * ADAPTER_STEPS, f"SAG's probe {checks['sag']}")
            require(all(s_[1] >= 512 for s_ in shapes["flash_attention_hpacked"]),
                    "no flash launch below 512 tokens (the probed mid-block attention)")
            require(checks["sag"]["levels_moved"] > 0, "SAG changes the images")

            ip_run = os.path.join(root, "ip_adapter")
            embedder = FrozenClipImageEmbedder()
            randomize_params_(embedder, gen)
            save_checkpoint(os.path.join(ip_run, "ckpt"),
                            {"params": init_ip_adapter(pipe.unet, gen)}, 1)
            save_checkpoint(os.path.join(ip_run, "ip_embedder"),
                            dict(embedder.named_parameters()), 1)
            del embedder
            ip_image = _edit_images(1, 256, 5)[0]
            pipe.load_ip_adapter(ip_run, ip_scale=0.0)
            checks["ip_scale_0_levels"] = levels(pipe.generate(prompts, ip_image=ip_image, **kw),
                                                 plain)
            require(checks["ip_scale_0_levels"] <= 1,
                    f"ip_scale 0 within 1 level of plain: {checks['ip_scale_0_levels']}")
            pipe.load_ip_adapter(ip_run, ip_scale=1.0)
            ipo = run("generate_ip", lambda: pipe.generate(prompts, ip_image=ip_image, **kw))
            checks["ip_levels_moved"] = float(np.abs(ipo.astype(np.int16) - plain).mean())
            require(checks["ip_levels_moved"] > 0, "the image prompt changes the images")
        del pipe
        torch.cuda.empty_cache()
        held = _hold_edit_kernels(shapes, ADAPTERS_SEED, "adapters")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "adapters", "nvidia_smi": smi, "entry_points": runs, "checkpoints": io,
          "checks": checks, "kernel_shapes_held": held,
          "phase_seconds": time.perf_counter() - t_phase})
    return {name: r_["launches"] for name, r_ in runs.items()}


def _warm_decay_target(t0, p1):
    """The target network after its first update from t0 toward the new
    parameters p1: the warm-up decay at n = 1, min(0.95, 2 / 11), in fp32,
    the product rounded to the shadow's dtype (the TPU package's rule)."""
    import numpy as np

    one_minus = float(np.float32(1) - min(np.float32(0.95), np.float32(2) / np.float32(11)))
    return t0 - (one_minus * (t0 - p1.to(t0.dtype))).to(t0.dtype)


def phase_few_step(smi: str, ddim50_seconds: float | None = None) -> dict:
    """Few-step and flow models at SD-v1 full width (bf16, every weight
    random from FEW_STEP_SEED), in a temporary directory removed at the end:
      teacher  a teacher run directory: the smallest tree `load_teacher_params`
               reads (the EMA shadow of a random UNet, bf16 ≈ 1.7 GB) and
               calibration.json;
      distill  `python -m sd_tpu_torch.train`'s `main` on
               lcm512_distill_config() (configs/lcm_512_catdog.yaml: CFG 7.5
               baked in, batch 4 as 4 microbatches, bf16, remat "dots") for
               FEW_STEP_STEPS steps on TRAIN_RUN_IMAGES synthetic 512² PNGs,
               a checkpoint and a LCM_STEPS-step eval grid at the last: the
               student before step 1 equals the teacher bit for bit, the
               target after step 1 is the warm-up decay's update toward the
               new parameters (bit for bit on a subset), losses and
               grad_norm finite, launches FEW_STEPS × distill_step +
               distill_eval; s/step, peak memory, the checkpoint's GB/s;
      lora     the same with distill.lora_rank FEW_STEP_LORA_RANK: before
               step 1 the merged weights are the teacher's bit for bit;
               lora.safetensors merges through `load_lora` into a
               `from_run` of the teacher, which then samples with lcm;
      serve    `from_run` of the distill run: generate(sampler="lcm",
               LCM_STEPS steps, guidance 1) of 2 prompts at 512² twice (the
               same bits, 4 UNet calls' launches and the decoder's); a
               `BatchingServer` request with "sampler": "lcm" gives the
               image of the same generate; s/generate and img/s beside the
               e2e phase's 50-step DDIM + CFG (`ddim50_seconds`);
      flow     train_ldm(flow512_train_config()) for FEW_STEP_STEPS steps
               (losses finite, launches those of train_ldm's step); a
               pipeline of that config: generate with flow (FLOW_STEPS
               steps, CFG 7.5) and flow_midpoint (FLOW_STEPS // 2) twice each
               (the same bits, launches as derived); a served "sampler":
               "flow" request answered.
    Every inference kernel shape the phase launched is held against its
    plain version (`_hold_edit_kernels`)."""
    import base64
    import contextlib
    import copy
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import flow512_train_config, lcm512_distill_config
    from sd_tpu_torch.data.image_io import decode_png
    from sd_tpu_torch.models.unet_sd import UNetModel
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.serve import BatchingServer
    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.train import distill, runners
    from sd_tpu_torch.train.checkpoint import save_checkpoint
    from sd_tpu_torch.train.lora import (load_lora_safetensors, lora_targets, merged_kernels,
                                         nest_lora)
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    prompts = ["a photo of a cat", "a photo of a dog"]
    shapes, runs, checks, io = {}, {}, {}, {}
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_few_step_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        require(free_gb >= FEW_STEP_DISK_GB, f"free disk under {root}: {free_gb:.1f} GB, the "
                f"phase needs {FEW_STEP_DISK_GB} GB (the distill run's ≈ 10 GB state)")
        data = os.path.join(root, "data")
        os.makedirs(data)
        _write_train_run_images(data)

        # -- the teacher run -------------------------------------------------------
        cfg = lcm512_distill_config()
        tcfg = {k: v for k, v in copy.deepcopy(cfg).items() if k != "distill"}
        tcfg["task"] = "ldm"
        gen = torch.Generator("cuda").manual_seed(FEW_STEP_SEED)
        unet = UNetModel(**{k: v for k, v in cfg["unet"]["params"].items() if k != "dtype"},
                         dtype=torch.bfloat16, device="cuda")
        randomize_params_(unet, gen)
        teacher_run = os.path.join(root, "teacher")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(teacher_run, "ckpt"),
                               {"ema": {"shadow": dict(unet.named_parameters())}}, 1)
        gb = os.path.getsize(path) / 1e9
        io["teacher_save"] = {"gb": gb, "seconds": time.perf_counter() - t0}
        io["teacher_save"]["gb_per_s"] = gb / io["teacher_save"]["seconds"]
        with open(os.path.join(teacher_run, "calibration.json"), "w") as f:
            json.dump({"scale_factor": 0.18215}, f)
        with open(os.path.join(root, "teacher.json"), "w") as f:
            json.dump(tcfg, f)
        teacher = {n: p.detach().cpu() for n, p in unet.named_parameters()}
        del unet
        torch.cuda.empty_cache()

        # -- the distillation runs, spied ------------------------------------------
        built, step_s, saves = [], [], []
        build0, make0, save0 = distill.build_ldm, distill.make_consistency_train_step, \
            runners.save_checkpoint

        def build_ldm(*a, **kw):
            built.append(build0(*a, **kw))
            return built[-1]

        save = _timed_save(save0, saves)

        def make_step(loss_fn, opt, prep_fn=None, grad_accum=1):
            step = make0(loss_fn, opt, prep_fn=prep_fn, grad_accum=grad_accum)

            def spied(state, batch, generator=None):
                first = state.step == 0
                if first:
                    unet = built[-1][1]
                    own = dict(unet.named_parameters())
                    checks.setdefault("teacher_bits", []).append(
                        all(torch.equal(p.detach().cpu(), teacher[n]) for n, p in own.items()))
                    if set(state.params) == set(own):
                        subset = sorted(own)[::97]
                    else:
                        merged = merged_kernels(unet, nest_lora(state.params))
                        checks.setdefault("lora_merged_is_teacher", []).append(
                            bool(merged) and all(torch.equal(w.cpu(), teacher[n])
                                                 for n, w in merged.items()))
                        subset = sorted(state.params)
                    before = {n: state.ema.shadow[n].clone() for n in subset}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs = step(state, batch, generator)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if first:
                    checks.setdefault("target_is_warm_decay_update", []).append(all(
                        torch.equal(state.ema.shadow[n],
                                    _warm_decay_target(before[n], state.params[n].detach()))
                        for n in subset))
                    checks.setdefault("target_moved", []).append(any(
                        not torch.equal(state.ema.shadow[n], before[n]) for n in subset))
                return logs

            return spied

        def run(name, run_cfg, expected):
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(run_cfg, f)
            out = os.path.join(root, name)
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            del step_s[:], saves[:]
            t0 = time.perf_counter()
            code = train_cli.main(["--config", path, "--data", data, "--out", out])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            require(code == 0, f"python -m sd_tpu_torch.train {name}: exit {code}")
            launches = dict(kernels.LAUNCHES)
            with open(os.path.join(out, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            steps = [r for r in recs if "grad_norm" in r]
            require(len(steps) == FEW_STEP_STEPS and all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps),
                f"{name}: {FEW_STEP_STEPS} finite step records: {steps}")
            require(os.path.exists(os.path.join(out, "samples", f"step_{FEW_STEP_STEPS}.png")),
                    f"{name}: the eval grid at step {FEW_STEP_STEPS}")
            require(launches == expected, f"{name} launches "
                    f"{ {k: v for k, v in launches.items() if v} } == "
                    f"{ {k: v for k, v in expected.items() if v} }")
            runs[name] = {"seconds": seconds, "step_seconds": list(step_s),
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                          "losses": [r["loss"] for r in steps],
                          "grad_norms": [r["grad_norm"] for r in steps],
                          "checkpoint_saves": list(saves),
                          "launches": {k: v for k, v in launches.items() if v}}
            del built[:]
            torch.cuda.empty_cache()
            return out, launches

        few = FEW_STEP_LAUNCHES
        dcfg = copy.deepcopy(cfg)
        dcfg["distill"]["teacher_run"] = teacher_run
        dcfg["train"].update(total_steps=FEW_STEP_STEPS, checkpoint_every=FEW_STEP_STEPS,
                             eval_every=FEW_STEP_STEPS)
        require(dcfg["distill"]["sample_steps"] == LCM_STEPS, "the eval's LCM_STEPS")
        lcfg = copy.deepcopy(dcfg)
        lcfg["distill"]["lora_rank"] = FEW_STEP_LORA_RANK
        patches = contextlib.ExitStack()
        for obj, name, fn in ((distill, "build_ldm", build_ldm),
                              (distill, "make_consistency_train_step", make_step),
                              (runners, "save_checkpoint", save)):
            patches.enter_context(mock.patch.object(obj, name, fn))
        patches.enter_context(_kernel_shape_spies(shapes))
        with patches:
            want = {k: FEW_STEP_STEPS * v + few["distill_eval"][k]
                    for k, v in few["distill_step"].items()}
            distill_dir, distill_launches = run("distill", dcfg, want)
            want = {k: FEW_STEP_STEPS * v + few["distill_eval"][k]
                    for k, v in few["lora_step"].items()}
            lora_dir, lora_launches = run("lora", lcfg, want)
            require(checks["teacher_bits"] == [True, True],
                    f"the student (and the LoRA base) before step 1 is the teacher bit for bit: "
                    f"{checks['teacher_bits']}")
            require(checks["lora_merged_is_teacher"] == [True],
                    "the merged LCM-LoRA student before step 1 is the teacher bit for bit")
            require(checks["target_is_warm_decay_update"] == [True, True]
                    and checks["target_moved"] == [True, True],
                    f"the target after step 1: the warm-up decay's update {checks}")

            # -- LCM-LoRA into a from_run of the teacher ---------------------------
            lora_file = os.path.join(lora_dir, "lora.safetensors")
            factors = load_lora_safetensors(lora_file)
            tpipe = Text2ImagePipeline.from_run(os.path.join(root, "teacher.json"), teacher_run)
            require(len(factors) == len(lora_targets(tpipe.unet)) and all(
                p["a"].shape[1] == FEW_STEP_LORA_RANK for p in factors.values()),
                    "lora.safetensors holds a rank-4 pair for every target")
            before = {n: p.detach().clone() for n, p in tpipe.unet.named_parameters()}
            tpipe.load_lora(lora_file)
            checks["lora_weights_changed"] = sum(
                not torch.equal(p, before[n]) for n, p in tpipe.unet.named_parameters())
            checks["lora_b_max_abs"] = max(float(p["b"].abs().max()) for p in factors.values())
            del before
            img = tpipe.generate(prompts, num_steps=LCM_STEPS, sampler="lcm",
                                 guidance_scale=1.0, seed=3)
            require(img.shape == (2, 512, 512, 3) and img.std() > 0,
                    "the teacher with the LCM-LoRA samples with lcm")
            del tpipe
            torch.cuda.empty_cache()

            # -- the student, served ------------------------------------------------
            t0 = time.perf_counter()
            pipe = Text2ImagePipeline.from_run(os.path.join(root, "distill.json"), distill_dir)
            torch.cuda.synchronize()
            io["from_run_seconds"] = time.perf_counter() - t0
            lcm_kw = dict(num_steps=LCM_STEPS, sampler="lcm", guidance_scale=1.0, seed=1)
            _run_twice(runs, "generate_lcm", lambda: pipe.generate(prompts, **lcm_kw),
                       few["generate_lcm"])
            batcher = BatchingServer(pipe, max_batch=2, batch_window_ms=10.0)
            batcher.start()
            try:
                served = batcher.submit({"prompt": prompts[0], "steps": LCM_STEPS,
                                         "sampler": "lcm", "guidance_scale": 1.0, "seed": 1})
            finally:
                batcher.stop()
            alone = pipe.generate(prompts[:1], negative_prompt=[""], **lcm_kw)
            require(np.array_equal(decode_png(base64.b64decode(served["image"])), alone[0]),
                    "the served lcm request gives generate's image")
            del pipe
            torch.cuda.empty_cache()
        gen_s = runs["generate_lcm"]["seconds"][1]
        checks["lcm_seconds_per_generate"] = gen_s
        checks["lcm_images_per_second"] = len(prompts) / gen_s
        checks["ddim50_cfg_seconds_per_generate"] = ddim50_seconds

        # -- the flow objective at SD-v1 width ------------------------------------
        fcfg = flow512_train_config()
        rng = np.random.default_rng(FEW_STEP_SEED)
        batches = [{"image": rng.uniform(-1, 1, (4, 512, 512, 3)).astype(np.float32),
                    "txt_raw": ["a photo of a cat", "a photo of a dog"] * 2}
                   for _ in range(FEW_STEP_STEPS)]
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = runners.train_ldm(fcfg, batches, max_steps=FEW_STEP_STEPS)
        torch.cuda.synchronize()
        flow_launches = dict(kernels.LAUNCHES)
        runs["flow_train"] = {"seconds": time.perf_counter() - t0,
                              "step_seconds": [h["seconds"] for h in hist],
                              "losses": [h["loss"] for h in hist],
                              "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                              "launches": {k: v for k, v in flow_launches.items() if v}}
        del state
        torch.cuda.empty_cache()
        require(len(hist) == FEW_STEP_STEPS and all(math.isfinite(h["loss"]) for h in hist),
                f"flow training: {FEW_STEP_STEPS} finite losses {hist}")
        want = {k: FEW_STEP_STEPS * v for k, v in few["flow_step"].items()}
        require(flow_launches == want, f"flow training launches "
                f"{runs['flow_train']['launches']} == { {k: v for k, v in want.items() if v} }")
        with _kernel_shape_spies(shapes):
            fpipe = Text2ImagePipeline(fcfg)
            for module in (fpipe.unet, fpipe.vae, fpipe.clip):
                randomize_params_(module, gen)
            _run_twice(runs, "generate_flow", lambda: fpipe.generate(
                prompts, num_steps=FLOW_STEPS, sampler="flow", guidance_scale=7.5, seed=2),
                few["generate_flow"])
            _run_twice(runs, "generate_flow_midpoint", lambda: fpipe.generate(
                prompts, num_steps=FLOW_STEPS // 2, sampler="flow_midpoint",
                guidance_scale=7.5, seed=2), few["generate_flow_midpoint"])
            batcher = BatchingServer(fpipe, max_batch=2, batch_window_ms=10.0)
            batcher.start()
            try:
                served = batcher.submit({"prompt": prompts[1], "steps": FLOW_STEPS,
                                         "sampler": "flow", "seed": 4})
            finally:
                batcher.stop()
            flow_img = decode_png(base64.b64decode(served["image"]))
            require(flow_img.shape == (512, 512, 3) and flow_img.std() > 0,
                    "the served flow request is answered")
            del fpipe
            torch.cuda.empty_cache()
        held = _hold_edit_kernels(shapes, FEW_STEP_SEED, "few_step")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "few_step", "nvidia_smi": smi, "free_disk_gb": free_gb, "runs": runs,
          "io": io, "checks": checks, "kernel_shapes_held": held,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"distill_run": distill_launches, "lora_run": lora_launches,
            "flow_train": flow_launches,
            **{name: r_["launches"] for name, r_ in runs.items() if name.startswith("generate")}}


def _fine_tune_configs(base_run: str) -> dict:
    """The fine_tune phase's run configs (`base_run` is the DreamBooth run
    directory, the base of the ControlNet and IP-Adapter runs): every
    one `sd512_train_config()`'s model at FINE_TUNE_STEPS steps, a constant
    FINE_TUNE_LR, one checkpoint at the end and no eval grid; the branches
    at the recipe's batch 4 in 4 microbatches (bf16) and the fixed scale
    0.18215 of the DreamBooth base; the fp32 tasks at batch 1."""
    import copy

    from sd_tpu_torch.core.config import sd512_inpaint_train_config, sd512_train_config

    def base(task="ldm", fixed_scale=True, batch=None, **blocks):
        cfg = copy.deepcopy(sd512_train_config())
        cfg.update(task=task, seed=FINE_TUNE_SEED, **blocks)
        cfg["train"].update(total_steps=FINE_TUNE_STEPS, checkpoint_every=FINE_TUNE_STEPS,
                            eval_every=10**6, lr=FINE_TUNE_LR, lr_schedule=None)
        if batch:
            cfg["train"].update(batch_size=batch, grad_accum=1)
        if fixed_scale:
            cfg["latent"]["scale_factor"] = 0.18215
        return cfg

    cond = base()
    cond["cond_stage"]["trainable"] = True
    cond["train"].update(weight_decay=1e-2, noise_offset=0.1, learn_logvar=True)
    inpaint = base(task="ldm_inpaint", fixed_scale=False, batch=1)
    for block in ("unet", "latent", "data"):
        inpaint[block] = sd512_inpaint_train_config()[block]
    return {
        "dreambooth": base(task="dreambooth", batch=1, dreambooth={
            "instance_prompt": "a photo of sks cat", "class_prompt": "a photo of a cat",
            "prior_weight": 1.0, "num_class_images": FINE_TUNE_CLASS_IMAGES,
            "class_num_steps": FINE_TUNE_CLASS_STEPS}),
        "lora": base(lora={"rank": 4}),
        "controlnet": base(controlnet={"hint": "canny", "base_run": base_run}),
        "ip_adapter": base(ip_adapter={"n_tokens": 4, "base_run": base_run}),
        "cond": cond,
        "textual_inversion": base(task="textual_inversion", batch=1, textual_inversion={
            "placeholder": "<thing>", "num_vectors": 2, "initializer": "object"}),
        "inpaint": inpaint,
    }


def phase_fine_tune(smi: str) -> dict:
    """Fine-tuning at SD-v1 full width (every weight from the trainers' own
    seeded init, the UNet's then randomized from FINE_TUNE_SEED; 512²
    synthetic PNGs), each run `python -m
    sd_tpu_torch.train`'s `main` on a `_fine_tune_configs` config, in a
    temporary directory removed at the end:
      dreambooth  fp32, 1 instance + 1 prior image a step, FINE_TUNE_CLASS_IMAGES
                  class images at FINE_TUNE_CLASS_STEPS DDIM steps first; the
                  base run of the next two;
      lora        rank 4 over the frozen UNet, lora.safetensors at the end;
      controlnet  canny hints over the DreamBooth run's EMA UNet: before step
                  1 the controlled UNet's output is the base's bit for bit,
                  after the run the base weights are unchanged bit for bit;
      ip_adapter  4 image tokens over the same base, the embedder beside;
      cond        the text encoder trained with the UNet, AdamW (1e-2), noise
                  offset 0.1, learned logvar: the logvar entries at the drawn
                  t moved and the rest stayed 0, the text tower moved, and
                  `from_run` refuses the run;
      textual_inversion  "<thing>" × 2 vectors from "object", fp32: the UNet
                  and the text tower unchanged bit for bit;
      inpaint     `sd512_inpaint_train_config()`, fp32, batch 1.
    Each: losses and grad_norm finite, launches FINE_TUNE_STEPS × its step's
    (FINE_TUNE_LAUNCHES), s/step, peak memory, the checkpoint's GB/s. Then
    each output served twice (the same bits, launches as derived): `from_run`
    of the DreamBooth run + generate, its `load_controlnet` + generate with
    an edge hint, its `load_ip_adapter` + generate with an image prompt; a
    fresh pipeline's `load_textual_inversion` + generate with the
    placeholder, and `load_lora` + generate; `from_run` of the inpainting run
    + its mask-conditioned inpaint. Every inference kernel shape the phase
    launched is held against its plain version (`_hold_edit_kernels`); the
    training kernels' shapes are the train phase's (held there)."""
    import contextlib
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.data.hints import edge_hint
    from sd_tpu_torch.diffusion.latent import LatentDiffusion
    from sd_tpu_torch.kernels import flash_attention as fa
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.train import dreambooth, runners
    from sd_tpu_torch.train.checkpoint import restore_tree
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    prompts = ["a photo of a cat", "a photo of a dog"]
    shapes, runs, checks, io = {}, {}, {}, {}
    train_shapes: set = set()
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_fine_tune_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        require(free_gb >= FINE_TUNE_DISK_GB, f"free disk under {root}: {free_gb:.1f} GB, the "
                f"phase needs {FINE_TUNE_DISK_GB} GB (two fp32 runs of ≈ 13.8 GB)")
        data = os.path.join(root, "data")
        os.makedirs(data)
        _write_train_run_images(data)
        cfgs = _fine_tune_configs(os.path.join(root, "dreambooth"))

        # -- spies: step times, checkpoint writes, the built stack, the branch --
        step_s, saves, built, hooks, drawn_t = [], [], [], {}, []
        loop0, save0, build0, branch0 = (runners._run_loop, runners.save_checkpoint,
                                         runners.build_ldm, runners.ldm_branch)
        lse0, p_losses0 = fa.flash_attention_lse, LatentDiffusion.p_losses

        run_loop = _timed_loop(loop0, step_s)
        save = _timed_save(save0, saves)

        def build(*a, **kw):
            # a random UNet (its zero-init output conv would stop every
            # gradient upstream of it at step 1): the trained tensors, the
            # text tower and textual inversion's vectors all get gradients
            built.append(build0(*a, **kw))
            unet = built[-1][1]
            randomize_params_(unet, torch.Generator(next(unet.parameters()).device)
                              .manual_seed(FINE_TUNE_SEED))
            if "built" in hooks:
                hooks["built"](*built[-1])
            return built[-1]

        def branch(*a, **kw):
            out = branch0(*a, **kw)
            if "branch" in hooks:
                hooks["branch"](out, a[2])
            return out

        def lse_spy(q, k, v, scale):
            train_shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
            return lse0(q, k, v, scale)

        def p_losses(self, z, cond, t, noise, learned_logvar=None):
            drawn_t.extend(t.tolist())
            return p_losses0(self, z, cond, t, noise, learned_logvar)

        def run(name, step_launches):
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfgs[name], f)
            out = os.path.join(root, name)
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            del step_s[:], saves[:], built[:]
            t0 = time.perf_counter()
            code = train_cli.main(["--config", path, "--data", data, "--out", out])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            require(code == 0, f"python -m sd_tpu_torch.train {name}: exit {code}")
            launches = dict(kernels.LAUNCHES)
            with open(os.path.join(out, "metrics.jsonl")) as f:
                steps = [r for r in map(json.loads, f) if "grad_norm" in r]
            require(len(steps) == FINE_TUNE_STEPS and all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps),
                f"{name}: {FINE_TUNE_STEPS} finite step records: {steps}")
            want = {k: FINE_TUNE_STEPS * v for k, v in step_launches.items()}
            require(launches == want, f"{name} launches "
                    f"{ {k: v for k, v in launches.items() if v} } == "
                    f"{ {k: v for k, v in want.items() if v} }")
            runs[name] = {"seconds": seconds, "step_seconds": list(step_s),
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                          "losses": [r["loss"] for r in steps],
                          "grad_norms": [r["grad_norm"] for r in steps],
                          "checkpoint_saves": list(saves),
                          "launches": {k: v for k, v in launches.items() if v}}
            print(f"[fine_tune] {name}: {seconds:.1f} s, steps {runs[name]['step_seconds']}, "
                  f"peak {runs[name]['peak_memory_gb']:.2f} GB, saves {saves}", flush=True)
            hooks.clear()
            del built[:]
            torch.cuda.empty_cache()
            return out

        ft = FINE_TUNE_LAUNCHES
        patches = contextlib.ExitStack()
        for obj, name, fn in ((runners, "_run_loop", run_loop), (dreambooth, "_run_loop", run_loop),
                              (runners, "save_checkpoint", save), (runners, "build_ldm", build),
                              (dreambooth, "build_ldm", build), (runners, "ldm_branch", branch),
                              (fa, "flash_attention_lse", lse_spy)):
            patches.enter_context(mock.patch.object(obj, name, fn))
        patches.enter_context(_kernel_shape_spies(shapes))
        with patches:
            dirs = {"dreambooth": run("dreambooth", ft["fp32_step"])}
            class_images = sorted(os.listdir(os.path.join(dirs["dreambooth"], "class_images")))
            checks["class_images"] = class_images
            require(len(class_images) == FINE_TUNE_CLASS_IMAGES, f"class images {class_images}")
            dirs["lora"] = run("lora", ft["lora_step"])

            base = []

            def controlnet_hook(br, unet):
                # before step 1: the zero projections give the base's output bit for
                # bit (this check's launches are not the run's)
                counted = dict(kernels.LAUNCHES)
                w = next(unet.parameters())
                c_cfg = cfgs["controlnet"]
                n, px = c_cfg["latent"]["image_size"], c_cfg["train"]["image_size"]
                g = torch.Generator(w.device).manual_seed(FINE_TUNE_SEED)
                rnd = lambda *s_: torch.randn(s_, generator=g, device=w.device).to(w.dtype)
                x = rnd(1, n, n, c_cfg["latent"]["channels"])
                ctx = rnd(1, 77, c_cfg["unet"]["params"]["context_dim"])
                hint = torch.rand((1, px, px, 3), generator=g, device=w.device)
                t = torch.tensor([500], device=w.device)
                with torch.no_grad():
                    checks["controlnet_step0_is_base"] = torch.equal(
                        br.ld.apply_model(x, t, {"c_crossattn": [ctx], "c_control": hint}),
                        unet(x, t, ctx))
                kernels.LAUNCHES.update(counted)
                base.append((unet, {n: p.detach().clone() for n, p in unet.named_parameters()}))

            hooks["branch"] = controlnet_hook
            dirs["controlnet"] = run("controlnet", ft["controlnet_step"])
            unet, before = base.pop()
            checks["controlnet_base_unchanged"] = all(
                torch.equal(p, before[n]) for n, p in unet.named_parameters())
            del unet, before
            require(checks["controlnet_step0_is_base"],
                    "the controlled UNet before step 1 is the base bit for bit")
            require(checks["controlnet_base_unchanged"], "the ControlNet run leaves the base "
                    "weights unchanged bit for bit")
            dirs["ip_adapter"] = run("ip_adapter", ft["ip_adapter_step"])
            require(os.path.isdir(os.path.join(dirs["ip_adapter"], "ip_embedder")),
                    "the IP-Adapter run writes its image embedder")

            tower = []
            hooks["branch"] = lambda br, unet: tower.append(
                (br.modules["cond"], {n: p.detach().clone()
                                      for n, p in br.modules["cond"].named_parameters()}))
            with mock.patch.object(LatentDiffusion, "p_losses", p_losses):
                dirs["cond"] = run("cond", ft["cond_step"])
            clip, before = tower.pop()
            logvar = restore_tree(os.path.join(dirs["cond"], "ckpt"))["logvar"]
            moved = sorted(int(i) for i in torch.nonzero(logvar).flatten())
            checks["cond"] = {"drawn_t": sorted(set(drawn_t)), "logvar_moved": moved,
                              "tower_tensors_moved": sum(not torch.equal(p, before[n])
                                                         for n, p in clip.named_parameters())}
            del clip, before
            require(moved and moved == sorted(set(drawn_t)),
                    f"the logvar moved at the drawn t and nowhere else {checks['cond']}")
            require(checks["cond"]["tower_tensors_moved"] > 0, "the text tower moved")
            try:
                Text2ImagePipeline.from_run(os.path.join(root, "cond.json"), dirs["cond"])
                refused = None
            except ValueError as e:
                refused = str(e)
            checks["cond"]["from_run_refused"] = refused
            require(refused is not None and "unet, cond" in refused,
                    f"from_run refuses the {{unet, cond}} run: {refused}")
            shutil.rmtree(dirs.pop("cond"))

            frozen = []
            hooks["built"] = lambda ld, unet, vae, embed: frozen.append(
                [(m, {n: p.detach().clone() for n, p in m.named_parameters()})
                 for m in (unet, embed.clip)])
            dirs["textual_inversion"] = run("textual_inversion", ft["fp32_step"])
            checks["ti_frozen_unchanged"] = all(torch.equal(p, snap[n]) for m, snap in frozen.pop()
                                                for n, p in m.named_parameters())
            require(checks["ti_frozen_unchanged"], "textual inversion leaves the UNet and the text "
                    "tower unchanged bit for bit")
            dirs["inpaint"] = run("inpaint", ft["fp32_step"])
            torch.cuda.empty_cache()

            # -- each output, served ------------------------------------------------------
            kw = dict(num_steps=FINE_TUNE_GENERATE_STEPS, guidance_scale=7.5, seed=1)
            t0 = time.perf_counter()
            pipe = Text2ImagePipeline.from_run(os.path.join(root, "dreambooth.json"),
                                               dirs["dreambooth"])
            torch.cuda.synchronize()
            io["from_run_dreambooth_seconds"] = time.perf_counter() - t0
            _run_twice(runs, "generate_dreambooth", lambda: pipe.generate(prompts, **kw),
                       ft["generate"])
            pipe.load_controlnet(dirs["controlnet"])
            hint = edge_hint(_edit_images(1, 512, FINE_TUNE_SEED)[0])
            _run_twice(runs, "generate_controlnet",
                       lambda: pipe.generate(prompts, control_image=hint, **kw),
                       ft["generate_controlnet"])
            pipe.controlnet = None
            pipe.load_ip_adapter(dirs["ip_adapter"])
            ip_image = _edit_images(1, 256, FINE_TUNE_SEED + 1)[0]
            _run_twice(runs, "generate_ip", lambda: pipe.generate(prompts, ip_image=ip_image, **kw),
                       ft["generate"])
            del pipe
            shutil.rmtree(dirs.pop("dreambooth"))
            torch.cuda.empty_cache()

            pipe = Text2ImagePipeline(cfgs["lora"])
            loaded = pipe.load_textual_inversion(
                os.path.join(dirs["textual_inversion"], "embedding.safetensors"))
            require(loaded == ["<thing>"], f"the embedding file holds the placeholder: {loaded}")
            _run_twice(runs, "generate_textual_inversion", lambda: pipe.generate(
                ["a photo of a <thing>", "a <thing> on a table"], **kw), ft["generate"])
            pipe.load_lora(os.path.join(dirs["lora"], "lora.safetensors"))
            _run_twice(runs, "generate_lora", lambda: pipe.generate(prompts, **kw),
                       ft["generate"])
            del pipe
            torch.cuda.empty_cache()

            pipe = Text2ImagePipeline.from_run(os.path.join(root, "inpaint.json"),
                                               dirs["inpaint"])
            init = _edit_images(2, 512, FINE_TUNE_SEED + 2)
            hgt, wid = init.shape[1:3]
            keep = np.ones((hgt, wid), np.float32)
            keep[hgt // 4:3 * hgt // 4, 5 * wid // 16:11 * wid // 16] = 0.0
            got = _run_twice(runs, "inpaint_conditioned",
                             lambda: pipe.inpaint(prompts, init, keep, **kw),
                             ft["inpaint_conditioned"])
            require(np.array_equal(got[:, keep == 1], init[:, keep == 1]),
                    "inpaint keeps the kept pixels bit for bit")
            del pipe
            torch.cuda.empty_cache()
        checks["training_kernel_shapes"] = sorted(train_shapes)
        require(train_shapes <= set(TRAIN_KERNEL_SHAPES), f"the training kernels' shapes "
                f"{sorted(train_shapes)} are the train phase's")
        held = _hold_edit_kernels(shapes, FINE_TUNE_SEED, "fine_tune")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "fine_tune", "nvidia_smi": smi, "free_disk_gb": free_gb, "runs": runs,
          "io": io, "checks": checks, "kernel_shapes_held": held,
          "phase_seconds": time.perf_counter() - t_phase})
    return {name: r_["launches"] for name, r_ in runs.items()}


def _timed_save(save0, saves: list):
    """`save_checkpoint` that appends each save's step, seconds, GB and GB/s
    to `saves`."""
    import torch

    def save(ckpt_dir, state, step, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save0(ckpt_dir, state, step, **kw)
        sec = time.perf_counter() - t0
        gb = os.path.getsize(out) / 1e9
        saves.append({"step": step, "seconds": sec, "gb": gb, "gb_per_s": gb / sec})
        return out

    return save


def _timed_loop(loop0, step_s: list):
    """`_run_loop` whose step function appends each step's seconds (to the
    card's synchronize) to `step_s`."""
    import torch

    def run_loop(step_fn, *a, **kw):
        def timed(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = step_fn(state, batch, generator)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return logs
        return loop0(timed, *a, **kw)

    return run_loop


def _sr_images(root: str, n: int = SR_IMAGES, size: int = 128) -> None:
    """n uint8 size² PNGs `im_<i>.png` (`_edit_images`' seeded fields)."""
    from sd_tpu_torch.data.image_io import write_png

    for i, im in enumerate(_edit_images(n, size, SR_SEED)):
        write_png(os.path.join(root, f"im_{i}.png"), im)


def _attention_routes(routes: dict):
    """Patches (an ExitStack to enter) that record into `routes`, keyed by
    the attention block (class and input shape) that made the call, the
    route each `dot_product_attention` call takes (the flash kernel or the
    plain path, by the port's shape rule) and how often; a LinearAttention
    block, which has no such call, counts under "einsum"."""
    import contextlib

    import torch

    from sd_tpu_torch.kernels import attention as attn_k
    from sd_tpu_torch.models.unet_sd import SelfAttentionBlock2D
    from sd_tpu_torch.nn.attention import AttnBlock, LinearAttention

    blocks = (SelfAttentionBlock2D, AttnBlock, LinearAttention)
    current: list = []
    dpa0 = attn_k.dot_product_attention

    def entry(key, **fields):
        row = routes.setdefault(key, {**fields, "calls": 0})
        row["calls"] += 1

    def pre(mod, args):
        if isinstance(mod, blocks):
            key = f"{type(mod).__name__} {list(args[0].shape)} {str(args[0].dtype)[6:]}"
            current.append(key)
            if isinstance(mod, LinearAttention):
                entry(key, route="einsum")

    def post(mod, args, out):
        if isinstance(mod, blocks):
            current.pop()

    def dpa(q, k, v, *, scale=None, impl=None):
        how = impl or os.environ.get("SD_TPU_ATTN_IMPL")
        flash = (q.dtype == torch.bfloat16 if how == "pallas"
                 else how is None and attn_k.flash_ok(q, k))
        entry(current[-1] if current else "outside a block", q=list(q.shape),
              kv=list(k.shape), route="flash" if flash else "plain")
        return dpa0(q, k, v, scale=scale, impl=impl)

    stack = contextlib.ExitStack()
    stack.callback(torch.nn.modules.module.register_module_forward_pre_hook(pre).remove)
    stack.callback(torch.nn.modules.module.register_module_forward_hook(post).remove)
    stack.enter_context(mock.patch.object(attn_k, "dot_product_attention", dpa))
    return stack


def _card_vs_cpu(name: str, module, fn, *inputs) -> dict:
    """`fn(module, *inputs)` with `module` (fp32) on the card against the
    same on a CPU copy of the module: max|Δ| and ‖Δ‖₂ relative to the CPU
    output, within CARD_CPU_TOL."""
    import copy

    import torch

    with torch.no_grad():
        out = fn(module, *(t.cuda() for t in inputs))
        torch.cuda.synchronize()
        cpu = copy.deepcopy(module).cpu()
        t0 = time.perf_counter()
        ref = fn(cpu, *(t.cpu() for t in inputs))
        cpu_s = time.perf_counter() - t0
    del cpu
    _, rel = rel_err(out.cpu(), ref)
    row = {"name": name, "shape": list(out.shape), "max_rel": rel,
           "l2_rel": l2_rel(out.cpu(), ref), "cpu_seconds": cpu_s}
    require(torch.isfinite(out).all().item() and rel <= CARD_CPU_TOL["max_rel"]
            and row["l2_rel"] <= CARD_CPU_TOL["l2_rel"],
            f"{name}: card fp32 against CPU fp32 {row} within {CARD_CPU_TOL}")
    return row


def _card_vs_float64(name: str, module, fn, *inputs) -> dict:
    """For a model that fp32 itself computes loosely (`UNetCompVis` with
    linear attention: its k softmax reads the unnormalised residual stream,
    and the CPU's fp32 output is ~1e-3·max|ref| from float64): `fn(module,
    *inputs)` in fp32 on the card and on a CPU copy, each against the CPU
    copy in float64; the card's max|Δ| and ‖Δ‖₂ at most
    F64_RATIO × the CPU's."""
    import copy

    import torch

    with torch.no_grad():
        out = fn(module, *(t.cuda() for t in inputs)).cpu().double()
        cpu = copy.deepcopy(module).cpu()
        t0 = time.perf_counter()
        ref32 = fn(cpu, *(t.cpu() for t in inputs)).double()
        cpu_s = time.perf_counter() - t0
        exact = fn(cpu.double(), *(t.cpu().double() if t.is_floating_point() else t.cpu()
                                   for t in inputs))
    del cpu
    errs = {who: (float((o - exact).abs().max() / exact.abs().max()),
                  float((o - exact).norm() / exact.norm())) for who, o in (("card", out),
                                                                          ("cpu", ref32))}
    row = {"name": name, "shape": list(out.shape), "card_max_rel_f64": errs["card"][0],
           "card_l2_rel_f64": errs["card"][1], "cpu_max_rel_f64": errs["cpu"][0],
           "cpu_l2_rel_f64": errs["cpu"][1], "max_rel": rel_err(out.float(), ref32.float())[1],
           "l2_rel": l2_rel(out.float(), ref32.float()), "cpu_seconds": cpu_s}
    require(torch.isfinite(out).all().item() and all(
        errs["card"][i] <= F64_RATIO * errs["cpu"][i] for i in (0, 1)),
        f"{name}: card fp32 as close to float64 as the CPU's fp32 (×{F64_RATIO}): {row}")
    return row

def phase_super_resolution(smi: str) -> dict:
    """Super-resolution (`task: ldm_sr`) at `configs/ldm_sr_catdog.yaml`'s
    full width through the port's command lines, in a temporary directory
    removed at the end: SR_IMAGES synthetic 128² PNGs; the KL-f4 first stage
    (`kl_128_catdog_config()`, fp32) trained SR_KL_STEPS steps by `python -m
    sd_tpu_torch.train`; `ldm_sr_catdog_config()` over its checkpoint (batch
    16, bsrgan_light on the host) for SR_STEPS[0] steps with an eval (20
    DDIM steps, PSNR / SSIM) and calibration.json, then resumed for a third;
    `python -m sd_tpu_torch.sample_sr` on the run (SR_SAMPLE_IMAGES images,
    SR_SAMPLE_STEPS steps). Checks: finite losses, the records, the eval
    grid, the resume, the LR batch the run trained on equal bit for bit to a
    fresh CPU run of the loader, the SR UNet (every weight random) on the
    card against its CPU copy in fp32 (CARD_CPU_TOL), and the launches:
    none (SR_RUN_LAUNCHES), every attention on the plain path, which the
    route of each self-attention and of the first stage's mid-block
    attention shows. Prints s/step, peak GB, checkpoint GB/s, the loader's
    host seconds per batch of 16 degradations and sample_sr's seconds."""
    import contextlib
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sd_tpu_torch import kernels, sample_sr
    from sd_tpu_torch.core.config import kl_128_catdog_config, ldm_sr_catdog_config
    from sd_tpu_torch.data.image_io import decode_png
    from sd_tpu_torch.models.unet_sd import UNetModel
    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.train import runners, sr
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_sr_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        require(free_gb >= SR_DISK_GB, f"free disk under {root}: {free_gb:.1f} GB, the phase "
                f"needs {SR_DISK_GB} GB")
        data = os.path.join(root, "data")
        os.makedirs(data)
        _sr_images(data)
        sr_cfg = ldm_sr_catdog_config()

        # -- the loader: 16 degradations a batch on the host, twice the same bits --
        loader_s = []
        first = []
        for _ in range(2):
            it = iter(runners._build_loader(data, sr_cfg, sr_cfg["train"]["batch_size"]))
            t0 = time.perf_counter()
            first.append(next(it))
            loader_s.append(time.perf_counter() - t0)
            it.close()
        require(first[0]["lr"].shape == (16, 32, 32, 3)
                and np.array_equal(first[0]["lr"], first[1]["lr"]),
                f"the loader's LR batch {first[0]['lr'].shape}, the same bits twice")

        step_s, saves, trained_lr = [], [], []
        run_loop = _timed_loop(runners._run_loop, step_s)
        save = _timed_save(runners.save_checkpoint, saves)
        batch0 = sr.sr_batch

        def sr_batch(batch, size, device):
            trained_lr.append(np.array(batch["lr"]))
            return batch0(batch, size, device)

        routes, runs = {}, {}

        def run(name, cfg, *extra):
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            out = os.path.join(root, name)
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            del step_s[:], saves[:]
            t0 = time.perf_counter()
            code = train_cli.main(["--config", path, "--data", data, "--out", out, *extra])
            torch.cuda.synchronize()
            require(code == 0, f"python -m sd_tpu_torch.train {name}: exit {code}")
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            with open(os.path.join(out, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            key = name if not extra else f"{name}_resumed"
            runs[key] = {"seconds": time.perf_counter() - t0, "step_seconds": list(step_s),
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                         "checkpoint_saves": list(saves), "launches": launches}
            require(launches == {k: v for k, v in SR_RUN_LAUNCHES.items() if v},
                    f"{key}: fp32 launches nothing, got {launches}")
            print(f"[super_resolution] {key}: {runs[key]['seconds']:.1f} s, steps "
                  f"{runs[key]['step_seconds']}, peak {runs[key]['peak_memory_gb']:.2f} GB, "
                  f"saves {saves}", flush=True)
            torch.cuda.empty_cache()
            return out, path, recs

        patches = contextlib.ExitStack()
        for obj, name, fn in ((runners, "_run_loop", run_loop),
                              (runners, "save_checkpoint", save), (sr, "sr_batch", sr_batch)):
            patches.enter_context(mock.patch.object(obj, name, fn))
        patches.enter_context(_attention_routes(routes))
        with patches:
            kl_cfg = kl_128_catdog_config()
            kl_cfg["seed"] = SR_SEED
            kl_cfg["train"].update(total_steps=SR_KL_STEPS, checkpoint_every=SR_KL_STEPS,
                                   eval_every=10**6)
            kl_dir, _, kl_recs = run("kl_f4", kl_cfg)
            require(len(kl_recs) == SR_KL_STEPS and all(
                math.isfinite(r["train/total_loss"]) for r in kl_recs), f"KL records {kl_recs}")

            sr_cfg["seed"] = SR_SEED
            sr_cfg["first_stage"]["ckpt"] = os.path.join(kl_dir, "ckpt")
            sr_cfg["train"].update(total_steps=SR_STEPS[0], checkpoint_every=SR_STEPS[0],
                                   eval_every=SR_STEPS[0])
            sr_dir, sr_json, recs = run("ldm_sr", sr_cfg)
            steps = [r for r in recs if "loss" in r]
            evals = [r for r in recs if "eval_psnr" in r]
            require([r["step"] for r in steps] == list(range(SR_STEPS[0])) and all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps),
                f"SR step records {steps}")
            require(len(evals) == 1 and math.isfinite(evals[0]["eval_psnr"])
                    and math.isfinite(evals[0]["eval_ssim"]), f"one eval record {evals}")
            with open(os.path.join(sr_dir, "samples", f"step_{SR_STEPS[0]}.png"), "rb") as f:
                grid = decode_png(f.read())
            with open(os.path.join(sr_dir, "calibration.json")) as f:
                scale = json.load(f)["scale_factor"]
            require(math.isfinite(scale) and scale > 0, f"calibration.json {scale}")
            require(np.array_equal(trained_lr[0], first[0]["lr"]),
                    "the LR batch the card run trained on is a CPU run's of the loader, "
                    "bit for bit")
            _, _, recs = run("ldm_sr", sr_cfg, "--max-steps", str(SR_STEPS[1]))
            require([r["step"] for r in recs if "loss" in r] == list(range(SR_STEPS[1])),
                    f"the resumed run's records {recs}")
            require(os.path.exists(os.path.join(sr_dir, "ckpt", f"step_{SR_STEPS[1]}.pt")),
                    "the resumed run's checkpoint")

            out = os.path.join(root, "sr.png")
            kernels.reset_launches()
            t0 = time.perf_counter()
            code = sample_sr.main(["--config", sr_json, "--ckpt", os.path.join(sr_dir, "ckpt"),
                                   "--input", data, "--n", str(SR_SAMPLE_IMAGES), "--steps",
                                   str(SR_SAMPLE_STEPS), "--out", out])
            torch.cuda.synchronize()
            sample_s = time.perf_counter() - t0
            require(code == 0, f"python -m sd_tpu_torch.sample_sr: exit {code}")
            with open(out, "rb") as f:
                sampled = decode_png(f.read())
            require(sampled.shape == (3 * 128 + 4, SR_SAMPLE_IMAGES * 128 + 6, 3)
                    and sampled.std() > 0, f"sample_sr's LR / SR / HR grid {sampled.shape}")
            sample_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            require(not sample_launches, f"sample_sr launches nothing: {sample_launches}")

        # -- the SR UNet on the card against its CPU copy, every weight random ---------
        unet = UNetModel(**sr_cfg["unet"]["params"])
        randomize_params_(unet, torch.Generator("cuda").manual_seed(SR_SEED))
        g = torch.Generator().manual_seed(SR_SEED)
        x = torch.randn((2, 32, 32, 6), generator=g)
        t = torch.tensor([17, 803])
        parity = _card_vs_cpu("sr_unet", unet, lambda m, x_, t_: m(x_, t_), x, t)
        del unet
        torch.cuda.empty_cache()
        row = {"phase": "super_resolution", "nvidia_smi": smi, "free_disk_gb": free_gb,
               "loader_seconds_per_batch_of_16": loader_s, "runs": runs,
               "eval": evals[0], "scale_factor": scale, "eval_grid": list(grid.shape),
               "sample_sr": {"seconds": sample_s, "images": SR_SAMPLE_IMAGES,
                             "steps": SR_SAMPLE_STEPS, "grid": list(sampled.shape)},
               "attention_routes": routes, "card_vs_cpu": parity,
               "phase_seconds": time.perf_counter() - t_phase}
        require(routes and all(r["route"] == "plain" for r in routes.values()),
                f"every SR attention on the plain path: {routes}")
        emit(row)
        return {name: r_["launches"] for name, r_ in runs.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_codec_attention(smi: str) -> dict:
    """The first stages with per-level attention at full width: `kl_f32`
    (attention at 16² and 8²) and `vq_gumbel_f8` (32²), each one fp32 GAN
    step at its own size (256², batch 4) through `python -m
    sd_tpu_torch.train` on synthetic PNGs (finite losses, no launch: every
    attention and conv plain), each one's encode → decode (every weight
    random, 256², batch 1) on the card against its CPU copy in fp32
    (CARD_CPU_TOL), and the same forward in bf16: vq_gumbel_f8's 32² level
    takes the wide flash kernel (CODEC_BF16_FLASH launches), kl_f32's levels
    stay plain; the kernel shapes it launched held against their plain
    versions. Prints each attention block's route, s/step, peak GB and the
    checkpoint GB/s beside the card's name and power limit."""
    import contextlib
    import math
    import shutil
    import tempfile

    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import kl_f32_config, vq_gumbel_f8_config
    from sd_tpu_torch.models.autoencoder import AutoencoderKL, VQModel
    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.train import runners
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_codec_")
    try:
        data = os.path.join(root, "data")
        os.makedirs(data)
        _sr_images(data, n=4, size=256)
        saves, step_s, routes, runs, parity, bf16 = [], [], {}, {}, [], {}
        save = _timed_save(runners.save_checkpoint, saves)
        run_loop = _timed_loop(runners._run_loop, step_s)

        shapes: dict = {}
        for name, fn, cls in (("kl_f32", kl_f32_config, AutoencoderKL),
                              ("vq_gumbel_f8", vq_gumbel_f8_config, VQModel)):
            cfg = fn()
            cfg["seed"] = SR_SEED
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            del saves[:], step_s[:]
            run_routes: dict = {}
            with mock.patch.object(runners, "save_checkpoint", save), \
                    mock.patch.object(runners, "_run_loop", run_loop), \
                    _attention_routes(run_routes):
                t0 = time.perf_counter()
                code = train_cli.main(["--config", path, "--data", data, "--out",
                                       os.path.join(root, name), "--max-steps", "1"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            require(code == 0, f"python -m sd_tpu_torch.train {name}: exit {code}")
            with open(os.path.join(root, name, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            require(len(recs) == 1 and all(math.isfinite(v) for k, v in recs[0].items()
                                           if k != "step"), f"{name}: one finite record {recs}")
            require(not launches, f"{name}: the fp32 step launches nothing, got {launches}")
            require(run_routes and all(r["route"] == "plain" for r in run_routes.values()),
                    f"{name}: every fp32 attention plain {run_routes}")
            runs[name] = {"seconds": seconds, "step_seconds": list(step_s), "peak_memory_gb":
                          torch.cuda.max_memory_allocated() / 2**30,
                          "checkpoint_saves": list(saves), "record": recs[0]}
            routes[name] = run_routes
            shutil.rmtree(os.path.join(root, name))
            torch.cuda.empty_cache()

            # -- forward: card against CPU (fp32), then bf16 with the kernels ------------
            model = cls(**cfg["model"]["params"]).eval()
            randomize_params_(model, torch.Generator("cuda").manual_seed(SR_SEED))
            x = torch.rand((1, 256, 256, 3), generator=torch.Generator().manual_seed(SR_SEED))
            x = x * 2 - 1
            # encode → decode (the VQ model's quantizer left out: its argmax flips at
            # near-ties from one device to the other)
            if cls is VQModel:
                fwd = lambda m, img: m.decode(m.encode_pre_quant(img))
            else:
                fwd = lambda m, img: m.decode(m.encode(img).mode())
            parity.append(_card_vs_cpu(name, model, fwd, x))
            model = model.to(torch.bfloat16)
            bf16_routes: dict = {}
            kernels.reset_launches()
            with torch.no_grad(), _attention_routes(bf16_routes), _kernel_shape_spies(shapes):
                out = fwd(model, x.cuda().bfloat16())
                torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            require(torch.isfinite(out.float()).all().item(), f"{name}: finite bf16 output")
            require(launches.get("flash_attention", 0) == CODEC_BF16_FLASH[name]
                    == launches.get("flash_fwd_wide", 0),
                    f"{name}: {CODEC_BF16_FLASH[name]} wide flash launches in bf16, got "
                    f"{launches}")
            bf16[name] = {"launches": launches, "attention_routes": bf16_routes}
            del model, out
            torch.cuda.empty_cache()
        held = _hold_edit_kernels(shapes, SR_SEED, "codec_attention")
        emit({"phase": "codec_attention", "nvidia_smi": smi, "runs": runs,
              "attention_routes": routes, "card_vs_cpu": parity, "bf16_forward": bf16,
              "kernel_shapes_held": held, "phase_seconds": time.perf_counter() - t_phase})
        return {f"{name}_bf16_forward": r_["launches"] for name, r_ in bf16.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_model_families(smi: str) -> dict:
    """The CompVis / guided-diffusion model families at full width, every
    weight random (seeded): (a) LDM-KL-8-G (`ldm_kl8g_txt2img_config()`):
    the 32-layer BERT of FAMILY_PROMPTS tokenized by `BERTTokenizerHost`
    (the Hugging Face tokenizer where a local copy is installed, else its
    hash fallback; printed) → `LatentDiffusion(crossattn, cond_fn=BERT)` →
    FAMILY_STEPS DDIM steps at CFG FAMILY_CFG against BERT's embedding of ""
    → KL-f8 decode to [2, 256, 256, 3], in bf16, with each part's seconds
    and its launches (MODEL_FAMILY_LAUNCHES: flash and GEGLU on every UNet
    call), and in fp32 the full-width BERT and one full-width UNet call
    with the 1280-wide context on the card against their CPU copies
    (CARD_CPU_TOL); (b) the ADM ImageNet 256² UNet (`adm_imagenet256_config()`):
    one bf16 forward at batch ADM_BATCH with two class labels to [2, 256,
    256, 6] (its 32² self-attention on the flash kernel, each attention
    block's route printed), and in fp32 card against CPU at ADM_PARITY_SIZE²;
    (c) card against CPU in fp32 of `UNetCompVis` with vanilla attention and
    `AttentionPool2d`, and, with linear attention (loose in fp32 on any
    device), card and CPU fp32 against CPU float64 (`_card_vs_float64`). The kernel shapes the bf16 runs
    launched are held against their plain versions."""
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import adm_imagenet256_config, ldm_kl8g_txt2img_config
    from sd_tpu_torch.diffusion.latent import LatentDiffusion
    from sd_tpu_torch.models.autoencoder import AutoencoderKL
    from sd_tpu_torch.models.conditioners import BERTEmbedder, BERTTokenizerHost
    from sd_tpu_torch.models.unet_compvis import UNetCompVis
    from sd_tpu_torch.models.unet_sd import AttentionPool2d, UNetModel
    from sd_tpu_torch.train.runners import build_process
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    seeded = lambda k: torch.Generator("cuda").manual_seed(FAMILY_SEED + k)
    cpu_gen = torch.Generator().manual_seed(FAMILY_SEED)
    shapes: dict = {}
    parity, launches, seconds = [], {}, {}

    def count(name, fn):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = dict(kernels.LAUNCHES)
        want = {k: v for k, v in MODEL_FAMILY_LAUNCHES[name].items() if v}
        got = {k: v for k, v in launches[name].items() if v}
        require(got == want, f"model_families {name}: launches {got} == {want}")
        return out

    # -- (a) LDM-KL-8-G -------------------------------------------------------------------
    cfg = ldm_kl8g_txt2img_config()
    tok = BERTTokenizerHost(max_length=77)
    # the Hugging Face tokenizer where a local bert-base-uncased is installed,
    # else the md5 hash fallback: printed, either gives [2, 77] ids
    tokenizer = "hash fallback" if tok._tok is None else type(tok._tok).__name__
    ids = torch.from_numpy(tok.tokenize(FAMILY_PROMPTS)).long()
    empty = torch.from_numpy(tok.tokenize([""] * len(FAMILY_PROMPTS))).long()
    bert = BERTEmbedder(**cfg["cond_stage"]["params"]).eval()
    randomize_params_(bert, seeded(0))
    unet = UNetModel(**cfg["unet"]["params"]).eval()
    randomize_params_(unet, seeded(1))
    vae = AutoencoderKL(**cfg["first_stage"]["params"]).eval()
    randomize_params_(vae, seeded(2))
    parity.append(_card_vs_cpu("bert_1p4b", bert, lambda m, t_: m(t_), ids[:1]))
    ctx = torch.randn((1, 77, 1280), generator=cpu_gen)
    lat = torch.randn((1, 32, 32, 4), generator=cpu_gen)
    parity.append(_card_vs_cpu("ldm_kl8g_unet", unet, lambda m, x_, t_, c_: m(x_, t_, c_),
                               lat, torch.tensor([631]), ctx))
    for mod in (bert, unet, vae):
        mod.to(torch.bfloat16)
    ld = LatentDiffusion(
        process=build_process(cfg, "cuda"), unet_apply=unet,
        decode_fn=lambda z: vae.decode(z.to(torch.bfloat16)), cond_fn=bert,
        conditioning_key=cfg["latent"]["conditioning_key"],
        scale_factor=cfg["latent"]["scale_factor"])
    unet_calls = []
    hook = unet.register_forward_pre_hook(lambda m, a: unet_calls.append(a[0].shape[0]))
    with torch.no_grad(), _kernel_shape_spies(shapes):
        conds = count("bert", lambda: [ld.get_learned_conditioning(t_.cuda())
                                       for t_ in (ids, empty)])
        x_T = torch.randn((len(FAMILY_PROMPTS), 32, 32, 4), generator=seeded(3),
                          device="cuda")

        def generate():
            t0 = time.perf_counter()
            z = ld.sample(tuple(x_T.shape), x_T, {"c_crossattn": [conds[0]]},
                          {"c_crossattn": [conds[1]]}, guidance_scale=FAMILY_CFG,
                          num_steps=FAMILY_STEPS, decode=False)
            torch.cuda.synchronize()
            seconds["ldm_kl8g_sampling_loop"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = ld.decode_first_stage(z)
            torch.cuda.synchronize()
            seconds["ldm_kl8g_decode"] = time.perf_counter() - t0
            return out

        images = count("ldm_kl8g_generate", generate)
    hook.remove()
    require(images.shape == (2, 256, 256, 3) and torch.isfinite(images.float()).all().item()
            and images.float().std().item() > 0,
            f"LDM-KL-8-G images {list(images.shape)}, finite and not constant")
    require(unet_calls == [2 * len(FAMILY_PROMPTS)] * FAMILY_STEPS,
            f"{FAMILY_STEPS} CFG UNet calls at batch {2 * len(FAMILY_PROMPTS)}, got {unet_calls}")
    per_call = {k: launches["ldm_kl8g_generate"][k] / FAMILY_STEPS
                for k in ("flash_attention_hpacked", "geglu_ff")}
    require(all(v == 5 for v in per_call.values()),
            f"flash and GEGLU on every UNet call: {per_call} a call")
    del bert, unet, vae, ld, images, conds
    torch.cuda.empty_cache()

    # -- (b) the ADM ImageNet 256² UNet ----------------------------------------------------
    adm_cfg = adm_imagenet256_config()
    adm = UNetModel(**adm_cfg["unet"]["params"]).eval()
    randomize_params_(adm, seeded(4))
    labels = torch.tensor([207, 980])
    x = torch.randn((1, ADM_PARITY_SIZE, ADM_PARITY_SIZE, 3), generator=cpu_gen)
    parity.append(_card_vs_cpu(f"adm_unet_{ADM_PARITY_SIZE}", adm,
                               lambda m, x_, t_, y_: m(x_, t_, None, y_), x,
                               torch.tensor([499]), labels[:1]))
    adm.to(torch.bfloat16)
    size = adm_cfg["image_size"]
    x = torch.randn((ADM_BATCH, size, size, 3), generator=seeded(5), device="cuda")
    routes: dict = {}
    with torch.no_grad(), _kernel_shape_spies(shapes), _attention_routes(routes):
        out = count("adm_forward", lambda: adm(x.bfloat16(), torch.tensor([10, 900],
                                                                          device="cuda"),
                                               None, labels.cuda()))
    require(out.shape == (ADM_BATCH, size, size, 6) and torch.isfinite(out.float()).all().item(),
            f"ADM output {list(out.shape)}, finite")
    flash_blocks = [k for k, r in routes.items() if r["route"] == "flash"]
    require(len(flash_blocks) == 1 and "[2, 32, 32, 512]" in flash_blocks[0]
            and routes[flash_blocks[0]]["calls"] == 5,
            f"the ADM UNet's 32² self-attentions on the flash kernel: {routes}")
    del adm, out
    torch.cuda.empty_cache()

    # -- (c) small card-against-CPU checks -------------------------------------------------
    kernels.reset_launches()
    x = torch.randn((2, 32, 32, 3), generator=cpu_gen)
    t = torch.tensor([10, 900])
    for attn_type in ("vanilla", "linear"):
        cv = UNetCompVis(ch=64, out_ch=3, ch_mult=(1, 2, 2), num_res_blocks=1,
                         attn_resolutions=(16,), resolution=32, attn_type=attn_type).eval()
        randomize_params_(cv, seeded(6))
        check = _card_vs_cpu if attn_type == "vanilla" else _card_vs_float64
        parity.append(check(f"unet_compvis_{attn_type}", cv, lambda m, x_, t_: m(x_, t_), x, t))
    pool = AttentionPool2d(64, 256, 8, output_dim=128).eval()
    randomize_params_(pool, seeded(7))
    parity.append(_card_vs_cpu("attention_pool_2d", pool, lambda m, x_: m(x_),
                               torch.randn((2, 8, 8, 256), generator=cpu_gen)))
    fp32 = {k: v for k, v in kernels.LAUNCHES.items() if v}
    require(not fp32, f"the fp32 checks launch nothing: {fp32}")
    del cv, pool
    torch.cuda.empty_cache()

    held = _hold_edit_kernels(shapes, FAMILY_SEED, "model_families")
    emit({"phase": "model_families", "nvidia_smi": smi, "tokenizer": tokenizer,
          "prompt_ids": ids.tolist(), "seconds": seconds,
          "launches": {k: {n: c for n, c in v.items() if c} for k, v in launches.items()},
          "unet_calls": len(unet_calls), "adm_attention_routes": routes,
          "card_vs_cpu": parity, "kernel_shapes_held": held,
          "phase_seconds": time.perf_counter() - t_phase})
    return {k: v for k, v in launches.items() if k != "bert"}


def training_options_config() -> dict:
    """ddpm_256_train_config() with bf16 compute over fp32 parameters and
    dropout (the training_options phase's)."""
    from sd_tpu_torch.core.config import ddpm_256_train_config

    cfg = ddpm_256_train_config()
    cfg["model"]["params"].update(dtype="bfloat16", dropout=TRAINING_OPTIONS_DROPOUT)
    return cfg


def _keyed_masks(model_names: dict):
    """A dropout `mask_hook` giving each site (its module's name + the
    child's) the keep mask of a CPU generator seeded by the site's key, so
    that models on two devices draw the same masks."""
    import zlib

    import torch

    def hook(module, name, shape, keep):
        key = f"{model_names[id(module)]}/{name}"
        g = torch.Generator().manual_seed(zlib.crc32(key.encode()))
        return torch.rand(shape, generator=g) < keep

    return hook


def _hold_training_kernels(shape, seed: int) -> dict:
    """The flash training kernels (LSE forward, dQ, dK/dV) at one [B, Sq,
    Skv, H, D] of a path on random bf16 inputs (a generator of their own):
    the route counters moved, against their fp32 plain versions (o within
    KERNEL_TOL, lse2 LSE_TOL absolute, dq, dk, dv GRAD_TOL), the same bits
    twice."""
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.kernels import flash_attention as fa

    b, sq, skv, h, d = shape
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s_: torch.randn(s_, generator=g, device="cuda").bfloat16()
    q, k, v, do = rnd(b, sq, h, d), rnd(b, skv, h, d), rnd(b, skv, h, d), rnd(b, sq, h, d)
    scale = d**-0.5
    counters = (LSE_ROUTE_COUNTER[fa.lse_route(d)],
                *(BWD_ROUTE_COUNTER[p, fa.bwd_route(d)] for p in ("dq", "dkv")))
    before = {c: kernels.LAUNCHES[c] for c in counters}
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_lse(q, k, v, scale)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        runs.append((o, lse, dq, dk, dv))
    moved = {c: kernels.LAUNCHES[c] - n for c, n in before.items()}
    f32 = [t.float() for t in (q, k, v)]
    o_ref, lse_ref = fa._flash_lse_ref(*f32, scale)
    o, lse, dq, dk, dv = runs[0]
    dq_ref, dk_ref, dv_ref, _ = fa._flash_bwd_ref(*f32, o.float(), lse, do.float(), scale)
    row = {"shape": list(shape), "route_counters_moved": moved,
           "o_rel_err": rel_err(o, o_ref)[1], "lse_abs_err": (lse - lse_ref).abs().max().item(),
           **{f"{n}_rel_err": rel_err(x, r)[1] for n, x, r in
              (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))},
           **{f"{n}_l2_rel": l2_rel(x, r) for n, x, r in
              (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))},
           "same_bits_twice": all(torch.equal(a, b_) for a, b_ in zip(*runs))}
    require(moved == dict.fromkeys(counters, 2), f"training kernels {list(shape)}: the route "
            f"counters {counters} moved by 2 each: {moved}")
    require(row["o_rel_err"] <= KERNEL_TOL and row["lse_abs_err"] <= LSE_TOL,
            f"LSE forward {list(shape)}: o {row['o_rel_err']:.3g}, lse2 {row['lse_abs_err']:.3g}")
    for n in ("dq", "dk", "dv"):
        require(row[f"{n}_rel_err"] <= GRAD_TOL["max_rel"]
                and row[f"{n}_l2_rel"] <= GRAD_TOL["l2_rel"],
                f"{n} {list(shape)}: max {row[f'{n}_rel_err']:.3g}, l2 {row[f'{n}_l2_rel']:.3g}")
    require(row["same_bits_twice"], f"training kernels {list(shape)}: the same bits twice")
    return row


def phase_training_options(smi: str) -> dict:
    """fp32 master weights with bf16 compute, and dropout, in train_ddpm at
    full width (`training_options_config()`: 256², batch 6): (a) the run:
    one warm-up and TRAINING_OPTIONS_STEPS timed steps, s/step, peak memory,
    launches (TRAINING_OPTIONS_LAUNCHES) with the stored parameters, Adam
    moments and EMA fp32, finite losses, `conv_out` moved off zero; (b) one
    bf16-compute step against the fp32 step on the card from the same
    random weights, batch, t, noise and dropout masks (the same step
    generator): loss and gradient within MIXED_TOL; (c) the fp32 step with
    dropout on the card against the CPU at batch 1, every mask injected
    from a key of its site (DDPM_TOL); (d) the path's flash training
    kernels at DDPM_ATTN_SHAPE against their plain versions. Returns the
    run's launches."""
    import math

    import numpy as np
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.core.config import split_dtype
    from sd_tpu_torch.models.unet_ddpm import UNetDDPM
    from sd_tpu_torch.nn import layers
    from sd_tpu_torch.train import runners
    from sd_tpu_torch.train.diffusion import Adam
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    cfg = training_options_config()
    tc, steps = cfg["train"], 1 + TRAINING_OPTIONS_STEPS
    mp, compute = split_dtype(cfg["model"]["params"])
    # (a) the run
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, hist = runners.train_ddpm(cfg, _image_batches(
        tc, steps, np.random.default_rng(TRAINING_OPTIONS_SEED)), max_steps=steps)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    timed = [r["seconds"] for r in hist[1:]]
    dtypes = {kind: sorted({str(t.dtype) for t in ts}) for kind, ts in (
        ("params", state.params.values()), ("adam_mu", state.opt_state.mu),
        ("adam_nu", state.opt_state.nu), ("ema", state.ema.shadow.values()))}
    conv_out_moved = bool(state.params["conv_out.weight"].any())
    del state
    torch.cuda.empty_cache()

    # (b) the bf16-compute step against the fp32 step: the same random weights
    # (every one, the zero-initialised head too), batch, t, noise and masks
    px, bsz = tc["image_size"], tc["batch_size"]
    g = torch.Generator("cuda").manual_seed(TRAINING_OPTIONS_SEED)
    batch = {"image": torch.rand(bsz, px, px, 3, generator=g, device="cuda") * 2 - 1,
             "t": torch.randint(0, 1000, (bsz,), generator=g, device="cuda"),
             "noise": torch.randn(bsz, px, px, 3, generator=g, device="cuda")}
    weights = None

    def one_step(compute_dtype):
        nonlocal weights
        model = UNetDDPM(**mp, compute_dtype=compute_dtype, device="cuda")
        if weights is None:
            randomize_params_(model, torch.Generator("cuda").manual_seed(TRAINING_OPTIONS_SEED))
            weights = {n: p.detach().clone() for n, p in model.state_dict().items()}
        model.load_state_dict(weights)
        st, step = runners.make_ddpm_trainer(cfg, model)
        grads, real = [], Adam.update_

        def capture(self, params, gs, opt_state):
            grads.extend(t.detach().float().clone() for t in gs)
            return real(self, params, gs, opt_state)

        with mock.patch.object(Adam, "update_", capture):
            logs = step(st, batch, runners.step_generator("cuda", TRAINING_OPTIONS_SEED, 0))
        loss = float(logs["loss"])
        del model, st
        torch.cuda.empty_cache()
        return loss, grads

    loss16, g16 = one_step(compute)
    loss32, g32 = one_step(None)
    gnorm = lambda ts: math.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))
    mixed = {"loss_bf16": loss16, "loss_fp32": loss32,
             "loss_rel": abs(loss16 - loss32) / abs(loss32),
             "grad_l2_rel": gnorm(a - b for a, b in zip(g16, g32)) / gnorm(g32)}
    del g16, g32, weights

    # (c) the fp32 step with dropout, card against CPU at batch 1
    g = torch.Generator().manual_seed(TRAINING_OPTIONS_SEED + 1)
    cpu = UNetDDPM(**mp, device="cpu")
    randomize_params_(cpu, g)
    gpu = UNetDDPM(**mp, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    one = {"image": torch.rand(1, px, px, 3, generator=g) * 2 - 1, "t": torch.tensor([500]),
           "noise": torch.randn(1, px, px, 3, generator=g)}
    names = {id(m): n for model in (cpu, gpu) for n, m in model.named_modules()}

    def run(model, dev):
        st, step = runners.make_ddpm_trainer(cfg, model)
        logs = step(st, {k: v.to(dev) for k, v in one.items()}, torch.Generator(dev))
        return ({k: float(v) for k, v in logs.items()},
                {n: p.detach().cpu() for n, p in st.params.items()})

    with mock.patch.object(layers, "mask_hook", _keyed_masks(names)):
        kernels.reset_launches()
        logs_gpu, p_gpu = run(gpu, "cuda")
        torch.cuda.synchronize()
        fp32_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        t0 = time.perf_counter()
        logs_cpu, p_cpu = run(cpu, "cpu")
        cpu_s = time.perf_counter() - t0
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    norm = lambda ts: math.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))
    parity = {"loss_rel": rel(logs_gpu["loss"], logs_cpu["loss"]),
              "grad_norm_rel": rel(logs_gpu["grad_norm"], logs_cpu["grad_norm"]),
              "params_l2_rel": norm(p_gpu[n] - p_cpu[n] for n in p_cpu) / norm(p_cpu.values()),
              "update_l2_rel": (norm((p_gpu[n] - init[n]) - (p_cpu[n] - init[n]) for n in p_cpu)
                                / norm(p_cpu[n] - init[n] for n in p_cpu)),
              "logs_gpu": logs_gpu, "logs_cpu": logs_cpu, "cpu_seconds": cpu_s}
    del cpu, gpu
    torch.cuda.empty_cache()

    # (d) the path's training kernels at its shape
    held = _hold_training_kernels(DDPM_ATTN_SHAPE, TRAINING_OPTIONS_SEED)
    want = TRAINING_OPTIONS_LAUNCHES["ddpm_bf16_steps"]
    row = {"phase": "training_options", "nvidia_smi": smi, "steps": len(hist),
           "timed_step_seconds": timed, "seconds_per_step": sum(timed) / len(timed),
           "images_per_second": tc["batch_size"] * len(timed) / sum(timed),
           "peak_memory_gb": peak_gb, "losses": [r["loss"] for r in hist],
           "grad_norms": [r["grad_norm"] for r in hist], "dtypes": dtypes,
           "launches": {k: v for k, v in launches.items() if v},
           "expected_launches": {k: v for k, v in want.items() if v},
           "mixed_precision": mixed, "mixed_bounds": MIXED_TOL, "cpu_parity": parity,
           "cpu_parity_bounds": DDPM_TOL, "fp32_parity_launches": fp32_launches,
           "held": held, "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    require(len(hist) == steps and all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                       for r in hist), f"{steps} finite bf16 DDPM steps")
    require(all(v == ["torch.float32"] for v in dtypes.values()),
            f"fp32 parameters, Adam moments and EMA under bf16 compute: {dtypes}")
    require(conv_out_moved, "conv_out left zero")
    require(launches == want, f"training_options launches {row['launches']} == "
            f"{row['expected_launches']}")
    require(mixed["loss_rel"] <= MIXED_TOL["loss_rel"]
            and mixed["grad_l2_rel"] <= MIXED_TOL["grad_l2_rel"],
            f"bf16-compute step against fp32 within {MIXED_TOL}: loss {mixed['loss_rel']:.3g}, "
            f"gradient {mixed['grad_l2_rel']:.3g}")
    require(all(math.isfinite(v) for v in logs_gpu.values())
            and parity["loss_rel"] <= DDPM_TOL["loss_rel"]
            and parity["grad_norm_rel"] <= DDPM_TOL["grad_norm_rel"]
            and parity["params_l2_rel"] <= DDPM_TOL["params_l2_rel"],
            f"fp32 DDPM step with dropout, card against CPU within {DDPM_TOL}: loss "
            f"{parity['loss_rel']:.3g}, grad_norm {parity['grad_norm_rel']:.3g}, params "
            f"{parity['params_l2_rel']:.3g}")
    require(not fp32_launches, f"no kernel launches in the fp32 DDPM step: {fp32_launches}")
    return {"ddpm_bf16_steps": launches}


def phase_bench_serve(smi: str):
    """`python -m sd_tpu_torch.bench_serve` (its `main`) on SD-v1 at 512² in
    bf16 with the default switches: BatchingServer(max_batch 4, window 50 ms)
    behind its HTTP front end on loopback, rows ddim50 (BENCH_SERVE_STEPS:
    10 steps, CFG 7.5) and lcm4 (4 steps, guidance 1), each row's warm-up at
    every bucket, 3 sequential requests, then BENCH_SERVE_CLIENTS clients ×
    BENCH_SERVE_REQUESTS requests. Gates: every response a 512² PNG, each
    row's `requests` clients × requests and its concurrent `mean_batch` above
    1, each row's launches by route the sum over the generates it ran of
    BENCH_SERVE_LAUNCHES[row, bucket]; then three explicitly seeded ddim50
    requests queued together (one bucket-4 generate) each within 1 uint8
    level of a direct `generate` of their batch. A batch draws its noise as
    one tensor, so a request served alone draws other noise; each request is
    also computed alone (batch 1) on its slot of the group's noise, and that
    distance, bf16's dependence on the batch, is reported, not gated.
    Returns (the rows' launches, the pipeline)."""
    import base64
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sd_tpu_torch import bench_serve, kernels
    from sd_tpu_torch.pipeline import to_uint8
    from sd_tpu_torch.serve import BatchingServer, decode_png, make_http_server

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    built, shapes, per_row = {}, [], {}
    real_pipeline, real_post, real_run_row = (bench_serve._pipeline, bench_serve._post,
                                              bench_serve.run_row)

    def pipeline(config, device):
        t0 = time.perf_counter()
        built["pipe"] = _Recording(real_pipeline(config, device))
        built["seconds"] = time.perf_counter() - t0
        return built["pipe"]

    def post(port, body, timeout=900.0):
        out = real_post(port, body, timeout)
        shapes.append(tuple(decode_png(base64.b64decode(out["image"])).shape))
        return out

    def run_row(name, port, batcher, body, clients, requests_per_client):
        torch.cuda.synchronize()
        kernels.reset_launches()
        n0 = len(built["pipe"].batches)
        row = real_run_row(name, port, batcher, body, clients, requests_per_client)
        torch.cuda.synchronize()
        per_row[name] = {"launches": dict(kernels.LAUNCHES),
                         "buckets": [len(p) for p, _ in built["pipe"].batches[n0:]]}
        return row

    rows_cut = {name: {**bench_serve.ROWS[name], "steps": n}
                for name, n in BENCH_SERVE_STEPS.items()}
    out_path = os.path.join(tempfile.mkdtemp(prefix="sd_tpu_torch_bench_"), "rows.json")
    with mock.patch.dict(bench_serve.ROWS, rows_cut), \
            mock.patch.object(bench_serve, "_pipeline", pipeline), \
            mock.patch.object(bench_serve, "_post", post), \
            mock.patch.object(bench_serve, "run_row", run_row):
        code = bench_serve.main(["--config", "sd_v1", "--rows", ",".join(BENCH_SERVE_STEPS),
                                 "--clients", str(BENCH_SERVE_CLIENTS),
                                 "--requests", str(BENCH_SERVE_REQUESTS), "--max-batch", "4",
                                 "--batch-window-ms", "50", "--out", out_path])
    require(code == 0, f"bench_serve exit {code}")
    with open(out_path) as f:
        rows = json.load(f)
    os.remove(out_path)
    os.rmdir(os.path.dirname(out_path))
    rec = built["pipe"]
    pipe = rec.pipe

    # three seeded requests queued together: one bucket-4 generate; each
    # against itself alone at batch 1 on its slot of the group's noise
    body = {"steps": BENCH_SERVE_STEPS["ddim50"], "guidance_scale": 7.5, "seed": BENCH_SERVE_SEED}
    prompts = bench_serve.PROMPTS[:3]
    batcher = BatchingServer(rec, max_batch=4, batch_window_ms=50)
    server = make_http_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    grouped = {}

    def send(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate",
            data=json.dumps({**body, "prompt": prompts[i]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            grouped[i] = json.loads(r.read())

    try:
        senders = [threading.Thread(target=send, args=(i,), daemon=True) for i in range(3)]
        for t in senders:
            t.start()
        deadline = time.monotonic() + 60
        while batcher.queue_depth() < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        require(batcher.queue_depth() == 3, "the three seeded requests queued")
        n0 = len(rec.batches)
        batcher.start()
        for t in senders:
            t.join(600)
    finally:
        batcher.stop()
        server.shutdown()
        server.server_close()
        thread.join(10)
    buckets = [len(p) for p, _ in rec.batches[n0:]]
    require(len(grouped) == 3 and buckets == [4],
            f"the three seeded requests answered by one bucket-4 generate: {buckets}")
    group_prompts, kw = rec.batches[n0]
    direct = pipe.generate(group_prompts, **kw)
    gen = torch.Generator("cuda").manual_seed(kw["seed"])
    h, w = pipe.latent_hw(None, None)
    x_T = torch.randn((4, h, w, pipe.cfg["latent"]["channels"]), generator=gen, device="cuda",
                      dtype=torch.float32)
    direct_diffs, alone_diffs, alone_means = [], [], []
    for i, p in enumerate(prompts):
        slot = group_prompts.index(p)
        served = decode_png(base64.b64decode(grouped[i]["image"])).astype(int)
        require(grouped[i]["batch_size"] == 3 and served.shape == (512, 512, 3),
                f"seeded request {i}: batch {grouped[i]['batch_size']}, {served.shape}")
        direct_diffs.append(int(np.abs(served - direct[slot]).max()))
        # measured, not gated: the request alone (batch 1) on its slot's noise
        with torch.no_grad():
            alone = to_uint8(pipe.sample([p], x_T[slot:slot + 1], "", kw["num_steps"],
                                         kw["guidance_scale"], kw.get("eta", 0.0),
                                         sampler=kw["sampler"]))[0].astype(int)
        alone_diffs.append(int(np.abs(served - alone).max()))
        alone_means.append(float(np.abs(served - alone).mean()))

    launches = {}
    for row in rows:
        name = row["row"]
        got = {k: v for k, v in per_row[name]["launches"].items() if v}
        want = launches_of()
        for b in per_row[name]["buckets"]:
            for k, v in BENCH_SERVE_LAUNCHES[name, b].items():
                want[k] += v
        launches[name] = per_row[name]["launches"]
        row.update(phase="bench_serve", nvidia_smi=smi,
                   generates_by_bucket={str(b): per_row[name]["buckets"].count(b)
                                        for b in BENCH_SERVE_BUCKETS},
                   launches=got, expected_launches={k: v for k, v in want.items() if v})
    result = {"phase": "bench_serve", "nvidia_smi": smi, "rows": rows,
              "responses": len(shapes), "response_shapes": sorted({str(s) for s in shapes}),
              "pipeline_build_seconds": built["seconds"],
              "grouped_vs_direct_generate_max_uint8": direct_diffs,
              "grouped_vs_alone_on_slot_noise_max_uint8": alone_diffs,
              "grouped_vs_alone_on_slot_noise_mean_uint8": alone_means,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
              "phase_seconds": time.perf_counter() - t_phase}
    emit(result)
    require(shapes and all(s == (512, 512, 3) for s in shapes),
            f"every bench_serve response a 512² PNG: {result['response_shapes']}")
    for row in rows:
        require(row["requests"] == BENCH_SERVE_CLIENTS * BENCH_SERVE_REQUESTS
                and row["steps"] == BENCH_SERVE_STEPS[row["row"]],
                f"{row['row']}: {row['requests']} requests at {row['steps']} steps")
        require(row["mean_batch"] > 1, f"{row['row']}: mean batch {row['mean_batch']} above 1")
        require(row["launches"] == row["expected_launches"],
                f"{row['row']} launches {row['launches']} == {row['expected_launches']}")
    require(max(direct_diffs) <= 1, f"grouped requests within 1 uint8 level of a direct generate "
            f"of their batch: {direct_diffs}")
    return launches, pipe


def phase_eval_tools(smi: str, pipe) -> dict:
    """The evaluation and diagnostic tools on the card: EVAL_TOOLS_IMAGES
    synthetic 128² PNGs (cat.<i> / dog.<i>); `python -m sd_tpu_torch.train`
    on kl_128_catdog_config() for 1 step, then ldm_32_catdog_cond_config()
    over its checkpoint for 1 step; `python -m sd_tpu_torch.eval_steering`
    on that run (EVAL_STEERING_ARGS: 2 rows with finite `acc_*`, `conf_*`
    and `fid_surrogate`); `cross_attention_maps` and `token_heatmaps` on
    `pipe`'s SD-v1 UNet at 512², batch 2, every cross-attention block
    captured (ATTN_VIZ_MAPS maps, every row summing to 1 within 1e-5,
    heatmaps [2, 64, 64, 77], the forward's launches ATTN_VIZ_LAUNCHES,
    seconds and peak memory); card against CPU in fp32 within CARD_CPU_TOL
    (every weight random): the probe classifier's forward, one FID feature
    batch of the ViT-B/32 tower, and the heatmaps of the full-width UNet at
    a EVAL_PARITY_LATENT² latent; `nan_check` flags a NaN injected into the
    probe's input and nothing on its clean forward; `tree_finite_summary`
    over the UNet's parameters on the card. Returns the launches by entry."""
    import math
    import shutil
    import tempfile

    import torch

    from sd_tpu_torch import eval_steering, kernels
    from sd_tpu_torch.core.config import (kl_128_catdog_config, ldm_32_catdog_cond_config,
                                         sd_v1_config)
    from sd_tpu_torch.data.image_io import write_png
    from sd_tpu_torch.eval import TinyImageClassifier
    from sd_tpu_torch.models.conditioners import FrozenClipImageEmbedder
    from sd_tpu_torch.models.unet_sd import UNetModel
    from sd_tpu_torch.train import __main__ as train_cli
    from sd_tpu_torch.utils import attn_viz, debug
    from sd_tpu_torch.weights import randomize_params_

    t_phase = time.perf_counter()
    seconds, launches = {}, {}
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_eval_")
    try:
        data = os.path.join(root, "data")
        os.makedirs(data)
        for i, im in enumerate(_edit_images(EVAL_TOOLS_IMAGES, 128, EVAL_TOOLS_SEED)):
            label = "cat" if i < EVAL_TOOLS_IMAGES // 2 else "dog"
            write_png(os.path.join(data, f"{label}.{i}.png"), im)

        def run(name, cfg):
            cfg["seed"] = EVAL_TOOLS_SEED
            cfg["train"].update(total_steps=1, checkpoint_every=1, eval_every=10**6)
            path = os.path.join(root, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            out = os.path.join(root, name)
            t0 = time.perf_counter()
            code = train_cli.main(["--config", path, "--data", data, "--out", out])
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            require(code == 0, f"python -m sd_tpu_torch.train {name}: exit {code}")
            return out, path

        kl_dir, _ = run("kl_f4", kl_128_catdog_config())
        cond_cfg = ldm_32_catdog_cond_config()
        cond_cfg["first_stage"]["ckpt"] = os.path.join(kl_dir, "ckpt")
        ldm_dir, ldm_path = run("ldm_32_catdog_cond", cond_cfg)
        out = os.path.join(root, "steering")
        kernels.reset_launches()
        t0 = time.perf_counter()
        code = eval_steering.main(["--config", ldm_path, "--ckpt", os.path.join(ldm_dir, "ckpt"),
                                   "--data", data, *EVAL_STEERING_ARGS,
                                   "--seed", str(EVAL_TOOLS_SEED), "--out", out])
        torch.cuda.synchronize()
        seconds["eval_steering"] = time.perf_counter() - t0
        launches["eval_steering"] = dict(kernels.LAUNCHES)
        require(code == 0, f"python -m sd_tpu_torch.eval_steering: exit {code}")
        with open(os.path.join(out, "steering.jsonl")) as f:
            steering = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keys = ("acc_cat", "conf_cat", "acc_dog", "conf_dog", "fid_surrogate")
    require(len(steering) == 2 and all(math.isfinite(r[k]) for r in steering for k in keys),
            f"eval_steering: 2 rows with finite {keys}: {steering}")

    # the heatmaps of SD-v1 at 512², batch 2, every block captured
    g = torch.Generator("cuda").manual_seed(EVAL_TOOLS_SEED)
    with torch.no_grad():
        ctx, _ = pipe.encode_prompts(["a photo of a cat", "a photo of a dog"])
    x = torch.randn(2, 64, 64, 4, generator=g, device="cuda").to(pipe.dtype)
    t = torch.tensor([500, 500], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    maps = attn_viz.cross_attention_maps(pipe.unet, x, t, ctx.to(pipe.dtype))
    heat = attn_viz.token_heatmaps(maps, (64, 64))
    torch.cuda.synchronize()
    seconds["attn_viz_512"] = time.perf_counter() - t0
    launches["attn_viz_512"] = dict(kernels.LAUNCHES)
    viz_peak = torch.cuda.max_memory_allocated() / 2**30
    row_err = max(float((p.sum(-1) - 1).abs().max()) for p in maps.values())
    n_maps, map_shapes = len(maps), sorted({str(list(p.shape)) for p in maps.values()})
    del maps

    # card against CPU, fp32, every weight random
    parity = {}
    x128 = torch.rand(8, 128, 128, 3, generator=g, device="cuda") * 2 - 1
    probe = TinyImageClassifier(2, device="cuda")
    randomize_params_(probe, g)
    parity["probe"] = _card_vs_cpu("probe forward", probe, lambda m, x_: m(x_), x128)
    tower = FrozenClipImageEmbedder(device="cuda")
    randomize_params_(tower, g)
    parity["fid_features"] = _card_vs_cpu("FID feature batch", tower, lambda m, x_: m(x_), x128)
    del tower
    uparams = sd_v1_config()["unet"]["params"]
    unet = UNetModel(**uparams, device="cuda")
    randomize_params_(unet, g)
    n = EVAL_PARITY_LATENT
    heatmaps = lambda m, x_, t_, c_: torch.from_numpy(attn_viz.token_heatmaps(
        attn_viz.cross_attention_maps(m, x_, t_, c_), (n, n), normalize=False))
    parity["heatmaps"] = _card_vs_cpu(
        f"heatmaps at a {n}² latent", unet, heatmaps,
        torch.randn(2, n, n, 4, generator=g, device="cuda"), t,
        torch.randn(2, 77, uparams["context_dim"], generator=g, device="cuda"))
    del unet
    torch.cuda.empty_cache()

    # NaN checks and the parameters' health on the card
    clean_err, _ = debug.nan_check(probe)(x128)
    bad = x128.clone()
    bad[0, 0, 0, 0] = float("nan")
    bad_err, _ = debug.nan_check(probe)(bad)
    health = debug.tree_finite_summary(dict(pipe.unet.named_parameters()))
    health = {k: (bool(v) if k == "finite" else int(v)) for k, v in health.items()}
    row = {"phase": "eval_tools", "nvidia_smi": smi, "steering_rows": steering,
           "seconds": seconds, "attn_viz_maps": n_maps,
           "attn_viz_map_shapes": map_shapes, "attn_viz_row_sum_err": row_err,
           "heatmaps_shape": list(heat.shape), "attn_viz_peak_memory_gb": viz_peak,
           "attn_viz_launches": {k: v for k, v in launches["attn_viz_512"].items() if v},
           "eval_steering_launches": {k: v for k, v in launches["eval_steering"].items() if v},
           "card_vs_cpu": parity,
           "nan_check": {"clean": clean_err.get(), "injected": bad_err.get()},
           "unet_parameters": health, "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    require(n_maps == ATTN_VIZ_MAPS, f"{n_maps} cross-attention maps == {ATTN_VIZ_MAPS}")
    require(row_err <= 1e-5, f"attention rows sum to 1 within 1e-5: {row_err:.3g}")
    require(heat.shape == (2, 64, 64, 77), f"heatmaps {heat.shape} == (2, 64, 64, 77)")
    require(launches["attn_viz_512"] == ATTN_VIZ_LAUNCHES,
            f"attn_viz launches {row['attn_viz_launches']} == "
            f"{ {k: v for k, v in ATTN_VIZ_LAUNCHES.items() if v} }")
    require(clean_err.get() is None and bad_err.get() is not None,
            f"nan_check: nothing on the clean forward, the injected NaN flagged: "
            f"{row['nan_check']}")
    require(health == {"finite": True, "num_nan": 0, "num_inf": 0},
            f"the UNet's parameters finite: {health}")
    return launches


# -- the parallel layer --------------------------------------------------------------

# what a rank of the parallel phase runs: an entry point (`python -m
# sd_tpu_torch.train` or `python -m sd_tpu_torch.serve`, its `main` with the
# arguments given), its launch counts zeroed just before and read just after,
# its steps' seconds and its peak device memory printed as one JSON line
_RANK_HARNESS = r"""
import json, os, sys, time
import torch
from sd_tpu_torch import kernels
from sd_tpu_torch.train import runners
seconds = []
real_loop = runners._run_loop
def loop(*a, **k):
    history = real_loop(*a, **k)
    seconds.extend(r["seconds"] for r in history)
    return history
runners._run_loop = loop
if sys.argv[1] == "train":
    from sd_tpu_torch.train.__main__ import main
else:
    from sd_tpu_torch.serve import main
kernels.reset_launches()
t0 = time.perf_counter()
rc = main(sys.argv[2:])
wall = time.perf_counter() - t0
print("RANK_RESULT " + json.dumps({
    "rc": rc, "rank": int(os.environ.get("RANK", "0")), "seconds": seconds, "wall": wall,
    "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    "launches": dict(kernels.LAUNCHES)}), flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    """The environment torchrun gives rank `rank` of `world` on one host."""
    return {**os.environ, "PYTHONPATH": str(HERE), "RANK": str(rank),
            "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _start_ranks(world: int, argv_of, env_extra: dict | None = None) -> list:
    """`world` processes (`argv_of(rank)`) with torchrun's environment."""
    port = _free_port()
    return [subprocess.Popen(argv_of(r), cwd=str(HERE),
                             env={**_rank_env(r, world, port), **(env_extra or {})},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _finish_ranks(procs: list, what: str, timeout: float = PARALLEL_RANK_TIMEOUT) -> list:
    """Each rank's RANK_RESULT (or TP_RESULT) JSON; every process ended."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        lines = [ln for ln in log.splitlines() if ln.startswith(("RANK_RESULT ", "TP_RESULT "))]
        require(p.returncode == 0 and lines, f"{what}: rank {r} exited {p.returncode}:\n"
                + log[-3000:])
        results.append(json.loads(lines[-1].split(" ", 1)[1]))
    return results


def _train_ranks(world: int, cfg: dict, data: str, out: str, steps: int, extra=()) -> list:
    """`python -m sd_tpu_torch.train` at `world` ranks (its main through
    _RANK_HARNESS) on a .json copy of `cfg`."""
    path = out + ".json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    argv = lambda r: [sys.executable, "-c", _RANK_HARNESS, "train", "--config", path,
                      "--data", data, "--out", out, "--max-steps", str(steps), *extra]
    return _finish_ranks(_start_ranks(world, argv), f"train at {world} ranks ({out})")


def _metrics(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _hold_run(name: str, out: str, ref_hist: list, ref: dict, init: dict) -> dict:
    """A parallel run's losses, grad_norm, Adam first moment and final
    parameters (its rank 0 checkpoint) against the plain run's (`ref`:
    `params`, `mu`), by PARALLEL_TOL."""
    import math
    import shutil

    from sd_tpu_torch.train.checkpoint import restore_tree

    rows = _metrics(out)
    loss_rel = max(abs(r["loss"] - h["loss"]) / abs(h["loss"]) for r, h in zip(rows, ref_hist))
    gn_rel = max(abs(r["grad_norm"] - h["grad_norm"]) / h["grad_norm"]
                 for r, h in zip(rows, ref_hist))
    tree = restore_tree(os.path.join(out, "ckpt"))
    l2 = lambda pairs: math.sqrt(sum(float((a.float() - b.float()).pow(2).sum())
                                     for a, b in pairs))
    diff = l2((tree["params"][n], p) for n, p in ref["params"].items())
    step = l2((p, init[n]) for n, p in ref["params"].items())
    moment_rel = (l2(zip(tree["opt_state"]["mu"], ref["mu"]))
                  / l2((m, m.new_zeros(())) for m in ref["mu"]))
    del tree
    shutil.rmtree(os.path.join(out, "ckpt"), ignore_errors=True)
    held = {"steps": len(rows), "loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "moment_rel": moment_rel, "update_rel": diff / step if step else None,
            "update_l2": step, "losses": [r["loss"] for r in rows],
            "grad_norms": [r["grad_norm"] for r in rows]}
    require(len(rows) == len(ref_hist), f"{name}: {len(ref_hist)} steps, ran {len(rows)}")
    require(step > 0, f"{name}: the plain run's update is 0")
    for key, bound in PARALLEL_TOL.items():
        require(held[key] <= bound, f"{name}: {key} {held[key]:.3g} > {bound}")
    return held


def _write_parallel_images(root: str) -> None:
    """PARALLEL_IMAGES 512² JPEGs (`cat_0..3.jpg`, `dog_0..3.jpg`) written
    by PIL: the port reads them through PIL, as the JAX package's loader
    falls back to."""
    import numpy as np
    from PIL import Image

    from sd_tpu_torch.data.image_io import resize

    rng = np.random.default_rng(PARALLEL_SEED)
    for i in range(PARALLEL_IMAGES):
        low = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        field = resize(low, 512, 512).astype(np.int16) + rng.integers(-12, 13, (512, 512, 3))
        Image.fromarray(np.clip(field, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"{('cat', 'dog')[i // 4]}_{i % 4}.jpg"), quality=92)


def _plain_train(cfg: dict, data: str, steps: int):
    """train_ldm without the parallel block, in this process: (history,
    {"params": final UNet parameters, "mu": Adam's first moment}, on the CPU)."""
    import torch

    from sd_tpu_torch.train.runners import train_ldm

    plain = {k: v for k, v in cfg.items() if k != "parallel"}
    state, hist = train_ldm(plain, data, max_steps=steps)
    ref = {"params": {n: p.detach().cpu() for n, p in state.params.items()},
           "mu": [m.cpu() for m in state.opt_state.mu]}
    del state
    torch.cuda.empty_cache()
    return hist, ref


def _rank_rows(results: list, want: dict, what: str) -> dict:
    """Each rank's seconds, peak memory and launches, the launches held
    against `want`."""
    for r in results:
        got = {k: v for k, v in r["launches"].items() if v}
        require(got == {k: v for k, v in want.items() if v},
                f"{what} rank {r['rank']}: launches {got} == {want}")
    return {f"rank{r['rank']}": {"step_seconds": r["seconds"], "wall_seconds": r["wall"],
                                 "peak_memory_gb": r["peak_gb"]} for r in results}


def tp_rank() -> int:
    """One rank of the parallel phase's tensor-parallel serving check
    (`python chip_smoke.py --tp-rank <dir>` under torchrun's environment):
    SD-v1 on the one card over gloo, `shard_for_serving` at data 1 × model
    2; one UNet call under the default and one under the opt-in switches on
    the inputs of PARALLEL_SEED, then a PARALLEL_TP_STEPS-step CFG generate
    of 2 prompts; rank 0 saves the outputs, every rank prints its launches,
    seconds and peak memory."""
    import torch

    from sd_tpu_torch import kernels
    from sd_tpu_torch.parallel import mesh as pmesh
    from sd_tpu_torch.parallel import multihost

    out_dir = sys.argv[sys.argv.index("--tp-rank") + 1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(backend="gloo", device="cuda:0")
    rank = torch.distributed.get_rank()
    pipe = _tp_pipeline()
    pipe.shard_for_serving(pmesh.make_mesh({"data": 1, "model": 2}))
    x, t, ctx = _tp_unet_inputs()
    res = {"rank": rank, "split_leaves": len(pipe._unet_split), "launches": {}, "seconds": {}}
    outs = {}
    for name, env in (("tp2_unet", {}), ("tp2_unet_optin", OPT_IN)):
        with switches(env), torch.no_grad():
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = pipe.unet(x, t, ctx).float().cpu()
            torch.cuda.synchronize()
            res["seconds"][name] = time.perf_counter() - t0
            res["launches"][name] = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs["tp2_generate"] = torch.from_numpy(pipe.generate(
        FAMILY_PROMPTS[:2], num_steps=PARALLEL_TP_STEPS, seed=PARALLEL_SEED))
    res["seconds"]["tp2_generate"] = time.perf_counter() - t0
    res["launches"]["tp2_generate"] = dict(kernels.LAUNCHES)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        torch.save(outs, os.path.join(out_dir, "tp_outputs.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("TP_RESULT " + json.dumps(res), flush=True)
    return 0


def _tp_pipeline():
    """SD-v1 (bf16) with every UNet parameter random from PARALLEL_SEED (the
    port's init zeroes the output conv, which would hide the UNet from
    every check)."""
    import torch

    from sd_tpu_torch.core.config import sd_v1_config
    from sd_tpu_torch.pipeline import Text2ImagePipeline
    from sd_tpu_torch.weights import randomize_params_

    pipe = Text2ImagePipeline(sd_v1_config())
    with torch.no_grad():
        randomize_params_(pipe.unet, torch.Generator(pipe.device).manual_seed(PARALLEL_SEED))
    return pipe


def _tp_unet_inputs():
    """A 512² UNet call's inputs of 2 prompts under CFG (4 rows), from PARALLEL_SEED."""
    import torch

    g = torch.Generator("cuda").manual_seed(PARALLEL_SEED)
    x = torch.randn((4, 64, 64, 4), generator=g, device="cuda").bfloat16()
    t = torch.tensor([981, 981, 500, 500], device="cuda")
    ctx = torch.randn((4, 77, 768), generator=g, device="cuda").bfloat16()
    return x, t, ctx


def _serve_shard_w1(root: str) -> dict:
    """`python -m sd_tpu_torch.serve --config sd_v1 --shard` without
    torchrun (a process group of one rank, NCCL): two requests, one after
    the other, then SIGINT. Returns its RANK_RESULT and the answers' check."""
    import base64
    import signal
    import urllib.request

    import numpy as np

    from sd_tpu_torch.data.image_io import decode_png

    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(HERE)
    proc = subprocess.Popen([sys.executable, "-u", "-c", _RANK_HARNESS, "serve", "--config",
                             "sd_v1", "--shard", "--port", "0", "--max-batch", "2",
                             "--steps", str(PARALLEL_SERVE_STEPS)], cwd=str(HERE), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log, port = [], None
    try:
        t0 = time.perf_counter()
        while port is None and time.perf_counter() - t0 < PARALLEL_RANK_TIMEOUT:
            line = proc.stdout.readline()
            if not line:
                break
            log.append(line)
            if line.startswith("serving on http://"):
                port = int(line.split(":")[2].split()[0])
        require(port is not None, "serve --shard came up:\n" + "".join(log)[-3000:])
        answers, seconds = [], []
        for i, prompt in enumerate(("a photo of a cat", "a photo of a dog")):
            body = json.dumps({"prompt": prompt, "seed": PARALLEL_SEED + i}).encode()
            t1 = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                answers.append(json.loads(r.read()))
            seconds.append(time.perf_counter() - t1)
        proc.send_signal(signal.SIGINT)
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.append(rest)
    lines = [ln for ln in "".join(log).splitlines() if ln.startswith("RANK_RESULT ")]
    require(proc.returncode == 0 and lines, "serve --shard exited cleanly:\n"
            + "".join(log)[-3000:])
    imgs = [decode_png(base64.b64decode(a["image"])) for a in answers]
    require(all(i.shape == (512, 512, 3) and np.ptp(i) > 0 for i in imgs)
            and [a["seed"] for a in answers] == [PARALLEL_SEED, PARALLEL_SEED + 1],
            "serve --shard answered two 512² images with their seeds")
    return {**json.loads(lines[-1].split(" ", 1)[1]), "request_seconds": seconds}


def phase_parallel(smi: str) -> dict:
    """The parallel layer on the card (see PARALLEL_SEED's comment): world 1
    over NCCL (train ZeRO-1 and FSDP, serve --shard), data-parallel training
    and tensor-parallel serving at two ranks on the one card over gloo, each
    rank's launches held, each run against its plain counterpart. Returns
    each run's launches by rank."""
    import shutil
    import tempfile

    import torch

    from sd_tpu_torch.core.config import sd512_train_config
    from sd_tpu_torch.train.runners import build_ldm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="sd_tpu_torch_parallel_")
    runs: dict = {}
    row: dict = {"phase": "parallel", "nvidia_smi": smi}
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        require(free_gb >= PARALLEL_DISK_GB, f"free disk under {root}: {free_gb:.1f} GB, the "
                f"phase needs {PARALLEL_DISK_GB} GB (one ≈ 12 GB checkpoint)")
        data = os.path.join(root, "data")
        os.makedirs(data)
        _write_parallel_images(data)
        base = sd512_train_config()
        _, unet, _, _ = build_ldm(base, torch.Generator("cuda").manual_seed(base["seed"]),
                                  torch.bfloat16, "cuda")
        init = {n: p.detach().cpu() for n, p in unet.named_parameters()}
        del unet
        torch.cuda.empty_cache()

        # (1) world 1 over NCCL: ZeRO-1, FSDP, against the plain run
        t0 = time.perf_counter()
        ref_hist, ref = _plain_train(base, data, PARALLEL_W1_STEPS)
        row["plain_w1_seconds"] = time.perf_counter() - t0
        row["plain_w1_step_seconds"] = [h["seconds"] for h in ref_hist]
        for mode in ("zero1", "fsdp"):
            name = f"train_{mode}_w1"
            cfg = {**base, "parallel": {"mesh": {"data": 1}, "state_sharding": mode}}
            out = os.path.join(root, name)
            res = _train_ranks(1, cfg, data, out, PARALLEL_W1_STEPS)
            row[name] = {**_rank_rows(res, PARALLEL_LAUNCHES[name], name),
                         **_hold_run(name, out, ref_hist, ref, init)}
            runs[name] = {f"rank{r['rank']}": r["launches"] for r in res}
        del ref

        # (2) data-parallel: two ranks on the one card over gloo, batch 8
        name = "train_dp2"
        cfg = {**base, "train": {**base["train"], "batch_size": PARALLEL_DP_BATCH},
               "parallel": {"mesh": {"data": 2}, "state_sharding": "zero1"}}
        out = os.path.join(root, name)
        res = _train_ranks(2, cfg, data, out, PARALLEL_DP_STEPS,
                           extra=("--backend", "gloo", "--device", "cuda:0"))
        t0 = time.perf_counter()
        dp_hist, dp_ref = _plain_train(cfg, data, PARALLEL_DP_STEPS)
        row["plain_dp_reference_seconds"] = time.perf_counter() - t0
        row["plain_dp_reference_step_seconds"] = [h["seconds"] for h in dp_hist]
        row[name] = {**_rank_rows(res, PARALLEL_LAUNCHES[name], name),
                     **_hold_run(name, out, dp_hist, dp_ref, init)}
        for r in res:
            for c in (*LSE_ROUTE_COUNTER.values(), "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"):
                if c != "flash_lse_wide":
                    require(r["launches"][c] > 0, f"{name} rank {r['rank']}: {c} moved")
        runs[name] = {f"rank{r['rank']}": r["launches"] for r in res}
        del dp_ref, init
        torch.cuda.empty_cache()

        # (3) tensor-parallel serving: two ranks on the one card over gloo
        t0 = time.perf_counter()
        procs = _start_ranks(2, lambda r: [sys.executable, str(HERE / "chip_smoke.py"),
                                           "--tp-rank", root])
        tp = _finish_ranks(procs, "tensor-parallel serving")
        row["tp2_seconds"] = time.perf_counter() - t0
        outs = torch.load(os.path.join(root, "tp_outputs.pt"))
        pipe = _tp_pipeline()
        x, t, ctx = _tp_unet_inputs()
        tp_row = {"split_leaves": tp[0]["split_leaves"]}
        for key, env in (("tp2_unet", {}), ("tp2_unet_optin", OPT_IN)):
            with switches(env), torch.no_grad():
                ref = pipe.unet(x, t, ctx).float().cpu()
            mx, l2 = rel_err(outs[key], ref)[1], l2_rel(outs[key], ref)
            tp_row[key] = {"max_rel": mx, "l2_rel": l2}
            require(mx <= UNET_TOL["max_rel"] and l2 <= UNET_TOL["l2_rel"],
                    f"{key}: max|Δ| {mx:.3g}·max|ref|, ‖Δ‖₂ {l2:.3g}·‖ref‖₂ within {UNET_TOL}")
        ref_imgs = pipe.generate(FAMILY_PROMPTS[:2], num_steps=PARALLEL_TP_STEPS,
                                 seed=PARALLEL_SEED)
        levels = (outs["tp2_generate"].numpy().astype(int) - ref_imgs.astype(int))
        tp_row["generate_levels"] = {"mean": float(abs(levels).mean()),
                                     "max": int(abs(levels).max())}
        require(tp_row["generate_levels"]["mean"] <= PARALLEL_LEVELS["mean"],
                f"tp2 generate: mean level difference {tp_row['generate_levels']['mean']:.3g} "
                f"≤ {PARALLEL_LEVELS['mean']}")
        del pipe
        torch.cuda.empty_cache()
        for r in tp:
            for key in ("tp2_unet", "tp2_unet_optin", "tp2_generate"):
                got = {k: v for k, v in r["launches"][key].items() if v}
                want = {k: v for k, v in PARALLEL_LAUNCHES[key].items() if v}
                require(got == want, f"{key} rank {r['rank']}: launches {got} == {want}")
            tp_row[f"rank{r['rank']}"] = {"seconds": r["seconds"], "peak_memory_gb": r["peak_gb"]}
            for key in ("tp2_unet", "tp2_unet_optin", "tp2_generate"):
                runs.setdefault(key, {})[f"rank{r['rank']}"] = r["launches"][key]
        require(tp[0]["split_leaves"] > 0, "the UNet split over the model axis")
        row["tp2"] = tp_row

        # (4) serve --shard at world 1 over NCCL: two requests
        t0 = time.perf_counter()
        served = _serve_shard_w1(root)
        row["serve_shard_w1"] = {
            "seconds": time.perf_counter() - t0, "request_seconds": served["request_seconds"],
            "peak_memory_gb": served["peak_gb"]}
        got = {k: v for k, v in served["launches"].items() if v}
        want = {k: v for k, v in PARALLEL_LAUNCHES["serve_shard_w1"].items() if v}
        require(got == want, f"serve --shard launches {got} == {want}")
        runs["serve_shard_w1"] = {"rank0": served["launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return runs


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


def bwd_sm90_report() -> dict:
    """Registers, spills and dynamic shared memory of the Hopper backward's
    instantiations at the path's head dims (40 -> 48, 80), at 64 rows per
    block and, at 48, at 128, from the build's log."""
    import ctypes
    import re

    from sd_tpu_torch.kernels import _build

    log = (_build.build_dir() / "flash_attention_bwd_sm90.log").read_text()
    smem = _build.function("flash_attention_bwd_sm90", "sd_flash_bwd_sm90_smem",
                           [ctypes.c_int] * 3)
    out = {}
    for mangled, vals in ptxas_report(log, lambda n: "_sm90_kernel" in n).items():
        m = re.search(r"flash_bwd_(dq|dkv)_sm90_kernelILi(\d+)ELi(\d+)E", mangled)
        kind, dp, rows = m.group(1), int(m.group(2)), 64 * int(m.group(3))
        if dp in (48, 80):
            out[f"{kind}<{dp}> rows {rows}"] = {
                "registers": vals[0], "spill_stores": vals[1], "spill_loads": vals[2],
                "smem_bytes": smem(dp, rows, int(kind == "dkv"))}
    return out


def bwd_wide_sm90_report() -> dict:
    """Registers (at entry: setmaxnreg gives the consumers 232), spills and
    dynamic shared memory of every instantiation of the wide Hopper backward
    (`flash_attention_bwd_wide_sm90.cu`; `dq<DP>`, `dkv<DP>` at padded head
    dim DP, `split` blocks a slab), from the build's log; raises on a
    spill."""
    import ctypes
    import re

    from sd_tpu_torch.kernels import _build

    log = (_build.build_dir() / "flash_attention_bwd_wide_sm90.log").read_text()
    smem = _build.function("flash_attention_bwd_wide_sm90", "sd_flash_bwd_wide_sm90_smem",
                           [ctypes.c_int] * 2)
    pattern = r"flash_bwd_(dq|dkv)_wide_sm90_kernelILi(\d+)E"
    out = {}
    for mangled, (regs, st, ld) in ptxas_report(log, lambda n: re.search(pattern, n)).items():
        m = re.search(pattern, mangled)
        kind, split = m.group(1), int(m.group(2))
        dp = 256 * split
        out[f"{kind}<{dp}> split {split}"] = {
            "registers": regs, "spill_stores": st, "spill_loads": ld,
            "smem_bytes": smem(dp, int(kind == "dkv")), "setmaxnreg": {"producer": 40,
                                                                       "consumers": 232}}
    require(len(out) == 4, f"the wide Hopper backward's instantiations: {sorted(out)}")
    spills = {k: v for k, v in out.items() if v["spill_stores"] or v["spill_loads"]}
    require(not spills, f"the wide Hopper backward spills: {spills}")
    # ptxas's notes that it serialized wgmma (C7510-C7519), by kernel
    out["wgmma_serialized"] = sorted(
        f"{m.group(1)}<{256 * int(m.group(2))}> split {m.group(2)}"
        for line in log.splitlines() if re.search(r"C751\d", line)
        for m in [re.search(pattern, line)] if m)
    return out


def ff_xattn_report() -> dict:
    """Registers, spills and dynamic shared memory of every instantiation of
    the Hopper GEGLU (`geglu_sm90<C>`) and cross-attention kernels
    (`xattn_gemm`, `xattn_attend<MP, warpgroups>`), from the
    build's logs; raises on a spill."""
    import ctypes
    import re

    from sd_tpu_torch.kernels import _build

    ff_smem = _build.function("geglu_sm90", "sd_geglu_fwd_sm90_smem", [ctypes.c_int])
    gemm_smem = _build.function("cross_attention_sm90", "sd_crossattn_gemm_sm90_smem", [])
    attend_smem = _build.function("cross_attention_sm90", "sd_crossattn_sm90_smem",
                                  [ctypes.c_int] * 3)
    out = {}
    patterns = {"geglu_sm90": r"geglu_sm90_kernelILi(\d+)E",
                "xattn_gemm": r"xattn_gemm_kernel",
                "xattn_attend": r"xattn_attend_kernelILi(\d+)ELi(\d+)E"}
    for lib, kinds in (("geglu_sm90", ("geglu_sm90",)),
                       ("cross_attention_sm90", ("xattn_gemm", "xattn_attend"))):
        log = (_build.build_dir() / f"{lib}.log").read_text()
        for kind in kinds:
            found = ptxas_report(log, lambda n, kind=kind: re.search(patterns[kind], n))
            for mangled, (regs, st, ld) in found.items():
                m = re.search(patterns[kind], mangled)
                if kind == "geglu_sm90":
                    name, smem = f"geglu_sm90<{m.group(1)}>", ff_smem(int(m.group(1)))
                elif kind == "xattn_gemm":
                    name, smem = "xattn_gemm", gemm_smem()
                else:   # the attention at head dim 160 (the largest UNet one)
                    mp, nwg = int(m.group(1)), int(m.group(2))
                    name, smem = f"xattn_attend<{mp}, {nwg}>", attend_smem(64 * nwg, mp, 160)
                out[name] = {"registers": regs, "spill_stores": st, "spill_loads": ld,
                             "smem_bytes": smem}
                if kind == "geglu_sm90":   # the registers at entry; setmaxnreg moves them
                    out[name]["setmaxnreg"] = {"producer": 40, "consumers": 232}
    spills = {k: v for k, v in out.items() if v["spill_stores"] or v["spill_loads"]}
    require(not spills, f"the Hopper GEGLU and cross-attention kernels spill: {spills}")
    return out


def pipe_gn_report() -> dict:
    """Registers, spills and dynamic shared memory of the pipelined sweep's
    instantiations at the path's head dims (40 → 48, 80; `pipe<DP, nwg>`
    and the exponential) and of the Hopper GroupNorm (its shared memory at
    each opt-in shape's plan, the C entry point's against `gn_plan`'s), from
    the build's logs; raises on a spill or a wgmma serialization warning
    (ptxas C7515) in either source."""
    import ctypes
    import re

    from sd_tpu_torch.kernels import _build, groupnorm as gn

    out = {}
    pipe_smem = _build.function("flash_attention_sm90", "sd_flash_fwd_sm90_pipe_smem",
                                [ctypes.c_int])
    gn_smem = _build.function("groupnorm_sm90", "sd_group_norm_sm90_smem", [ctypes.c_int] * 4)
    pattern = r"flash_fwd_sm90_pipe_kernelILi(\d+)ELb([01])E"
    for lib, keep in (("flash_attention_sm90", lambda n: re.search(pattern, n)),
                      ("groupnorm_sm90", lambda n: "gn_sm90_kernel" in n)):
        log = (_build.build_dir() / f"{lib}.log").read_text()
        serialized = [line for line in log.splitlines()
                      if "C7515" in line or ("wgmma" in line and "serializ" in line)]
        require(not serialized, f"{lib}: wgmma serialized: {serialized}")
        for mangled, (regs, st, ld) in ptxas_report(log, keep).items():
            m = re.search(pattern, mangled)
            if m is None:
                name = "group_norm_sm90" + (" silu" if "ILb1E" in mangled else "")
                row = {"registers": regs, "spill_stores": st, "spill_loads": ld}
            elif int(m.group(1)) in (48, 80):
                # warpgroups a block: three at d <= 48, one block an SM (pipe_nwg)
                dp = int(m.group(1))
                name = f"pipe<{dp}>" + (" exp_bf16" if m.group(2) == "1" else "")
                row = {"registers": regs, "spill_stores": st, "spill_loads": ld,
                       "warpgroups": 3 if dp <= 48 else 2, "smem_bytes": pipe_smem(dp)}
            else:
                row = None
            require(not (st or ld), f"{lib}: {mangled} spills {st} / {ld} bytes")
            if row:
                out[name] = row
    plans = {}
    for (B, S, C), n in zip(GN_SHAPES, GN_LAUNCHES):
        p = gn.gn_plan(B, S, C, 32)
        require(gn_smem(C, 32, p.cs, p.rows) == p.smem, f"gn_plan's shared memory at {B, S, C}")
        plans[f"{B}x{S}x{C}"] = p._asdict()
    out["group_norm_plans"] = plans
    return out


def gn_conv_report() -> dict:
    """Registers, spills and dynamic shared memory of the fused GroupNorm →
    SiLU → 3×3 conv's kernels (`conv2d_gn_sm90.cu`: the conv with its
    prologue, the weights' pre-pass, the statistics pass's partials and
    finalize launches), from the build's log; raises on a spill, a wgmma
    serialization warning (ptxas C7515) or a statistics grid other than
    `gn_stats_plan`'s."""
    import ctypes

    from sd_tpu_torch.kernels import _build, conv2d

    log = (_build.build_dir() / "conv2d_gn_sm90.log").read_text()
    serialized = [line for line in log.splitlines()
                  if "C7515" in line or ("wgmma" in line and "serializ" in line)]
    require(not serialized, f"conv2d_gn_sm90: wgmma serialized: {serialized}")
    names = {"conv3x3_sm90_kernelILb1E": "conv3x3_sm90 pro",
             "pack_weights_kernel": "pack_weights", "gnc_partials_kernel": "gn_stats partials",
             "gnc_finalize_kernel": "gn_stats finalize"}
    out = {}
    for mangled, (regs, st, ld) in ptxas_report(
            log, lambda n: any(k in n for k in names)).items():
        name = next(v for k, v in names.items() if k in mangled)
        out[name] = {"registers": regs, "spill_stores": st, "spill_loads": ld}
        require(not (st or ld), f"conv2d_gn_sm90: {mangled} spills {st} / {ld} bytes")
    require(set(out) == set(names.values()), f"conv2d_gn_sm90's kernels: {sorted(out)}")
    out["conv3x3_sm90 pro"]["smem_bytes"] = _build.function(
        "conv2d_gn_sm90", "sd_gn_silu_conv3x3_fwd_sm90_smem", [])()
    # the statistics pass's grid: the C entry point's against `gn_stats_plan`'s
    blocks = _build.function("conv2d_gn_sm90", "sd_gn_stats_sm90_blocks", [ctypes.c_int] * 2)
    for B, H, W, C, O in [(b, h, h, c, o) for b, h, c, o in DECODER_CONVS] + GN_CONV_RAGGED:
        require(blocks(H * W, C) == conv2d.gn_stats_plan(H * W, C, 32).blocks,
                f"gn_stats_plan's blocks at {H * W} pixels, C = {C}")
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
    # before the "flash_bwd_dq" key below, which would swallow these
    if "flash_bwd_dq_sm90_kernel" in name:
        return "flash dQ, Hopper (port)"
    if "flash_bwd_dkv_sm90_kernel" in name:
        return "flash dK/dV, Hopper (port)"
    if "flash_bwd_dq_wide_sm90_kernel" in name:
        return "flash dQ, wide Hopper (port)"
    if "flash_bwd_dkv_wide_sm90_kernel" in name:
        return "flash dK/dV, wide Hopper (port)"
    if "flash_fwd_sm90_pipe_kernel<" in name:
        return "flash Hopper pipelined forward (port)"
    if "gn_sm90_kernel" in name:
        return "groupnorm, Hopper (port)"
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
    if "geglu_sm90_kernel" in name:
        return "geglu, Hopper (port)"
    if "xattn_gemm_kernel" in name:
        return "cross-attention projections, Hopper (port)"
    if "xattn_attend_kernel" in name:
        return "cross-attention, Hopper (port)"
    if "conv3x3_sm90_kernel<true>" in name:
        return "GN-SiLU-conv3x3 Hopper (port)"
    if "gnc_partials_kernel" in name or "gnc_finalize_kernel" in name:
        return "GN-SiLU-conv3x3 statistics, Hopper (port)"
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


def phase_profile(pipe, prompts, optin: bool = False) -> dict:
    """Where one generate's time goes (`--profile`): the layers' times from
    CUDA events, and device time by kernel family from torch.profiler over
    a whole 50-step generate, against its wall time; with `optin`, under the
    opt-in switches. Returns the row it prints."""
    with switches(OPT_IN if optin else {}):
        return _profile_generate(pipe, prompts, "generate (opt-in)" if optin else "generate")


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


def _profile_generate(pipe, prompts, of: str) -> dict:
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
    row = {"phase": "profile", "of": of, "layers": layers, **_device_breakdown(prof, wall)}
    emit(row)
    return row


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
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          **host_libraries()})

    from sd_tpu_torch.kernels import _build
    from sd_tpu_torch.kernels.flash_attention import launch_name as fa_launch_name

    t0 = time.perf_counter()
    per_lib = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library": per_lib,
          "wide_flash_registers": wide_flash_registers(),
          "flash_variant_registers": variant_flash_registers(),
          "flash_fwd_smem_bytes": flash_smem(),
          "flash_bwd_sm90": bwd_sm90_report(),
          "flash_bwd_wide_sm90": bwd_wide_sm90_report(),
          "ff_xattn_sm90": ff_xattn_report(),
          "pipe_gn_sm90": pipe_gn_report(),
          "gn_conv_sm90": gn_conv_report(),
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
    launches, pipe, prompts, images, e2e_seconds = phase_e2e()
    launches_optin = phase_e2e_optin(pipe, prompts, images)
    launches_serve, grouped = phase_serve(pipe, smi)
    launches_switches = phase_switch_combinations(pipe)
    profiling = "--profile" in sys.argv[1:]
    gn_profile_ms = None
    if profiling:
        phase_profile(pipe, prompts)
        gn_profile_ms = phase_profile(pipe, prompts, optin=True)["families_ms"].get(
            "groupnorm, Hopper (port)", 0.0)
        phase_profile_serve(pipe, grouped)
    del pipe
    torch.cuda.empty_cache()
    phase_train_parity()
    train = phase_train()
    if profiling:
        phase_train_profile()
    phase_klvae_parity()
    klvae = phase_klvae_train()
    phase_ddpm_parity()
    phase_ddpm_train()
    phase_vq_parity()
    vq = phase_vq_train()
    train_run = phase_train_run(smi)
    image_edit = phase_image_edit(smi)
    adapters = phase_adapters(smi)
    few_step = phase_few_step(smi, e2e_seconds)
    fine_tune = phase_fine_tune(smi)
    super_resolution = phase_super_resolution(smi)
    codec_attention = phase_codec_attention(smi)
    model_families = phase_model_families(smi)
    training_options = phase_training_options(smi)
    bench_serve_launches, bench_pipe = phase_bench_serve(smi)
    eval_tools = phase_eval_tools(smi, bench_pipe)
    del bench_pipe
    torch.cuda.empty_cache()
    parallel = phase_parallel(smi)
    if profiling:
        phase_trainer_profiles()

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
               # the backward: its rows are train_kl_vae's d = 512 (the wide
               # Hopper kernels); the route counters take their own shapes,
               # train_ldm's d <= 128 and train_kl_vae's d = 512
               "flash_bwd_dq": (src + "flash_attention_bwd_wide_sm90.cu",
                                tpu + "flash_attention.py:465"),
               "flash_bwd_dkv": (src + "flash_attention_bwd_wide_sm90.cu",
                                 tpu + "flash_attention.py:511"),
               "flash_bwd_dq_sm90": (src + "flash_attention_bwd_sm90.cu",
                                     tpu + "flash_attention.py:465"),
               "flash_bwd_dkv_sm90": (src + "flash_attention_bwd_sm90.cu",
                                      tpu + "flash_attention.py:511"),
               "flash_bwd_dq_wide_sm90": (src + "flash_attention_bwd_wide_sm90.cu",
                                          tpu + "flash_attention.py:465"),
               "flash_bwd_dkv_wide_sm90": (src + "flash_attention_bwd_wide_sm90.cu",
                                           tpu + "flash_attention.py:511"),
               "geglu_ff": (src + "geglu_sm90.cu", tpu + "geglu.py:48"),
               "conv3x3_same": (src + "conv2d_sm90.cu", tpu + "conv2d.py:30"),
               "gn_silu_conv3x3": (src + "conv2d_gn_sm90.cu",
                                   tpu + "conv2d.py:38, _gn_stats_affine :297"),
               "group_norm": (src + "groupnorm_sm90.cu", tpu + "groupnorm.py:31"),
               # the pipelined sweep at head dims up to 128 (its row: [8, 4096,
               # 8, 40], the UNet's level 0 under SD_TPU_ATTN_HPACKED=0 at the
               # switch combination's batch, where its launches run)
               "flash_fwd_sm90_pipe": (src + "flash_attention_sm90.cu",
                                       tpu + "flash_attention.py:123"),
               "crossattn_kv": (src + "cross_attention_sm90.cu",
                                tpu + "cross_attention.py:41")}
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
    # (the fused conv's statistics pass, unfused yardsticks and the port's pair)
    gn_conv_keys = ("stats_rel_err", "stats_same_bits_as_plain", "stats_ms", "stats_device_ms",
                    "stats_bound_ms", "unfused_device_ms", "pair_ms", "pair_device_ms")
    keys = ("shape", "name", "how", "max_abs_err", "ms", "generic_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_op", "library_ms", "kv_tile", "device_ms", "generic_device_ms",
            "library_device_ms", "serial_ms", "serial_device_ms", "unfused_ms", "split", "plan",
            *gn_conv_keys)
    for counter in ROUTE_COUNTERS:
        rows_ = hopper_rows[counter] + hopper_variant_rows[counter]
        table[counter] = {**rows_[0], "other_shapes": [
            {k: r[k] for k in keys if k in r} for r in rows_[1:]]}
    # the conv's row: its largest decoder shape, with the other shapes (and
    # conv2d.cu's time beside each)
    # ... and GEGLU's and the cross-attention's: the largest main-path shape,
    # with the other shapes (the ragged case among them)
    # ... and GroupNorm's, with its bound summed over the launches of one
    # opt-in generate (and, under --profile, its measured device time there)
    # ... and the fused GroupNorm → SiLU → conv's (its largest decoder shape)
    for name in ("conv3x3_same", "geglu_ff", "crossattn_kv", "group_norm", "gn_silu_conv3x3"):
        table[name]["other_shapes"] = [
            {k: r[k] for k in keys if k in r} for r in hopper_rows[name]
            if r["shape"] != table[name]["shape"]]
    gn_rows = {tuple(r["shape"][:3]): r for r in hopper_rows["group_norm"]
               if r["shape"][3:] == [32, 1e-5, None]}
    table["group_norm"]["per_generate"] = {
        "launches_by_shape": [[list(s), n] for s, n in zip(GN_SHAPES, GN_LAUNCHES)],
        "bound_ms": sum(n * gn_rows[s]["bound_ms"] for s, n in zip(GN_SHAPES, GN_LAUNCHES))}
    if gn_profile_ms is not None:
        # measured: the Hopper GroupNorm's device time in the profiled opt-in generate
        table["group_norm"]["per_generate"]["profile_device_ms"] = gn_profile_ms
    # the flash training kernels (rows 4-6) run on two paths: their row is
    # train_kl_vae's shape and launches, with train_ldm's beside them; the
    # training forward's route counters each take their own shapes
    device_keys = ("device_ms", "generic_device_ms", "library_device_ms")
    # SDPA on the default dispatch and pinned (the library keys are the faster's),
    # and the Hopper backward at the other rows per block
    sdpa_keys = ("library_default", "library_pinned")
    rows_keys = ("rows", "alt_rows", "alt_rows_ms", "alt_rows_device_ms", "split")
    train_keys = ("shape", "route", "kv_split", "max_abs_err", "lse_abs_err", "ms", "generic_ms",
                  "plain_ms", "bound_ms", "bound_by", "bound_op", "library_ms",
                  "library_backend", *device_keys, *sdpa_keys, *rows_keys)
    # SDPA computes dQ, dK and dV together: its backward stands on both rows
    lse_rows = train_rows["flash_attention_lse"]
    for route, counter in LSE_ROUTE_COUNTER.items():
        train_rows[counter] = {s_: r for s_, r in lse_rows.items() if r["route"] == route}
    for (part, route), counter in BWD_ROUTE_COUNTER.items():
        train_rows[counter] = {s_: r for s_, r in train_rows["flash_bwd_" + part].items()
                               if r["route"] == route}
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
             "flash_bwd_dq_sm90": ("train_ldm", train["launches"]),
             "flash_bwd_dkv_sm90": ("train_ldm", train["launches"]),
             "flash_bwd_dq_wide_sm90": ("train_kl_vae", klvae["launches"]),
             "flash_bwd_dkv_wide_sm90": ("train_kl_vae", klvae["launches"]),
             "flash_attention_pipelined": ("generate, opt-in", launches_optin),
             "group_norm": ("generate, opt-in", launches_optin),
             "crossattn_kv": ("generate, opt-in", launches_optin),
             "gn_silu_conv3x3": ("none: not wired, as in sd_tpu", launches_optin)}
    for name in launches_switches:
        env = next(e for e, _, names in SWITCH_COMBINATIONS if name in names)
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
        for key in ("generic_ms", "other_shapes", "kv_tile", *device_keys, "unfused_ms",
                    "route_counter", "split", "plan", "serial_ms", "serial_device_ms",
                    "per_generate", *gn_conv_keys):
            if key in r:
                row[key] = r[key]
        if name == "conv3x3_same":
            row["launches_by_shape"] = [[list(c), n] for c, n in zip(DECODER_CONVS,
                                                                     DECODER_CONV_LAUNCHES)]
        if name in train_rows:
            row.update(launches_by_path={"train_kl_vae": klvae["launches"][name],
                                         "train_ldm": train["launches"][name],
                                         "train_vq": vq["launches"][name]},
                       launches_per_step={"train_kl_vae": klvae["launches_per_step"][name],
                                          "train_ldm": train["launches_per_step"][name],
                                          "train_vq": vq["launches_per_step"][name]},
                       library_backend=r["library_backend"], other_shapes=r["other_shapes"],
                       **{k: r[k] for k in (*sdpa_keys, *rows_keys) if k in r})
        # the train_run phase's launches of this kernel, by stage
        runs = {stage: counts[name] for stage, counts in train_run.items() if counts[name]}
        if runs:
            row["train_run_launches"] = runs
        # ... and the image_edit phase's, by entry point
        edits = {entry: counts[name] for entry, counts in image_edit.items()
                 if counts.get(name)}
        if edits:
            row["image_edit_launches"] = edits
        # ... and the adapters phase's
        steered = {entry: counts[name] for entry, counts in adapters.items()
                   if counts.get(name)}
        if steered:
            row["adapters_launches"] = steered
        # ... and the few_step phase's
        few = {entry: counts[name] for entry, counts in few_step.items() if counts.get(name)}
        if few:
            row["few_step_launches"] = few
        # ... and the fine_tune phase's, by run and served check
        tuned = {entry: counts[name] for entry, counts in fine_tune.items()
                 if counts.get(name)}
        if tuned:
            row["fine_tune_launches"] = tuned
        # ... and the super_resolution, codec_attention, model_families,
        # training_options, bench_serve and eval_tools phases', where not 0
        for phase, by_entry in (("super_resolution", super_resolution),
                                ("codec_attention", codec_attention),
                                ("model_families", model_families),
                                ("training_options", training_options),
                                ("bench_serve", bench_serve_launches),
                                ("eval_tools", eval_tools)):
            moved = {entry: counts[name] for entry, counts in by_entry.items()
                     if counts.get(name)}
            if moved:
                row[f"{phase}_launches"] = moved
        # ... and every rank's of the parallel phase's runs (0 where none)
        row["parallel_launches"] = {run: {rank: counts.get(name, 0)
                                          for rank, counts in by_rank.items()}
                                    for run, by_rank in parallel.items()}
        rows.append(row)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(tp_rank() if "--tp-rank" in sys.argv else main())
