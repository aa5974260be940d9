"""GroupNorm over [B, S, C]: hand-written CUDA kernels and their plain
PyTorch version. `group_norm` launches `csrc/groupnorm_sm90.cu` (one launch
a call: the tile of x in shared memory by TMA, a group's statistics summed
across a thread-block cluster in rank order), with the
grid `gn_plan` decides from the shape; `csrc/groupnorm.cu` (two launches
and a workspace) is its yardstick on the card, `_launch_gn(...,
source="template")`.

Counterpart of `sd_tpu/kernels/groupnorm.py` (`group_norm`,
`group_norm_xla`, `group_norm_trainable`, `group_norm_wants_pallas`).
Statistics in fp32 with the variance E[x²] − μ² clamped at 0, an optional
fp32 SiLU epilogue, output in x's dtype. Opt-in, as in the TPU package:
`SD_TPU_PALLAS_GN=1`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build
from sd_tpu_torch.kernels import conv2d
from sd_tpu_torch.kernels.flash_attention import H100_SMS

# what `gn_plan` reads of csrc/groupnorm_sm90.cu: 256 threads a block, one
# 8-channel vector column per thread, clusters of 1, 2, 4 or 8 row blocks,
# TMA boxes of at most 256 channels and 256 rows, and the H100's shared
# memory (227 KB a block; 228 KB an SM, 1 KB of it reserved per block)
GN_THREADS = 256
GN_CLUSTERS = (1, 2, 4, 8)
GN_BOX_MAX = 256
GN_SMEM_MAX = 232448
SM_SMEM = 233472
# `gn_plan`'s aim: about 40 KB of x a block, at least 128 blocks
GN_BLOCK_BYTES = 40960
GN_MIN_BLOCKS = 128
# the yardstick (groupnorm.cu): about two blocks per SM across the batch
_TARGET_BLOCKS = 264


def group_norm_xla(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                   groups: int = 32, eps: float = 1e-5,
                   act: str | None = None) -> torch.Tensor:
    """Plain version with the kernel's numerics (fp32 fast-variance stats,
    clamped at 0; SiLU in fp32 before the cast)."""
    B, S, C = x.shape
    x32 = x.float().reshape(B, S, groups, C // groups)
    mu = x32.mean(dim=(1, 3), keepdim=True)
    var = (x32 * x32).mean(dim=(1, 3), keepdim=True) - mu * mu
    y = (x32 - mu) * torch.rsqrt(var.clamp_min(0.0) + eps)
    y = y.reshape(B, S, C) * scale.float() + bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


class GnPlan(NamedTuple):
    cs: int        # channels of a slice: whole groups, a multiple of 8
    rows: int      # rows of a block (box_r times the row boxes)
    box_c: int     # channels of a TMA box (a multiple of 8 that divides cs)
    box_r: int     # rows of a TMA box
    cluster: int   # row blocks of a (batch row, slice), one cluster
    blocks: int    # blocks of the grid
    smem: int      # dynamic shared memory of a block (bytes)


def _gn_smem(cs: int, cg: int, rows: int) -> int:
    """A block's shared memory (csrc/groupnorm_sm90.cu `gn_smem`): the bf16
    tile, per-lane fp32 sums and squares, per-group partials (16 bytes
    each), per-(group, warp) sums (8 bytes each), per-channel a and c,
    per-group mean and 1/σ, the mbarrier."""
    lanes, gs = GN_THREADS // (cs // 8), cs // cg
    return 2 * rows * cs + 8 * lanes * cs + 16 * gs + GN_THREADS // 4 * gs + 8 * cs + 8 * gs + 8


def gn_plans(B: int, S: int, C: int, G: int) -> list[GnPlan]:
    """Every grid the Hopper kernel takes at [B, S, C] with G groups: a slice
    of whole groups and a multiple of 8 channels (at most one per thread),
    the row blocks of a (batch row, slice) a cluster of 1, 2, 4 or 8 that
    covers S, a block's shared memory within the H100's."""
    if B < 1 or S < 1 or G < 1 or C % 8 or C % G:
        raise ValueError(f"group_norm: kernel takes C % 8 == 0 and C % groups == 0, "
                         f"got B={B}, S={S}, C={C}, groups={G}")
    cg = C // G
    unit = cg * 8 // math.gcd(cg, 8)
    plans = []
    for cs in range(unit, min(C, 8 * GN_THREADS) + 1, unit):
        if C % cs:
            continue
        box_c = 8 * max(d for d in range(1, GN_BOX_MAX // 8 + 1) if (cs // 8) % d == 0)
        for cluster in GN_CLUSTERS:
            rows = _round_up(-(-S // cluster), 8)
            n_rb = -(-rows // GN_BOX_MAX)
            box_r = _round_up(-(-rows // n_rb), 8)
            rows = box_r * n_rb
            smem = _gn_smem(cs, cg, rows)
            if -(-S // rows) == cluster and smem <= GN_SMEM_MAX:
                plans.append(GnPlan(cs, rows, box_c, box_r, cluster, B * (C // cs) * cluster,
                                    smem))
    return plans


def gn_waves(plan: GnPlan) -> int:
    """Waves of the plan's grid over the H100: 132 SMs, as many blocks an SM
    as its shared memory and threads hold."""
    per_sm = min(SM_SMEM // (plan.smem + 1024), 2048 // GN_THREADS)
    return -(-plan.blocks // (H100_SMS * per_sm))


@functools.lru_cache(maxsize=None)
def gn_plan(B: int, S: int, C: int, G: int) -> GnPlan:
    """The Hopper kernel's grid at [B, S, C] with G groups, decided from the
    shape alone on every device, once a shape (a call's host time counts:
    the UNet runs 57 GroupNorms a step). Of `gn_plans`, the fewest waves,
    then the block count nearest (in ratio) to about 40 KB of x a block,
    held between one and two blocks an SM (128..264: fewer leave SMs idle,
    more pay the fixed cost of a block and its cluster for little data),
    then the smaller cluster. Raises on a shape it cannot take."""
    plans = gn_plans(B, S, C, G)
    if not plans:
        raise ValueError(f"group_norm: no tile of whole groups fits in shared memory at "
                         f"B={B}, S={S}, C={C}, groups={G}")
    target = min(max(round(2 * B * S * C / GN_BLOCK_BYTES), GN_MIN_BLOCKS), 2 * H100_SMS)
    return min(plans, key=lambda p: (gn_waves(p), abs(math.log2(p.blocks / target)), p.cluster))


def _gn_tiled_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                  groups: int = 32, eps: float = 1e-5, act: str | None = None,
                  plan: GnPlan | None = None) -> torch.Tensor:
    """Plain version of the Hopper kernel's tiling (`csrc/groupnorm_sm90.cu`)
    under `plan` (`gn_plan`'s by default): each block sums its tile of rows ×
    slice in fp32, rows past S read as zeros; a group's sums are added over
    the cluster's blocks in rank order; y = x·a + c with a = rsqrt(var +
    eps)·scale and c = bias − μ·a per channel, the SiLU in fp32, one
    rounding. The same function as `group_norm_xla` up to the order of its
    fp32 sums."""
    B, S, C = x.shape
    p = plan or gn_plan(B, S, C, groups)
    cg = C // groups
    xp = torch.zeros((B, p.cluster * p.rows, C), dtype=torch.float32, device=x.device)
    xp[:, :S] = x.float()
    # [B, rank, rows, slice, group of the slice, channel of the group]
    tiles = xp.view(B, p.cluster, p.rows, C // p.cs, p.cs // cg, cg)
    part1, part2 = tiles.sum(dim=(2, 5)), (tiles * tiles).sum(dim=(2, 5))
    s1, s2 = part1[:, 0], part2[:, 0]
    for rank in range(1, p.cluster):
        s1, s2 = s1 + part1[:, rank], s2 + part2[:, rank]
    cnt = float(S * cg)
    mu = (s1 / cnt).reshape(B, groups)
    var = torch.clamp((s2 / cnt).reshape(B, groups) - mu * mu, min=0.0)
    a = torch.rsqrt(var + eps).repeat_interleave(cg, dim=1) * scale.float()
    c = bias.float() - mu.repeat_interleave(cg, dim=1) * a
    y = x.float() * a[:, None] + c[:, None]
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _chunks(B: int, S: int) -> tuple[int, int]:
    """(rows per chunk, chunks) for the yardstick's (chunks, B) grid."""
    want = max(1, min(S, -(-_TARGET_BLOCKS // B)))
    rows = -(-S // want)
    return rows, -(-S // rows)


def _launch_gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, act: str | None, source: str = "sm90") -> torch.Tensor:
    """One GroupNorm on the card: the Hopper kernel (`source="sm90"`, the
    grid `gn_plan` picks) or the yardstick (`"template"`,
    groupnorm.cu: a statistics launch into a workspace, then a normalize
    launch). Checks what both take and raises on anything else."""
    B, S, C = x.shape
    if C % 8 or C % groups:
        raise ValueError(f"group_norm: kernel takes C % 8 == 0 and C % groups == 0, "
                         f"got C={C}, groups={groups}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm: x must be contiguous, 16-byte aligned bfloat16")
    if scale.shape != (C,) or bias.shape != (C,) or scale.dtype != bias.dtype \
            or scale.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_norm: scale and bias must be [{C}] of one dtype, "
                         "float32 or bfloat16")
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm: {name} must be contiguous on {x.device}")
    y = torch.empty_like(x)
    flags = (float(eps), int(act == "silu"), int(scale.dtype == torch.float32))
    ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr())
    if source == "sm90":
        p = gn_plan(B, S, C, groups)
        fn = _build.function("groupnorm_sm90", "sd_group_norm_sm90",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        with _build.on_device(x.device):
            code = fn(*ptrs, B, S, C, groups, p.cs, p.rows, p.box_c, p.box_r, p.cluster, *flags,
                      _build.stream_ptr(x.device))
        _build.check(code, "sd_group_norm_sm90")
        return y
    rows, nchunk = _chunks(B, S)
    part = torch.empty((B, nchunk, groups, 2), dtype=torch.float32, device=x.device)
    fn = _build.function("groupnorm", "sd_group_norm_fwd",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    code = fn(*ptrs, part.data_ptr(), B, S, C, groups, rows, nchunk, *flags,
              _build.stream_ptr(x.device))
    _build.check(code, "sd_group_norm_fwd")
    return y


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm of x [B, S, C] over its channel (last) axis with affine
    scale and bias [C]; output in x's dtype. On the card the Hopper kernel
    (`csrc/groupnorm_sm90.cu`, counted under `group_norm_sm90` beside
    `group_norm`), which takes C % 8 == 0 and whole groups where a tile of
    whole groups fits in shared memory (`gn_plan`; every shape the ≤ 3 MB
    gate of `group_norm_wants_pallas` passes), and raises ValueError on
    anything else; elsewhere the plain version. Forward only: on
    the card an input that needs a gradient raises."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: act must be None or 'silu', got {act!r}")
    if not x.is_cuda:
        return group_norm_xla(x, scale, bias, groups=groups, eps=eps, act=act)
    kernels.refuse_grad("group_norm", x, scale, bias)
    y = _launch_gn(x, scale, bias, groups, eps, act)
    kernels.LAUNCHES["group_norm"] += 1
    kernels.LAUNCHES["group_norm_sm90"] += 1
    return y


def group_norm_trainable(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int = 32, eps: float = 1e-5,
                         act: str | None = None) -> torch.Tensor:
    """`group_norm` for inference, the plain version (autograd's own forward
    and backward) when a gradient is wanted: the TPU package's
    `group_norm_trainable`."""
    if kernels.needs_grad(x, scale, bias):
        return group_norm_xla(x, scale, bias, groups=groups, eps=eps, act=act)
    return group_norm(x, scale, bias, groups=groups, eps=eps, act=act)


def group_norm_wants_pallas(shape: tuple, groups: int,
                            dtype: torch.dtype = torch.bfloat16) -> bool:
    """The TPU gate: opt-in (`SD_TPU_PALLAS_GN=1`), outside a training step,
    the kernel's dtype, channels in whole groups (at least 128), and
    [S, C] slabs of at most 3 MB (the UNet levels; the up-path concats and
    the codec maps stay plain)."""
    if conv2d._TRAIN_CTX_VAR.get():
        return False
    if os.environ.get("SD_TPU_PALLAS_GN", "0") != "1":
        return False
    if dtype != torch.bfloat16:
        return False
    C = shape[-1]
    S = 1
    for d in shape[1:-1]:
        S *= d
    if C < 128 or C % groups != 0:
        return False
    if S < 64 or S % 8 != 0:
        return False
    return S * C * 2 <= 3 * 1024 * 1024
