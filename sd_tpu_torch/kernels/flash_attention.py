"""Flash attention: hand-written CUDA kernels (`csrc/flash_attention_sm90.cu`,
`csrc/flash_attention_sm90_pv8.cu`, `csrc/flash_attention_wide.cu`,
`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`), their plain
PyTorch versions, and the `torch.autograd.Function` that trains through them.

Counterpart of `sd_tpu/kernels/flash_attention.py`. The TPU package has two
forward kernels, `flash_attention` over [B, S, H, D] (transposed to
[B*H, S, D] around the kernel) and `flash_attention_hpacked` over the
projection-native [B, S, H*D]; here one kernel reads both through strides.
`launch_plan` decides which source serves an inference call: the serial
sweep at head dims up to 128 runs `flash_attention_sm90.cu` (route counter
`flash_fwd_sm90`) or, with the int8 PV, `flash_attention_sm90_pv8.cu`
(`flash_fwd_sm90_pv8`); every sweep above 128 (serial, pipelined, int8 PV)
runs `flash_attention_wide.cu` (`flash_fwd_wide`); the pipelined sweep at
head dims up to 128 runs the template of `flash_attention.cu`, whose other
instantiations are only the yardstick the Hopper kernels are timed against.
A route counter counts beside the wrapper's own counter.
`flash_attention` is differentiable, as the TPU package's `jax.custom_vjp`
is: with grad off it runs the inference forward; with grad on, the training
forward that also keeps the base-2 row log-sum-exp (the Hopper forwards'
`LSE` epilogue, `lse_route`: `flash_attention_sm90.cu` up to head dim 128,
route counter `flash_lse_sm90`, `flash_attention_wide.cu` above,
`flash_lse_wide`), and a backward of a dQ
kernel (which writes delta = rowsum(dO∘O)) then a dK/dV kernel, at every
head dim the forward takes (multiples of 8 up to 512: the SD UNet's 40-160
and the codec's single-head 512). Non-causal only. With
`SD_TPU_FLASH_BWD=chunked` (any value but "pallas", as in the TPU package)
the training forward is the inference forward and the backward a plain
chunked recompute (`_bwd_chunked_ref`): no LSE, dQ or dK/dV kernel runs.
`flash_attention_hpacked` is inference-only, as on the TPU. With
`SD_TPU_FLASH_PIPE=1` (opt-in, as in the TPU package) the inference launch of
`flash_attention` runs the software-pipelined kv sweep, which gives the same
bits; the head-packed and training kernels never do.

The inference forwards take the TPU kernels' two variants:
`softmax_dtype=torch.bfloat16` (the softmax exponential in bf16, as
`jnp.exp2` computes it on a bf16 operand) and `pv_quant="int8"` (the PV
product of each kv tile on int8 codes, `_pv_int8`). The pipelined sweep
keeps the first and drops the second, as `_flash_attention_bhsd` does; the
training path ignores both. Their plain version is a tiled online-softmax
sweep (`_flash_tiled_ref`) that takes the kv tile: the int8 codes depend on
it. The wrappers hand both the plain version and the CUDA kernel the TPU
package's kv tile (`_tpu_block_k`, `_tpu_hpacked_block_k`), so the int8
codes on the card are `sd_tpu`'s. On the card the int8 PV runs a pre-pass
launch that writes V's column scales and codes once per kv tile, in the
order the kernels read them (`_v_codes_ref` is its plain version and
`_flash_codes_ref` the sweep through its codes).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30


def _xla_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> torch.Tensor:
    """Plain attention with the kernel's numerics: fp32 logits and softmax,
    probabilities cast to the input dtype before the fp32-accumulated p·v."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp2` as XLA lowers it: exp(x · ln 2) with ln 2 and the product
    rounded to x's dtype (in bf16 the constant is 0.69140625), the
    exponential in fp32 (XLA keeps that precision where the result is read
    in fp32, as every use in the sweep reads it)."""
    return torch.exp((x * torch.tensor(LN2, dtype=x.dtype, device=x.device)).float())


def _pv_int8(p: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU package's int8 PV of one kv tile: p [B, H, Sq, bk] fp32 in
    [0, 1], v [B, bk, H, D]. Returns (pv [B, H, Sq, D] fp32, row sums of the
    quantized p [B, H, Sq, 1]): p_i8 = trunc(p·127 + 0.5), per head-dim
    column vs = max|v| / 127 and v_i8 = round-half-even(v / max(vs, 1e-30)),
    pv = (p_i8 · v_i8) · vs / 127. The integer products are summed in fp32,
    exactly: |p_i8 · v_i8| ≤ 127², so every partial sum over a tile of up to
    1024 rows stays an integer below 2^24."""
    if p.shape[-1] > 1024:
        raise ValueError(f"int8 PV: a kv tile of {p.shape[-1]} rows is not summed exactly")
    p_i8 = (p * 127.0 + 0.5).to(torch.int8)
    p_sum = p_i8.float().sum(dim=-1, keepdim=True) / 127.0
    v32 = v.float()
    vs = v32.abs().amax(dim=1, keepdim=True) / 127.0                # [B, 1, H, D]
    v_i8 = torch.round(v32 / torch.clamp(vs, min=1e-30)).to(torch.int8)
    pv = torch.einsum("bhqk,bkhd->bhqd", p_i8.float(), v_i8.float())
    return pv * (vs / 127.0).permute(0, 2, 1, 3), p_sum


def _flash_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, block_k: int,
                     softmax_dtype: torch.dtype = torch.float32,
                     pv_quant: str = "none", pipelined: bool = False) -> torch.Tensor:
    """Plain version of the inference forward with its variants: the TPU
    kernel's online-softmax sweep over kv tiles of `block_k` rows, q
    [B, Sq, H, D], k/v [B, Skv, H, D]. Base-2 logits in fp32, p =
    exp2((s − m_new) in `softmax_dtype`), corr = exp2(m_prev − m_new) in
    fp32; p cast to v's dtype for the PV product, or both quantized per tile
    with `pv_quant="int8"`; the output divided by max(l, 1e-30). The
    pipelined sweep stores p in `softmax_dtype` between its two halves, so
    its PV reads the rounded exponential (`pipelined=True`)."""
    B, Sq, H, D = q.shape
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    qf = q.float()
    for j0 in range(0, k.shape[1], block_k):
        kt, vt = k[:, j0:j0 + block_k], v[:, j0:j0 + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt.float()) * (scale * LOG2E)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = _exp2((s - m_new).to(softmax_dtype))
        corr = _exp2(m - m_new)
        if pv_quant == "int8":
            pv, p_sum = _pv_int8(p.float(), vt)
        else:
            p_pv = p.to(softmax_dtype) if pipelined else p
            pv = torch.einsum("bhqk,bkhd->bhqd", p_pv.to(v.dtype).float(), vt.float())
            p_sum = p.float().sum(dim=-1, keepdim=True)
        l = corr * l + p_sum
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _perm16() -> torch.Tensor:
    """Byte p of each 16-row kv group of the int8 V codes holds kv row
    perm16(p) (`csrc/sm90.cuh`): the order in which a thread finds its P
    values in the fp32 accumulator (columns 2t, 2t + 1, 8 + 2t, 9 + 2t), so
    the kernels pack P into the int8 A fragment with no shuffle."""
    p = torch.arange(16)
    return ((p & 2) << 2) | ((p >> 2) << 1) | (p & 1)


def _padded_dim(d: int) -> int:
    """The head dim a kernel tiles: a multiple of 16 up to 128, else 256 or 512."""
    return _round_up(d, 16) if d <= 128 else 256 if d <= 256 else 512


def _v_codes_ref(v: torch.Tensor, block_k: int, dp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the int8 PV pre-pass over v [B, Skv, H, D], per kv
    super-tile of `block_k` rows (`_pv_int8`'s V half): (codes, vmul).
    codes [B·H, ⌈Skv/T⌉·T/16, dp, 16] int8: for each 16-row kv group and
    head-dim column, v_i8 = round-half-even(v / max(vs, 1e-30)) of the
    group's rows in `_perm16` order, zeros past Skv and past D; vmul
    [B·H, ⌈Skv/T⌉, dp] fp32: vs / 127 with vs = max|v| / 127 per column of
    the super-tile, 0 past D."""
    B, skv, H, D = v.shape
    n_st = -(-skv // block_k)
    vp = torch.zeros(B, n_st * block_k, H, dp, dtype=torch.float32, device=v.device)
    vp[:, :skv, :, :D] = v.float()
    vp = vp.permute(0, 2, 1, 3).reshape(B * H, n_st, block_k, dp)
    vs = vp.abs().amax(dim=2) / 127.0                                   # [BH, n_st, dp]
    codes = torch.round(vp / torch.clamp(vs, min=1e-30)[:, :, None]).to(torch.int8)
    codes = codes.reshape(B * H, n_st * block_k // 16, 16, dp)[:, :, _perm16().to(v.device)]
    return codes.transpose(2, 3).contiguous(), vs / 127.0


def _flash_codes_ref(q: torch.Tensor, k: torch.Tensor, codes: torch.Tensor,
                     vmul: torch.Tensor, scale: float, block_k: int,
                     softmax_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`_flash_tiled_ref`'s int8 sweep with V's half taken from the pre-pass
    (`_v_codes_ref`): each super-tile's p_i8 is put in the codes' permuted
    row order and contracted with them, as the kernels do. The integer sums
    are exact, so the output is the tiled sweep's."""
    B, Sq, H, D = q.shape
    n_st, dp = vmul.shape[1], vmul.shape[2]
    perm = _perm16().to(q.device)
    cod = codes.view(B, H, n_st, block_k // 16, dp, 16).transpose(-1, -2).float()
    cod = cod.reshape(B, H, n_st, block_k, dp)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    qf = q.float()
    for st in range(n_st):
        kt = k[:, st * block_k:(st + 1) * block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt.float()) * (scale * LOG2E)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = _exp2((s - m_new).to(softmax_dtype))
        corr = _exp2(m - m_new)
        p_i8 = (p.float() * 127.0 + 0.5).to(torch.int8).float()
        p_pad = torch.zeros((B, H, Sq, block_k), device=q.device)
        p_pad[..., :kt.shape[1]] = p_i8
        p_perm = p_pad.unflatten(-1, (block_k // 16, 16))[..., perm].flatten(-2)
        pv = torch.einsum("bhqk,bhkd->bhqd", p_perm, cod[:, :, st])[..., :D]
        pv = pv * vmul.view(B, H, n_st, dp)[:, :, st, None, :D]
        l = corr * l + p_i8.sum(dim=-1, keepdim=True) / 127.0
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _flash_hpacked_tiled_ref(q, k, v, heads: int, scale: float, block_k: int,
                             softmax_dtype: torch.dtype = torch.float32,
                             pv_quant: str = "none") -> torch.Tensor:
    """`_flash_tiled_ref` over projection-native [B, S, H·D] tensors."""
    b, sq, hd = q.shape
    split = lambda x: x.unflatten(2, (heads, hd // heads))
    return _flash_tiled_ref(split(q), split(k), split(v), scale, block_k,
                            softmax_dtype, pv_quant).reshape(b, sq, hd)


def _flash_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain training forward: (o [B, Sq, H, D] in q's dtype, lse2 [B, H, Sq]
    fp32), lse2 the base-2 log-sum-exp of the logits times scale·log2(e)."""
    s2 = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype).float(), v.float())
    return out.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _p_ds(q, k, v, lse, do, delta, scale: float):
    """p recomputed from lse2 (0 on rows whose lse2 is NEG_INF) and
    dS = p∘(dO·vᵀ − delta), both [B, H, Sq, Skv] fp32."""
    s2 = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    lse_ = lse[..., None]
    p = torch.where(lse_ > NEG_INF / 2, torch.exp2(s2 - lse_), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _flash_bwd_dq_ref(q, k, v, o, lse, do, scale: float):
    """Plain dQ with the kernel's numerics: (dq, delta), delta = rowsum(dO∘O)
    [B, H, Sq] fp32; dS cast to K's dtype before dS·K, fp32 accumulation."""
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    _, ds = _p_ds(q, k, v, lse, do, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), delta


def _flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale: float):
    """Plain dK/dV with the kernel's numerics: p cast to dO's dtype before
    pᵀ·dO and dS to Q's dtype before dSᵀ·Q, fp32 accumulation."""
    p, ds = _p_ds(q, k, v, lse, do, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_ref(q, k, v, o, lse, do, scale: float):
    """Plain backward of the training forward: (dq, dk, dv, delta)."""
    dq, delta = _flash_bwd_dq_ref(q, k, v, o, lse, do, scale)
    return (dq, *_flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale), delta)


def _bwd_chunked_ref(q, k, v, g, scale: float, block_q: int = 1024):
    """The TPU package's `_bwd_chunked`: (dq, dk, dv) recomputed over q
    chunks of min(block_q, 512, Sq) rows, softmax in fp32 from the logits,
    dS and p cast to the inputs' dtype before their products, dK and dV
    summed in fp32 over the chunks; a ragged Sq takes the gradient of the
    plain attention instead."""
    sq = q.shape[1]
    chunk = min(block_q, 512, sq)
    if sq % chunk:
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(_xla_ref(*qkv, scale), qkv, g)
    kf, vf = k.float(), v.float()
    dk, dv, dqs = torch.zeros(k.shape, device=k.device), torch.zeros(v.shape, device=v.device), []
    for i0 in range(0, sq, chunk):
        qi, gi = q[:, i0:i0 + chunk], g[:, i0:i0 + chunk]
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qi.float(), kf) * scale, dim=-1)
        dp = torch.einsum("bqhd,bkhd->bhqk", gi.float(), vf)
        ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True))).to(q.dtype).float()
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype))
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qi.float()) * scale
        dv += torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), gi.float())
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash attention: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"flash attention: {name} needs unit stride along D "
                         f"and strides that are multiples of 8, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} must be 16-byte aligned")


def _check_views(q, k, *rest):
    """Shapes, head dim, device, dtype and strides of bf16 [B, S, H, D] views
    (`rest` are (tensor, name, like), `like` the view whose shape it has)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, D) or any(t.shape != like.shape for t, _, like in rest):
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, "
                         + ", ".join(f"{n} {tuple(t.shape)}" for t, n, _ in rest))
    if D % 8 or D > 512:
        raise ValueError(f"flash attention: head dim {D} must be a multiple "
                         f"of 8 and at most 512")
    devs = {q.device, k.device} | {t.device for t, _, _ in rest}
    if len(devs) != 1:
        raise ValueError(f"flash attention: tensors on {devs}")
    for t, name in ((q, "q"), (k, "k"), *((t, n) for t, n, _ in rest)):
        _check(t, name)
    return B, Sq, Skv, H, D


def _check_rows(t: torch.Tensor, name: str, B: int, H: int, Sq: int,
                device: torch.device) -> None:
    """A per-row statistic (lse2, delta): contiguous [B, H, Sq] fp32."""
    if (t.shape != (B, H, Sq) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"flash attention: {name} must be contiguous fp32 "
                         f"{(B, H, Sq)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


_FWD_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float])
# ... with the int8 PV's two scratch pointers after the four tensors
_FWD_PV8_ARGS = _FWD_ARGS[:4] + [ctypes.c_void_p] * 2 + _FWD_ARGS[4:]


# the route counter of each source an inference call can run on (the
# template, flash_attention.cu, has none: its launches count under their names)
ROUTE_COUNTERS = {"sm90": "flash_fwd_sm90", "sm90_pv8": "flash_fwd_sm90_pv8",
                  "wide": "flash_fwd_wide"}


class Plan(NamedTuple):
    """What one inference call launches on the card."""
    name: str          # its launch counter
    route: str         # "sm90" (flash_attention_sm90.cu), "sm90_pv8"
    #                    (flash_attention_sm90_pv8.cu), "wide" (flash_attention_wide.cu)
    #                    or "template" (flash_attention.cu)
    pipelined: bool
    exp_bf16: bool
    pv_int8: bool
    block_k: int       # the TPU package's kv tile: the int8 PV's and the plain sweep's


def launch_plan(sq: int, skv: int, heads: int, d: int, exp_bf16: bool, pv_int8: bool,
                hpacked: bool) -> Plan:
    """The inference launch of a [B, S, H, D] (or head-packed) call, decided
    on every device, so a CPU or meta run makes the card's choice: the
    pipelined sweep where the switch holds ([B, S, H, D] only), which keeps
    the bf16 exponential and drops the int8 PV, as the TPU package's does.
    Above head dim 128 every sweep runs the wide kernel; up to 128 the serial
    sweep runs the Hopper kernel (its int8-PV form with the int8 PV) and the
    pipelined sweep the template."""
    pipelined = not hpacked and flash_pipelined_ok(skv, d)
    pv_int8 = pv_int8 and not pipelined
    base = ("flash_attention_hpacked" if hpacked
            else "flash_attention_pipelined" if pipelined else "flash_attention")
    block_k = (_tpu_hpacked_block_k(sq, skv, heads * d) if hpacked else _tpu_block_k(skv, d))
    route = ("wide" if d > 128 else "template" if pipelined
             else "sm90_pv8" if pv_int8 else "sm90")
    return Plan(launch_name(base, exp_bf16, pv_int8), route, pipelined, exp_bf16, pv_int8,
                block_k)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            scale: float, plan: Plan) -> None:
    """Run the inference kernel `plan` names over strided [B, S, H, D] views
    (out written in place) and count it. It has no backward: an input that
    needs a gradient raises."""
    kernels.refuse_grad("flash attention forward", q, k, v)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (out, "out", q))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq, Skv, D,
            _strides(q, k, v, out), float(scale) * LOG2E)
    stream = _build.stream_ptr(q.device)
    if plan.route == "sm90":
        fn = _build.function("flash_attention_sm90", "sd_flash_fwd_sm90",
                             _FWD_ARGS + [ctypes.c_int, ctypes.c_void_p])
        _build.check(fn(*args, int(plan.exp_bf16), stream), "sd_flash_fwd_sm90")
    elif plan.route in ("sm90_pv8", "wide"):
        # the int8 PV's scratch: V's codes and column factors per kv tile,
        # written by the pre-pass launch
        codes = vmul = None
        if plan.pv_int8:
            n_st, dp = -(-Skv // plan.block_k), _padded_dim(D)
            codes = torch.empty((B * H, n_st * plan.block_k // 16, dp, 16), dtype=torch.int8,
                                device=q.device)
            vmul = torch.empty((B * H, n_st, dp), dtype=torch.float32, device=q.device)
        scratch = (codes.data_ptr() if plan.pv_int8 else None,
                   vmul.data_ptr() if plan.pv_int8 else None)
        lead, rest = args[:4], args[4:]
        if plan.route == "sm90_pv8":
            fn = _build.function("flash_attention_sm90_pv8", "sd_flash_fwd_sm90_pv8",
                                 _FWD_PV8_ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            code = fn(*lead, *scratch, *rest, int(plan.exp_bf16), plan.block_k, stream)
        else:
            fn = _build.function("flash_attention_wide", "sd_flash_fwd_wide",
                                 _FWD_PV8_ARGS + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            code = fn(*lead, *scratch, *rest, int(plan.pipelined), int(plan.exp_bf16),
                      int(plan.pv_int8), plan.block_k, stream)
        _build.check(code, "sd_flash_fwd_" + plan.route)
    else:
        # the int8 PV's column scales per kv tile: a pre-pass launch fills them
        scales = (torch.empty((B * H, -(-Skv // plan.block_k), D), dtype=torch.float32,
                              device=q.device) if plan.pv_int8 else None)
        fn = _build.function("flash_attention", "sd_flash_fwd",
                             _FWD_ARGS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        code = fn(*args, int(plan.pipelined), int(plan.exp_bf16), int(plan.pv_int8),
                  plan.block_k, scales.data_ptr() if plan.pv_int8 else None, stream)
        _build.check(code, "sd_flash_fwd")
    if plan.route in ROUTE_COUNTERS:
        kernels.LAUNCHES[ROUTE_COUNTERS[plan.route]] += 1
    kernels.LAUNCHES[plan.name] += 1


def launch_name(base: str, exp_bf16: bool, pv_int8: bool) -> str:
    """The launch counter of an inference flash kernel and its variants."""
    return base + ("_exp_bf16" if exp_bf16 else "") + ("_pv_int8" if pv_int8 else "")


def _variants(softmax_dtype: torch.dtype, pv_quant: str) -> tuple[bool, bool]:
    if softmax_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention: softmax_dtype {softmax_dtype}")
    if pv_quant not in ("none", "int8"):
        raise ValueError(f"flash attention: pv_quant {pv_quant!r}")
    return softmax_dtype == torch.bfloat16, pv_quant == "int8"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tpu_block_k(skv: int, d: int, block_k: int = 1024) -> int:
    """The kv tile of the TPU package's `flash_attention` sweep (its default
    block_k, rounded to 128 lanes, halved down to 512 rows at wide heads)."""
    bk = min(block_k, _round_up(skv, 128))
    while bk * d * 2 > (1 << 19) and bk > 512:
        bk //= 2
    return bk


def _tpu_kv_tiles(skv: int, d: int, block_k: int = 1024) -> int:
    """Kv tiles of the TPU package's `flash_attention` sweep."""
    return -(-skv // _tpu_block_k(skv, d, block_k))


def _tpu_hpacked_block_k(sq: int, skv: int, hd: int, block_q: int = 1024,
                         block_k: int = 1024) -> int:
    """The kv tile of the TPU package's `flash_attention_hpacked` (its
    default blocks under its VMEM caps)."""
    bq, bk = min(block_q, _round_up(sq, 8)), min(block_k, _round_up(skv, 128))
    while bq * hd * 6 > 8 * 1024 * 1024 and bq > 256:
        bq //= 2
    while bk * hd * 4 > 4 * 1024 * 1024 and bk > 256:
        bk //= 2
    while bq * bk > 512 * 1024 and bq > 256:
        bq //= 2
    while bq * bk > 512 * 1024 and bk > 256:
        bk //= 2
    return bk


def flash_pipelined_ok(skv: int, d: int) -> bool:
    """The TPU package's switch in `_flash_attention_bhsd`: opt-in
    (`SD_TPU_FLASH_PIPE=1`) and a kv sweep of at least two of its tiles."""
    return (os.environ.get("SD_TPU_FLASH_PIPE", "0") == "1"
            and _tpu_kv_tiles(skv, d) >= 2)


def use_pallas_bwd() -> bool:
    """The TPU package's `_use_pallas_bwd`: the flash backward kernels
    unless `SD_TPU_FLASH_BWD` names anything but "pallas"."""
    return os.environ.get("SD_TPU_FLASH_BWD", "pallas") == "pallas"


# the route counter of each source the training forward runs on (the
# template, flash_attention.cu, is the yardstick only and has none), and the
# counter of the combine launch of a split sweep
LSE_ROUTE_COUNTERS = {"sm90": "flash_lse_sm90", "wide": "flash_lse_wide"}
LSE_COMBINE_COUNTER = "flash_lse_combine"
# what `lse_split` reads of the wide kernel (`CfgWide`: 64 q rows per block,
# 64 kv rows per step, one block per SM) and the H100's SM count
_WIDE_BQ = _WIDE_BK = 64
H100_SMS = 132
# the C entry point of each training-forward source
_LSE_ENTRY = {"sm90": ("flash_attention_sm90", "sd_flash_fwd_sm90_lse"),
              "wide": ("flash_attention_wide", "sd_flash_fwd_wide_lse"),
              "template": ("flash_attention", "sd_flash_fwd_lse")}


def lse_route(d: int) -> str:
    """The source of the training forward at head dim d, decided from the
    shape alone, so a CPU or meta run makes the card's choice: the Hopper
    forward (`flash_attention_sm90.cu`) up to 128, the wide kernel
    (`flash_attention_wide.cu`) from 129 to 512, with the LSE epilogue."""
    if d <= 0 or d > 512:
        raise ValueError(f"flash attention (training): head dim {d} is not in 1..512")
    return "sm90" if d <= 128 else "wide"


def lse_split(b: int, sq: int, skv: int, h: int, d: int) -> int:
    """Into how many parts the training forward splits each row's kv sweep,
    decided from the shape alone on every device: 2 on the wide route where
    its grid, doubled, still fits in one wave of the H100 (alone it would
    leave half the SMs or more idle) and the sweep has at least two kv
    steps; else 1. At d ≤ 128 the sweep is never split: its kernels take
    tens of microseconds, and a second launch costs the host more than the
    split saves the card."""
    if lse_route(d) != "wide":
        return 1
    blocks = -(-sq // _WIDE_BQ) * b * h
    return 2 if 2 * blocks <= H100_SMS and skv > _WIDE_BK else 1


def _lse_combine_ref(part: torch.Tensor, B: int, H: int, Sq: int, D: int, n_split: int,
                     dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split sweep's combine: `part` holds n_split
    unnormalized fp32 O [B·H·Sq, D] then their (m, l) [B·H·Sq, 2]; returns
    (o [B, Sq, H, D] in `dtype`, lse2 [B, H, Sq])."""
    rows = B * H * Sq
    po = part[:n_split * rows * D].view(n_split, rows, D)
    ml = part[n_split * rows * D:n_split * rows * (D + 2)].view(n_split, rows, 2)
    m = ml[..., 0].amax(dim=0)
    c = torch.exp2(ml[..., 0] - m)
    l = (c * ml[..., 1]).sum(dim=0)
    o = (c[..., None] * po).sum(dim=0) / torch.clamp(l, min=1e-30)[:, None]
    lse = torch.where(l > 0, m + torch.log2(l), torch.full_like(l, NEG_INF))
    return o.view(B, H, Sq, D).transpose(1, 2).to(dtype), lse.view(B, H, Sq)


def lse_combine(part: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                n_split: int) -> None:
    """The combine launch of a split training forward: o (a [B, Sq, H, D]
    view, written in place) and lse2 [B, H, Sq] from the parts in `part`
    (fp32, n_split·B·H·Sq·(D + 2) values)."""
    B, Sq, H, D = out.shape
    if (part.dtype != torch.float32 or part.numel() != n_split * B * H * Sq * (D + 2)
            or not part.is_contiguous() or lse.shape != (B, H, Sq)):
        raise ValueError(f"flash attention: parts {tuple(part.shape)} {part.dtype} do not "
                         f"fit {n_split} x o {tuple(out.shape)}, lse {tuple(lse.shape)}")
    fn = _build.function("flash_attention_wide", "sd_flash_lse_combine",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    code = fn(part.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Sq, D, n_split,
              (ctypes.c_longlong * 3)(*out.stride()[:3]), _build.stream_ptr(out.device))
    _build.check(code, "sd_flash_lse_combine")
    kernels.LAUNCHES[LSE_COMBINE_COUNTER] += 1


def _launch_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                route: str, n_split: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward on `route` ("sm90", "wide", or the template's
    `LSE` instantiation, the yardstick) over [B, S, H, D] views: (o, lse2
    [B, H, Sq] fp32). With n_split > 1 (the wide route) the sweep writes its
    parts and `lse_combine` writes o and lse2."""
    out, lse, part = _lse_sweep(q, k, v, scale, route, n_split)
    if part is not None:
        lse_combine(part, out, lse, n_split)
    return out, lse


def _lse_sweep(q, k, v, scale: float, route: str, n_split: int = 1):
    """The training forward's sweep launch alone: (o, lse2, part), part None
    unless the sweep is split (then o and lse2 are not written yet)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (out, "out", q))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib, symbol = _LSE_ENTRY[route]
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
    args = [B, H, Sq, Skv, D, _strides(q, k, v, out), float(scale) * LOG2E]
    part = None
    if route != "wide":
        fn = _build.function(lib, symbol,
                             [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + tail + [ctypes.c_void_p])
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  *args, _build.stream_ptr(q.device))
    else:
        part = (torch.empty(n_split * B * H * Sq * (D + 2), dtype=torch.float32, device=q.device)
                if n_split > 1 else None)
        fn = _build.function(lib, symbol, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + tail
                             + [ctypes.c_int, ctypes.c_void_p])
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  None if part is None else part.data_ptr(), *args, n_split,
                  _build.stream_ptr(q.device))
    _build.check(code, symbol)
    return out, lse, part


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward over q [B, Sq, H, D], k/v [B, Skv, H, D]: (o, lse2
    [B, H, Sq] fp32). On the card the kernel `lse_route` names (counted
    under its route beside `flash_attention_lse`), its kv sweep split as
    `lse_split` says (the combine launch counted under `flash_lse_combine`);
    else the plain version."""
    route = lse_route(q.shape[-1])
    if not q.is_cuda:
        return _flash_lse_ref(q, k, v, scale)
    B, Sq, H, D = q.shape
    out, lse = _launch_lse(q, k, v, scale, route, lse_split(B, Sq, k.shape[1], H, D))
    kernels.LAUNCHES[LSE_ROUTE_COUNTERS[route]] += 1
    kernels.LAUNCHES["flash_attention_lse"] += 1
    return out, lse


_BWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p])


def flash_bwd_dq(q, k, v, o, lse, do, scale: float):
    """(dq, delta [B, H, Sq] fp32) from the training forward's o and lse2
    and the output gradient do. On the card the dQ kernel, else the plain
    version."""
    if not q.is_cuda:
        return _flash_bwd_dq_ref(q, k, v, o, lse, do, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (o, "o", q), (do, "do", q),
                                    (dq, "dq", q))
    _check_rows(lse, "lse", B, H, Sq, q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "sd_flash_bwd_dq", _BWD_ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), B, H, Sq, Skv, D,
              _strides(q, k, v, o, do, dq), float(scale) * LOG2E, float(scale),
              _build.stream_ptr(q.device))
    _build.check(code, "sd_flash_bwd_dq")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) from lse2 and flash_bwd_dq's delta. On the card the dK/dV
    kernel (no atomics: the same bits on every run), else the plain
    version."""
    if not q.is_cuda:
        return _flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    B, Sq, Skv, H, D = _check_views(q, k, (v, "v", k), (do, "do", q), (dk, "dk", k),
                                    (dv, "dv", k))
    _check_rows(lse, "lse", B, H, Sq, q.device)
    _check_rows(delta, "delta", B, H, Sq, q.device)
    fn = _build.function("flash_attention_bwd", "sd_flash_bwd_dkv", _BWD_ARGS)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, H, Sq, Skv, D, _strides(q, k, v, do, dk, dv),
              float(scale) * LOG2E, float(scale), _build.stream_ptr(q.device))
    _build.check(code, "sd_flash_bwd_dkv")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The training path: the LSE forward, then the dQ and dK/dV kernels
    (the plain versions of all three off the card)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, out, lse, do, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


class _FlashAttentionChunked(torch.autograd.Function):
    """The training path under `SD_TPU_FLASH_BWD=chunked`: the inference
    forward (a kernel on the card) and the plain chunked backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _inference(q, k, v, scale, False, False)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_bwd_chunked_ref(q, k, v, do, ctx.scale), None)


def _inference(q, k, v, scale: float, exp_bf16: bool, pv_int8: bool) -> torch.Tensor:
    """The inference forward over [B, S, H, D]: the kernel on the card, its
    plain version elsewhere."""
    plan = launch_plan(q.shape[1], k.shape[1], q.shape[2], q.shape[3], exp_bf16, pv_int8,
                       False)
    if not q.is_cuda:
        if not (plan.exp_bf16 or plan.pv_int8):
            return _xla_ref(q, k, v, scale)
        return _flash_tiled_ref(q, k, v, scale, plan.block_k,
                                torch.bfloat16 if exp_bf16 else torch.float32,
                                "int8" if plan.pv_int8 else "none", plan.pipelined)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, scale, plan)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None,
                    softmax_dtype: torch.dtype = torch.float32,
                    pv_quant: str = "none") -> torch.Tensor:
    """Attention over q [B, Sq, H, D], k/v [B, Skv, H, D] (non-causal);
    differentiable in q, k and v (the gradient path ignores the inference
    variants `softmax_dtype` and `pv_quant`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kernels.needs_grad(q, k, v):
        fn = _FlashAttention if use_pallas_bwd() else _FlashAttentionChunked
        return fn.apply(q, k, v, float(scale))
    return _inference(q, k, v, float(scale), *_variants(softmax_dtype, pv_quant))


def flash_attention_hpacked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, heads: int, *,
                            scale: float | None = None,
                            softmax_dtype: torch.dtype = torch.float32,
                            pv_quant: str = "none") -> torch.Tensor:
    """Attention over projection-native q [B, Sq, H*D], k/v [B, Skv, H*D]:
    heads are read through strides, no transpose enters or leaves.
    Inference only (`hpacked_flash_ok` keeps training away from it)."""
    b, sq, hd = q.shape
    d = hd // heads
    if hd != heads * d:
        raise ValueError(f"width {hd} is not {heads} heads")
    if scale is None:
        scale = d ** -0.5
    exp_bf16, pv_int8 = _variants(softmax_dtype, pv_quant)
    split = lambda x: x.unflatten(2, (heads, d))
    plan = launch_plan(sq, k.shape[1], heads, d, exp_bf16, pv_int8, True)
    if not q.is_cuda:
        if not (exp_bf16 or pv_int8):
            return _xla_ref(split(q), split(k), split(v), scale).reshape(b, sq, hd)
        return _flash_hpacked_tiled_ref(q, k, v, heads, scale, plan.block_k,
                                        softmax_dtype, pv_quant)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(split(q), split(k), split(v), split(out), scale, plan)
    return out
