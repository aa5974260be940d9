"""The inference variants of the flash forward (`SD_TPU_FLASH_EXP=bf16`,
`SD_TPU_FLASH_PV=int8`) against the JAX package's Pallas kernels run in
interpret mode, fp32 on the CPU.

The plain tiled versions (`_flash_tiled_ref`, `_flash_hpacked_tiled_ref`)
run at the Pallas call's own kv tile (`block_k`): the int8 codes depend on
it. q and k are multiples of 1/8 in [-1, 1], so the logits are exact in
fp32 on both sides and both take the same bf16 exponentials and the same
int8 codes; what remains is fp32 summation order. Tolerance:
max|Δ| ≤ 1e-5·max|ref|.

Also: the pipelined sweep keeps the bf16 exponential and drops the int8 PV
(`_flash_attention_bhsd`'s precedence), the gradient path ignores both
switches, the gates read the switches at call time, the kv tile an int8-PV
launch hands the CUDA kernel is the TPU package's, the route `launch_plan`
picks for every head dim and switch, and `SD_TPU_FLASH_BWD=chunked` trains
through the plain chunked backward with `_bwd_chunked`'s gradients. The
plain version of the int8 PV pre-pass (`_v_codes_ref`: V's codes, permuted
within 16-row kv groups, and column factors per kv super-tile) gives the
TPU package's `_pv_int8` codes and scales, and the sweep through those codes
(`_flash_codes_ref`) gives the tiled sweep's output bit for bit.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import MODULE_TOL, assert_close, nprand, to_torch
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.kernels import flash_attention as jfa
from sd_tpu_torch.kernels import attention as attn_k
from sd_tpu_torch.kernels import flash_attention as fa

VARIANT_TOL = 1e-5
VARIANTS = [("bf16", "none"), ("f32", "int8"), ("bf16", "int8")]
JAX_DT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TORCH_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for var in ("SD_TPU_FLASH_PIPE", "SD_TPU_FLASH_EXP", "SD_TPU_FLASH_PV"):
        monkeypatch.delenv(var, raising=False)


def dyadic(*shape, seed: int = 0) -> np.ndarray:
    """Multiples of 1/8 in [-1, 1]: their dot products are exact in fp32."""
    return (np.random.default_rng(seed).integers(-8, 9, shape) / 8).astype(np.float32)


def qkv(b, sq, skv, width, seed=0):
    return dyadic(b, sq, width, seed=seed), dyadic(b, skv, width, seed=seed + 1), \
        nprand(b, skv, width, seed=seed + 2)


def process_state() -> dict:
    """The process-global settings that could move either side's bits, and
    the test modules this process has imported (what ran before)."""
    mkldnn = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    return {"pid": os.getpid(), "torch_threads": torch.get_num_threads(),
            "torch_matmul_precision": torch.get_float32_matmul_precision(),
            "mkldnn_matmul_fp32_precision": getattr(mkldnn, "fp32_precision", "absent"),
            "torch_default_dtype": str(torch.get_default_dtype()),
            "jax_default_matmul_precision": jax.config.jax_default_matmul_precision,
            "jax_enable_x64": jax.config.jax_enable_x64,
            "test_modules": sorted(m for m in sys.modules if m.startswith("test_"))}


def row_exponentials(q, k, scale, block_q, block_k, exp, index) -> str:
    """The worst element's row (index (b, q, h, d) of the [B, Sq, H, D]
    output), recomputed from the same inputs on both sides kv tile by kv
    tile at the kernel's tile shapes: the fp32 base-2 logit minus the
    running max (s − m_new), its rounding to the softmax dtype and p = exp2
    of it, by the port's ops and by the Pallas kernel's jnp ops; says where
    they differ."""
    b, i, h, _ = index
    i0 = i // block_q * block_q
    qt, kr = q[b, i0:i0 + block_q, h], k[b, :, h]              # [bq, D], [Skv, D]

    @jax.jit
    def pallas(qt, kt, m_prev):
        # the kernel's ops on its tiles, in one program so that XLA keeps
        # the precision it keeps inside the kernel
        s = jax.lax.dot_general(qt, kt, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.float32) * (scale * jfa.LOG2E)
        m_new = jnp.maximum(m_prev, jnp.max(s, axis=1, keepdims=True))
        x = (s - m_new).astype(JAX_DT[exp])
        return s - m_new, x, jnp.exp2(x).astype(jnp.float32), m_new

    lines, m_t = [], torch.full((len(qt), 1), fa.NEG_INF)
    m_j = jnp.full((len(qt), 1), jfa.NEG_INF, jnp.float32)
    for j0 in range(0, kr.shape[0], block_k):
        kt = kr[j0:j0 + block_k]
        s_t = torch.einsum("qd,kd->qk", to_torch(qt), to_torch(kt)) * (scale * fa.LOG2E)
        m_t = torch.maximum(m_t, s_t.amax(dim=1, keepdim=True))
        x_t = s_t - m_t
        r_t = x_t.to(TORCH_DT[exp])
        x_j, r_j, p_j, m_j = pallas(jnp.asarray(qt), jnp.asarray(kt), m_j)
        sides = {"s−m_new": (x_t[i - i0].numpy(), np.asarray(x_j)[i - i0]),
                 "rounded": (r_t[i - i0].float().numpy(),
                             np.asarray(r_j.astype(jnp.float32))[i - i0]),
                 "p": (fa._exp2(r_t[i - i0]).float().numpy(), np.asarray(p_j)[i - i0])}
        for name, (a, c) in sides.items():
            diff = np.flatnonzero(a != c)
            if len(diff):
                c0 = int(diff[0])
                lines.append(f"tile {j0 // block_k} {name}: {len(diff)} differ, first at kv "
                             f"{j0 + c0}: port {a[c0]!r} pallas {c[c0]!r}")
    return "; ".join(lines) or "the row's s − m_new, rounding and p agree bit for bit"


def close(got, ref, tol=VARIANT_TOL, rerun=None, row=None):
    """max|got − ref| ≤ tol·max|ref|. On a failure the message gives the
    worst element's index and both values there, `row(index)` (the row's
    exponentials on both sides), which side's bits changed when `rerun()`
    (both sides again, as (ref, got)) runs them again in this process, and
    `process_state()`."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, bound = float(np.abs(got - ref).max()), tol * float(np.abs(ref).max())
    if err <= bound:
        return
    worst = np.unravel_index(int(np.abs(got - ref).argmax()), got.shape)
    why = f"; worst at {tuple(int(x) for x in worst)}: plain {got[worst]!r}, pallas {ref[worst]!r}"
    if row is not None:
        why += f"; {row(worst)}"
    if rerun is not None:
        ref2, got2 = rerun()
        why += (f"; run again in this process, the Pallas side's bits "
                f"{'held' if np.array_equal(ref, ref2) else 'changed'} and the plain side's "
                f"{'held' if np.array_equal(got, got2) else 'changed'}")
    assert err <= bound, f"max|Δ| = {err:.3g} > {bound:.3g}{why}; {process_state()}"


@pytest.mark.parametrize("skv", [256, 200])
@pytest.mark.parametrize("exp,pv", VARIANTS)
def test_tiled_variants_match_pallas(skv, exp, pv):
    q, k, v = (x.reshape(1, x.shape[1], 2, 40) for x in qkv(1, 256, skv, 80))

    def sides():
        ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                  block_k=128, interpret=True, softmax_dtype=JAX_DT[exp],
                                  pv_quant=pv)
        got = fa._flash_tiled_ref(to_torch(q), to_torch(k), to_torch(v), 40**-0.5, 128,
                                  TORCH_DT[exp], pv)
        return np.asarray(ref, np.float32), got.numpy()

    ref, got = sides()
    close(got, ref, rerun=sides,
          row=lambda at: row_exponentials(q, k, 40**-0.5, 128, 128, exp, at))


@pytest.mark.parametrize("exp,pv", VARIANTS)
def test_hpacked_tiled_variants_match_pallas(exp, pv):
    q, k, v = qkv(1, 256, 200, 80, seed=3)
    ref = jfa.flash_attention_hpacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                                      block_q=128, block_k=128, interpret=True,
                                      softmax_dtype=JAX_DT[exp], pv_quant=pv)
    got = fa._flash_hpacked_tiled_ref(to_torch(q), to_torch(k), to_torch(v), 2, 40**-0.5,
                                      128, TORCH_DT[exp], pv)
    close(got, ref)


def test_wrappers_take_the_tpu_kv_tile_off_the_card():
    """On a CPU tensor each wrapper runs the plain version at the kv tile the
    TPU package picks with its default blocks: 1024 rows for the head-packed
    call below (two tiles, the second ragged), one 256-row tile for the
    [B, S, H, D] call."""
    q, k, v = qkv(1, 256, 1300, 160, seed=5)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kw = dict(softmax_dtype=torch.bfloat16, pv_quant="int8")
    assert fa._tpu_hpacked_block_k(256, 1300, 160) == 1024
    close(fa.flash_attention_hpacked(to_torch(q), to_torch(k), to_torch(v), 2, **kw),
          jfa.flash_attention_hpacked(jq, jk, jv, 2, interpret=True,
                                      softmax_dtype=jnp.bfloat16, pv_quant="int8"))
    q4 = q.reshape(1, 256, 2, 80)
    k4, v4 = (x[:, :200].reshape(1, 200, 2, 80) for x in (k, v))
    assert fa._tpu_block_k(200, 80) == 256
    close(fa.flash_attention(to_torch(q4), to_torch(k4), to_torch(v4), **kw),
          jfa.flash_attention(jnp.asarray(q4), jnp.asarray(k4), jnp.asarray(v4),
                              interpret=True, softmax_dtype=jnp.bfloat16, pv_quant="int8"))


@pytest.mark.parametrize("b,sq,skv,h,d,packed", [
    (8, 4096, 4096, 8, 40, True), (8, 1024, 1024, 8, 80, True),
    (4, 4096, 4096, 1, 512, False), (1, 1000, 1300, 8, 40, True),
    (1, 512, 700, 1, 512, False), (2, 4096, 1000, 8, 40, False)])
def test_int8_pv_tile_is_the_tpu_packages(monkeypatch, b, sq, skv, h, d, packed):
    """The kv tile an int8-PV call hands the CUDA kernel (its launch plan,
    made on every device) is the one the TPU package's wrapper builds its
    Pallas kernel with (traced abstractly, the kernel's `block_k` recorded),
    at the serving path's shapes and ragged ones; no kernel runs here."""
    seen, real = [], jfa.pl.pallas_call

    def spy(kernel, **kw):
        seen.append(kernel.keywords["block_k"])
        return real(kernel, **kw)

    plans, plan = [], fa.launch_plan
    monkeypatch.setattr(fa, "launch_plan", lambda *a: plans.append(plan(*a)) or plans[-1])
    meta = lambda s_: torch.empty(b, s_, h * d, dtype=torch.bfloat16, device="meta")
    jshape = lambda s_: jax.ShapeDtypeStruct((b, s_, h * d), jnp.bfloat16)
    with monkeypatch.context() as m:
        m.setattr(jfa.pl, "pallas_call", spy)
        if packed:
            jax.eval_shape(lambda q, k, v: jfa.flash_attention_hpacked(
                q, k, v, h, pv_quant="int8"), jshape(sq), jshape(skv), jshape(skv))
            fa.flash_attention_hpacked(meta(sq), meta(skv), meta(skv), h, pv_quant="int8")
        else:
            split = lambda x: x.reshape(b, x.shape[1], h, d)
            jax.eval_shape(lambda q, k, v: jfa.flash_attention(
                split(q), split(k), split(v), pv_quant="int8"), jshape(sq), jshape(skv),
                jshape(skv))
            fa.flash_attention(*(x.unflatten(2, (h, d)) for x in (meta(sq), meta(skv),
                                                                   meta(skv))),
                               pv_quant="int8")
    assert len(seen) == len(plans) == 1
    assert plans[0].block_k == seen[0] and plans[0].pv_int8
    assert plans[0].route == ("wide" if d > 128 else "sm90_pv8")


@pytest.mark.parametrize("d", [40, 80, 128, 136, 256, 512])
@pytest.mark.parametrize("hpacked", [True, False])
@pytest.mark.parametrize("pipe", ["0", "1"])
@pytest.mark.parametrize("exp_bf16,pv_int8", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_launch_plan_routes(monkeypatch, d, hpacked, pipe, exp_bf16, pv_int8):
    """The source each inference launch runs on the card, decided on every
    device: above head dim 128 the wide kernel, whatever the sweep; up to
    128 the pipelined sweep (where `SD_TPU_FLASH_PIPE=1` holds: [B, S, H, D]
    calls only) the Hopper kernel's PIPE form, the int8 PV its int8-PV
    form, the rest the Hopper kernel; no plan names the template. The pipelined sweep keeps the bf16
    exponential and drops the int8 PV; the launch counter names the variant
    that runs."""
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", pipe)
    plan = fa.launch_plan(4096, 4096, 8 if hpacked else 1, d, exp_bf16, pv_int8, hpacked)
    piped = pipe == "1" and not hpacked
    route = ("wide" if d > 128 else "sm90_pipe" if piped else "sm90_pv8" if pv_int8
             else "sm90")
    base = ("flash_attention_hpacked" if hpacked
            else "flash_attention_pipelined" if piped else "flash_attention")
    assert (plan.route, plan.pipelined, plan.exp_bf16, plan.pv_int8) == (
        route, piped, exp_bf16, pv_int8 and not piped)
    assert plan.name == fa.launch_name(base, exp_bf16, pv_int8 and not piped)
    assert fa.ROUTE_COUNTERS[plan.route] == {
        "sm90": "flash_fwd_sm90", "sm90_pipe": "flash_fwd_sm90_pipe",
        "sm90_pv8": "flash_fwd_sm90_pv8", "wide": "flash_fwd_wide"}[route]


def _tpu_pv_int8_codes(v_tile: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The TPU package's `_pv_int8` on one kv tile v [n, D] with p the n×n
    identity: (its int8 codes of v, captured from its int32 product, and
    its output, 127·v_i8 · vs/127 in fp32)."""
    seen, real = [], jax.lax.dot_general

    def spy(lhs, rhs, *a, **kw):
        seen.append(np.asarray(rhs))
        return real(lhs, rhs, *a, **kw)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.lax, "dot_general", spy)
        pv, _ = jfa._pv_int8(jnp.eye(v_tile.shape[0], dtype=jnp.float32), jnp.asarray(v_tile))
    assert len(seen) == 1 and seen[0].dtype == np.int8
    return seen[0], np.asarray(pv)


@pytest.mark.parametrize("skv,d,block_k", [(256, 40, 128), (300, 40, 128), (700, 136, 384)])
def test_v_codes_are_the_tpu_packages(skv, d, block_k):
    """The plain pre-pass over v [1, Skv, 2, D] (bf16 values), super-tile by
    super-tile, the last ragged where Skv is not a multiple of T: un-permuted,
    its codes are `_pv_int8`'s for that tile (zeros past Skv and past D), and
    its column factor vs / 127 gives `_pv_int8`'s product bit for bit."""
    v = to_torch(nprand(1, skv, 2, d, seed=4)).bfloat16()
    dp = fa._padded_dim(d)
    codes, vmul = fa._v_codes_ref(v, block_k, dp)
    n_st = -(-skv // block_k)
    assert codes.shape == (2, n_st * block_k // 16, dp, 16) and codes.dtype == torch.int8
    assert vmul.shape == (2, n_st, dp)
    perm = fa._perm16()
    assert sorted(perm.tolist()) == list(range(16))
    # codes[bh, c, :, p] holds kv row 16c + perm[p]: undo the permutation
    rows = torch.empty_like(codes)
    rows[..., perm] = codes
    rows = rows.transpose(2, 3).reshape(2, n_st * block_k, dp).numpy()
    for h in range(2):
        for st in range(n_st):
            r0, r1 = st * block_k, min(skv, (st + 1) * block_k)
            tile = v[0, r0:r1, h].float().numpy()
            v_i8, pv = _tpu_pv_int8_codes(tile)
            np.testing.assert_array_equal(rows[h, r0:r1, :d], v_i8)
            assert not rows[h, r1:(st + 1) * block_k].any() and not rows[h, r0:r1, d:].any()
            mine = (127 * v_i8.astype(np.float32)) * vmul[h, st, :d].numpy()
            np.testing.assert_array_equal(mine, pv)
            assert not vmul[h, st, d:].any()


@pytest.mark.parametrize("b,sq,skv,h,d,block_k", [(1, 256, 256, 2, 40, 128),
                                                  (2, 50, 700, 1, 136, 384),
                                                  (1, 33, 1300, 2, 80, 1024)])
@pytest.mark.parametrize("exp", ["f32", "bf16"])
def test_sweep_through_the_permuted_codes(b, sq, skv, h, d, block_k, exp):
    """The int8 sweep through the pre-pass's permuted codes (how the kernels
    contract P with V) gives the tiled int8 sweep's output bit for bit, the
    last super-tile ragged; and, on dyadic q and k, the JAX package's
    Pallas kernel's within the variants' tolerance."""
    q, k, v = (to_torch(x.reshape(b, x.shape[1], h, d)) for x in qkv(b, sq, skv, h * d, seed=9))
    codes, vmul = fa._v_codes_ref(v, block_k, fa._padded_dim(d))
    got = fa._flash_codes_ref(q, k, codes, vmul, d**-0.5, block_k, TORCH_DT[exp])
    assert torch.equal(got, fa._flash_tiled_ref(q, k, v, d**-0.5, block_k, TORCH_DT[exp],
                                                "int8"))
    if b == 1 and skv == 256:
        ref = jfa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), block_q=128,
                                  block_k=block_k, interpret=True, softmax_dtype=JAX_DT[exp],
                                  pv_quant="int8")
        close(got, ref)


def test_pipelined_sweep_drops_int8_and_keeps_bf16(monkeypatch):
    """`SD_TPU_FLASH_PIPE=1` with a kv sweep of two TPU tiles: both packages
    run the pipelined sweep with the bf16 exponential and without int8."""
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", "1")
    q, k, v = (x.reshape(1, x.shape[1], 2, 40) for x in qkv(1, 128, 2048, 80, seed=7))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                              softmax_dtype=jnp.bfloat16, pv_quant="int8")
    assert fa.flash_pipelined_ok(2048, 40)
    got = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                             softmax_dtype=torch.bfloat16, pv_quant="int8")
    close(got, ref)
    args = (to_torch(q), to_torch(k), to_torch(v), 40**-0.5, 1024, torch.bfloat16)
    close(got, fa._flash_tiled_ref(*args, "none", pipelined=True))
    int8 = fa._flash_tiled_ref(*args, "int8")
    assert float((got - int8).abs().max()) > 100 * VARIANT_TOL * float(got.abs().max())


def test_gradients_ignore_the_switches():
    """With a gradient wanted, flash_attention runs the training path: the
    same output and gradients with or without the variants, and the Pallas
    kernels' vjp with pv_quant="int8" (which ignores it too) within 1e-4."""
    q, k, v = (nprand(1, 256, 2, 40, seed=s) for s in (8, 9, 10))
    g = nprand(1, 256, 2, 40, seed=11)

    def port(**kw):
        ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
        out = fa.flash_attention(*ins, **kw)
        out.backward(to_torch(g))
        return out.detach(), [t.grad for t in ins]

    out_v, grads_v = port(softmax_dtype=torch.bfloat16, pv_quant="int8")
    out_e, grads_e = port()
    assert torch.equal(out_v, out_e)
    assert all(torch.equal(a, b) for a, b in zip(grads_v, grads_e))
    ref, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, block_q=128, block_k=128,
                                                      interpret=True, pv_quant="int8"),
                       *(jnp.asarray(a) for a in (q, k, v)))
    assert_close(out_v, ref, MODULE_TOL)
    for got, want in zip(grads_v, vjp(jnp.asarray(g))):
        assert_close(got, want, MODULE_TOL)


def test_gates_read_the_switches_at_call_time(monkeypatch):
    """`dot_product_attention` (bf16 [1, 512, 1, 64]: the flash rule holds)
    takes the variants the environment names when it is called; fp32 and the
    77-token cross-attention shape go to the plain path and ignore them; the
    head-packed caller passes them on."""
    q, k, v = (torch.from_numpy(nprand(1, 512, 1, 64, seed=s)).bfloat16() for s in (1, 2, 3))
    exact = attn_k.dot_product_attention(q, k, v)
    assert torch.equal(exact, fa._xla_ref(q, k, v, 64**-0.5))
    monkeypatch.setenv("SD_TPU_FLASH_EXP", "bf16")
    monkeypatch.setenv("SD_TPU_FLASH_PV", "int8")
    assert attn_k.flash_variants() == {"softmax_dtype": torch.bfloat16, "pv_quant": "int8"}
    got = attn_k.dot_product_attention(q, k, v)
    assert torch.equal(got, fa._flash_tiled_ref(q, k, v, 64**-0.5, 512, torch.bfloat16,
                                                "int8"))
    assert not torch.equal(got, exact)
    q32, k32, v32 = q.float(), k.float(), v.float()
    assert torch.equal(attn_k.dot_product_attention(q32, k32, v32),
                       fa._xla_ref(q32, k32, v32, 64**-0.5))
    assert torch.equal(attn_k.dot_product_attention(q, k[:, :77], v[:, :77]),
                       fa._xla_ref(q, k[:, :77], v[:, :77], 64**-0.5))

    seen = []
    monkeypatch.setattr(fa, "flash_attention_hpacked", lambda *a, **kw: seen.append(kw))
    attn_k.hpacked_flash_attention(q[0], k[0], v[0], 1)
    monkeypatch.delenv("SD_TPU_FLASH_PV")
    attn_k.hpacked_flash_attention(q[0], k[0], v[0], 1)
    assert seen == [{"scale": None, "softmax_dtype": torch.bfloat16, "pv_quant": "int8"},
                    {"scale": None, "softmax_dtype": torch.bfloat16, "pv_quant": "none"}]


def test_launch_counter_names():
    assert fa.launch_name("flash_attention_hpacked", True, True) == \
        "flash_attention_hpacked_exp_bf16_pv_int8"
    assert fa.launch_name("flash_attention_pipelined", True, False) == \
        "flash_attention_pipelined_exp_bf16"
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(1, 8, 1, 8), torch.zeros(1, 8, 1, 8),
                           torch.zeros(1, 8, 1, 8), pv_quant="fp8")


@pytest.mark.parametrize("sq", [1024, 700])
def test_chunked_backward_matches_the_tpu_package(monkeypatch, sq):
    """`SD_TPU_FLASH_BWD=chunked`: flash_attention trains through the
    inference forward and the plain chunked backward (no LSE, dQ or dK/dV
    wrapper is reached), whose gradients are the JAX package's
    `_bwd_chunked` (two 512-row q chunks; a ragged 700 rows take the
    gradient of the plain attention in both), fp32, within 1e-4."""
    monkeypatch.setenv("SD_TPU_FLASH_BWD", "chunked")
    assert not fa.use_pallas_bwd() and not jfa._use_pallas_bwd()
    q, k, v, g = (nprand(1, n, 2, 40, seed=s) for s, n in ((1, sq), (2, 600), (3, 600), (4, sq)))
    for name in ("flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(fa, name, lambda *a, name=name: pytest.fail(f"{name} reached"))
    qkv = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*qkv)
    grads = torch.autograd.grad(out, qkv, to_torch(g))
    want = jfa._bwd_chunked(40**-0.5, 1024, tuple(jnp.asarray(x) for x in (q, k, v)),
                            jnp.asarray(g))
    assert_close(out, jfa._xla_ref(*(jnp.asarray(x) for x in (q, k, v)), 40**-0.5), MODULE_TOL)
    for got, ref in zip(grads, want):
        assert_close(got, ref, MODULE_TOL)
