"""The pipelined flash sweep at head dims up to 128 (the `PIPE` kernel of
`csrc/flash_attention_sm90.cu`) and GroupNorm (`csrc/groupnorm_sm90.cu`) on
their Hopper kernels: routes, plans and the plain forms of their tiling on
the CPU, the kernels themselves on the card.

Routes and plans, from the shape alone on every device: `launch_plan` sends
every pipelined sweep at d ≤ 128 (either exponential, the int8 PV asked for
and dropped) to the PIPE kernel, counted under `flash_fwd_sm90_pipe`, and no
plan names the template (`flash_attention.cu`, the yardstick). `gn_plan`
gives every opt-in GroupNorm shape (`chip_smoke.GN_SHAPES`) and the ragged
case a grid of whole groups in 16-byte TMA boxes, rows covering S, one wave
of the H100 and at most 227 KB of shared memory a block; shapes it cannot
take raise.

Plain forms, fp32, against the TPU package's Pallas kernels in interpret
mode within 1e-4·max(1, max|ref|): `_gn_tiled_ref` under every plan of a
shape (each block's fp32 sums, rows past S as zeros, the cluster's partials
added in rank order) and `_flash_tiled_ref` at the Hopper kernel's kv tile
(`sm90_block_k`) with the pipelined sweep's bf16 p.

On the card (`cuda` marker; skipped without a card): the PIPE kernel within
1e-2·max|ref| of the fp32 plain version, the serial Hopper kernel's bits with
either exponential, the same bits twice, its counter moved once a call;
GroupNorm within 1e-2·max|ref| of `group_norm_xla` at every opt-in shape,
with SiLU and in the ragged case, the same bits twice, one launch a call on
`group_norm_sm90`; and a raise, not a fallback, on what either refuses. This
file imports JAX only inside the CPU tests, so the card's tests run where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_hopper_pipe_gn.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from sd_tpu_torch import kernels
from sd_tpu_torch.kernels import _build, flash_attention as fa, groupnorm as gn
from sd_tpu_torch.kernels.flash_attention import H100_SMS

GN_RAGGED = (3, 100, 136, 8)
GN_CASES = [(b, s, c, 32) for b, s, c in chip_smoke.GN_SHAPES] + [GN_RAGGED]
# blocks of `gn_plan`'s grid at each opt-in shape: 256 at the two largest
# (about 40 KB of x a block), 128 elsewhere; 12 in the ragged case
GN_BLOCKS = {(4, 4096, 320): 256, (4, 1024, 960): 256, (4, 1024, 1280): 256, GN_RAGGED[:3]: 12}


@pytest.mark.parametrize("d", range(8, 129, 8))
@pytest.mark.parametrize("exp_bf16,pv_int8", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_pipelined_sweeps_up_to_head_dim_128_take_the_pipe_kernel(monkeypatch, d, exp_bf16,
                                                                  pv_int8):
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", "1")
    plan = fa.launch_plan(4096, 4096, 8, d, exp_bf16, pv_int8, False)
    assert (plan.route, plan.pipelined, plan.exp_bf16, plan.pv_int8) == (
        "sm90_pipe", True, exp_bf16, False)
    assert plan.name == fa.launch_name("flash_attention_pipelined", exp_bf16, False)
    assert fa.ROUTE_COUNTERS[plan.route] == "flash_fwd_sm90_pipe"


@pytest.mark.parametrize("pipe", ["0", "1"])
@pytest.mark.parametrize("hpacked", [False, True])
def test_no_plan_names_the_template(monkeypatch, pipe, hpacked):
    """Every head dim the forward takes, short and long sweeps, every
    variant: a Hopper route with a counter, never the template."""
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", pipe)
    routes = set()
    for d in range(8, 513, 8):
        for skv in (77, 700, 4096):
            for exp_bf16 in (False, True):
                for pv_int8 in (False, True):
                    plan = fa.launch_plan(1024, skv, 4, d, exp_bf16, pv_int8, hpacked)
                    assert plan.route in fa.ROUTE_COUNTERS and plan.route != "template"
                    routes.add(plan.route)
    want = {"sm90", "sm90_pv8", "wide"} | ({"sm90_pipe"} if pipe == "1" and not hpacked
                                            else set())
    assert routes == want


@pytest.mark.parametrize("d", [40, 48, 64, 80, 128])
def test_sm90_block_k_is_the_kernels_tile(d):
    assert fa.sm90_block_k(d) == (128 if -(-d // 16) * 16 <= 48 else 64)


@pytest.mark.parametrize("shape", GN_CASES)
def test_gn_plan_at_the_opt_in_shapes(shape):
    B, S, C, G = shape
    p = gn.gn_plan(B, S, C, G)
    cg = C // G
    assert p.cs % cg == 0 and p.cs % 8 == 0 and C % p.cs == 0          # whole groups
    assert p.box_c % 8 == 0 and p.box_c <= gn.GN_BOX_MAX and p.cs % p.box_c == 0
    assert (2 * p.box_c) % 16 == 0                                        # 16-byte box rows
    assert p.box_r % 8 == 0 and p.box_r <= gn.GN_BOX_MAX and p.rows % p.box_r == 0
    assert p.cluster in gn.GN_CLUSTERS and (p.cluster - 1) * p.rows < S <= p.cluster * p.rows
    assert p.smem == gn._gn_smem(p.cs, cg, p.rows) <= gn.GN_SMEM_MAX
    assert p.blocks == B * (C // p.cs) * p.cluster == GN_BLOCKS.get((B, S, C), 128)
    assert gn.gn_waves(p) == 1 and p in gn.gn_plans(B, S, C, G)
    if (B, S, C) != GN_RAGGED[:3]:
        assert p.blocks >= H100_SMS - 4                                   # a wave's worth


@pytest.mark.parametrize("shape", [(4, 64, 100, 32), (2, 64, 120, 7), (0, 64, 128, 32),
                                   (2, 8192, 2560, 1)])
def test_gn_plan_refuses_what_the_kernel_cannot_take(shape):
    """C not a multiple of 8 or of the groups, no rows, or no tile of whole
    groups in shared memory (2560 channels in one group over 8192 rows):
    raises, on a CPU tensor too, before any CUDA call."""
    with pytest.raises(ValueError):
        gn.gn_plan(*shape)
    B, S, C, G = shape
    x = torch.zeros((B, S, C), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gn._launch_gn(x, torch.ones(C), torch.zeros(C), G, 1e-5, None)


def _gn_np(B, S, C, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, C)) * 3.0 + 0.5).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(2, 64, 128, 32), (1, 200, 320, 32), GN_RAGGED])
@pytest.mark.parametrize("eps,act", [(1e-5, None), (1e-6, "silu")])
def test_gn_tiled_ref_matches_pallas_under_every_plan(shape, eps, act):
    import jax.numpy as jnp

    from sd_tpu.kernels import groupnorm as jgn

    B, S, C, G = shape
    x, scale, bias = _gn_np(B, S, C)
    ref = np.asarray(jgn.group_norm(*(jnp.asarray(a) for a in (x, scale, bias)), groups=G,
                                    eps=eps, act=act, interpret=True))
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    plans = gn.gn_plans(B, S, C, G)
    assert gn.gn_plan(B, S, C, G) in plans and len(plans) > 1
    for p in plans:
        got = gn._gn_tiled_ref(*args, groups=G, eps=eps, act=act, plan=p).numpy()
        assert np.abs(got - ref).max() <= tol, p


@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 256, 300, 2, 40), (1, 130, 200, 2, 80)])
def test_pipelined_plain_sweep_at_the_kernels_tile_matches_pallas(b, sq, skv, h, d):
    """The pipelined bf16-exponential sweep's plain version at the Hopper
    kernel's kv tile against the TPU package's pipelined kernel at the same
    tile (interpret mode, fp32 inputs, bf16 p)."""
    import jax.numpy as jnp

    from sd_tpu.kernels import flash_attention as jfa

    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (sq, skv, skv))
    tile = fa.sm90_block_k(d)
    perm = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, a.shape[1], d))
    pad = lambda a, n: jnp.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0)))
    nq, nk = -(-sq // 8) * 8, -(-skv // tile) * tile
    with pytest.MonkeyPatch.context() as m:
        m.setenv("SD_TPU_FLASH_PIPE", "1")
        out = jfa._flash_attention_bhsd(pad(perm(q), nq), pad(perm(k), nk), pad(perm(v), nk),
                                        d**-0.5, nq, tile, skv, True, p_dtype=jnp.bfloat16)
    ref = np.asarray(out)[:, :sq].reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    got = fa._flash_tiled_ref(*(torch.from_numpy(a) for a in (q, k, v)), d**-0.5, tile,
                              torch.bfloat16, "none", pipelined=True).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))


def test_new_counters_sources_and_chip_smoke_expectations():
    assert {"flash_fwd_sm90_pipe", "group_norm_sm90"} <= set(kernels.LAUNCHES)
    assert {"flash_fwd_sm90_pipe", "group_norm_sm90"} <= set(chip_smoke.KERNELS)
    assert "groupnorm_sm90" in _build.SOURCES and (_build.CSRC / "groupnorm_sm90.cu").is_file()
    optin = chip_smoke.EXPECTED_LAUNCHES_OPTIN
    assert optin["group_norm_sm90"] == optin["group_norm"] == 2850
    parity = chip_smoke.PARITY_OPTIN_LAUNCHES
    assert all(parity[m]["group_norm_sm90"] == parity[m]["group_norm"] for m in parity)
    combo = next(want for env, want, _ in chip_smoke.SWITCH_COMBINATIONS
                 if env.get("SD_TPU_ATTN_HPACKED") == "0")
    assert combo["flash_fwd_sm90_pipe"] == 5 and combo["group_norm_sm90"] == 57
    assert chip_smoke.ROUTE_COUNTER["sm90_pipe"] == fa.ROUTE_COUNTERS["sm90_pipe"]
    assert chip_smoke.KERNEL_ROUTE_COUNTER["group_norm"] == "group_norm_sm90"


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator("cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _sweep(q, k, v, route, exp_bf16):
    out = torch.empty_like(q)
    name = "flash_attention_pipelined" if route == "sm90_pipe" else "flash_attention"
    fa._launch(q, k, v, out, q.shape[-1] ** -0.5,
               fa.Plan(fa.launch_name(name, exp_bf16, False), route, route == "sm90_pipe",
                       exp_bf16, False, 0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", [(8, 4096, 4096, 8, 40), (4, 4096, 4096, 8, 40),
                                          (4, 1024, 1024, 8, 80), (1, 1000, 1300, 8, 40),
                                          (2, 512, 700, 4, 64), (1, 300, 257, 2, 128),
                                          (1, 200, 100, 2, 80)])
@pytest.mark.parametrize("exp_bf16", [False, True])
def test_pipe_kernel_on_card(cuda, b, sq, skv, h, d, exp_bf16):
    """Against its plain version, the serial kernel's bits, the same bits
    twice, one count a call on its counter."""
    q, k, v = _rnd(cuda, b, sq, h, d), _rnd(cuda, b, skv, h, d), _rnd(cuda, b, skv, h, d)
    kernels.reset_launches()
    out = _sweep(q, k, v, "sm90_pipe", exp_bf16)
    assert kernels.LAUNCHES["flash_fwd_sm90_pipe"] == 1
    assert kernels.LAUNCHES["flash_fwd_sm90"] == 0
    torch.cuda.synchronize()
    ref = fa._flash_tiled_ref(q, k, v, d**-0.5, fa.sm90_block_k(d),
                              torch.bfloat16 if exp_bf16 else torch.float32, pipelined=True)
    assert _rel(out, ref) <= 1e-2
    assert torch.equal(out, _sweep(q, k, v, "sm90", exp_bf16))
    assert torch.equal(out, _sweep(q, k, v, "sm90_pipe", exp_bf16))


@pytest.mark.cuda
def test_pipelined_wrapper_reaches_the_pipe_kernel(cuda, monkeypatch):
    monkeypatch.setenv("SD_TPU_FLASH_PIPE", "1")
    q, k, v = (_rnd(cuda, 2, 4096, 8, 40) for _ in range(3))
    kernels.reset_launches()
    out = fa.flash_attention(q, k, v)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        "flash_attention_pipelined": 1, "flash_fwd_sm90_pipe": 1}
    assert torch.equal(out, _sweep(q, k, v, "sm90", False))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GN_CASES)
@pytest.mark.parametrize("eps,act", [(1e-5, None), (1e-6, "silu")])
def test_hopper_group_norm_on_card(cuda, shape, eps, act):
    B, S, C, G = shape
    x = _rnd(cuda, B, S, C, scale=3.0) + 0.5
    scale, bias = 1 + _rnd(cuda, C, scale=0.2), _rnd(cuda, C, scale=0.3)
    kw = dict(groups=G, eps=eps, act=act)
    kernels.reset_launches()
    y = gn.group_norm(x, scale, bias, **kw)
    assert kernels.LAUNCHES["group_norm_sm90"] == kernels.LAUNCHES["group_norm"] == 1
    torch.cuda.synchronize()
    ref = gn.group_norm_xla(x.float(), scale.float(), bias.float(), **kw)
    assert _rel(y, ref) <= 1e-2
    assert _rel(y, gn._launch_gn(x, scale, bias, G, eps, act, source="template")) <= 1e-2
    assert torch.equal(y, gn.group_norm(x, scale, bias, **kw))


@pytest.mark.cuda
def test_hopper_group_norm_takes_fp32_and_bf16_affines(cuda):
    x = _rnd(cuda, 2, 256, 640)
    scale, bias = 1 + _rnd(cuda, 640, scale=0.2), _rnd(cuda, 640, scale=0.3)
    for s, b in ((scale, bias), (scale.float(), bias.float())):
        ref = gn.group_norm_xla(x.float(), s.float(), b.float())
        assert _rel(gn.group_norm(x, s, b), ref) <= 1e-2


@pytest.mark.cuda
def test_pipe_and_group_norm_raise_rather_than_fall_back(cuda):
    kernels.reset_launches()
    with pytest.raises(ValueError):   # C not a multiple of 8
        gn.group_norm(_rnd(cuda, 2, 64, 100), torch.ones(100, device="cuda"),
                      torch.zeros(100, device="cuda"), groups=4)
    with pytest.raises(ValueError):   # no tile of whole groups fits
        gn.group_norm(_rnd(cuda, 1, 8192, 2560), torch.ones(2560, device="cuda"),
                      torch.zeros(2560, device="cuda"), groups=1)
    q = _rnd(cuda, 1, 256, 2, 40)
    with pytest.raises(RuntimeError):   # no kv rows: the C entry point refuses
        _sweep(q, q[:, :0], q[:, :0], "sm90_pipe", False)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
