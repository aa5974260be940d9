"""The port's mini x-transformers library (`sd_tpu_torch/models/x_transformer.py`)
and `FeedForwardGEGLU(glu=False)` against the JAX package's, on the CPU in
fp32 at tiny widths (dim 32, 4 heads of 8, 7 tokens).

The same seeded numpy inputs go through both, the weights carried over by
`load_flax_params` with every parameter random (the scalar gains, the memory
key / values, the talking-heads projections, the positions and memory tokens
too), each JAX apply jitted once. Every `XAttention` variant (causal,
talking heads, sparse top-k, memory key / values, the query mask, a
cross-attention with a context mask, all of them at once) and every
`AttentionLayers` layout (pre- and post-norm, macaron, sandwich, rezero,
GRU-gated residuals, ScaleNorm, RMSNorm, cross-attention, the plain MLP) is
a case; each agrees within 1e-5·max(1, max|ref|) (`TOL`). Also:
`TransformerWrapper` with memory tokens and a mask, its logits and
embedding heads, a passed-in `XEncoder`; the seeded initialisation of the
new leaves; and the errors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_helpers import (assert_close, flax_init, injected_dropout, nprand, port,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)

from sd_tpu.models import x_transformer as jx
from sd_tpu.nn import attention as jattn
from sd_tpu_torch.models import x_transformer as tx
from sd_tpu_torch.nn.attention import FeedForwardGEGLU
from sd_tpu_torch.nn.layers import dropout_rng
from sd_tpu_torch.weights import init_params_, randomize_params_

TOL = 1e-5
DIM, HEADS, DH, N, CTX = 32, 4, 8, 7, 24


def run_both(jmod, tmod, *args, seed: int = 0, **kw):
    """(port output, JAX output) of the modules on numpy args (None passes
    through) with the same random weights."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = flax_init(jmod, *jargs, seed=seed, **kw)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kw))(params, *jargs)
    with torch.no_grad():
        got = port(tmod, params)(*[None if a is None else to_torch(a) for a in args], **kw)
    return got, ref


def _mask(b: int, n: int, seed: int) -> np.ndarray:
    m = np.random.default_rng(seed).random((b, n)) > 0.3
    m[:, 0] = True                                  # every row keeps a key
    return m


# -- norms and the feed-forward ---------------------------------------------------------


@pytest.mark.parametrize("norm", ["scale", "rms"])
def test_norms_match(norm):
    x = nprand(2, N, DIM, seed=1)
    jmod, tmod = ((jx.ScaleNorm(), tx.ScaleNorm(device="cpu")) if norm == "scale"
                  else (jx.RMSNorm(), tx.RMSNorm(DIM, device="cpu")))
    got, ref = run_both(jmod, tmod, x, seed=2)
    assert_close(got, ref, TOL)


def test_feed_forward_without_glu_matches():
    x = nprand(2, N, DIM, seed=3)
    ff = FeedForwardGEGLU(DIM, glu=False, device="cpu")
    got, ref = run_both(jattn.FeedForwardGEGLU(glu=False), ff, x, seed=4)
    assert_close(got, ref, TOL)
    assert ff.proj_in.weight.shape == (4 * DIM, DIM)


# -- XAttention ---------------------------------------------------------------------------


XATTN_CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "talking_heads": dict(talking_heads=True),
    "sparse_topk": dict(sparse_topk=3),
    "mem_kv": dict(num_mem_kv=2),
    "masked": dict(),
    "cross": dict(),
    "all": dict(causal=True, talking_heads=True, sparse_topk=4, num_mem_kv=3),
}


@pytest.mark.parametrize("case", list(XATTN_CASES))
def test_xattention_matches(case):
    opts = XATTN_CASES[case]
    x = nprand(2, N, DIM, seed=5)
    ctx = nprand(2, 5, CTX, seed=6) if case == "cross" else None
    kw = {}
    if case in ("masked", "all"):
        kw["mask"] = _mask(2, N, 7)
    if case == "cross":
        kw["context_mask"] = _mask(2, 5, 8)
    tmod = tx.XAttention(DIM, HEADS, DH, context_dim=CTX if ctx is not None else None,
                         device="cpu", **opts)
    jmod = jx.XAttention(heads=HEADS, dim_head=DH, **opts)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = flax_init(jmod, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx),
                       seed=9, **jkw)
    ref = jax.jit(lambda p, a, c, k: jmod.apply({"params": p}, a, c, **k))(
        params, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), jkw)
    with torch.no_grad():
        got = port(tmod, params)(to_torch(x), None if ctx is None else to_torch(ctx),
                                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_close(got, ref, TOL)


# -- AttentionLayers ----------------------------------------------------------------------


LAYER_CASES = {
    "pre_norm": dict(),
    "post_norm": dict(pre_norm=False),
    "macaron": dict(macaron=True),
    "sandwich": dict(sandwich_coef=1),
    "rezero": dict(use_rezero=True),
    "gate_residual": dict(gate_residual=True),
    "scalenorm": dict(use_scalenorm=True),
    "rmsnorm": dict(use_rmsnorm=True, pre_norm=False),
    "cross_attend": dict(cross_attend=True),
    "mlp_ff": dict(ff_glu=False, talking_heads=True, num_mem_kv=2),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_attention_layers_match(case):
    opts = LAYER_CASES[case]
    x = nprand(2, N, DIM, seed=10)
    cross = opts.get("cross_attend", False)
    ctx = nprand(2, 5, CTX, seed=11) if cross else None
    mask = _mask(2, N, 12)
    depth = 3 if "sandwich_coef" in opts else 2
    jmod = jx.AttentionLayers(dim=DIM, depth=depth, heads=HEADS, dim_head=DH, **opts)
    tmod = tx.AttentionLayers(DIM, depth, HEADS, DH, context_dim=CTX if cross else None,
                              device="cpu", **opts)
    got, ref = run_both(jmod, tmod, x, ctx, mask, seed=13)
    assert_close(got, ref, TOL)
    assert tmod.layer_types == tuple(jmod._layer_types())


# -- TransformerWrapper -------------------------------------------------------------------


@pytest.mark.parametrize("head", ["embeddings", "logits"])
def test_transformer_wrapper_with_memory_tokens_matches(head):
    tokens = np.random.default_rng(14).integers(0, 50, (2, N)).astype(np.int32)
    mask = _mask(2, N, 15)
    kw = dict(num_tokens=50, max_seq_len=9, num_memory_tokens=2,
              return_embeddings=head == "embeddings")
    jmod = jx.TransformerWrapper(dim=DIM, depth=2, heads=HEADS, **kw)
    tmod = tx.TransformerWrapper(kw.pop("num_tokens"), kw.pop("max_seq_len"), DIM, 2, HEADS,
                                 device="cpu", **kw)
    got, ref = run_both(jmod, tmod, tokens, mask, seed=16)
    assert got.shape == ((2, N, DIM) if head == "embeddings" else (2, N, 50))
    assert_close(got, ref, TOL)


def test_transformer_wrapper_takes_an_encoder_and_both_heads():
    tokens = np.random.default_rng(17).integers(0, 40, (2, N)).astype(np.int32)
    opts = dict(heads=2, dim_head=16, use_rmsnorm=True, gate_residual=True)
    jmod = jx.TransformerWrapper(num_tokens=40, max_seq_len=N,
                                 attn_layers=jx.XEncoder(dim=DIM, depth=1, **opts))
    tmod = tx.TransformerWrapper(40, N, attn_layers=tx.XEncoder(DIM, 1, device="cpu", **opts),
                                 device="cpu")
    params = flax_init(jmod, jnp.asarray(tokens), seed=18)
    port(tmod, params)
    for logits in (False, True):
        ref = jax.jit(lambda p, t: jmod.apply({"params": p}, t, return_logits=logits))(
            params, jnp.asarray(tokens))
        with torch.no_grad():
            assert_close(tmod(torch.from_numpy(tokens), return_logits=logits), ref, TOL)
    with pytest.raises(ValueError, match="causal"):
        tx.XEncoder(DIM, 1, causal=True, device="cpu")
    with pytest.raises(ValueError, match="attn_layers"):
        tx.TransformerWrapper(40, N, device="cpu")


# -- initialisation and errors -----------------------------------------------------------


def test_init_and_randomize_cover_every_new_leaf():
    layers = tx.AttentionLayers(DIM, 1, HEADS, DH, use_rezero=True, num_mem_kv=2,
                                talking_heads=True, gate_residual=True, device="cpu")
    wrapper = tx.TransformerWrapper(50, 9, num_memory_tokens=3, attn_layers=layers,
                                    device="cpu")
    norm = tx.ScaleNorm(device="cpu")
    init_params_(wrapper, torch.Generator().manual_seed(0))
    init_params_(norm, torch.Generator().manual_seed(0))
    p = dict(wrapper.named_parameters())
    assert float(p["attn_layers.rezero_0"]) == 0.0 and float(norm.g) == 1.0
    for name in ("attn_layers.attn_0.mem_k", "attn_layers.attn_0.pre_softmax_proj",
                 "pos_emb", "memory_tokens"):
        assert 0.01 < float(p[name].std()) < 0.03, name
    randomize_params_(wrapper, torch.Generator().manual_seed(1))
    randomize_params_(norm, torch.Generator().manual_seed(1))
    for name, t in [*wrapper.named_parameters(), ("g", norm.g)]:
        assert torch.all(t != 0) and not torch.all(t == 1), name


def test_dropout_in_training_is_refused():
    """(Named when the port refused dropout.) The attention probabilities'
    dropout of a training step (`dropout_rng`) against the JAX package's
    with the same injected masks; outside it, and in eval mode, the
    deterministic form bit for bit."""
    x = nprand(2, N, DIM, seed=3)
    jattn_ = jx.XAttention(heads=HEADS, dim_head=DH, dropout=0.1)
    params = flax_init(jattn_, jnp.asarray(x), seed=4)
    attn = port(tx.XAttention(DIM, HEADS, DH, dropout=0.1, device="cpu"), params).train()
    det = attn(to_torch(x))
    with injected_dropout(attn):
        ref = jattn_.apply({"params": params}, jnp.asarray(x), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        with dropout_rng(torch.Generator().manual_seed(0)):
            assert_close(attn(to_torch(x)), ref, TOL)
            assert torch.equal(attn.eval()(to_torch(x)), det)
    assert not np.allclose(np.asarray(ref), det.detach().numpy())
