"""fp32 storage with bf16 compute, and dropout in training, against the JAX
package on the CPU:

* the layers (`Dense`, `Conv2d`, `Conv3x3`) storing fp32 and computing in
  bf16 against flax's `dtype=bfloat16` over fp32 parameters (within
  2e-2·max|ref|, two bf16 roundings apart), their gradients reaching the
  fp32 tensors; with the two dtypes equal, the layer is its one-dtype self
  bit for bit;
* the repair: a config pinning `unet.params.dtype: bfloat16` without
  `train.param_dtype` builds an LDM UNet with fp32 parameters that computes
  in bf16 (its output bf16), whose ε-loss on the same inputs is the JAX
  package's bf16-compute loss within 1e-2 relative;
* the SD UNet with dropout 0.1 in a training forward (resblocks, every
  cross-attention's output, the unfused GEGLU), fp32, both packages' masks
  injected at the flax paths: within 1e-5·max(1, max|ref|).

The DDPM step in both precisions: `test_torch_ddpm_mixed_step.py`.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_helpers import (assert_close, flax_init, injected_dropout, nprand, port,
                                to_torch)
from test_torch_helpers import jax_quick_compiles  # noqa: F401 (autouse)
from test_torch_models import TINY_UNET, unet_params
from test_torch_slice import tiny_config

from sd_tpu.models.unet_sd import UNetModel as JUNet
from sd_tpu.nn.layers import Conv3x3 as JConv3x3
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.nn.layers import Conv2d, Conv3x3, Dense, dropout_rng
from sd_tpu_torch.train import runners

BF16_TOL = 2e-2          # ·max|ref|: one bf16 rounding of the output, one of the inputs
LOSS_REL = 1e-2          # the bf16-compute losses, relative


def test_layers_store_fp32_and_compute_in_bf16():
    x = nprand(2, 6, 6, 16, seed=1)
    bf = torch.bfloat16
    for jmod, make in ((fnn.Dense(8, dtype=jnp.bfloat16),
                        lambda c: Dense(16, 8, compute_dtype=c)),
                       (fnn.Conv(8, (3, 3), padding=1, dtype=jnp.bfloat16),
                        lambda c: Conv2d(16, 8, 3, compute_dtype=c)),
                       (JConv3x3(8, dtype=jnp.bfloat16),
                        lambda c: Conv3x3(16, 8, compute_dtype=c))):
        params = flax_init(jmod, jnp.asarray(x), seed=2)
        ref = jmod.apply({"params": params}, jnp.asarray(x))
        mod = port(make(bf), params)
        got = mod(to_torch(x))
        assert got.dtype == bf and ref.dtype == jnp.bfloat16
        assert mod.weight.dtype == torch.float32
        assert_close(got.float(), np.asarray(ref, np.float32), BF16_TOL)
        mod.weight.requires_grad_(True)
        mod(to_torch(x)).float().sum().backward()
        assert mod.weight.grad.dtype == torch.float32 and mod.weight.grad.abs().sum() > 0
        with torch.no_grad():                # equal dtypes: the one-dtype layer's bits
            assert torch.equal(port(make(torch.float32), params)(to_torch(x)),
                               port(make(None), params)(to_torch(x)))


def _unet_inputs():
    return (nprand(2, 16, 16, 4, seed=3), np.array([7, 501]), nprand(2, 16, 32, seed=4))


def test_pinned_unet_dtype_computes_in_bf16_over_fp32_params():
    cfg = tiny_config()
    cfg["unet"]["params"]["dtype"] = "bfloat16"
    assert "param_dtype" not in cfg.get("train", {})
    _, unet, _, _ = runners.build_ldm(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = unet_params(seed=5)
    port(unet, params)
    assert {p.dtype for p in unet.parameters()} == {torch.float32}
    x, t, ctx = _unet_inputs()
    noise = nprand(*x.shape, seed=6)
    with torch.no_grad():
        out = unet(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert out.dtype == torch.bfloat16
    jout = jax.jit(JUNet(**TINY_UNET, dtype=jnp.bfloat16).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    loss = float(((out.float() - to_torch(noise)) ** 2).mean())
    jloss = float(jnp.mean((jout.astype(jnp.float32) - noise) ** 2))
    assert abs(loss - jloss) <= LOSS_REL * jloss


def test_sd_unet_dropout_matches():
    params = unet_params(seed=7)
    x, t, ctx = _unet_inputs()
    junet = JUNet(**TINY_UNET, dropout=0.1)
    unet = port(UNetModel(**TINY_UNET, dropout=0.1, device="cpu"), params).train()
    with injected_dropout(unet):
        ref = jax.jit(lambda p, x, t, c: junet.apply(
            {"params": p}, x, t, c, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)}))(params, jnp.asarray(x), jnp.asarray(t),
                                                      jnp.asarray(ctx))
        with torch.no_grad(), dropout_rng(torch.Generator().manual_seed(0)):
            got = unet(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert_close(got, ref, 1e-5)
    with torch.no_grad():
        det = unet(to_torch(x), torch.from_numpy(t), to_torch(ctx))
    assert not np.allclose(det.numpy(), np.asarray(ref), atol=1e-3)


def test_dropout_run_resumes_where_an_unbroken_one_ends(tmp_path):
    """`train_ddpm` with dropout 0.1 and bf16 compute: 2 steps, against 1
    step, a resume from its checkpoint and a second: the masks come from
    each step's generator, so the parameters end bit for bit equal."""
    from sd_tpu_torch.core.config import ddpm_smoke_config
    from sd_tpu_torch.train.checkpoint import restore_tree

    cfg = ddpm_smoke_config()
    cfg["model"]["params"].update(dtype="bfloat16", dropout=0.1)
    cfg["train"].update(checkpoint_every=1, eval_every=10**6)
    rng = np.random.default_rng(11)
    images = [{"image": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)}
              for _ in range(2)]
    whole, _ = runners.train_ddpm(cfg, images, max_steps=2, device="cpu")
    out = str(tmp_path / "run")
    runners.train_ddpm(cfg, images[:1], out_dir=out, max_steps=1, device="cpu")
    resumed, _ = runners.train_ddpm(cfg, images[1:], out_dir=out, max_steps=2, device="cpu")
    assert resumed.step == whole.step == 2
    for n, p in whole.params.items():
        assert torch.equal(resumed.params[n], p), n
    assert restore_tree(out + "/ckpt")["step"] == 2
