"""Helpers shared by the PyTorch-port parity tests (`tests/test_torch_*.py`),
and tests of the parameter carry-over they rest on.

The port is held against the JAX package on the CPU in fp32: the same
inputs and weights, made from a seed with numpy, go through both. Every
parameter is random (zero-init ones included), so no residual branch is
trivially zero. Tolerances: modules ≤ 1e-4·max(1, max|ref|), the
text-to-image slice ≤ 1e-3·max(1, max|ref|).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sd_tpu_torch.weights import flax_shapes, load_flax_params

# several test workers share the host's cores
torch.set_num_threads(2)

MODULE_TOL = 1e-4
SLICE_TOL = 1e-3


def randomize_tree(params, seed: int = 0):
    """A flax param tree with every leaf random: kernels N(0, 1/fan_in),
    biases N(0, 0.1²), norm scales 1 + N(0, 0.1²), embeddings N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = tuple(x.shape)
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def flax_init(module, *args, seed: int = 0, **kw):
    """Random params for a flax module, as plain nested dicts of numpy (only
    the tree's shapes are traced: every leaf is drawn anew)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return randomize_tree(_plain(params), seed)


def _plain(tree):
    return {k: _plain(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


def port(module: torch.nn.Module, params) -> torch.nn.Module:
    load_flax_params(module, params)
    return module.eval()


def jax_pipeline(cfg: dict, seed: int = 0):
    """The JAX package's `Text2ImagePipeline` of `cfg` in fp32 (its own
    `build_ldm` process, first-stage closures and programs) with every
    parameter random (`randomize_tree`). While it is built, its modules'
    `init` is only traced (`jax.eval_shape`): eager flax initialisation
    compiles one program per op, tens of seconds at these widths, and its
    values would be replaced anyway."""
    from unittest import mock

    import flax.linen as nn

    from sd_tpu.pipeline import Text2ImagePipeline as JPipeline

    real_init = nn.Module.init

    def traced_init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r: real_init(self, r, *args, **kw), rngs)
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    with mock.patch.object(nn.Module, "init", traced_init):
        jp = JPipeline(cfg, rng=jax.random.PRNGKey(seed), param_dtype=None)
    rand = lambda tree, s: jax.tree_util.tree_map(jax.numpy.asarray,
                                                 randomize_tree(_plain(tree), s))
    jp.unet_params = rand(jp.unet_params, seed)
    jp.vae_params = rand(jp.vae_params, seed + 1)
    jp.clip.params = rand(jp.clip.params, seed + 2)
    return jp


def port_pipeline(cfg: dict, jpipe):
    """The port's pipeline of `cfg` on the CPU in fp32 with `jpipe`'s weights."""
    from sd_tpu_torch.pipeline import Text2ImagePipeline

    pipe = Text2ImagePipeline(cfg, device="cpu", param_dtype=torch.float32)
    port(pipe.unet, jpipe.unet_params)
    port(pipe.vae, jpipe.vae_params)
    port(pipe.clip, jpipe.clip.params)
    return pipe


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_close(got, ref, tol: float = MODULE_TOL) -> None:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"max|Δ| = {err:.3g} > {bound:.3g}"


def nprand(*shape, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- tests of the carry-over ---------------------------------------------------


def _dense_tree():
    import flax.linen as nn
    import jax.numpy as jnp

    return flax_init(nn.Dense(3), jnp.zeros((1, 5)))


def test_load_flax_params_transposes_dense_kernels():
    from sd_tpu_torch.nn.layers import Dense

    tree = _dense_tree()
    mod = port(Dense(5, 3), tree)
    np.testing.assert_array_equal(mod.weight.numpy(), tree["kernel"].T)
    np.testing.assert_array_equal(mod.bias.numpy(), tree["bias"])
    assert flax_shapes(tree) == {"weight": (3, 5), "bias": (3,)}


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_load_flax_params_is_strict(change):
    from sd_tpu_torch.nn.layers import Dense

    tree = _dense_tree()
    if change == "missing":
        del tree["bias"]
    elif change == "extra":
        tree["other"] = np.zeros(3, np.float32)
    else:
        tree["kernel"] = np.zeros((5, 4), np.float32)
    with pytest.raises((KeyError, ValueError)):
        load_flax_params(Dense(5, 3), tree)


def test_conv_kernels_map_hwio_to_oihw():
    import flax.linen as nn
    import jax.numpy as jnp

    from sd_tpu_torch.nn.layers import Conv2d

    tree = flax_init(nn.Conv(6, (3, 3), padding=1), jnp.zeros((1, 4, 4, 2)))
    mod = port(Conv2d(2, 6, 3), tree)
    np.testing.assert_array_equal(mod.weight.numpy(),
                                  tree["kernel"].transpose(3, 2, 0, 1))
    assert mod.weight.is_contiguous(memory_format=torch.channels_last)
