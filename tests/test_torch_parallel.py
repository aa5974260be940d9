"""The port's parallel layer (`sd_tpu_torch/parallel/`) on the CPU, over gloo
process groups of 2 and 4 ranks, against the port's one-rank step and the
JAX package's mesh layer (`tests/test_parallel.py`, `tests/test_multihost.py`
case for case).

Each group is started once for the module (`tests/torch_parallel_group.py`:
`world` processes of `tests/torch_parallel_worker.py`, which import the port
and torch only); every case runs inside it and hands its results back, and
this process runs the one-rank and JAX references meanwhile:

* `make_mesh` shapes and errors, `shard_batch`'s rows, a prefix mesh;
* the TP rules on the port's names against the JAX package's specs on the
  same tiny UNet (a flax kernel [in, out] is the port's weight [out, in]),
  and the ZeRO / FSDP specs of `test_zero_state_sharding`'s tree;
* the ZeRO-1 and FSDP steps of that tree at 2 and 4 data ranks: moments,
  and under FSDP the parameters, held 1/w per rank, and the step equal to
  the one-rank step (atol / rtol 1e-5) and to the JAX package's replicated
  step (`MODULE_TOL`);
* FSDP over the tiny UNet of `test_fsdp_unet_train_step_matches` at data 4
  and data 2 × model 2 (its attention and feed-forward split over "model"):
  the weights held ≤ 0.6 of the whole per rank, `grad_norm` and the Adam
  first moment (the averaged gradient) equal the one-rank step's (1e-5 of
  their scale) and the parameters within 1e-3 of that step's own update
  (‖θ_w − θ_1‖ ≤ 1e-3·‖θ_1 − θ_0‖ over the elements whose gradient is above
  1e-5 of the largest: Adam moves every element by about lr·sign(g), and
  where g is rounding noise, in the directions a GroupNorm makes null, any
  summation order flips it; `_by_update`);
* `train_ldm` with a `parallel:` block at world 2 (ZeRO-1 and FSDP, grad
  accumulation, caption dropout) equal to the one-rank run, its world-2
  checkpoint resumed at world 1 as the one-rank checkpoint resumes;
  `train_kl_vae` (FSDP; BatchNorm PatchGAN), `train_vq` (ZeRO-1; EMA
  codebook, BatchNorm), `train_ddpm` (FSDP, dropout 0.1: its masks drawn
  for the whole batch), `train_ldm_inpaint` (its host masks and caption
  draws) and `train_ldm_sr` at world 2 equal to world 1: the logs, the
  running statistics and the codebook at 1e-5, both moments at 1e-5 of
  their scale, the parameters and the EMA by the rule above;
* a group of 2 without a `parallel:` block: `train_ldm` raises naming the
  block, and the CLI refuses a task that reads none (exit 2);
* `initialize`'s no-op, `process_local_batch`, the loader's rank and row
  rules, `host_local_to_global`.
"""

from __future__ import annotations

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_group import Group

from sd_tpu.parallel import mesh as jmesh
from sd_tpu.train.diffusion import ddpm_optimizer as jddpm_optimizer
from sd_tpu.train.diffusion import init_train_state as jinit_train_state
from sd_tpu.train.diffusion import make_diffusion_train_step as jmake_step
from sd_tpu_torch.core.config import (ddpm_smoke_config, inpaint_smoke_config,
                                     kl_f8_256_train_config, ldm_sr_smoke_config,
                                     sd512_train_config, vq_smoke_config)
from sd_tpu_torch.data.loader import DataLoader
from sd_tpu_torch.models.unet_sd import UNetModel
from sd_tpu_torch.parallel import mesh as pm
from sd_tpu_torch.parallel.multihost import initialize, process_local_batch
from sd_tpu_torch.train import checkpoint as ckpt
from sd_tpu_torch.train import runners
from sd_tpu_torch.train.diffusion import (ddpm_optimizer, init_train_state,
                                          make_diffusion_train_step)
from sd_tpu_torch.weights import randomize_params_, torch_name

from test_torch_helpers import MODULE_TOL, init_shapes, jax_quick_compiles  # noqa: F401

TOL = 1e-5
UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4, context_dim=32)
TINY_VAE = dict(embed_dim=4, ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
                z_channels=4)


def _dense(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"dense.weight": torch.tensor(rng.normal(size=(32, 16)), dtype=torch.float32),
            "dense.bias": torch.zeros(32),
            "to_q.weight": torch.tensor(rng.normal(size=(16, 16)), dtype=torch.float32)}


def _ldm_cfg(mode: str) -> dict:
    cfg = sd512_train_config()
    cfg["unet"]["params"].update(UNET)
    cfg["first_stage"]["params"].update(TINY_VAE)
    cfg["cond_stage"]["params"] = dict(vocab_size=1000, hidden_size=32, num_layers=2,
                                       num_heads=4, max_length=16)
    cfg["latent"]["image_size"] = 4
    cfg["train"].update(image_size=32, lr_schedule=None, param_dtype="float32", grad_accum=2,
                        checkpoint_every=2, remat="none")
    cfg["parallel"] = {"mesh": {"data": 2}, "state_sharding": mode}
    return cfg


def _kl_cfg() -> dict:
    cfg = kl_f8_256_train_config()
    cfg["model"]["params"] = dict(TINY_VAE, ch_mult=[1, 2], attn_resolutions=[])
    cfg["discriminator"] = {"ndf": 8, "n_layers": 1, "use_actnorm": False}
    cfg["loss"].update(perceptual="none", disc_start=0)
    cfg["train"].update(image_size=32, batch_size=4, checkpoint_every=2, eval_every=2)
    cfg["parallel"] = {"mesh": {"data": 2}, "state_sharding": "fsdp"}
    return cfg


def _vq_cfg() -> dict:
    cfg = vq_smoke_config()
    cfg["model"]["params"]["quantizer_type"] = "ema"
    cfg["discriminator"]["use_actnorm"] = False
    cfg["train"].update(batch_size=4, checkpoint_every=2, eval_every=2)
    cfg["parallel"] = {"mesh": {"data": 2}, "state_sharding": "zero1"}
    return cfg


def _ddpm_cfg() -> dict:
    cfg = ddpm_smoke_config()
    cfg["model"]["params"]["dropout"] = 0.1
    cfg["train"].update(batch_size=4, grad_accum=2, checkpoint_every=2, eval_every=2)
    cfg["parallel"] = {"mesh": {"data": 2}, "state_sharding": "fsdp"}
    return cfg


def _inpaint_cfg() -> dict:
    cfg = inpaint_smoke_config()
    cfg["train"].update(batch_size=4, checkpoint_every=2, eval_every=2)
    cfg["parallel"] = {"mesh": {"data": 2}}
    return cfg


def _sr_cfg() -> dict:
    cfg = ldm_sr_smoke_config()
    cfg["train"].update(batch_size=4, checkpoint_every=2)
    cfg["parallel"] = {"mesh": {"data": 2}, "state_sharding": "zero1"}
    return cfg


# name: ((module, trainer), config, batch fields)
TRAINERS = {"ldm_zero1": (("sd_tpu_torch.train.runners", "train_ldm"),
                          lambda: _ldm_cfg("zero1"), ("txt", 32)),
            "ldm_fsdp": (("sd_tpu_torch.train.runners", "train_ldm"),
                         lambda: _ldm_cfg("fsdp"), ("txt", 32)),
            "kl_vae": (("sd_tpu_torch.train.runners", "train_kl_vae"), _kl_cfg, ("", 32)),
            "vq": (("sd_tpu_torch.train.runners", "train_vq"), _vq_cfg, ("", 32)),
            "ddpm": (("sd_tpu_torch.train.runners", "train_ddpm"), _ddpm_cfg, ("", 16)),
            "inpaint": (("sd_tpu_torch.train.inpaint", "train_ldm_inpaint"), _inpaint_cfg,
                        ("txt", 32)),
            "sr": (("sd_tpu_torch.train.sr", "train_ldm_sr"), _sr_cfg, ("lr", 32))}


def _run(name: str):
    import importlib

    module, fn = TRAINERS[name][0]
    return getattr(importlib.import_module(module), fn)


def _batches(fields: tuple) -> list[dict]:
    kind, size = fields
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        img = lambda s: (rng.integers(0, 256, (4, s, s, 3)) / 127.5 - 1.0).astype(np.float32)
        b = {"image": img(size)}
        if kind == "txt":
            b["txt_raw"] = ["a photo of a cat", "a photo of a dog", "a red cube", "a tree"]
        elif kind == "lr":
            b["lr"] = img(size // 4)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' results, and the one-rank references made meanwhile."""
    root = tmp_path_factory.mktemp("parallel")
    unet = UNetModel(**UNET, device="cpu")
    randomize_params_(unet, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    steps_in = {"dense": _dense(), "unet_cfg": UNET,
                "dense_x": torch.tensor(rng.normal(size=(8, 16)), dtype=torch.float32),
                "unet": {n: p.detach().clone() for n, p in unet.named_parameters()},
                "unet_x": torch.tensor(rng.normal(size=(8, 16, 16, 4)), dtype=torch.float32)}
    train_in = {"trainers": {name: t[0] for name, t in TRAINERS.items()}}
    for name, (_, make, fields) in TRAINERS.items():
        train_in[f"{name}_cfg"] = make()
        train_in[f"{name}_batches"] = _batches(fields)
        train_in[f"{name}_dir"] = str(root / f"{name}_w2")
    started = {"w2": Group("steps", 2, root / "w2", steps_in),
               "w4": Group("steps", 4, root / "w4", steps_in),
               "trainers": Group("trainers", 2, root / "trainers", train_in)}
    refs = {"unet": _unet_reference(steps_in), "root": root, "inputs": train_in}
    for name in TRAINERS:
        cfg = copy.deepcopy(train_in[f"{name}_cfg"])
        del cfg["parallel"]
        for steps in (0, 2):
            _, hist = _run(name)(copy.deepcopy(cfg), train_in[f"{name}_batches"],
                                 out_dir=str(root / f"{name}_w1_{steps}"), max_steps=steps,
                                 device="cpu")
        refs[name] = hist
    return {k: g.results() for k, g in started.items()}, steps_in, refs


def _unet_reference(inputs: dict) -> dict:
    """The tiny UNet's one-rank step (θ_0, θ_1, mu, grad_norm)."""
    unet = UNetModel(**UNET, device="cpu")
    with torch.no_grad():
        for n, p in unet.named_parameters():
            p.copy_(inputs["unet"][n])
    opt = ddpm_optimizer(1e-3)
    state = init_train_state(dict(unet.named_parameters()), opt, ema_decay=0.99)

    def loss_fn(batch, generator, logvar):
        t = torch.zeros(batch.shape[0], dtype=torch.int64)
        return (unet(batch, t, torch.zeros(batch.shape[0], 7, 32)) ** 2).mean(), {}

    logs = make_diffusion_train_step(loss_fn, opt)(state, inputs["unet_x"])
    return {"params": {n: p.detach().clone() for n, p in state.params.items()},
            "mu": [m.clone() for m in state.opt_state.mu],
            "grad_norm": float(logs["grad_norm"])}


def _close(got: dict, ref: dict, tol: float = TOL) -> None:
    for n in ref:
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(ref[n]), atol=tol, rtol=tol,
                                   err_msg=n)


def _by_update(got: dict, one: dict, zero: dict, mu: list, bound: float = 1e-3) -> None:
    """‖θ_w − θ_1‖₂ ≤ bound·‖θ_1 − θ_0‖₂, the difference over the elements
    whose one-rank gradient (its first moment `mu`, in the leaves' order) is
    above 1e-5 of the largest: below it the gradient is rounding noise (the
    directions a GroupNorm makes null), which Adam scales to ±lr whatever
    its size, so any summation order moves those elements by up to 2·lr."""
    scale = max(float(torch.as_tensor(m).abs().max()) for m in mu)
    diff = step = 0.0
    for n, m in zip(one, mu):
        a, b, z = (torch.as_tensor(t[n]).double() for t in (got, one, zero))
        real = torch.as_tensor(m).abs() >= 1e-5 * scale
        diff += float(((a - b) * real).pow(2).sum())
        step += float((b - z).pow(2).sum())
    assert step > 0 and diff ** 0.5 <= bound * step ** 0.5, (diff ** 0.5, step ** 0.5)


def _scaled(got: list, ref: list, tol: float = TOL) -> None:
    """Each tensor within tol of the largest magnitude over the list."""
    scale = max(float(torch.as_tensor(r).abs().max()) for r in ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float((torch.as_tensor(g) - torch.as_tensor(r)).abs().max())
        assert err <= tol * scale, (i, err, scale)


# -- mesh, rules, multihost -----------------------------------------------------------


def test_make_mesh_shapes_and_rows(groups):
    results = groups[0]
    w4 = results["w4"]
    assert [r["mesh"] for r in w4] == [(("data",), (4,), {"data": i}) for i in range(4)]
    assert w4[0]["mesh_2x2"] == (2, 2)
    assert "wants 3 ranks" in w4[0]["mesh_3"]
    assert [r["prefix"] for r in w4] == [{"data": 0}, {"data": 1}, None, None]
    for world, res in ((2, results["w2"]), (4, w4)):
        per = 16 // world
        for r, out in enumerate(res):
            assert out["rows"].tolist() == list(range(r * per, (r + 1) * per))


def _axes(**sizes):
    return types.SimpleNamespace(axes=lambda: dict(sizes))


def test_tp_rules_on_the_port_names_equal_the_tpu_packages():
    from sd_tpu.models.unet_sd import UNetModel as JUNet

    shapes = init_shapes(JUNet(**UNET), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
                         jnp.zeros((1, 7, 32)))["params"]
    jm = jmesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    jspecs = jmesh.infer_param_sharding(shapes, jm, jmesh.TP_RULES_UNET)
    unet = UNetModel(**UNET, device="meta")
    ours = pm.infer_param_sharding(dict(unet.named_parameters()), _axes(data=2, model=2),
                                   pm.TP_RULES_UNET)
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert len(flat) == len(ours)
    split = 0
    for path, sh in flat:
        keys = tuple(str(k.key) for k in path)
        shape = _leaf(shapes, keys).shape
        name, perm = torch_name(keys, len(shape))
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        want = spec if perm is None else tuple(spec[i] for i in perm)
        assert ours[name] == want, (name, ours[name], want)
        split += "model" in want
    assert split == 44


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_rules_zero_and_fsdp_specs_mirror_the_tpu_packages():
    rng = jax.random.PRNGKey(0)
    jparams = {"dense": {"kernel": jax.random.normal(rng, (16, 32)), "bias": jnp.zeros((32,))},
               "to_q": {"kernel": jax.random.normal(rng, (16, 16))},
               "odd": {"to_q": {"kernel": jnp.zeros((7, 7))}}}
    jm = jmesh.make_mesh({"data": 4, "model": 2})
    jstate = jinit_train_state(jparams, jddpm_optimizer(1e-2), ema_decay=0.99)
    ours_params = {"dense.weight": torch.zeros(32, 16), "dense.bias": torch.zeros(32),
                   "to_q.weight": torch.zeros(16, 16), "odd.to_q.weight": torch.zeros(7, 7)}
    state = init_train_state(ours_params, ddpm_optimizer(1e-2), ema_decay=0.99)
    mesh = _axes(data=4, model=2)
    mesh.size = lambda a: mesh.axes().get(a, 1)
    mesh.index, mesh.group = (lambda a: 0), (lambda a: None)
    for jfn, fn in ((jmesh.zero_state_sharding, pm.zero_state_sharding),
                    (jmesh.fsdp_state_sharding, pm.fsdp_state_sharding)):
        jsh = jfn(jstate, jm, tp_rules=jmesh.TP_RULES_UNET)
        sh = fn(state, mesh, tp_rules=pm.TP_RULES_UNET)
        for (path, leaf) in jax.tree_util.tree_flatten_with_path(
                jsh.params, is_leaf=lambda x: hasattr(x, "spec"))[0]:
            keys = tuple(str(k.key) for k in path)
            shape = _leaf(jparams, keys).shape
            name, perm = torch_name(keys, len(shape))
            spec = tuple(leaf.spec) + (None,) * (len(shape) - len(leaf.spec))
            assert sh.params[name] == (spec if perm is None else tuple(spec[i] for i in perm))
            ema = _leaf(jsh.ema.shadow, keys).spec
            ema = tuple(ema) + (None,) * (len(shape) - len(ema))
            assert sh.ema.shadow[name] == (ema if perm is None else tuple(ema[i] for i in perm))
        assert sh.opt_state.mu == list(sh.ema.shadow.values())
        # the layout the trainers run: `shard_train_state_` over the split
        # `shard_module_` would make holds each leaf as the specs above say
        mode = "fsdp" if jfn is jmesh.fsdp_state_sharding else "zero1"
        tp = {n: pm.Leaf(tp_dim=spec.index("model"))
              for n, spec in pm.infer_param_sharding(ours_params, mesh, pm.TP_RULES_UNET).items()
              if "model" in spec}
        run = init_train_state({n: t.clone() for n, t in ours_params.items()},
                               ddpm_optimizer(1e-2), ema_decay=0.99)
        sharded = pm.shard_train_state_(run, mesh, mode, tp)
        for leaf, (name, spec) in zip(sharded.leaves, sh.ema.shadow.items(), strict=True):
            assert leaf.data_dim == (spec.index("data") if "data" in spec else None), name
            assert leaf.tp_dim == (spec.index("model") if "model" in spec else None), name
            whole = ours_params[name].shape
            held = run.params[name].shape
            assert (held != whole) == ("data" in sh.params[name]), name


def test_initialize_is_a_no_op_without_a_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_picks_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device: pass device='cpu'"):
        initialize(backend="gloo", rank=0, world_size=2)
    assert not torch.distributed.is_initialized()


def test_process_local_batch_math():
    assert process_local_batch(32, world=4) == 8
    assert process_local_batch(8, world=1) == 8
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        process_local_batch(10, world=4)


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


def test_loader_ranks_and_rows():
    full = [b["x"][:, 0].tolist() for b in DataLoader(_Range(24), 4, seed=9, num_workers=1)]
    by_rank = [[b["x"][:, 0].tolist() for b in DataLoader(_Range(24), 4, seed=9, num_workers=1,
                                                          rank=r, world=2)] for r in range(2)]
    assert by_rank == [full[0::2], full[1::2]]
    rows = pm.local_rows(4, 2, 1, 2)          # rank 1 of 2, two microbatches of 2
    assert rows.tolist() == [1, 3]
    got = [b["x"][:, 0].tolist() for b in DataLoader(_Range(24), 4, seed=9, num_workers=1,
                                                     rows=rows)]
    assert got == [[b[1], b[3]] for b in full]
    with pytest.raises(ValueError, match="must divide the data axis"):
        pm.local_rows(6, 2, 0, 2)
    with pytest.raises(ValueError, match="grad_accum"):
        pm.local_rows(6, 4, 0, 2)


def test_host_local_to_global(groups):
    results, inputs, _ = groups
    for r in results["w2"]:
        np.testing.assert_array_equal(r["global_x"].numpy(), inputs["dense_x"].numpy())


# -- the steps ------------------------------------------------------------------------


def _jax_dense_step(inputs: dict) -> dict:
    d = {k: v.numpy() for k, v in inputs["dense"].items()}
    params = {"dense": {"kernel": jnp.asarray(d["dense.weight"].T),
                        "bias": jnp.asarray(d["dense.bias"])},
              "to_q": {"kernel": jnp.asarray(d["to_q.weight"].T)}}
    opt = jddpm_optimizer(1e-2)
    state = jinit_train_state(params, opt, ema_decay=0.99)

    def loss_fn(p, batch, rng, logvar):
        out = jnp.tanh(batch @ p["dense"]["kernel"] + p["dense"]["bias"])
        return jnp.mean(out ** 2) + jnp.mean(p["to_q"]["kernel"] ** 2), {}

    new, logs = jax.jit(jmake_step(loss_fn, opt, jit=False))(
        state, jnp.asarray(inputs["dense_x"].numpy()), jax.random.PRNGKey(3))
    flat = lambda t: {"dense.weight": np.asarray(t["dense"]["kernel"]).T,
                      "dense.bias": np.asarray(t["dense"]["bias"]),
                      "to_q.weight": np.asarray(t["to_q"]["kernel"]).T}
    return {"params": flat(new.params), "ema": flat(new.ema.shadow),
            "grad_norm": float(logs["grad_norm"])}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_zero_and_fsdp_steps_equal_one_rank_and_the_tpu_packages(groups, world, mode):
    results, inputs, _ = groups
    import torch_parallel_worker as worker

    worker.DENSE.clear()
    worker.DENSE.update({k: v.clone() for k, v in inputs["dense"].items()})
    opt = ddpm_optimizer(1e-2)
    state = init_train_state(worker.DENSE, opt, ema_decay=0.99)
    logs = make_diffusion_train_step(worker.dense_loss, opt)(state, inputs["dense_x"])
    one = {n: p.detach() for n, p in state.params.items()}
    jref = _jax_dense_step(inputs)
    for r, out in enumerate(results[f"w{world}"]):
        got = out[f"dense_{mode}"]
        _close(got["params"], one)
        _close(got["ema"], state.ema.shadow)
        np.testing.assert_allclose(got["grad_norm"], float(logs["grad_norm"]), rtol=TOL)
        _close(got["params"], jref["params"], MODULE_TOL)
        _close(got["ema"], jref["ema"], MODULE_TOL)
        np.testing.assert_allclose(got["grad_norm"], jref["grad_norm"], rtol=MODULE_TOL)
        # the moments held 1/w (every leaf here divides); under FSDP the parameters too
        for n, (mu, p) in got["held"].items():
            whole = inputs["dense"][n].numel()
            assert mu == whole // world, (n, mu)
            assert p == (whole // world if mode == "fsdp" else whole), (n, p)


@pytest.mark.parametrize("axes", ["unet_data4", "unet_data2_model2"])
def test_fsdp_unet_step_equals_the_one_rank_step(groups, axes):
    results, inputs, refs = groups
    ref = refs["unet"]
    total = sum(p.numel() for p in inputs["unet"].values())
    for out in results["w4"]:
        got = out[axes]
        assert got["local"] < 0.6 * total
        assert bool(got["split"]) == (axes == "unet_data2_model2")
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=TOL)
        _scaled(got["mu"], ref["mu"])
        _by_update(got["params"], ref["params"], inputs["unet"], ref["mu"])


# -- the trainers ---------------------------------------------------------------------


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{path}/{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_at_world_2_equals_world_1(groups, name):
    results, _, refs = groups
    root = refs["root"]
    for r in results["trainers"]:
        for got, want in zip(r[name], refs[name], strict=True):
            for k, v in want.items():
                if k != "seconds":
                    np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)
    w2 = ckpt.restore_tree(str(root / f"{name}_w2" / "ckpt"))
    w1 = ckpt.restore_tree(str(root / f"{name}_w1_2" / "ckpt"))
    w0 = ckpt.restore_tree(str(root / f"{name}_w1_0" / "ckpt"))
    assert _flat(w2).keys() == _flat(w1).keys()
    assert w2["step"] == w1["step"] == 2
    moments = {"params": "opt_state", "params_g": "opt_state_g", "params_d": "opt_state_d"}
    for field, opt in moments.items():
        if field in w1:
            _scaled(w2[opt]["mu"], w1[opt]["mu"])
            _scaled(w2[opt]["nu"], w1[opt]["nu"])
            assert w2[opt]["count"] == w1[opt]["count"]
            _by_update(w2[field], w1[field], w0[field], w1[opt]["mu"])
    for field in ("batch_stats_d", "model_state"):
        if field in w1:
            _close(w2[field], w1[field])
    if "ema" in w1:
        _by_update(w2["ema"]["shadow"], w1["ema"]["shadow"], w0["ema"]["shadow"],
                   w1["opt_state"]["mu"])
        assert w2["ema"]["num_updates"] == w1["ema"]["num_updates"]


def test_a_group_without_a_parallel_block_refuses_to_train(groups):
    for r in groups[0]["trainers"]:
        assert "process group has 2 ranks and the config has no `parallel:` block" in r["no_block"]
        assert r["cli_ti"] == 2


def test_world_2_checkpoint_resumes_at_world_1(groups):
    _, _, refs = groups
    root, inputs = refs["root"], refs["inputs"]
    cfg = copy.deepcopy(inputs["ldm_zero1_cfg"])
    del cfg["parallel"]
    hist = {}
    for run in ("ldm_zero1_w2", "ldm_zero1_w1_2"):
        _, hist[run] = runners.train_ldm(copy.deepcopy(cfg), inputs["ldm_zero1_batches"],
                                         out_dir=str(root / run), max_steps=3, device="cpu")
    a, b = hist["ldm_zero1_w2"], hist["ldm_zero1_w1_2"]
    assert len(a) == len(b) == 1
    for k, v in b[0].items():
        if k != "seconds":
            np.testing.assert_allclose(a[0][k], v, rtol=TOL, atol=TOL, err_msg=k)
    w2 = ckpt.restore_tree(str(root / "ldm_zero1_w2" / "ckpt"))
    w1 = ckpt.restore_tree(str(root / "ldm_zero1_w1_2" / "ckpt"))
    assert w2["step"] == w1["step"] == 3
    _close(w2["params"], w1["params"])
