"""The rank mesh and the parallel training and serving layouts.

Counterpart of `sd_tpu/parallel/mesh.py`. The TPU package names a
`jax.sharding.Mesh` and lets XLA insert the collectives; the port runs one
process per rank in a `torch.distributed` group and makes each collective
itself:

  * `make_mesh(axes)`: the group's first prod(axes) ranks as an array over
    the named axes, in the TPU package's order ("data" outer, "model"
    inner), with one process group per line of each axis;
  * "data": each rank takes its rows of every microbatch (`local_rows`),
    every draw of a step is made at the microbatch's global shape and each
    rank keeps its rows (`batch_rows`, `global_draw`), and the gradient is
    averaged over the axis after accumulation and before the global norm;
  * "model": Megatron tensor parallelism of the UNet's attention and
    feed-forward (`TP_RULES_UNET` on the port's parameter names,
    `shard_module_`): q/k/v and the feed-forward's input split by output
    rows (GEGLU's fused input by matching rows of its value and gate
    halves), the output projections by input columns, each rank attending
    over its own heads; a row-parallel output is all-reduced and its bias
    added once after the sum;
  * state: ZeRO-1 (`zero_state_sharding`: Adam's moments and the EMA
    shadow held 1/w per rank on each leaf's largest divisible free dim,
    updated shard-locally, the parameters gathered back) and ZeRO-3
    (`fsdp_state_sharding`: the parameters held sharded between steps too,
    gathered for the step), and their GAN forms (`gan_state_sharding`).

A spec is a tuple of axis names (or None) per dim of a tensor in the
port's layout. The rules keep the TPU package's specs, written for flax's
layout (a Dense kernel [in, out], a conv kernel [kh, kw, in, out]), and
`infer_param_sharding` reads them against the flax-ordered shape, so a
rule splits (or, where the shape does not divide, replicates) exactly the
leaves it does there; the spec it returns is in the port's dims.

Collectives: `all_reduce` and `broadcast` on every backend; `all_gather` on
NCCL and on CPU tensors, and as one broadcast per rank of CUDA tensors under
gloo (which carries only those two for CUDA tensors). A mesh that does not
fit the group, a batch that does not divide the data axis and a layout the
modules cannot run raise; nothing falls back to one rank.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

Spec = tuple

# -- the mesh ------------------------------------------------------------------------


class Mesh:
    """Ranks of the process group over named axes (the array `ranks`, its
    shape the axes' sizes), with this rank's coordinate and one process
    group per axis line that holds it."""

    def __init__(self, axes: dict[str, int], ranks: np.ndarray, device=None):
        self.axis_names = tuple(axes)
        self.shape = tuple(int(v) for v in axes.values())
        self.ranks = np.asarray(ranks).reshape(self.shape)
        self.device = device
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        self.coord = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                      if len(where) else None)
        self._groups: dict[str, Any] = {}
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.shape[i])
            for line in lines:       # every rank makes every group, in one order
                group = dist.new_group([int(r) for r in line])
                if me in line:
                    self._groups[name] = group
        self._device_mesh = None

    @property
    def devices(self) -> np.ndarray:
        """The rank array (`jax.sharding.Mesh.devices`' counterpart)."""
        return self.ranks

    def axes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        return self.axes().get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 on an axis the mesh lacks)."""
        if self.coord is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside the mesh {self.axes()}")
        return self.coord.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along `axis` (None on an
        axis the mesh lacks)."""
        return self._groups.get(axis)

    def device_mesh(self):
        """The same layout as a `torch.distributed.DeviceMesh` (for DTensor)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            kind = "cpu" if self.device is None else torch.device(self.device).type
            self._device_mesh = DeviceMesh(kind, torch.as_tensor(self.ranks),
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.axes()})"


def make_mesh(axes: dict[str, int] | None = None, ranks: Sequence[int] | None = None,
              device=None) -> Mesh:
    """A mesh over the process group: default every rank on one "data"
    axis; `axes` over all of its ranks, or over `ranks` (e.g. a prefix, as
    the TPU package takes `devices[:n]`). Raises without a process group and
    where the axes do not cover the ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a torch.distributed process group: launch with "
                           "torchrun (or call sd_tpu_torch.parallel.multihost.initialize())")
    world = dist.get_world_size()
    if axes is None:
        axes = {"data": world}
    n = int(np.prod(list(axes.values())))
    ranks = np.asarray(list(range(world) if ranks is None else ranks))
    if ranks.size != n:
        raise ValueError(f"mesh {dict(axes)} wants {n} ranks, got {ranks.size}")
    if device is None:
        from sd_tpu_torch.parallel.multihost import local_device

        device = local_device()
    return Mesh(dict(axes), ranks, device)


# -- collectives ---------------------------------------------------------------------


def _cuda_under_gloo(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` summed (or `op`) over `group`, in place."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_flat(t: torch.Tensor, group) -> torch.Tensor:
    """The 1-D tensors `t` of every rank of `group`, concatenated in rank
    order: one all_gather, or under gloo with CUDA tensors one broadcast per
    rank."""
    n = dist.get_world_size(group)
    out = torch.empty((n, t.numel()), dtype=t.dtype, device=t.device)
    if _cuda_under_gloo(t, group):
        me = dist.get_rank(group)
        for r in range(n):
            if r == me:
                out[r].copy_(t)
            dist.broadcast(out[r], src=dist.get_global_rank(group, r), group=group)
    else:
        dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out.reshape(-1)


def _bucketed(tensors: list[torch.Tensor], limit: int):
    """The tensors in consecutive runs of at most `limit` elements (one
    longer tensor alone)."""
    run, size = [], 0
    for t in tensors:
        if run and size + t.numel() > limit:
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


BUCKET = 1 << 26       # elements per fused collective (256 MB in fp32)


def all_reduce_mean_(tensors: list[torch.Tensor], group, size: int) -> None:
    """Each tensor averaged over `group` in place, summed in fp32 in
    buckets of `BUCKET` elements."""
    for run in _bucketed([t for t in tensors if t.numel()], BUCKET):
        flat = torch.cat([t.reshape(-1).float() for t in run])
        all_reduce_(flat, group)
        flat /= size
        pos = 0
        for t in run:
            t.copy_(flat[pos:pos + t.numel()].view_as(t))
            pos += t.numel()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis (the input
    of a column-parallel layer is replicated, its gradient partial)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float().contiguous()
        all_reduce_(g32, ctx.group)
        return g32.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Partial outputs summed over the model axis; the gradient passes as
    it is (every rank holds the whole output)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverData(torch.autograd.Function):
    """The mean over the data axis, forward and backward (a statistic every
    rank's loss reads)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return all_reduce_(x.float().contiguous().clone(), group).div_(size).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_(g.float().contiguous().clone(), ctx.group)
                .div_(ctx.size).to(g.dtype), None, None)


# -- the data axis: rows and draws ---------------------------------------------------

# (index of this rank's rows in the global batch, global batch size)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("sd_tpu_torch_rows", default=None)
# (process group, size) of the data axis inside a parallel step
_DATA: contextvars.ContextVar = contextvars.ContextVar("sd_tpu_torch_data", default=None)


def local_rows(batch_size: int, grad_accum: int, rank: int, size: int) -> np.ndarray:
    """The positions in a global batch of `batch_size` rows that data rank
    `rank` of `size` holds: its rows of each of the `grad_accum`
    microbatches, in microbatch order. Raises where a microbatch does not
    divide over the axis."""
    if batch_size % grad_accum:
        raise ValueError(f"batch of {batch_size} does not split into grad_accum={grad_accum}")
    micro = batch_size // grad_accum
    if micro % size:
        raise ValueError(f"microbatch of {micro} rows (batch {batch_size} / grad_accum "
                         f"{grad_accum}) must divide the data axis ({size})")
    per = micro // size
    return np.concatenate([np.arange(i * micro + rank * per, i * micro + (rank + 1) * per)
                           for i in range(grad_accum)])


@contextlib.contextmanager
def batch_rows(index, total: int):
    """Inside: every `global_draw` makes its draw for `total` rows and
    keeps the rows `index` (this rank's positions)."""
    token = _ROWS.set((np.asarray(index, dtype=np.int64), int(total)))
    try:
        yield
    finally:
        _ROWS.reset(token)


def global_draw(draw: Callable[[int], Any], n: int):
    """`draw(n)` — a draw whose leading dim is the batch — or, inside
    `batch_rows`, `draw(total)` with this rank's rows kept: each rank of a
    data-parallel run takes the numbers a one-rank run draws for its rows."""
    rows = _ROWS.get()
    if rows is None:
        return draw(n)
    index, total = rows
    if len(index) != n:
        raise ValueError(f"a draw for {n} rows inside batch_rows of {len(index)} local rows")
    full = draw(total)
    if isinstance(full, list):
        return [full[i] for i in index]
    if len(index) and np.all(np.diff(index) == 1):
        return full[int(index[0]):int(index[0]) + n]
    return full[torch.as_tensor(index) if torch.is_tensor(full) else index]


@contextlib.contextmanager
def data_axis(mesh: Mesh | None):
    """Inside: `data_mean` / `data_sum_` reduce over the mesh's data axis."""
    token = _DATA.set(None if mesh is None else (mesh.group("data"), mesh.size("data")))
    try:
        yield
    finally:
        _DATA.reset(token)


def data_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the data axis of the enclosing `data_axis`
    (autograd: the gradient's mean likewise); `t` itself outside one."""
    ctx = _DATA.get()
    if ctx is None:
        return t
    return _MeanOverData.apply(t, *ctx)


def data_sum_(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data axis in place (no gradient), or `t`."""
    ctx = _DATA.get()
    if ctx is not None:
        all_reduce_(t, ctx[0])
    return t


# -- parameter rules -----------------------------------------------------------------

# The TPU package's Megatron rules over the "model" axis, its specs in flax's
# layout: q/k/v and FF-in kernels split on the output dim (column parallel),
# out-projections and FF-out on the input dim (row parallel); the biases of
# column-parallel layers with their outputs.
TP_RULES_UNET: list[tuple[str, Spec]] = [
    (r".*(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.weight$", (None, "model")),
    (r".*(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.bias$", ("model",)),
    (r".*qkv\.weight$", (None, None, None, "model")),
    (r".*(to_out|out_proj|proj_out)\.weight$", ("model", None)),
    (r".*ff\.proj_in\.weight$", (None, "model")),
    (r".*ff\.proj_in\.bias$", ("model",)),
    (r".*ff\.proj_out\.weight$", ("model", None)),
    (r".*(fc1)\.weight$", (None, "model")),
    (r".*(fc1)\.bias$", ("model",)),
    (r".*(fc2)\.weight$", ("model", None)),
]


def _flax_dims(ndim: int) -> list[int]:
    """For each flax dim, the port dim holding it: a Dense kernel [in, out]
    is the weight [out, in], a conv kernel [kh, kw, in, out] the weight
    [out, in, kh, kw]; other leaves keep their order."""
    return {2: [1, 0], 4: [2, 3, 1, 0]}.get(ndim, list(range(ndim)))


def _to_port(flax_spec: Spec, ndim: int) -> Spec:
    spec = [None] * ndim
    for i, name in enumerate(tuple(flax_spec) + (None,) * (ndim - len(flax_spec))):
        spec[_flax_dims(ndim)[i]] = name
    return tuple(spec)


def _spec_fits(spec: Spec, shape: tuple, axis_sizes: dict) -> bool:
    if len(spec) > len(shape):
        return False
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        if dim % int(np.prod([axis_sizes.get(n, 1) for n in names])):
            return False
    return True


def replicated(tensor_or_ndim) -> Spec:
    """The all-None spec of a tensor (or of a rank `ndim`)."""
    n = tensor_or_ndim if isinstance(tensor_or_ndim, int) else tensor_or_ndim.dim()
    return (None,) * n


def infer_param_sharding(params: dict[str, torch.Tensor], mesh: Mesh,
                         rules: list[tuple[str, Spec]] | None = None) -> dict[str, Spec]:
    """Each named tensor's spec (port dims): the first rule whose pattern
    matches its name, read against the flax-ordered shape; a rule that does
    not divide the shape, and an unmatched name, replicate."""
    sizes = mesh.axes()
    out = {}
    for name, t in params.items():
        spec = replicated(t)
        for pattern, flax_spec in rules or []:
            if re.match(pattern, name):
                flax_shape = tuple(t.shape[d] for d in _flax_dims(t.dim()))
                if _spec_fits(flax_spec, flax_shape, sizes):
                    spec = _to_port(flax_spec, t.dim())
                break
        out[name] = spec
    return out


def shard_batch(mesh: Mesh, batch: Any, axis: str = "data") -> Any:
    """This rank's rows of every tensor / array / list of `batch` (leading
    dim split over `axis` in rank order); raises where a batch does not
    divide."""
    n, r = mesh.size(axis), mesh.index(axis)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        b = len(x)
        if b % n:
            raise ValueError(f"batch {b} must divide the {axis} axis ({n})")
        part = b // n
        return x[r * part:(r + 1) * part]

    return take(batch)


# -- state layouts -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """How a tensor is laid out: split over "model" on `tp_dim` (`paired`:
    by matching rows of its two halves, GEGLU's fused value/gate input) and
    over "data" on `data_dim`; None: whole on every rank of that axis."""

    tp_dim: int | None = None
    paired: bool = False
    data_dim: int | None = None


def _tp_take(t: torch.Tensor, leaf: Leaf, rank: int, n: int) -> torch.Tensor:
    """Model rank `rank`'s piece of the whole tensor `t`."""
    if leaf.tp_dim is None or n == 1:
        return t
    if leaf.paired:
        return torch.cat([h.chunk(n, leaf.tp_dim)[rank] for h in t.chunk(2, leaf.tp_dim)],
                         leaf.tp_dim)
    return t.chunk(n, leaf.tp_dim)[rank]


def _tp_join(pieces: list[torch.Tensor], leaf: Leaf) -> torch.Tensor:
    """The whole tensor from every model rank's piece (`_tp_take`'s inverse)."""
    if leaf.tp_dim is None or len(pieces) == 1:
        return pieces[0]
    if leaf.paired:
        halves = [p.chunk(2, leaf.tp_dim) for p in pieces]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], leaf.tp_dim)
    return torch.cat(pieces, leaf.tp_dim)


def _data_take(t: torch.Tensor, leaf: Leaf, rank: int, n: int) -> torch.Tensor:
    """Data rank `rank`'s slice of `t` (a view; `t` where it is not split)."""
    if leaf.data_dim is None:
        return t
    part = t.shape[leaf.data_dim] // n
    return t.narrow(leaf.data_dim, rank * part, part)


def _tp_base(params: dict[str, torch.Tensor], mesh: Mesh,
             tp_rules: list[tuple[str, Spec]] | None,
             tp_specs: dict[str, Spec] | None) -> dict[str, Spec]:
    """The parameters' tensor-parallel specs: `tp_specs` where given (the
    split in force), else the rules' inference."""
    if tp_specs is not None:
        return {name: tp_specs.get(name, replicated(t)) for name, t in params.items()}
    return infer_param_sharding(params, mesh, tp_rules or [])


def zero_param_like_sharding(params: dict[str, torch.Tensor], mesh: Mesh,
                             data_axis: str = "data",
                             tp_rules: list[tuple[str, Spec]] | None = None,
                             tp_specs: dict[str, Spec] | None = None) -> dict[str, Spec]:
    """Specs for parameter-shaped state (Adam's moments, the EMA shadow):
    each leaf keeps its tensor-parallel placement and its largest free dim
    that the data axis divides (the largest in flax's order, the first on a
    tie, as the TPU package picks) splits over `data_axis` too. Leaves with
    no such dim keep the parameter's spec. The tensor-parallel placement is
    `tp_specs` (the trainers pass the split `shard_module_` made; a leaf
    already holds its model piece) or else the `tp_rules`' inference."""
    n = mesh.size(data_axis)
    base = _tp_base(params, mesh, tp_rules, tp_specs)
    out = {}
    for name, t in params.items():
        spec = list(base[name])
        if n > 1 and t.dim():
            order = _flax_dims(t.dim())
            cand = [i for i in range(t.dim())
                    if spec[order[i]] is None and t.shape[order[i]] % n == 0]
            if cand:
                spec[order[max(cand, key=lambda i: t.shape[order[i]])]] = data_axis
        out[name] = tuple(spec)
    return out


def _adam_specs(specs: list[Spec]):
    """An AdamState of specs: the count replicated, both moments as given."""
    from sd_tpu_torch.train.diffusion import AdamState

    return AdamState(count=(), mu=list(specs), nu=list(specs))


def _trained_names(state) -> list[str]:
    names = list(state.params)
    if state.logvar is not None and len(state.opt_state.mu) > len(names):
        names.append("logvar")
    return names


def zero_state_sharding(state, mesh: Mesh, data_axis: str = "data",
                        tp_rules: list[tuple[str, Spec]] | None = None,
                        tp_specs: dict[str, Spec] | None = None):
    """The specs of a TrainState (a TrainState of specs): parameters keep
    their tensor-parallel (or replicated) layout; Adam's moments and the
    EMA shadow are ZeRO-split over `data_axis`; the logvar replicates."""
    p = _tp_base(state.params, mesh, tp_rules, tp_specs)
    z = zero_param_like_sharding(state.params, mesh, data_axis, tp_rules, tp_specs)
    trained = _trained_names(state)
    z_all = {**z, "logvar": ()}
    return dataclasses.replace(
        state, params=p, opt_state=_adam_specs([z_all[n] for n in trained]),
        ema=None if state.ema is None else dataclasses.replace(state.ema, shadow=z),
        logvar=None if state.logvar is None else (None,))


def fsdp_state_sharding(state, mesh: Mesh, data_axis: str = "data",
                        tp_rules: list[tuple[str, Spec]] | None = None,
                        tp_specs: dict[str, Spec] | None = None):
    """ZeRO-3: the parameters split over `data_axis` too (each on its
    largest divisible free dim, on top of any tensor-parallel placement),
    Adam's moments and the EMA shadow in the same layout, so the whole
    update is shard-local."""
    z = zero_param_like_sharding(state.params, mesh, data_axis, tp_rules, tp_specs)
    trained = _trained_names(state)
    z_all = {**z, "logvar": (None,)}
    return dataclasses.replace(
        state, params=z, opt_state=_adam_specs([z_all[n] for n in trained]),
        ema=None if state.ema is None else dataclasses.replace(state.ema, shadow=z),
        logvar=None if state.logvar is None else (None,))


def gan_state_sharding(state, mesh: Mesh, data_axis: str = "data", mode: str = "zero1"):
    """The specs of a GanTrainState. "zero1": both networks' parameters
    replicate and both optimizers' moments ZeRO-split over `data_axis`;
    "fsdp": the parameters split too, the moments in their layout. The
    discriminator's running statistics and the generator's buffers (the EMA
    codebook) replicate. No tensor-parallel rules (the codec is convolutions)."""
    if mode not in ("zero1", "fsdp"):
        raise ValueError(f"mode={mode!r}: expected 'zero1' or 'fsdp'")
    rep = lambda tree: {n: replicated(t) for n, t in tree.items()}
    zg = zero_param_like_sharding(state.params_g, mesh, data_axis)
    zd = zero_param_like_sharding(state.params_d, mesh, data_axis)
    pg, pd = (zg, zd) if mode == "fsdp" else (rep(state.params_g), rep(state.params_d))
    return dataclasses.replace(
        state, params_g=pg, params_d=pd, batch_stats_d=rep(state.batch_stats_d),
        opt_state_g=_adam_specs(list(zg.values())),
        opt_state_d=_adam_specs(list(zd.values())),
        model_state=rep(state.model_state))


# -- tensor parallelism of the modules ------------------------------------------------


class ModelParallel:
    """A rank's model axis, held by the modules it splits: `CrossAttention`
    and `FeedForwardGEGLU` read `size` (their local heads / inner width),
    their Dense layers call `linear`."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated input of a column-parallel layer (its gradient
        summed over the axis)."""
        return _CopyToModel.apply(x, self.group) if x.requires_grad else x

    def reduce(self, partial: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """A row-parallel output: the ranks' partial products summed in
        fp32, then the bias added once, in the partial's dtype."""
        y = _ReduceFromModel.apply(partial.float(), self.group)
        if bias is not None:
            y = y + bias.float()
        return y.to(partial.dtype)

    def linear(self, layer, x: torch.Tensor, mode: str) -> torch.Tensor:
        """A split Dense layer: "col" (its output rows) or "row" (its input
        columns)."""
        dt = layer.cdtype
        w = layer.weight.to(dt)
        if mode == "col":
            b = None if layer.bias is None else layer.bias.to(dt)
            return torch.nn.functional.linear(self.enter(x).to(dt), w, b)
        return self.reduce(torch.nn.functional.linear(x.to(dt), w), layer.bias)


_ATTN = {"to_q": (None, "model"), "to_k": (None, "model"), "to_v": (None, "model"),
         "to_out": ("model", None)}
_FF = {"proj_in": (None, "model"), "proj_out": ("model", None)}


def shard_module_(module: torch.nn.Module, mesh: Mesh,
                  rules: list[tuple[str, Spec]] | None = None) -> dict[str, Leaf]:
    """Split `module`'s attention and feed-forward blocks over the mesh's
    "model" axis, in place, where the rules split all of a block's weights
    and its heads (feed-forward width) divide the axis; every other leaf
    stays whole. Each split weight keeps its rank's piece; the blocks attend
    over their local heads. Returns {parameter name: Leaf} of what was split
    ({} on a model axis of 1)."""
    from sd_tpu_torch.nn.attention import CrossAttention, FeedForwardGEGLU

    n = mesh.size("model")
    if n == 1:
        return {}
    params = dict(module.named_parameters())
    specs = infer_param_sharding(params, mesh, TP_RULES_UNET if rules is None else rules)
    mp = ModelParallel(mesh.group("model"), n, mesh.index("model"))
    split: dict[str, Leaf] = {}
    for prefix, sub in module.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(sub, CrossAttention):
            layers, ok = _ATTN, sub.heads % n == 0
        elif isinstance(sub, FeedForwardGEGLU):
            layers, ok = _FF, sub.inner % n == 0
        else:
            continue
        flax = {f"{pre}{k}.weight": _to_port(v, 2) for k, v in layers.items()}
        ok = ok and all(specs.get(k) == v for k, v in flax.items())
        if isinstance(sub, FeedForwardGEGLU) and sub.proj_in.bias is not None:
            ok = ok and specs.get(f"{pre}proj_in.bias") == ("model",)
        if not ok:
            continue
        paired = isinstance(sub, FeedForwardGEGLU) and sub.glu
        for k in layers:
            dense = getattr(sub, k)
            mode = "col" if k in ("to_q", "to_k", "to_v", "proj_in") else "row"
            for pname in ("weight", "bias"):
                p = getattr(dense, pname)
                if p is None or (mode == "row" and pname == "bias"):
                    continue
                leaf = Leaf(0 if mode == "col" else 1, paired and k == "proj_in")
                with torch.no_grad():
                    p.data = _tp_take(p.data, leaf, mp.rank, n).clone()
                split[f"{pre}{k}.{pname}"] = leaf
            dense.tp = (mp, mode)
        sub.tp = mp
    return split


# -- sharded updates -----------------------------------------------------------------


class ShardedTensors:
    """Trained tensors over a mesh: each with its Leaf (its tensor-parallel
    piece is what the rank's tensor holds; `data_dim` where the optimizer
    state, and under "fsdp" the tensor itself between steps, is split over
    the data axis)."""

    def __init__(self, tensors: list[torch.Tensor], leaves: list[Leaf], mesh: Mesh,
                 mode: str):
        if mode not in ("zero1", "fsdp"):
            raise ValueError(f"parallel.state_sharding={mode!r}: expected one of "
                             "['fsdp', 'zero1']")
        self.tensors, self.leaves, self.mesh, self.mode = tensors, leaves, mesh, mode
        self.n, self.r = mesh.size("data"), mesh.index("data")
        self.group = mesh.group("data")
        self._held: list[torch.Tensor | None] = [None] * len(tensors)

    def shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's data slice of a tensor shaped like tensor `i` (a view)."""
        return _data_take(t, self.leaves[i], self.r, self.n)

    def place_(self) -> None:
        """Under "fsdp" keep only this rank's slice of each split tensor."""
        if self.mode == "fsdp":
            for i, t in enumerate(self.tensors):
                if self.leaves[i].data_dim is not None:
                    t.data = self.shard(t.data, i).clone()

    def gather_(self) -> None:
        """Under "fsdp" make each tensor whole (its slice kept aside for the
        update); a no-op under "zero1"."""
        if self.mode != "fsdp":
            return
        idx = [i for i, l in enumerate(self.leaves) if l.data_dim is not None]
        for i in idx:
            self._held[i] = self.tensors[i].data
        whole = self._gather([self._held[i] for i in idx], idx)
        for i, w in zip(idx, whole):
            self.tensors[i].data = w

    def restore_(self) -> None:
        """Undo `gather_`: each tensor back to the slice it holds."""
        for i, t in enumerate(self.tensors):
            if self._held[i] is not None:
                t.data = self._held[i]
                self._held[i] = None

    def _gather(self, slices: list[torch.Tensor], idx: list[int]) -> list[torch.Tensor]:
        """The whole tensors (over the data axis) from every rank's slices:
        flat all_gathers, one per dtype and bucket of `BUCKET` elements."""
        out: list[torch.Tensor | None] = [None] * len(slices)
        by_dtype: dict[torch.dtype, list[int]] = {}
        for k, s in enumerate(slices):
            by_dtype.setdefault(s.dtype, []).append(k)
        for ks in by_dtype.values():
            for run in _bucketed([slices[k] for k in ks], BUCKET):
                run_ks, ks = ks[:len(run)], ks[len(run):]
                flat = torch.cat([s.reshape(-1) for s in run])
                every = all_gather_flat(flat, self.group).view(self.n, -1)
                pos = 0
                for k, s in zip(run_ks, run):
                    pieces = [every[r, pos:pos + s.numel()].view(s.shape) for r in range(self.n)]
                    out[k] = torch.cat(pieces, self.leaves[idx[k]].data_dim)
                    pos += s.numel()
        return out

    def sync_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients averaged over the data axis (in place), then each
        cut to this rank's slice."""
        all_reduce_mean_(grads, self.group, self.n)
        return [self.shard(g, i) for i, g in enumerate(grads)]

    def global_norm(self, grad_slices: list[torch.Tensor]) -> torch.Tensor:
        """√Σ‖g‖² over the whole gradients from this rank's slices: the
        squares of data-split slices summed over the data axis, of
        model-split pieces over the model axis, each whole leaf once."""
        dev = grad_slices[0].device if grad_slices else None
        sums = torch.zeros(4, dtype=torch.float32, device=dev)
        for g, leaf in zip(grad_slices, self.leaves):
            k = (leaf.data_dim is not None) + 2 * (leaf.tp_dim is not None)
            sums[k] += g.float().pow(2).sum()
        data = sums[[1, 3]].clone()
        all_reduce_(data, self.group)
        sums[[1, 3]] = data
        model = self.mesh.group("model")
        if model is not None and self.mesh.size("model") > 1:
            tp = sums[[2, 3]].clone()
            all_reduce_(tp, model)
            sums[[2, 3]] = tp
        return torch.sqrt(sums.sum())

    def update_(self, optimizer, grads: list[torch.Tensor], opt_state,
                ema=None, ema_names: list[str] | None = None) -> torch.Tensor:
        """One optimizer step from the whole local gradients: averaged over
        the data axis, cut to this rank's slices, clipped by the global
        norm, Adam on the slices (in place), the EMA on its slices; then
        the tensors whole again ("zero1": the updated slices gathered) or
        kept as slices ("fsdp"). Returns the global norm."""
        gs = self.sync_grads(grads)
        norm = self.global_norm(gs)
        if self.mode == "fsdp":
            self.restore_()
            views = list(self.tensors)
        else:
            views = [self.shard(t.data, i) for i, t in enumerate(self.tensors)]
        with torch.no_grad():
            optimizer.update_(views, gs, opt_state, norm=norm)
        if ema is not None:
            from sd_tpu_torch.core.ema import ema_update

            ema_update(ema, dict(zip(ema_names, views)))
        if self.mode == "zero1":
            idx = [i for i, l in enumerate(self.leaves) if l.data_dim is not None]
            whole = self._gather([views[i] for i in idx], idx)
            with torch.no_grad():
                for i, w in zip(idx, whole):
                    self.tensors[i].data.copy_(w)
        return norm

    def whole(self, t: torch.Tensor, i: int, held: bool = True,
              model: bool = True) -> torch.Tensor:
        """The whole tensor of a tensor laid out as tensor `i` (`held`: a
        data slice as the state holds it; else already whole over the data
        axis), joined over the model axis too unless `model` is False. Every
        rank of the mesh must call it."""
        leaf = self.leaves[i]
        if held and leaf.data_dim is not None:
            t = self._gather([t.contiguous()], [i])[0]
        n_tp = self.mesh.size("model")
        if not model or leaf.tp_dim is None or n_tp == 1:
            return t
        every = all_gather_flat(t.reshape(-1).contiguous(), self.mesh.group("model"))
        return _tp_join(list(every.view(n_tp, *t.shape).unbind(0)), leaf)


def _cut(t: torch.Tensor, sharded: ShardedTensors, i: int) -> torch.Tensor:
    """A whole parameter-shaped tensor cut to this rank's piece of tensor
    `i`: its model piece, then its data slice (a copy)."""
    leaf = sharded.leaves[i]
    n_tp = sharded.mesh.size("model")
    piece = _tp_take(t, leaf, sharded.mesh.index("model"), n_tp) if n_tp > 1 else t
    return sharded.shard(piece, i).clone()


def _tp_specs(tensors: dict[str, torch.Tensor], tp_split: dict[str, Leaf]) -> dict[str, Spec]:
    """The specs of the split `shard_module_` made ("model" on each split
    leaf's `tp_dim`)."""
    return {name: tuple("model" if d == tp_split[name].tp_dim else None
                        for d in range(t.dim())) if name in tp_split else replicated(t)
            for name, t in tensors.items()}


def shard_tensors_(tensors: list[torch.Tensor], names: list[str], specs: list[Spec],
                   adam_states: list, mesh: Mesh, mode: str,
                   tp_split: dict[str, Leaf] | None = None) -> ShardedTensors:
    """Lay out trained tensors (already cut to their model pieces by
    `shard_module_`) and the whole-shaped Adam states over them: each
    tensor's data dim is where its moments' spec (`specs`, from
    `zero_state_sharding` / `fsdp_state_sharding` / `gan_state_sharding`)
    names "data"; the moments are cut to this rank's slices, under "fsdp"
    the tensors too."""
    leaves = [dataclasses.replace((tp_split or {}).get(name, Leaf()),
                                  data_dim=spec.index("data") if "data" in spec else None)
              for name, spec in zip(names, specs, strict=True)]
    sharded = ShardedTensors(tensors, leaves, mesh, mode)
    for st in adam_states:
        st.mu = [_cut(m, sharded, i) for i, m in enumerate(st.mu)]
        st.nu = [_cut(v, sharded, i) for i, v in enumerate(st.nu)]
    sharded.place_()
    return sharded


def shard_train_state_(state, mesh: Mesh, mode: str,
                       tp_split: dict[str, Leaf] | None = None) -> ShardedTensors:
    """Lay out a TrainState in place by `zero_state_sharding` ("zero1") or
    `fsdp_state_sharding` ("fsdp") over the split in force (`tp_split`):
    Adam's moments and the EMA shadow cut to this rank's slices, under
    "fsdp" the parameters too; the logvar whole. The parameters must
    already hold their model pieces."""
    layout = {"zero1": zero_state_sharding, "fsdp": fsdp_state_sharding}.get(mode)
    if layout is None:
        raise ValueError(f"parallel.state_sharding={mode!r}: expected one of ['fsdp', 'zero1']")
    specs = layout(state, mesh, tp_specs=_tp_specs(state.params, tp_split or {}))
    names = _trained_names(state)
    tensors = list(state.params.values()) + ([state.logvar] if "logvar" in names else [])
    sharded = shard_tensors_(tensors, names, specs.opt_state.mu, [state.opt_state], mesh,
                             mode, tp_split)
    if state.ema is not None:
        at = {n: i for i, n in enumerate(names)}
        state.ema.shadow = {n: _cut(s, sharded, at[n]) for n, s in state.ema.shadow.items()}
    return sharded


class ShardedAdam:
    """An optimizer whose `update_` is `ShardedTensors.update_` over its
    tensors (the GAN steps call it as they call `Adam.update_`)."""

    def __init__(self, optimizer, sharded: ShardedTensors):
        self.optimizer, self.sharded = optimizer, sharded

    def update_(self, params, grads, state, norm=None) -> None:  # noqa: ARG002
        self.sharded.update_(self.optimizer, list(grads), state)


def whole_gan_state(state, gen: ShardedTensors, disc: ShardedTensors):
    """The whole GanTrainState on the CPU from every rank's pieces (every
    rank calls it)."""
    from sd_tpu_torch.train.diffusion import AdamState

    held = gen.mode == "fsdp"
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}

    def params(tree, sh):
        return {n: sh.whole(p.detach(), i, held).cpu() for i, (n, p) in enumerate(tree.items())}

    def adam(st, sh):
        return AdamState(count=st.count, mu=[sh.whole(m, i).cpu() for i, m in enumerate(st.mu)],
                         nu=[sh.whole(v, i).cpu() for i, v in enumerate(st.nu)])

    return dataclasses.replace(
        state, params_g=params(state.params_g, gen), params_d=params(state.params_d, disc),
        batch_stats_d=cpu(state.batch_stats_d), opt_state_g=adam(state.opt_state_g, gen),
        opt_state_d=adam(state.opt_state_d, disc), model_state=cpu(state.model_state))


def ema_over_data(state, sharded: ShardedTensors):
    """`state` with its EMA shadow whole over the data axis (each rank's
    model pieces, on its device): what the modules of this rank can run."""
    if state.ema is None:
        return state
    at = {n: i for i, n in enumerate(_trained_names(state))}
    shadow = {n: sharded.whole(s, at[n], model=False) for n, s in state.ema.shadow.items()}
    return dataclasses.replace(state, ema=dataclasses.replace(state.ema, shadow=shadow))


def mean_logs(logs: dict, mesh: Mesh) -> dict:
    """The tensor logs averaged over the data axis (numbers as they are)."""
    keys = [k for k, v in logs.items() if torch.is_tensor(v)]
    if not keys:
        return logs
    stacked = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    all_reduce_mean_([stacked], mesh.group("data"), mesh.size("data"))
    return {**logs, **dict(zip(keys, stacked.unbind(0)))}


def whole_train_state(state, sharded: ShardedTensors):
    """The whole TrainState on the CPU (what a one-rank run holds), from
    every rank's pieces: every rank of the mesh calls it."""
    from sd_tpu_torch.train.diffusion import AdamState

    names = _trained_names(state)
    at = {n: i for i, n in enumerate(names)}
    held = sharded.mode == "fsdp"
    whole = lambda t, i, h=True: sharded.whole(t.detach(), i, h).cpu()
    opt = state.opt_state
    return dataclasses.replace(
        state,
        params={n: whole(p, at[n], held) for n, p in state.params.items()},
        opt_state=AdamState(count=opt.count, mu=[whole(m, i) for i, m in enumerate(opt.mu)],
                            nu=[whole(v, i) for i, v in enumerate(opt.nu)]),
        ema=None if state.ema is None else dataclasses.replace(
            state.ema, shadow={n: whole(s, at[n]) for n, s in state.ema.shadow.items()}),
        logvar=None if state.logvar is None else state.logvar.detach().cpu())


def make_parallel_train_step(loss_fn: Callable, optimizer, mesh: Mesh,
                             sharded: ShardedTensors, ema_names: list[str],
                             grad_accum: int = 1) -> Callable:
    """`make_diffusion_train_step` over a mesh: `step(state, batch,
    generator) -> logs`, `batch` this rank's rows of each microbatch (in
    microbatch order). Each microbatch's loss runs with its draws at the
    microbatch's global shape (`batch_rows`); the gradients, summed over the
    microbatches and divided by `grad_accum`, are averaged over the data
    axis before the global norm (`grad_norm`, before clipping) and the
    sharded update; the logs are the data axis's mean. Under "fsdp" the
    parameters are gathered for the step and cut back by the update."""
    from sd_tpu_torch.kernels.conv2d import training_trace
    from sd_tpu_torch.train.diffusion import _split

    n, r = mesh.size("data"), mesh.index("data")

    def step(state, batch, generator=None) -> dict:
        trained = sharded.tensors
        sums: dict[str, torch.Tensor] = {}
        sharded.gather_()
        mbs = _split(batch, grad_accum) if grad_accum > 1 else [batch]
        with training_trace(), data_axis(mesh):
            for mb in mbs:
                m = _rows_of(mb)
                with batch_rows(np.arange(r * m, (r + 1) * m), m * n):
                    loss, logs = loss_fn(mb, generator, state.logvar)
                loss.backward()
                for k, v in logs.items():
                    sums[k] = sums.get(k, 0.0) + v.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in trained]
        if grad_accum > 1:
            for g in grads:
                g.div_(grad_accum)
        out = mean_logs({k: v / grad_accum for k, v in sums.items()}, mesh)
        for p in trained:
            p.grad = None
        out["grad_norm"] = sharded.update_(optimizer, grads, state.opt_state,
                                           state.ema, ema_names)
        state.step += 1
        return out

    return step


def _rows_of(batch) -> int:
    if isinstance(batch, dict):
        return _rows_of(next(iter(batch.values())))
    if isinstance(batch, (list, tuple)):
        return _rows_of(batch[0]) if batch and torch.is_tensor(batch[0]) else len(batch)
    return batch.shape[0]
