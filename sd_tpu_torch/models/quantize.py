"""Vector quantizers: the argmin codebook VQ (legacy β placement, index
remap), its one-hot form, the Gumbel-softmax VQ and the EMA codebook, as a
module and as a function.

Counterpart of `sd_tpu/models/quantize.py` `VectorQuantizer`,
`VectorQuantizerOneHot`, `GumbelQuantize`, `EMAVectorQuantizer`,
`EmaCodebook` and `ema_quantize`:
the nearest code by the expanded square ‖z‖² + ‖e‖² − 2 z·eᵀ in fp32, the
lookup by index, straight-through gradients z + (z_q − z).detach(), the
perplexity of the code histogram. NHWC: z is [B, H, W, e_dim].

Differences from the TPU package: the Gumbel noise is handed in (or drawn
from an explicit `torch.Generator`), never from a global RNG; the EMA
codebook is three fp32 buffers (`weight`, `cluster_size`, `embed_avg`) that
`update=True` rewrites in place after the lookup, where the TPU package
returns a new 'codebook' collection. The codebooks' flax name `embedding`
is the torch parameter `weight` (`weights.torch_name`). `remap` (a `.npy`
path or a list of the used codes) reports the indices in the used subset:
the argmin VQ maps each code to its place in the subset and a code outside
it to `unknown_index` ("random": a draw from the call's generator, "extra":
one past the subset, or that integer); the Gumbel VQ masks the unused codes
out of its softmax. `get_codebook_entry` maps the indices back.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.nn.layers import Conv2d
from sd_tpu_torch.parallel.mesh import data_mean, data_sum_, global_draw


def _nearest_code(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ‖z − e_k‖² via the expanded-square matmul form, in fp32. [N]."""
    z32, e32 = z_flat.float(), codebook.float()
    d = (z32.pow(2).sum(dim=1, keepdim=True) + e32.pow(2).sum(dim=1)[None, :]
         - 2.0 * z32 @ e32.t())
    return torch.argmin(d, dim=1)


def _one_hot(idx: torch.Tensor, n_e: int) -> torch.Tensor:
    return (idx[:, None] == torch.arange(n_e, device=idx.device)).float()


def _perplexity(idx: torch.Tensor, n_e: int) -> torch.Tensor:
    """exp(entropy) of the code histogram of `idx`."""
    avg_probs = data_mean(_one_hot(idx.reshape(-1), n_e).mean(dim=0))
    return torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())


def _load_used(remap) -> np.ndarray | None:
    """The used codes of `remap` (a `.npy` path or a sequence), or None."""
    if remap is None:
        return None
    return np.load(remap) if isinstance(remap, str) else np.asarray(remap, dtype=np.int64)


def _ema_update_(weight, cluster_size, embed_avg, z_flat, idx, decay, eps) -> None:
    """Laplace-smoothed EMA of the code counts and sums of `z_flat` [N, D]
    assigned to `idx`, written into the three codebook tensors."""
    n_e = weight.shape[0]
    one_hot = _one_hot(idx, n_e)
    counts = data_sum_(one_hot.sum(dim=0))
    sums = data_sum_(one_hot.t() @ z_flat)
    cluster_size.mul_(decay).add_((1 - decay) * counts)
    embed_avg.mul_(decay).add_((1 - decay) * sums)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + n_e * eps) * n
    weight.copy_(embed_avg / smoothed[:, None])


class VectorQuantizer(nn.Module):
    """Argmin VQ with a commitment loss and straight-through gradients; the
    codebook `weight` [n_e, e_dim] is a parameter trained by its gradient.
    `legacy` puts β on the embedding term (the reference's placement), else
    on the commitment term."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, legacy: bool = True,
                 remap=None, unknown_index: str | int = "random",
                 sane_index_shape: bool = False, *, dtype=torch.float32, device=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.legacy = n_e, e_dim, beta, legacy
        self.sane_index_shape, self.unknown_index = sane_index_shape, unknown_index
        self.weight = nn.Parameter(torch.empty(n_e, e_dim, dtype=dtype, device=device),
                                   requires_grad=False)
        used = _load_used(remap)
        # the used codes: a constant of the config, not a parameter or a buffer
        self.used = None if used is None else torch.as_tensor(used, device=device)
        self.re_embed = n_e if used is None else len(used) + (unknown_index == "extra")

    def remap_to_used(self, inds: torch.Tensor, generator: torch.Generator | None = None,
                      draws: torch.Tensor | None = None) -> torch.Tensor:
        """Codes → their places in the used subset; a code outside it →
        `unknown_index` ("random": `draws`, else uniform in [0, re_embed)
        from `generator`, else from a generator seeded 0)."""
        match = inds[..., None] == self.used.to(inds.device)
        new = match.int().argmax(dim=-1)
        unknown = ~match.any(dim=-1)
        if self.unknown_index == "random":
            if draws is None:
                gen = generator or torch.Generator(inds.device).manual_seed(0)
                draws = global_draw(lambda n: torch.randint(
                    0, self.re_embed, (n, *new.shape[1:]), generator=gen, device=gen.device),
                    new.shape[0]).to(inds.device)
            return torch.where(unknown, draws.to(new.dtype), new)
        fill = self.re_embed - 1 if self.unknown_index == "extra" else int(self.unknown_index)
        return torch.where(unknown, torch.full_like(new, fill), new)

    def unmap_to_all(self, inds: torch.Tensor) -> torch.Tensor:
        """Places in the used subset → codes ("extra" → code used[0])."""
        used = self.used.to(inds.device)
        if self.unknown_index == "extra":
            inds = torch.where(inds >= len(used), torch.zeros_like(inds), inds)
        return used[inds]

    @torch.no_grad()
    def reset_codebook_(self, generator: torch.Generator) -> None:
        """The TPU package's init: U(−1/K, 1/K)."""
        u = torch.rand(self.weight.shape, generator=generator, device=self.weight.device)
        self.weight.copy_((2 * u - 1) / self.n_e)

    def forward(self, z: torch.Tensor, generator: torch.Generator | None = None,
                remap_draws: torch.Tensor | None = None):
        """(z_q, loss, (perplexity, None, indices)); under `remap` the
        indices are the used subset's (`remap_to_used` with `generator` or
        `remap_draws`, [B, H·W])."""
        B, H, W, C = z.shape
        assert C == self.e_dim
        idx = _nearest_code(z.reshape(-1, C), self.weight)
        z_q = self.weight[idx].reshape(z.shape).to(z.dtype)
        z32, zq32 = z.float(), z_q.float()
        commit = (zq32.detach() - z32).pow(2).mean()
        embed = (zq32 - z32.detach()).pow(2).mean()
        loss = commit + self.beta * embed if self.legacy else self.beta * commit + embed
        z_q = z + (z_q - z).detach()
        perplexity = _perplexity(idx, self.n_e)
        if self.used is not None:
            idx = self.remap_to_used(idx.reshape(B, -1), generator, remap_draws).reshape(-1)
        if self.sane_index_shape:
            idx = idx.reshape(B, H, W)
        return z_q, loss, (perplexity, None, idx)

    def get_codebook_entry(self, indices: torch.Tensor, shape: tuple | None = None):
        indices = indices.reshape(-1)
        if self.used is not None:
            indices = self.unmap_to_all(indices)
        z_q = self.weight[indices]
        return z_q.reshape(shape) if shape is not None else z_q


class VectorQuantizerOneHot(nn.Module):
    """The legacy one-hot VQ: the nearest code's one-hot row times the
    codebook `weight` [n_e, e_dim] in fp32, the loss commit + β·embed, the
    one-hot matrix returned beside the perplexity."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.weight = nn.Parameter(torch.empty(n_e, e_dim, dtype=dtype, device=device),
                                   requires_grad=False)

    reset_codebook_ = VectorQuantizer.reset_codebook_

    def forward(self, z: torch.Tensor):
        """(z_q, loss, (perplexity, one_hot [N, n_e], indices))."""
        idx = _nearest_code(z.reshape(-1, self.e_dim), self.weight)
        one_hot = _one_hot(idx, self.n_e)
        z_q = (one_hot @ self.weight.float()).reshape(z.shape).to(z.dtype)
        z32, zq32 = z.float(), z_q.float()
        loss = ((zq32.detach() - z32).pow(2).mean()
                + self.beta * (zq32 - z32.detach()).pow(2).mean())
        z_q = z + (z_q - z).detach()
        return z_q, loss, (_perplexity(idx, self.n_e), one_hot, idx)


class GumbelQuantize(nn.Module):
    """Gumbel-softmax categorical VQ: logits from the 1×1 `proj` conv, a
    soft mixture of the codebook `weight` [n_e, e_dim] (hard one-hot with
    straight-through gradients when `straight_through` or `deterministic`),
    the KL to the uniform prior as its loss."""

    def __init__(self, n_e: int, e_dim: int, straight_through: bool = True,
                 kl_weight: float = 5e-4, temp_init: float = 1.0, remap=None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_e, self.e_dim = n_e, e_dim
        self.straight_through, self.kl_weight, self.temp_init = (
            straight_through, kl_weight, temp_init)
        self.used = _load_used(remap)
        self.proj = Conv2d(e_dim, n_e, 1, dtype=dtype, device=device)
        self.weight = nn.Parameter(torch.empty(n_e, e_dim, dtype=dtype, device=device),
                                   requires_grad=False)

    @torch.no_grad()
    def reset_codebook_(self, generator: torch.Generator) -> None:
        """The TPU package's init: N(0, 1)."""
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))

    def forward(self, z: torch.Tensor, gumbel: torch.Tensor | None = None,
                temp: float | None = None, deterministic: bool = False,
                generator: torch.Generator | None = None):
        """(z_q, kl_loss, (perplexity, None, indices)). The Gumbel noise is
        `gumbel` (the logits' shape, [B, H, W, n_e]) or drawn from
        `generator`; with neither, or `deterministic`, there is none."""
        temp = self.temp_init if temp is None else temp
        logits = self.proj(z).float()
        if self.used is not None:
            # the unused codes masked out of the categorical
            mask = np.full((self.n_e,), -np.inf, np.float32)
            mask[self.used] = 0.0
            logits = logits + torch.from_numpy(mask).to(logits.device)
        if gumbel is None and generator is not None and not deterministic:
            u = global_draw(lambda n: torch.rand((n, *logits.shape[1:]), generator=generator,
                                                 device=logits.device), logits.shape[0])
            tiny = torch.finfo(torch.float32).tiny
            gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        if deterministic or gumbel is None:
            soft = torch.softmax(logits / temp, dim=-1)
        else:
            soft = torch.softmax((logits + gumbel.float()) / temp, dim=-1)
        idx = soft.argmax(dim=-1)
        if self.straight_through or deterministic:
            probs = F.one_hot(idx, self.n_e).float() + soft - soft.detach()
        else:
            probs = soft
        z_q = torch.einsum("bhwk,kd->bhwd", probs, self.weight.float()).to(z.dtype)
        qy = torch.softmax(logits, dim=-1)
        terms = qy * torch.log(qy * self.n_e + 1e-10)
        if self.used is not None:
            terms = torch.where(torch.isfinite(logits), terms, torch.zeros_like(terms))
        kl = self.kl_weight * terms.sum(dim=-1).mean()
        perplexity = _perplexity(idx, self.n_e)
        if self.used is not None:
            # the used subset's places (the mask keeps the argmax inside it)
            inv = np.zeros((self.n_e,), np.int64)
            inv[self.used] = np.arange(len(self.used))
            idx = torch.from_numpy(inv).to(idx.device)[idx]
        return z_q, kl, (perplexity, None, idx)

    def get_codebook_entry(self, indices: torch.Tensor, shape: tuple | None = None):
        flat = indices.reshape(-1)
        if self.used is not None:
            flat = torch.as_tensor(self.used, device=flat.device)[flat]
        z_q = self.weight[flat]
        return z_q.reshape(shape) if shape is not None else z_q


class EMAVectorQuantizer(nn.Module):
    """Argmin VQ whose codebook learns by a Laplace-smoothed EMA of the codes'
    assignments, not by gradients: `weight`, `cluster_size` and `embed_avg`
    are fp32 buffers. The loss is the commitment term β·‖sg[z_q] − z‖²."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, decay: float = 0.99,
                 eps: float = 1e-5, *, device=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.decay, self.eps = n_e, e_dim, beta, decay, eps
        kw = dict(dtype=torch.float32, device=device)
        self.register_buffer("weight", torch.empty(n_e, e_dim, **kw))
        self.register_buffer("cluster_size", torch.zeros(n_e, **kw))
        self.register_buffer("embed_avg", torch.empty(n_e, e_dim, **kw))

    @torch.no_grad()
    def reset_codebook_(self, generator: torch.Generator) -> None:
        """The TPU package's init: weight N(0, 1), cluster_size 0, embed_avg
        the weight."""
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))
        self.cluster_size.zero_()
        self.embed_avg.copy_(self.weight)

    def forward(self, z: torch.Tensor, update: bool = False):
        """(z_q, loss, (perplexity, None, indices)); with `update` the EMA
        update from this call's assignments, applied after the lookup (z_q
        is the codebook as it was before it)."""
        B, H, W, C = z.shape
        assert C == self.e_dim
        z_flat = z.reshape(-1, C).float()
        idx = _nearest_code(z_flat, self.weight)
        z_q = self.weight[idx].reshape(z.shape).to(z.dtype)
        loss = self.beta * (z_q.float().detach() - z.float()).pow(2).mean()
        if update:
            with torch.no_grad():
                _ema_update_(self.weight, self.cluster_size, self.embed_avg,
                             z_flat.detach(), idx, self.decay, self.eps)
        z_q = z + (z_q - z).detach()
        return z_q, loss, (_perplexity(idx, self.n_e), None, idx)

    def get_codebook_entry(self, indices: torch.Tensor, shape: tuple | None = None):
        z_q = self.weight[indices.reshape(-1)]
        return z_q.reshape(shape) if shape is not None else z_q


@dataclasses.dataclass(frozen=True)
class EmaCodebook:
    """The EMA codebook as a value: code weights [K, D], EMA cluster sizes
    [K] and embedding sums [K, D], fp32."""

    weight: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor
    decay: float = 0.99
    eps: float = 1e-5

    @classmethod
    def create(cls, generator: torch.Generator, n_e: int, e_dim: int, decay: float = 0.99,
               eps: float = 1e-5, device=None) -> "EmaCodebook":
        w = torch.randn((n_e, e_dim), generator=generator, device=device)
        return cls(weight=w, cluster_size=torch.zeros(n_e, device=device),
                   embed_avg=w.clone(), decay=decay, eps=eps)


def ema_quantize(codebook: EmaCodebook, z: torch.Tensor, update: bool = True
                 ) -> tuple[torch.Tensor, EmaCodebook, torch.Tensor, torch.Tensor]:
    """One EMA-VQ step on `z` [..., D]: (z_q, the codebook after the update
    (a new one; `codebook` is unchanged), perplexity, indices)."""
    z_flat = z.reshape(-1, z.shape[-1]).float()
    idx = _nearest_code(z_flat, codebook.weight)
    z_q = codebook.weight[idx].reshape(z.shape).to(z.dtype)
    new_cb = codebook
    if update:
        new_cb = dataclasses.replace(codebook, weight=codebook.weight.clone(),
                                     cluster_size=codebook.cluster_size.clone(),
                                     embed_avg=codebook.embed_avg.clone())
        with torch.no_grad():
            _ema_update_(new_cb.weight, new_cb.cluster_size, new_cb.embed_avg,
                         z_flat.detach(), idx, codebook.decay, codebook.eps)
    z_q = z + (z_q - z).detach()
    return z_q, new_cb, _perplexity(idx, codebook.weight.shape[0]), idx
