"""ToMe — token merging for the SD UNet's self-attention (a serving option).

Counterpart of `sd_tpu/nn/tome.py` (Bolya & Hoffman, arXiv:2303.17604):
each SpatialTransformer block whose token count reaches `tome_min_tokens`
merges the `ratio` most redundant tokens before its self-attention and
unmerges after. No parameters: checkpoints are unchanged.

The destination set is the top-left token of every sy×sx tile, the merge
count r is rounded so that N − r stays a multiple of 128 (the flash
kernel's q tile), and each source token is matched to its most similar
destination by fp32 cosine similarity. The same bits on every run of the
card, and the TPU package's choices:
  * the sources are ranked by a stable descending sort (`lax.top_k` breaks
    ties toward the lower index; `torch.topk` promises no order);
  * the merged sources are summed into their destinations by a one-hot
    matrix product, not a scatter-add (`index_add_` on the card is atomic,
    so its sums' order, and their bits, change from run to run); the mean
    is taken in fp32;
  * unmerge writes a permutation of the token positions, so no write
    collides.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _dst_grid(H: int, W: int, sy: int = 2, sx: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) token indices: one dst per sy×sx tile (its top-left
    corner), src the rest, each in raster order."""
    idx = np.arange(H * W).reshape(H, W)
    dst = idx[::sy, ::sx].reshape(-1)
    keep = np.ones(H * W, bool)
    keep[dst] = False
    return np.nonzero(keep)[0], dst


def merge_count(n_tokens: int, n_src: int, ratio: float, multiple: int = 128) -> int:
    """r with r ≤ ratio·N, r ≤ Ns and N − r a multiple of `multiple`; 0
    turns merging off."""
    r = min(int(n_tokens * ratio), n_src)
    kept = -(-(n_tokens - r) // multiple) * multiple
    return max(n_tokens - kept, 0)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] at per-batch token indices idx [B, n] → [B, n, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def build_tome(x: torch.Tensor, H: int, W: int, ratio: float, sy: int = 2,
               sx: int = 2) -> tuple[Callable, Callable, int] | None:
    """Bipartite soft matching on the cosine similarity of the block input
    x [B, N, C]: (merge, unmerge, r), merge [B, N, C'] → [B, N − r, C'] (the
    same matching for any C'), unmerge back, each merged source taking its
    destination's output; None where the rounded count r is 0."""
    B, N, _ = x.shape
    if N != H * W:
        raise ValueError(f"{N} tokens for a {H}×{W} grid")
    src_np, dst_np = _dst_grid(H, W, sy, sx)
    r = merge_count(N, len(src_np), ratio)
    if r <= 0:
        return None
    src_idx = torch.from_numpy(src_np).to(x.device)
    dst_idx = torch.from_numpy(dst_np).to(x.device)
    Ns, Nd = len(src_np), len(dst_np)

    metric = x.float()
    metric = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True) + 1e-6)
    scores = torch.einsum("bsc,bdc->bsd", metric[:, src_idx], metric[:, dst_idx])
    node_max, node_idx = scores.max(dim=-1)                  # first max, as argmax
    order = torch.sort(node_max, dim=-1, descending=True, stable=True).indices
    merged_src, unm_src = order[:, :r], order[:, r:]
    m_dst = torch.gather(node_idx, 1, merged_src)            # [B, r] dst slots
    # each position of the merged sequence's tokens in the full one
    positions = torch.cat([src_idx[unm_src], src_idx[merged_src],
                           dst_idx.expand(B, Nd)], dim=1)

    def merge(tokens: torch.Tensor) -> torch.Tensor:
        src_t, dst_t = tokens[:, src_idx], tokens[:, dst_idx]
        onehot = F.one_hot(m_dst, Nd).to(tokens.dtype)           # [B, r, Nd]
        sums = torch.bmm(onehot.transpose(1, 2), _rows(src_t, merged_src))
        count = 1.0 + onehot.float().sum(dim=1)[..., None]
        dst_m = ((dst_t.float() + sums.float()) / count).to(tokens.dtype)
        return torch.cat([_rows(src_t, unm_src), dst_m], dim=1)

    def unmerge(tokens: torch.Tensor) -> torch.Tensor:
        dst_t = tokens[:, Ns - r:]
        full = torch.cat([tokens[:, :Ns - r], _rows(dst_t, m_dst), dst_t], dim=1)
        idx = positions[..., None].expand(-1, -1, tokens.shape[-1])
        return torch.zeros((B, N, tokens.shape[-1]), dtype=tokens.dtype,
                           device=tokens.device).scatter(1, idx, full)

    return merge, unmerge, r
