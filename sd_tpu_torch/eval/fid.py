"""Fréchet distance (FID-style) between image sets, with a pluggable
feature extractor.

Counterpart of `sd_tpu/eval/fid.py`. The Gaussian statistics and the
distance are float64 numpy on the host (kept here as the port's own copy):
d² = |μ1 − μ2|² + tr(Σ1 + Σ2 − 2·(Σ1 Σ2)^½), with tr((Σ1 Σ2)^½) taken as
tr((Σ1^½ Σ2 Σ1^½)^½) through two symmetric eigendecompositions, the
spectrum clamped at 0. The device runs the feature forward only, batch by
batch, the last short batch padded with zeros to the batch size (one shape)
and the padding rows dropped.

`clip_feature_fn` is the CLIP ViT-B/32 visual tower (`FrozenClipImageEmbedder`)
as the extractor: with calibrated weights the published CLIP-FID variant;
with random weights from a seed a deterministic regression statistic,
comparable only within one extractor (no Inception or CLIP weights are in
the repository). Its weights come from `params` (the TPU package's tree,
carried across by `load_flax_params`) or from a seeded `torch.Generator`:
flax's init stream cannot be reproduced in torch, so the seeded surrogate is
not the TPU package's seeded surrogate.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import numpy as np
import torch


def gaussian_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of an [N, D] feature matrix (float64)."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2:
        raise ValueError(f"expected [N, D] features, got shape {f.shape}")
    # np.cov squeezes D = 1 to a scalar: keep the matrix shape
    return f.mean(axis=0), np.atleast_2d(np.cov(f, rowvar=False))


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD square root by eigendecomposition (spectrum clamped)."""
    w, v = np.linalg.eigh((mat + mat.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w + eps)) @ v.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray) -> float:
    """d² between N(μ1, Σ1) and N(μ2, Σ2), clamped at 0."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.atleast_2d(np.asarray(cov1, np.float64))
    cov2 = np.atleast_2d(np.asarray(cov2, np.float64))
    diff = float(((mu1 - mu2) ** 2).sum())
    s1 = _sqrtm_psd(cov1)
    inner = s1 @ cov2 @ s1
    w = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = float(np.sqrt(np.clip(w, 0.0, None)).sum())
    return max(diff + float(np.trace(cov1) + np.trace(cov2)) - 2.0 * tr_sqrt, 0.0)


def extract_features(feature_fn: Callable[[torch.Tensor], torch.Tensor],
                     images: np.ndarray | Iterable[np.ndarray],
                     batch_size: int = 32) -> np.ndarray:
    """`feature_fn` over batches of `images` ([N, H, W, C] in [-1, 1], or an
    iterable of such batches), each handed over as a CPU fp32 tensor: [N, D]
    fp32 features. A short batch is padded to `batch_size` with zeros and
    its padding rows dropped."""
    if isinstance(images, np.ndarray):
        images = [images[i:i + batch_size] for i in range(0, len(images), batch_size)]
    out = []
    for batch in images:
        batch = np.ascontiguousarray(batch, np.float32)
        n = batch.shape[0]
        if n < batch_size:
            pad = np.zeros((batch_size - n, *batch.shape[1:]), np.float32)
            batch = np.concatenate([batch, pad], axis=0)
        with torch.no_grad():
            feats = feature_fn(torch.from_numpy(batch))
        feats = np.asarray(feats.float().cpu() if torch.is_tensor(feats) else feats, np.float32)
        out.append(feats[:n].reshape(n, -1))
    if not out:
        raise ValueError("no images given")
    return np.concatenate(out, axis=0)


def fid(feature_fn: Callable[[torch.Tensor], torch.Tensor], real: np.ndarray,
        generated: np.ndarray, batch_size: int = 32) -> float:
    """Fréchet distance between the feature Gaussians of two image sets."""
    fr = extract_features(feature_fn, real, batch_size)
    fg = extract_features(feature_fn, generated, batch_size)
    return fid_from_features(fr, fg)


def fid_from_features(real_feats: np.ndarray, gen_feats: np.ndarray) -> float:
    mu1, c1 = gaussian_stats(real_feats)
    mu2, c2 = gaussian_stats(gen_feats)
    return frechet_distance(mu1, c1, mu2, c2)


def clip_feature_fn(params: Mapping | None = None, *, seed: int = 0,
                    dtype: torch.dtype | None = None,
                    device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Images [B, H, W, 3] in [-1, 1] → fp32 embeddings [B, 512] on the CLIP
    ViT-B/32 visual tower, built on the card unless `device` names another,
    its weights from `params` (the TPU package's `FrozenClipImageEmbedder`
    tree) or, without them, from a `torch.Generator` seeded by `seed`; in
    `dtype` (default fp32)."""
    from sd_tpu_torch.core.config import resolve_device
    from sd_tpu_torch.models.conditioners import FrozenClipImageEmbedder
    from sd_tpu_torch.weights import init_params_, load_flax_params

    device = resolve_device(device)
    model = FrozenClipImageEmbedder(dtype=dtype or torch.float32, device=device)
    model.eval().requires_grad_(False)
    if params is None:
        init_params_(model, torch.Generator(device).manual_seed(seed))
    else:
        load_flax_params(model, params)

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return model(x.to(device, torch.float32)).float()

    return fn
