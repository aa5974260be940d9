"""Control hints for ControlNet (arXiv:2302.05543 §4: the canonical task
conditions on an edge map of an image).

Counterpart of `sd_tpu/data/hints.py`, host-side numpy and deterministic: a
Canny-style edge detector (Gaussian smooth → gradients → magnitude → a
linear ramp between two thresholds) without the thinning and hysteresis
passes, since the conditioning signal needs edge locations, not 1-px-thin
contours.
"""

from __future__ import annotations

import numpy as np


def _gauss_blur3(x: np.ndarray) -> np.ndarray:
    """Separable 3-tap binomial blur with edge-replicate padding."""
    k = np.array([0.25, 0.5, 0.25], x.dtype)
    p = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    x = p[:-2] * k[0] + p[1:-1] * k[1] + p[2:] * k[2]
    p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    return p[:, :-2] * k[0] + p[:, 1:-1] * k[1] + p[:, 2:] * k[2]


def edge_hint(image: np.ndarray, low: float = 0.1,
              high: float = 0.25) -> np.ndarray:
    """uint8/float HWC (or NHWC) image → float32 edge hint in [0, 1]:
    0 = flat, 1 = strong edge, linear ramp between the thresholds
    (fractions of the max gradient magnitude). 3 channels (the hint
    encoder's default hint_channels)."""
    x = np.asarray(image)
    if x.ndim == 4:
        return np.stack([edge_hint(im, low, high) for im in x])
    x = x.astype(np.float32)
    if x.max() > 1.5:  # uint8 range
        x = x / 255.0
    gray = x.mean(axis=-1) if x.ndim == 3 else x
    g = _gauss_blur3(gray)
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = g[:, 2:] - g[:, :-2]
    gy[1:-1, :] = g[2:, :] - g[:-2, :]
    mag = np.hypot(gx, gy)
    m = mag.max()
    if m > 0:
        mag = mag / m
    hint = np.clip((mag - low) / max(high - low, 1e-6), 0.0, 1.0)
    return np.repeat(hint[..., None], 3, axis=-1).astype(np.float32)


HINT_FNS = {
    "canny": edge_hint,   # the community name for the edge-conditioned task
    "identity": lambda im: (np.asarray(im, np.float32) / 255.0
                            if np.asarray(im).dtype == np.uint8
                            else np.asarray(im, np.float32)),
}
