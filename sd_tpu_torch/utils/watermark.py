"""Invisible watermark for generated images (copy of
`sd_tpu/utils/watermark.py`; host-side numpy, post-decode).

Blind 8×8-block DCT watermark on the BT.601 luma: a keyed PRNG assigns each
block one payload bit, encoded as the order of two mid-frequency
coefficients (c[3,1] vs c[1,3]); detection majority-votes each bit over its
blocks and needs the key, not the original image.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 8
# mid-frequency coefficient pair that carries the bit (low enough to
# survive JPEG's high-frequency quantization, high enough to be invisible)
_C1 = (3, 1)
_C2 = (1, 3)


def _dct_matrix(n: int = _BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix (D @ x applies the transform)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    return d


_D = _dct_matrix()


def _blocks(y: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
    """[H, W] luma → [nb, 8, 8] blocks (crop to a multiple of 8)."""
    H, W = y.shape
    h, w = H - H % _BLOCK, W - W % _BLOCK
    b = y[:h, :w].reshape(h // _BLOCK, _BLOCK, w // _BLOCK, _BLOCK)
    return b.transpose(0, 2, 1, 3).reshape(-1, _BLOCK, _BLOCK), (h, w)


def _unblocks(b: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    h, w = hw
    b = b.reshape(h // _BLOCK, w // _BLOCK, _BLOCK, _BLOCK)
    return b.transpose(0, 2, 1, 3).reshape(h, w)


def str_to_bits(s: str, n_bits: int = 48) -> np.ndarray:
    """Stable key-string → payload bits (FNV-1a stream)."""
    out = []
    h = np.uint64(0xCBF29CE484222325)
    data = s.encode()
    i = 0
    while len(out) < n_bits:
        h = np.uint64((int(h) ^ data[i % len(data)] ^ i)
                      * 0x100000001B3 % (1 << 64))
        out.extend(int(b) for b in f"{int(h) & 0xFF:08b}")
        i += 1
    return np.asarray(out[:n_bits], np.uint8)


def embed_watermark(
    img: np.ndarray,           # [H, W, 3] uint8
    bits: np.ndarray,          # [n] 0/1 payload
    key: int = 0,
    margin: float = 6.0,
) -> np.ndarray:
    """Return a marked copy. `margin` trades robustness vs visibility
    (6.0 ≈ 40+ dB PSNR, survives JPEG q80)."""
    bits = np.asarray(bits, np.uint8)
    x = img.astype(np.float32)
    # ITU-R BT.601 luma; the watermark rides Y so chroma subsampling
    # (JPEG 4:2:0) cannot touch it
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    blocks, hw = _blocks(y)
    nb = blocks.shape[0]
    if nb < bits.size:
        raise ValueError(f"image too small: {nb} blocks < {bits.size} bits")
    assign = np.random.default_rng(key).integers(0, bits.size, nb)

    coeff = _D @ blocks @ _D.T
    c1 = coeff[:, _C1[0], _C1[1]].copy()
    c2 = coeff[:, _C2[0], _C2[1]].copy()
    want_pos = bits[assign].astype(bool)      # bit 1 ⇒ c1 − c2 ≥ margin
    diff = c1 - c2
    adj = np.where(want_pos, np.maximum(0.0, margin - diff),
                   -np.maximum(0.0, margin + diff)) * 0.5
    coeff[:, _C1[0], _C1[1]] = c1 + adj
    coeff[:, _C2[0], _C2[1]] = c2 - adj
    y_marked = _unblocks(_D.T @ coeff @ _D, hw)

    delta = np.zeros_like(y)
    delta[: hw[0], : hw[1]] = y_marked - y[: hw[0], : hw[1]]
    out = x + delta[..., None]                # add the luma delta to RGB
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def detect_watermark(
    img: np.ndarray,
    n_bits: int,
    key: int = 0,
) -> tuple[np.ndarray, float]:
    """Blind detection: (bits [n_bits], mean per-bit vote confidence in
    [0.5, 1.0] — ~0.5 on unmarked images)."""
    x = img.astype(np.float32)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    blocks, _ = _blocks(y)
    assign = np.random.default_rng(key).integers(0, n_bits, blocks.shape[0])
    coeff = _D @ blocks @ _D.T
    vote = coeff[:, _C1[0], _C1[1]] - coeff[:, _C2[0], _C2[1]]

    bits = np.zeros(n_bits, np.uint8)
    conf = np.zeros(n_bits, np.float64)
    for i in range(n_bits):
        v = vote[assign == i]
        if v.size == 0:
            conf[i] = 0.5
            continue
        pos = float(np.mean(v > 0))
        bits[i] = pos >= 0.5
        conf[i] = max(pos, 1.0 - pos)
    return bits, float(conf.mean())


def verify_watermark(img: np.ndarray, payload: str, key: int = 0,
                     n_bits: int = 48, threshold: float = 0.8) -> bool:
    """Does `img` carry `payload`? Compares detected bits to
    str_to_bits(payload) with a bit-accuracy threshold."""
    want = str_to_bits(payload, n_bits)
    got, _ = detect_watermark(img, n_bits, key)
    return float(np.mean(got == want)) >= threshold
