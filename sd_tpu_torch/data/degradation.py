"""BSRGAN-style image degradations for super-resolution training data
(host-side numpy, scipy.ndimage and PIL).

The port's own copy of `sd_tpu/data/degradation.py`, draw for draw: the
same calls on the passed `np.random.Generator` in the same order, the same
arithmetic, so one seed gives the same LR bits in both packages. Iso- and
anisotropic Gaussian blur kernels, bicubic / bilinear / nearest resizing
(PIL on uint8), classical downsampling, Gaussian / speckle / Poisson / JPEG
noise, the named single-degradation models (bicubic, SRMD, DPSR,
classical), USM sharpening, and the composites `degradation_bsrgan` (its
`light` ranges), `degradation_bsrgan_variant` and `degradation_bsrgan_plus`.
Every function takes and returns float32 HWC images in [0, 1] (the BSRGAN
convention). The JPEG stages need PIL built with JPEG support: without it
they raise an error that says so, and never fall back to another
degradation.
"""

from __future__ import annotations

import io

import numpy as np
from scipy import ndimage


# ---------------------------------------------------------------------------
# blur kernels
# ---------------------------------------------------------------------------


def gaussian_kernel_2d(ksize: int = 21, sigma1: float = 2.0,
                       sigma2: float | None = None,
                       theta: float = 0.0) -> np.ndarray:
    """Isotropic (sigma2=None) or anisotropic rotated Gaussian kernel,
    normalized to sum 1."""
    if sigma2 is None:
        sigma2 = sigma1
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    cov = rot @ np.diag([sigma1**2, sigma2**2]) @ rot.T
    inv = np.linalg.inv(cov)
    r = (ksize - 1) / 2
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    pts = np.stack([xs, ys], -1)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", pts, inv, pts))
    return (k / k.sum()).astype(np.float32)


def random_blur_kernel(rng: np.random.Generator, ksize: int = 21,
                       light: bool = False) -> np.ndarray:
    """Random iso/aniso kernel with BSRGAN-ish parameter ranges."""
    hi = 2.4 if light else 4.0
    if rng.random() < 0.5:
        s1 = rng.uniform(0.1, hi)
        return gaussian_kernel_2d(ksize, s1)
    s1, s2 = rng.uniform(0.5, hi / 0.5 * 0.5, 2)
    theta = rng.uniform(0, np.pi)
    return gaussian_kernel_2d(ksize, s1, s2, theta)


def apply_blur(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = ndimage.convolve(img[..., c], kernel, mode="mirror")
    return out


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------


def _pil_image(jpeg: bool = False):
    """PIL's `Image` module, and with `jpeg` a check that it can write JPEG;
    a missing piece raises an error naming it."""
    try:
        from PIL import Image, features
    except ImportError as e:
        raise ImportError("the SR degradations need PIL (Pillow), which is not "
                          "installed") from e
    if jpeg and not features.check("jpg"):
        raise RuntimeError("the bsrgan degradations' JPEG stage needs PIL built with JPEG "
                           "support (libjpeg); this PIL has none")
    return Image


def resize(img: np.ndarray, out_hw: tuple[int, int],
           method: str = "bicubic") -> np.ndarray:
    Image = _pil_image()
    resample = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
                "nearest": Image.NEAREST, "lanczos": Image.LANCZOS}[method]
    u8 = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    u8 = u8.resize((out_hw[1], out_hw[0]), resample)
    return np.asarray(u8, np.float32) / 255.0


def downsample_classical(img: np.ndarray, sf: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Blur-then-subsample or direct interpolation downsampling (the two
    classical paths of the reference)."""
    h, w = img.shape[:2]
    if rng.random() < 0.5:
        k = random_blur_kernel(rng)
        img = apply_blur(img, k)
        return img[::sf, ::sf]
    method = ("bicubic", "bilinear", "nearest")[rng.integers(0, 3)]
    return resize(img, (h // sf, w // sf), method)


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       noise_level: tuple[float, float] = (2, 25)) -> np.ndarray:
    level = rng.uniform(*noise_level) / 255.0
    mode = rng.random()
    if mode < 0.6:  # per-channel
        noise = rng.normal(0, level, img.shape)
    elif mode < 0.8:  # grayscale
        noise = rng.normal(0, level, img.shape[:2])[..., None]
    else:  # correlated-channel
        cov = np.abs(level**2 * np.array([[1.0, 0.6, 0.4],
                                          [0.6, 1.0, 0.6],
                                          [0.4, 0.6, 1.0]]))
        noise = rng.multivariate_normal(np.zeros(3), cov,
                                        img.shape[:2]).astype(np.float32)
    return np.clip(img + noise, 0, 1).astype(np.float32)


def add_poisson_noise(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    vals = 10 ** rng.uniform(2.0, 4.0)
    return np.clip(rng.poisson(np.clip(img, 0, 1) * vals) / vals,
                   0, 1).astype(np.float32)


def add_speckle_noise(img: np.ndarray, rng: np.random.Generator,
                      noise_level: tuple[float, float] = (2, 25)) -> np.ndarray:
    level = rng.uniform(*noise_level) / 255.0
    noise = rng.normal(0, level, img.shape)
    return np.clip(img + img * noise, 0, 1).astype(np.float32)


def add_jpeg_noise(img: np.ndarray, rng: np.random.Generator,
                   quality: tuple[int, int] = (30, 95)) -> np.ndarray:
    Image = _pil_image(jpeg=True)
    q = int(rng.integers(*quality))
    buf = io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=q
    )
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32) / 255.0


# ---------------------------------------------------------------------------
# named single-degradation models (reference: image_degradation/bsrgan.py
# :228-296 — the bicubic / srmd / dpsr / classical degradation families)
# ---------------------------------------------------------------------------


def bicubic_degradation(x: np.ndarray, sf: int = 3) -> np.ndarray:
    """Plain bicubic 1/sf downsampling (reference: bsrgan.py:228-238)."""
    h, w = x.shape[:2]
    return resize(x, (h // sf, w // sf), "bicubic")


def srmd_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """SRMD model: blur THEN bicubic downsample (reference: bsrgan.py:240-259;
    Zhang et al. 2018 'Learning a single convolutional super-resolution
    network for multiple degradations')."""
    x = _blur_wrap(x, k)
    return bicubic_degradation(x, sf)


def dpsr_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """DPSR model: bicubic downsample THEN blur (reference: bsrgan.py:262-281;
    Zhang et al. 2019 'Deep Plug-and-Play Super-Resolution')."""
    x = bicubic_degradation(x, sf)
    return _blur_wrap(x, k)


def classical_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """Classical model: blur then direct sf-strided subsampling
    (reference: bsrgan.py:284-296)."""
    x = _blur_wrap(x, k)
    return x[::sf, ::sf, ...]


def _blur_wrap(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Channel-wise convolution with 'wrap' boundary — the named degradation
    models use wrap, the composite pipeline uses mirror (reference mode args
    at bsrgan.py:257,280,293 vs :585)."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = ndimage.convolve(img[..., c], kernel, mode="wrap")
    return out


def shift_pixel(k: np.ndarray, sf: int) -> np.ndarray:
    """Shift a blur kernel by (sf-1)/2 px toward the upper-left so strided
    ::sf subsampling picks grid-aligned taps (reference: bsrgan.py:99-125,
    used by the variant's shifted-kernel downsample :583-586)."""
    shift = (sf - 1) * 0.5
    out = ndimage.shift(k, (-shift, -shift), order=1, mode="nearest")
    s = out.sum()
    return out / s if s > 0 else k


def add_sharpening(img: np.ndarray, weight: float = 0.5, radius: float = 50,
                   threshold: int = 10) -> np.ndarray:
    """USM sharpening with a soft mask (reference: bsrgan.py:299-322, borrowed
    from Real-ESRGAN; cv2.GaussianBlur → scipy gaussian_filter here)."""
    sigma = max(radius / 6.0, 1e-3)  # cv2 ksize→sigma convention, approx
    blur = np.stack(
        [ndimage.gaussian_filter(img[..., c], sigma) for c in range(img.shape[2])],
        axis=-1,
    )
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = np.stack(
        [ndimage.gaussian_filter(mask[..., c], sigma) for c in range(mask.shape[2])],
        axis=-1,
    )
    sharp = np.clip(img + weight * residual, 0, 1)
    return (soft_mask * sharp + (1 - soft_mask) * img).astype(np.float32)


# ---------------------------------------------------------------------------
# composite degradations
# ---------------------------------------------------------------------------


def degradation_bsrgan(
    img: np.ndarray,
    sf: int = 4,
    rng: np.random.Generator | None = None,
    light: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """The shuffled BSRGAN degradation composite: random order of
    {blur ×2, classical downsample, gaussian/poisson/speckle noise, JPEG},
    final JPEG, returns (lq, hq) with lq at 1/sf resolution
    (reference: image_degradation/bsrgan.py degradation_bsrgan; `light=True`
    ≈ bsrgan_light parameter ranges)."""
    rng = rng or np.random.default_rng()
    hq = img.astype(np.float32).copy()
    h, w = hq.shape[:2]
    lq = hq.copy()

    stages = list(rng.permutation(6))
    downsampled = False
    for s in stages:
        if s == 0:
            lq = apply_blur(lq, random_blur_kernel(rng, light=light))
        elif s == 1 and rng.random() < 0.5:
            lq = apply_blur(lq, random_blur_kernel(rng, light=light))
        elif s == 2 and not downsampled:
            lq = downsample_classical(lq, sf, rng)
            downsampled = True
        elif s == 3 and rng.random() < 0.5:
            lq = add_gaussian_noise(lq, rng,
                                    (2, 12) if light else (2, 25))
        elif s == 4 and rng.random() < 0.1:
            lq = add_poisson_noise(lq, rng)
        elif s == 5 and rng.random() < 0.1:
            lq = add_speckle_noise(lq, rng)
    if not downsampled:
        lq = downsample_classical(lq, sf, rng)
    lq = add_jpeg_noise(lq, rng, (30, 95))
    if lq.shape[:2] != (h // sf, w // sf):  # enforce exact size after jpeg
        # divergence from reference bsrgan.py:530-613 (which never resizes
        # post-JPEG): only hit when slot-3 rounding drifted the shape
        lq = resize(lq, (h // sf, w // sf))
    return lq.astype(np.float32), hq


def degradation_bsrgan_variant(
    img: np.ndarray,
    sf: int = 4,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The paper's degradation model ("Designing a Practical Degradation Model
    for Deep Blind Image Super-Resolution") — reference: bsrgan.py:530-613:
    optional ×2 pre-downsample at sf=4, a 7-slot shuffle with the random-scale
    downsample2 kept before the to-target downsample3, gaussian noise,
    probabilistic JPEG, final JPEG. Returns (lq, hq); lq is h//sf × w//sf."""
    rng = rng or np.random.default_rng()
    sf_ori = sf
    h1, w1 = img.shape[:2]
    img = img[: h1 - h1 % sf, : w1 - w1 % sf, ...].astype(np.float32).copy()
    h, w = img.shape[:2]
    hq = img.copy()

    if sf == 4 and rng.random() < 0.25:  # downsample1 (scale2_prob)
        method = ("bicubic", "bilinear", "nearest")[rng.integers(0, 3)]
        img = resize(img, (h // 2, w // 2), method)
        sf = 2

    order = list(rng.permutation(7))
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:  # keep downsample2 before downsample3
        order[i2], order[i3] = order[i3], order[i2]

    a = b = None
    for i in order:
        if i in (0, 1):
            img = apply_blur(img, random_blur_kernel(rng))
        elif i == 2:
            b, a = img.shape[:2]  # reference records (w, h) = (a, b) here
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                method = ("bicubic", "bilinear", "nearest")[rng.integers(0, 3)]
                img = resize(img, (max(1, int(img.shape[0] / sf1)),
                                   max(1, int(img.shape[1] / sf1))), method)
            else:
                k = gaussian_kernel_2d(25, rng.uniform(0.1, 0.6 * sf))
                img = apply_blur(img, shift_pixel(k, sf))
                img = img[::sf, ::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            ref_h = b if b is not None else img.shape[0]
            ref_w = a if a is not None else img.shape[1]
            method = ("bicubic", "bilinear", "nearest")[rng.integers(0, 3)]
            img = resize(img, (int(ref_h / sf), int(ref_w / sf)), method)
        elif i == 4:
            img = add_gaussian_noise(img, rng, (2, 25))
        elif i == 5:
            if rng.random() < 0.9:  # jpeg_prob
                img = add_jpeg_noise(img, rng)
        # slot 6 = camera ISP model: commented out in the reference too

    img = add_jpeg_noise(img, rng)
    # Divergence from the reference (bsrgan.py:530-613): the reference leaves
    # whatever size slot-3 rounding produced; we enforce the exact target so
    # batches collate — but only when the shape actually differs, so the
    # terminal JPEG stage is not silently resampled in the common case.
    target = (h // sf_ori, w // sf_ori)
    lq = img if img.shape[:2] == target else resize(img, target)
    return lq.astype(np.float32), hq


def degradation_bsrgan_plus(
    img: np.ndarray, sf: int = 4, rng: np.random.Generator | None = None,
    shuffle_prob: float = 0.5, use_sharp: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """`degradation_bsrgan_plus`: optional USM pre-sharpening, then with prob
    `shuffle_prob` the shuffled composite, else a fixed
    blur→downsample→noise→jpeg order (reference: bsrgan.py:617-716)."""
    rng = rng or np.random.default_rng()
    if use_sharp:
        img = add_sharpening(img.astype(np.float32))
    if rng.random() < shuffle_prob:
        return degradation_bsrgan(img, sf, rng)
    hq = img.astype(np.float32).copy()
    h, w = hq.shape[:2]
    lq = apply_blur(hq, random_blur_kernel(rng))
    lq = downsample_classical(lq, sf, rng)
    lq = add_gaussian_noise(lq, rng)
    lq = add_jpeg_noise(lq, rng)
    if lq.shape[:2] != (h // sf, w // sf):
        lq = resize(lq, (h // sf, w // sf))
    return lq.astype(np.float32), hq
