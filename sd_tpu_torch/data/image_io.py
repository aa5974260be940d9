"""Image files on the standard library and numpy: PNG decode and encode,
PIL-compatible resampling, center crop.

Counterpart of what `sd_tpu/native/image_loader.cc` and
`sd_tpu/data/datasets.py _load_image` do (the TPU package decodes with
libjpeg / libpng or PIL; the card's machine has PIL, with JPEG support, but
not the libjpeg / libpng headers the native decoder builds against: the
port decodes the PNGs below itself and hands every other file to PIL). `load_image` returns float32 HWC
in [-1, 1] as both of those do.

PNG: 8-bit gray, gray + alpha, RGB and RGBA, and palette or gray at 1, 2, 4
or 8 bits, non-interlaced; the five row filters (None, Sub and Up
vectorised over the row, Average and Paeth a byte at a time). Converting to
RGB follows PIL's `convert("RGB")`: alpha and the palette's transparency
are dropped, gray is replicated, gray below 8 bits is scaled to 0-255.
Every other file (a JPEG, BMP or WEBP, a 16-bit or interlaced PNG) is read
by PIL, `Image.open(path).convert("RGB")`, the TPU package's own route when
its native decoder declines a file; a file PIL cannot read either raises a
ValueError that names it.

Resampling is PIL's separable filter as the native loader ports it:
bicubic (Keys, a = -0.5) or bilinear, the support scaled by the
downsampling factor, the weights of each output pixel normalised over its
in-bounds window, the horizontal pass first, each pass rounded to uint8.
"""

from __future__ import annotations

import binascii
import functools
import io
import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# -- PNG encode ---------------------------------------------------------------------


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", binascii.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 1|3|4] → PNG bytes (8-bit, no filtering)."""
    x = np.asarray(img, np.uint8)
    if x.ndim == 2:
        x = x[..., None]
    h, w, c = x.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)      # filter byte 0 per row
    rows[:, 1:] = x.reshape(h, w * c)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- PNG decode ---------------------------------------------------------------------

# channels of each colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The filtered scanlines (a filter byte, then `stride` bytes, per row)
    → uint8 [h, stride]."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("truncated image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    if not raw[:, 0].any():                 # every row unfiltered
        return raw[:, 1:].copy()
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:    # Sub: a running sum mod 256 over each byte of a pixel
            pad = (-stride) % bpp
            cols = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            row = np.cumsum(cols, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:    # Up
            row = line + prior
        elif kind in (3, 4):
            row = _unfilter_row(bytes(line), bytes(prior), bpp, kind)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def _unfilter_row(line: bytes, prior: bytes, bpp: int, kind: int) -> np.ndarray:
    """Average (3) or Paeth (4) over one row, a byte at a time: each byte
    depends on the one `bpp` to its left."""
    row = bytearray(line)
    n = len(row)
    if kind == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    else:
        for i in range(n):
            if i >= bpp:
                a, c = row[i - bpp], prior[i - bpp]
            else:
                a = c = 0
            b = prior[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    return np.frombuffer(bytes(row), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 [H, W, C]: C is the file's channels (1 gray, 2 gray
    + alpha, 3 RGB, 4 RGBA), a palette image expanded to RGB; gray below 8
    bits scaled to 0-255. Checks every chunk's CRC."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr, palette = 8, [], None, None
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if binascii.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color}")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if depth not in ((1, 2, 4, 8) if color in (0, 3) else (8,)):
        raise ValueError(f"PNG bit depth {depth} with colour type {color} is not supported")
    c = _CHANNELS[color]
    stride = (w * c * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, c * depth // 8))
    if depth < 8:
        # samples packed from the high bits of each byte
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        img = samples.reshape(h, -1)[:, :w]
        if color == 0:
            img = (img.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        img = img[..., None]
    else:
        img = rows.reshape(h, w, c)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        img = table[img[..., 0]]
    return np.ascontiguousarray(img)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] → [H, W, 3] as PIL's convert("RGB"): gray replicated,
    alpha dropped."""
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] → [H, W] as PIL's convert("L"): gray kept, alpha
    dropped, RGB to ITU-R 601-2 luma in PIL's fixed point."""
    if img.shape[-1] in (1, 2):
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000
    return (luma >> 16).astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """The image file at `path` → uint8 [H, W, 3]: a PNG the decoder above
    carries by it, any other file (JPEG, BMP, WEBP, a 16-bit or interlaced
    PNG) by PIL's `convert("RGB")`. A file neither reads raises a ValueError
    naming it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        try:
            return to_rgb(decode_png(data))
        except (ValueError, zlib.error, struct.error) as e:
            png_error = e
    else:
        png_error = None
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"), np.uint8)
    except (OSError, UnidentifiedImageError, ValueError, SyntaxError) as e:
        cause = png_error if png_error is not None else e
        raise ValueError(f"{path}: {cause}") from e


# -- resampling ---------------------------------------------------------------------


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _sinc(x: np.ndarray) -> np.ndarray:
    px = np.pi * x
    return np.where(x == 0.0, 1.0, np.sin(px) / np.where(x == 0.0, 1.0, px))


def _lanczos(x: np.ndarray) -> np.ndarray:
    """PIL's truncated sinc, a = 3: sinc(x)·sinc(x/3) on [−3, 3)."""
    return np.where((x >= -3.0) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0),
            "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=64)
def resample_weights(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """float32 [out_size, in_size]: each output pixel's weights over the
    input, PIL's window and normalisation (zero outside the window); cached
    and read-only."""
    if method not in _FILTERS:
        raise ValueError(f"resampling {method!r}: only {sorted(_FILTERS)} (and nearest)")
    fn, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    radius = support * filterscale
    out = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(0, int(math.floor(center - radius + 0.5)))
        hi = min(in_size, int(math.floor(center + radius + 0.5)))
        ww = fn((np.arange(lo, hi) + 0.5 - center) / filterscale)
        total = ww.sum()
        if total != 0.0:
            out[i, lo:hi] = (ww / total).astype(np.float32)
    out.flags.writeable = False
    return out


def _to_uint8(v: np.ndarray) -> np.ndarray:
    """Round half up and clip, as each of PIL's passes stores uint8 (in
    place on `v`; the cast truncates, which is the floor of the clipped,
    non-negative value)."""
    v += np.float32(0.5)
    np.clip(v, 0.0, 255.0, out=v)
    return v.astype(np.uint8)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's nearest source of each output pixel, ⌊(i + ½)·in/out⌋, with its
    rounding: the position starts at in/out·½ and adds in/out per pixel, in
    double precision."""
    step = in_size / out_size
    pos, idx = step * 0.5, np.empty(out_size, np.int64)
    for i in range(out_size):
        idx[i] = min(int(pos), in_size - 1)
        pos += step
    return idx


def resize(img: np.ndarray, height: int, width: int, method: str = "bicubic") -> np.ndarray:
    """uint8 [H, W, C] → uint8 [height, width, C]: for bicubic, bilinear and
    lanczos the horizontal pass, then the vertical, each rounded to uint8 (a
    pass whose size does not change is skipped, as PIL skips it); for
    nearest each output pixel copies its source pixel."""
    x = np.asarray(img, np.uint8)
    if method == "nearest":
        return np.ascontiguousarray(x[_nearest_index(x.shape[0], height)][
            :, _nearest_index(x.shape[1], width)])
    # each pass one batched product over the other axis, that axis outermost
    if x.shape[1] != width:
        wh = resample_weights(x.shape[1], width, method)
        rows = np.ascontiguousarray(x.transpose(0, 2, 1), np.float32)      # [H, C, W]
        x = _to_uint8(np.matmul(rows, wh.T)).transpose(0, 2, 1)
    if x.shape[0] != height:
        wv = resample_weights(x.shape[0], height, method)
        cols = np.ascontiguousarray(x.transpose(1, 2, 0), np.float32)      # [W, C, H]
        x = _to_uint8(np.matmul(cols, wv.T)).transpose(2, 0, 1)
    return np.ascontiguousarray(x)


def center_crop(img: np.ndarray) -> np.ndarray:
    """The largest centred square."""
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return img[y0:y0 + s, x0:x0 + s]


def load_image(path: str, size: int, method: str = "bicubic",
               crop: bool = False) -> np.ndarray:
    """The image at `path`, optionally centre-cropped, resized to size² →
    float32 [size, size, 3] in [-1, 1]."""
    img = read_rgb(path)
    if crop:
        img = center_crop(img)
    return resize(img, size, size, method).astype(np.float32) / np.float32(127.5) - np.float32(1.0)
