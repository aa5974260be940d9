"""Metrics, logging and image grids.

Counterpart of `sd_tpu/train/metrics.py`: the append-only `metrics.jsonl`
stream (`step`, `time`, then every float of the step's logs), PSNR and SSIM
of image batches in [-1, 1], parameter counts, uint8 postprocessing, image
grids and per-step timing. Grids are uint8 arrays written as PNG by
`data/image_io.py` (the TPU package's are PIL images). `ismap` / `isimage`
tell conditioning maps from images, `save_animation` writes a denoising
trajectory as a GIF and `log_txt_as_img` renders prompts (both through
PIL, imported when called, as in the TPU package). `compiled_cost` counts a
call's FLOPs with `torch.utils.flop_counter` (the TPU package's XLA cost
analysis; its "flops" key), `profile_trace` writes a `torch.profiler` trace
(its `jax.profiler` trace).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from sd_tpu_torch.data.image_io import write_png


class MetricsLogger:
    """Append-only JSONL metrics stream with a console echo every
    `echo_every` steps; `path` None keeps no file."""

    def __init__(self, path: str | None = None, echo_every: int = 50):
        self.path = path
        self.echo_every = echo_every
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo_every and step % self.echo_every == 0:
            print(f"[metrics] { {k: round(v, 5) for k, v in rec.items() if k != 'time'} }")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def psnr(a, b, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB between image batches in [-1, 1]."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return w / w.sum()


def ssim(a, b, data_range: float = 2.0) -> float:
    """Mean SSIM over a batch of NHWC images (channels averaged): an 11×11
    gaussian window (σ 1.5), Wang et al.'s constants."""
    from scipy.signal import convolve2d

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    w = _gaussian_window()
    conv = lambda x: convolve2d(x, w, mode="valid")
    vals = []
    for i in range(a.shape[0]):
        for c in range(a.shape[-1]):
            x, y = a[i, :, :, c], b[i, :, :, c]
            mx, my = conv(x), conv(y)
            vx, vy, vxy = conv(x * x) - mx**2, conv(y * y) - my**2, conv(x * y) - mx * my
            s = ((2 * mx * my + c1) * (2 * vxy + c2)) / ((mx**2 + my**2 + c1) * (vx + vy + c2))
            vals.append(np.mean(s))
    return float(np.mean(vals))


def ismap(x) -> bool:
    """4-D with more than 3 channels (NHWC): a segmentation-style map."""
    return hasattr(x, "ndim") and x.ndim == 4 and x.shape[-1] > 3


def isimage(x) -> bool:
    """4-D with 1 or 3 channels (NHWC)."""
    return hasattr(x, "ndim") and x.ndim == 4 and x.shape[-1] in (1, 3)


def count_params(params) -> int:
    """Elements of a module's parameters, or of a dict / list of tensors."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    return int(sum(p.numel() for p in params))


def postprocess(images) -> np.ndarray:
    """[-1, 1] float NHWC → uint8 (truncating)."""
    images = np.asarray(images, dtype=np.float32)
    return np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, rows: int | None = None, cols: int | None = None,
              pad: int = 2) -> np.ndarray:
    """uint8 NHWC batch (C 1 or 3) → one uint8 [H, W, 3] grid on white,
    `pad` pixels between tiles; square-ish unless `rows` or `cols` is given."""
    n, h, w, c = images.shape
    if cols is None:
        cols = int(np.ceil(np.sqrt(n)) if rows is None else np.ceil(n / rows))
    if rows is None:
        rows = int(np.ceil(n / cols))
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3), 255, np.uint8)
    for i in range(n):
        y, x = (i // cols) * (h + pad), (i % cols) * (w + pad)
        if y >= grid.shape[0] or x >= grid.shape[1]:
            continue      # a tile past an explicit rows × cols: off the canvas
        tile = images[i] if c == 3 else np.repeat(images[i], 3, axis=-1)
        grid[y:y + h, x:x + w] = tile[:grid.shape[0] - y, :grid.shape[1] - x]
    return grid


def save_image_grid(images, path: str, **kw) -> None:
    """float [-1, 1] batch → grid PNG at `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, make_grid(postprocess(np.asarray(images)), **kw))


def save_animation(frames, path: str, duration_ms: int = 100) -> None:
    """A sequence of float [-1, 1] batches → a looping GIF of their grids."""
    from PIL import Image

    imgs = [Image.fromarray(make_grid(postprocess(np.asarray(f)))) for f in frames]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=duration_ms, loop=0)


def log_txt_as_img(shape_hw: tuple[int, int], texts: list[str]) -> np.ndarray:
    """Each text drawn black on white in PIL's default font, wrapped every
    40·(w/256) characters: float NHWC in [-1, 1]."""
    from PIL import Image, ImageDraw

    h, w = shape_hw
    out = np.zeros((len(texts), h, w, 3), np.float32)
    for i, text in enumerate(texts):
        img = Image.new("RGB", (w, h), (255, 255, 255))
        nc = max(1, int(40 * (w / 256)))
        lines = "\n".join(text[s: s + nc] for s in range(0, len(text), nc))
        ImageDraw.Draw(img).multiline_text((0, 0), lines, fill=(0, 0, 0))
        out[i] = np.asarray(img, np.float32) / 127.5 - 1.0
    return out


def compiled_cost(fn, *args) -> dict:
    """{"flops": the FLOPs of `fn(*args)`} as `torch.utils.flop_counter`
    counts them (matmuls, convolutions and attention; elementwise work
    uncounted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with `torch.profiler` (the CPU, and CUDA where
    there is a card) and write its Chrome trace to `log_dir/trace.json`.
    Usage: `with profile_trace("out/trace"): step(...)`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock time of each `with` block after the first `skip_first`:
    mean, p50, p90."""

    def __init__(self, skip_first: int = 2):
        self.skip = skip_first
        self.times: list[float] = []
        self._t0 = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip:
            self.times.append(dt)

    def stats(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
                "p90_s": float(np.percentile(arr, 90)), "steps": len(arr)}
