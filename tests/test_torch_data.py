"""The port's data path and run files against the JAX package's, on the CPU:

* PNG decode (`sd_tpu_torch/data/image_io.py`) of PIL-written gray, gray +
  alpha, 1-bit, RGB, RGBA and palette (8- and 4-bit) files, bitwise against
  `sd_tpu.data.datasets._load_image` at the file's own size (its
  resampling is then the identity) and against PIL's `convert("RGB")`;
  between them the files use all five row filters (PIL's adaptive choice;
  `optimize=True` takes Average);
* resizing (bicubic and bilinear, up and down, with and without the
  centre crop) within one uint8 level of `_load_image`'s;
* a JPEG the decoders cannot read (a truncated file) raises an error naming
  the file, from the reader, the dataset and through the loader's threads
  (no quiet skip, no hang), where a whole one decodes (through PIL, as the
  TPU package's fallback does: `tests/test_torch_image_formats.py`);
* `DataLoader` over `ClassCaptionDataset`: the batch order, the flips and
  the captions bitwise equal to the JAX package's loader on the same folder
  and seed, over two epochs, with `drop_last` off and a rank of two;
* `make_grid` equal to the JAX package's PIL grid, the port's grid PNG read
  back by PIL equal to it; `psnr` and `ssim` within 1e-6 of the JAX
  package's;
* `load_config` by name, from JSON and from YAML, and its errors.
"""

from __future__ import annotations

import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from sd_tpu.data import datasets as jdatasets
from sd_tpu.data.loader import DataLoader as JDataLoader
from sd_tpu.train import metrics as jmetrics
from sd_tpu_torch.core import config as port_config
from sd_tpu_torch.data import image_io
from sd_tpu_torch.data.datasets import ClassCaptionDataset, ImageFolderDataset
from sd_tpu_torch.data.loader import DataLoader, collate
from sd_tpu_torch.train import metrics

REPO = Path(__file__).resolve().parents[1]


def _structured(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 [h, w, 4] whose rows suit different PNG filters: random rows,
    ramps (Sub), copies of the row above (Up), the mean of left and above
    (Average) and gradients (Paeth)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 4), np.int64)
    for y in range(h):
        kind = y % 5
        if kind == 0 or y == 0:
            img[y] = rng.integers(0, 256, (w, 4))
        elif kind == 1:
            img[y] = (rng.integers(0, 256, 4) + np.arange(w)[:, None] * rng.integers(1, 4, 4)) % 256
        elif kind == 2:
            img[y] = img[y - 1]
        elif kind == 3:
            img[y, 0] = img[y - 1, 0] // 2
            for x in range(1, w):
                img[y, x] = (img[y, x - 1] + img[y - 1, x]) // 2
        else:
            img[y] = (img[y - 1] + np.arange(w)[:, None] + y) % 256
    return img.astype(np.uint8)


MODES = ("L", "LA", "1", "RGB", "RGBA", "P", "P4")


def _pil_image(mode: str, seed: int = 0, h: int = 29, w: int = 37) -> Image.Image:
    base = _structured(h, w, seed)
    if mode in ("L", "LA", "RGBA", "RGB"):
        chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = base[..., :chans]
        return Image.fromarray(arr[..., 0] if chans == 1 else arr, mode)
    if mode == "1":
        return Image.fromarray(base[..., 0]).convert("1")
    return Image.fromarray(base[..., :3]).convert(
        "P", palette=Image.ADAPTIVE, colors=200 if mode == "P" else 12)


def _write(img: Image.Image, path: Path, optimize: bool) -> Path:
    img.save(path, "PNG", optimize=optimize)
    return path


def _filters(path: Path) -> set:
    """The row filter types of a PNG file."""
    data = path.read_bytes()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    stride = (w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (stride + 1)] for y in range(h)}


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_png_decode_is_bitwise_the_tpu_packages(tmp_path, mode, optimize):
    path = _write(_pil_image(mode), tmp_path / f"{mode}.png", optimize)
    got = image_io.read_rgb(str(path))
    assert got.shape == (29, 37, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    # the centre crop at its own size: no resampling
    np.testing.assert_array_equal(image_io.load_image(str(path), 29, crop=True),
                                  jdatasets._load_image(str(path), 29, center_crop=True))
    square = _write(_pil_image(mode, seed=1, h=30, w=30), tmp_path / f"sq{mode}.png", optimize)
    np.testing.assert_array_equal(image_io.load_image(str(square), 30),
                                  jdatasets._load_image(str(square), 30))


def test_the_decode_cases_use_every_png_filter(tmp_path):
    seen = set()
    for mode in MODES:
        for optimize in (False, True):
            seen |= _filters(_write(_pil_image(mode), tmp_path / f"{mode}{optimize}.png",
                                    optimize))
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("size,crop", [(16, False), (16, True), (48, False), (64, True),
                                       (29, False)])
def test_resize_within_one_level_of_the_tpu_packages(tmp_path, method, size, crop):
    path = _write(_pil_image("RGB", seed=3), tmp_path / "rgb.png", False)
    got = image_io.load_image(str(path), size, method, crop)
    want = jdatasets._load_image(str(path), size, method, crop)
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) * 127.5 <= 1.0 + 1e-4


def test_a_jpeg_raises_an_error_naming_the_file(tmp_path):
    folder = tmp_path / "imgs"
    folder.mkdir()
    Image.fromarray(_structured(16, 16, 1)[..., :3]).save(folder / "a.png")
    jpeg = folder / "b.jpg"
    Image.fromarray(_structured(16, 16, 2)[..., :3]).save(jpeg, "JPEG")
    assert image_io.read_rgb(str(jpeg)).shape == (16, 16, 3)
    jpeg.write_bytes(jpeg.read_bytes()[:40])       # the header alone: no image data
    with pytest.raises(ValueError, match="b.jpg"):
        image_io.read_rgb(str(jpeg))
    ds = ImageFolderDataset(str(folder), image_size=16)
    assert [Path(p).name for p in ds.paths] == ["a.png", "b.jpg"]
    with pytest.raises(ValueError, match="b.jpg"):
        ds[1]
    with pytest.raises(ValueError, match="b.jpg"):      # through the loader's threads
        list(DataLoader(ds, batch_size=2, num_workers=2))
    (folder / "c.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 20)
    with pytest.raises(ValueError, match="c.png"):
        image_io.read_rgb(str(folder / "c.png"))


def _class_folder(root: Path, n: int = 7, size: int = 16) -> Path:
    rng = np.random.default_rng(9)
    root.mkdir()
    for i in range(n):
        name = f"{('cat', 'dog')[i % 2]}.{i}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(root / name)
    return root


@pytest.mark.parametrize("kw", [dict(batch_size=3), dict(batch_size=3, drop_last=False),
                                dict(batch_size=2, rank=1, world=2),
                                dict(batch_size=2, shuffle=False, seed=4)])
def test_loader_order_flips_and_captions_equal_the_tpu_packages(tmp_path, kw):
    folder = str(_class_folder(tmp_path / "imgs"))
    port = DataLoader(ClassCaptionDataset(folder, image_size=16), num_workers=3, **kw)
    ref = JDataLoader(jdatasets.ClassCaptionDataset(folder, image_size=16), num_workers=3, **kw)
    assert len(port) == len(ref)
    for _ in range(2):                                   # two epochs: the flips move
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b) == ["image", "txt_raw"]
            assert a["txt_raw"] == b["txt_raw"]
            np.testing.assert_array_equal(a["image"], b["image"])


def test_loader_stops_cleanly_on_an_early_break(tmp_path):
    import threading

    folder = str(_class_folder(tmp_path / "imgs", n=12))
    loader = DataLoader(ImageFolderDataset(folder, image_size=16), batch_size=2, prefetch=1)
    before = threading.active_count()
    for batch in loader:
        break
    del batch
    import time
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert collate([{"a": np.zeros(2), "s": "x"}, {"a": np.ones(2), "s": "y"}])["s"] == ["x", "y"]


@pytest.mark.parametrize("n,rows,cols,chans", [(4, None, None, 3), (5, None, None, 3),
                                               (3, 1, None, 1), (6, None, 4, 3)])
def test_make_grid_and_its_png_equal_the_tpu_packages(tmp_path, n, rows, cols, chans):
    imgs = np.random.default_rng(n).uniform(-1.2, 1.2, (n, 9, 11, chans)).astype(np.float32)
    u8 = metrics.postprocess(imgs)
    np.testing.assert_array_equal(u8, jmetrics.postprocess(imgs))
    got = metrics.make_grid(u8, rows=rows, cols=cols)
    want = np.asarray(jmetrics.make_grid(jmetrics.postprocess(imgs), rows=rows, cols=cols))
    np.testing.assert_array_equal(got, want)
    metrics.save_image_grid(imgs, str(tmp_path / "g.png"), rows=rows, cols=cols)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")), want)


def test_psnr_and_ssim_equal_the_tpu_packages():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), -1, 1).astype(np.float32)
    assert abs(metrics.psnr(a, b) - jmetrics.psnr(a, b)) <= 1e-6
    assert abs(metrics.ssim(a, b) - jmetrics.ssim(a, b)) <= 1e-6
    assert abs(metrics.ssim(a[0], b[0]) - jmetrics.ssim(a[0], b[0])) <= 1e-6
    assert metrics.psnr(a, a) == float("inf")


def test_load_config_by_name_json_and_yaml(tmp_path, monkeypatch):
    assert port_config.load_config("sd_v1") == port_config.sd_v1_config()
    assert port_config.load_config("vq_smoke_config") == port_config.vq_smoke_config()
    cfg = port_config.kl_f8_256_train_config()
    (tmp_path / "kl.json").write_text(json.dumps(cfg))
    assert port_config.load_config(tmp_path / "kl.json") == cfg
    with open(REPO / "configs" / "ddpm_smoke.yaml") as f:
        want = yaml.safe_load(f)
    assert port_config.load_config(str(REPO / "configs" / "ddpm_smoke.yaml")) == want
    with pytest.raises(ValueError, match="not a config name"):
        port_config.load_config("no_such_config")
    monkeypatch.setitem(sys.modules, "yaml", None)       # PyYAML not installed
    with pytest.raises(RuntimeError, match="PyYAML"):
        port_config.load_config(str(REPO / "configs" / "ddpm_smoke.yaml"))


def test_png_encode_round_trips_through_the_decoder():
    img = _structured(13, 21, 5)[..., :3]
    data = image_io.encode_png(img)
    np.testing.assert_array_equal(image_io.decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
