"""JPEG, BMP and WEBP files through the port's reader against the JAX
package's, on the CPU.

The port decodes the PNGs it carries itself and hands every other file to
PIL's `convert("RGB")` (`sd_tpu_torch/data/image_io.py read_rgb`); the JAX
package decodes with its native libjpeg path where it is built, else with
the same PIL call (`sd_tpu/data/datasets.py _load_image`). The files are
written by PIL into the test's directory; the tolerance is the JAX
package's own bound between its native decoder and PIL
(`tests/test_native_loader.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from sd_tpu.data import datasets as jdatasets
from sd_tpu_torch.data import image_io
from sd_tpu_torch.data.datasets import ImageFolderDataset

TOL = 1.05 / 127.5

FORMATS = [("jpg", "JPEG"), ("bmp", "BMP"), ("webp", "WEBP")]


def _photo(seed: int, h: int = 40, w: int = 52) -> np.ndarray:
    """A smooth uint8 RGB image with some texture (JPEG-friendly)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([x / w, y / h, (x + y) / (w + h)], -1) * 200
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _folder(tmp_path, ext: str, fmt: str):
    root = tmp_path / ext
    root.mkdir()
    for i in range(3):
        Image.fromarray(_photo(i)).save(root / f"img{i}.{ext}", fmt)
    return root


@pytest.mark.parametrize("ext,fmt", FORMATS)
def test_image_files_load_as_the_tpu_packages(tmp_path, ext, fmt):
    root = _folder(tmp_path, ext, fmt)
    path = str(root / f"img0.{ext}")
    for size, crop in ((32, False), (24, True), (40, False)):
        got = image_io.load_image(path, size, crop=crop)
        want = jdatasets._load_image(path, size, "bicubic", crop)
        assert got.shape == want.shape == (size, size, 3) and got.dtype == np.float32
        assert float(np.abs(got - want).max()) <= TOL, (ext, size, crop)
    with Image.open(path) as img:
        np.testing.assert_array_equal(image_io.read_rgb(path),
                                      np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("ext,fmt", FORMATS)
def test_image_folder_items_equal_the_tpu_packages(tmp_path, ext, fmt):
    root = _folder(tmp_path, ext, fmt)
    ours = ImageFolderDataset(str(root), image_size=32)
    theirs = jdatasets.ImageFolderDataset(str(root), image_size=32)
    assert len(ours) == len(theirs) == 3
    for ds in (ours, theirs):
        ds.set_epoch(1)
    for i in range(3):
        a, b = ours[i]["image"], theirs[i]["image"]
        assert a.shape == b.shape == (32, 32, 3)
        assert float(np.abs(a - b).max()) <= TOL, (ext, i)
