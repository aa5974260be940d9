"""Host-side datasets: image folders, LSUN-style folders, explicit path
lists, class captions and COCO captions.

Counterpart of `sd_tpu/data/datasets.py` (`ImageFolderDataset`,
`LSUNDataset`, `ImagePathsDataset`, `ClassCaptionDataset`,
`CocoCaptionDataset`, `SRDataset`): the same sorted walk, extensions,
per-item flip stream and captions, each item float32 [size, size, 3] in
[-1, 1]; `SRDataset` adds the item's low-resolution twin, made on the host
by `data/degradation.py`. Images are read by `data/image_io.py` (its own
PNG decoder, PIL for JPEG, BMP, WEBP and the PNGs it does not carry; a file
neither reads raises an error naming it).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from sd_tpu_torch.data.image_io import load_image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolderDataset:
    """Every image under `root` (sorted walk), resized to `image_size`,
    flipped left-right with probability ½ by a generator of its own per
    item, epoch and seed."""

    def __init__(self, root: str, image_size: int = 256, random_flip: bool = True,
                 center_crop: bool = False, seed: int = 0):
        self.root = root
        self.image_size = image_size
        self.random_flip = random_flip
        self.center_crop = center_crop
        self.paths = sorted(os.path.join(dp, f) for dp, _, files in os.walk(root)
                            for f in files if f.lower().endswith(IMG_EXTENSIONS))
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the flip stream (the loader calls it at each epoch)."""
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        img = load_image(self.paths[idx], self.image_size, crop=self.center_crop)
        if self.random_flip:
            # one generator per item: the loader's threads read items concurrently
            rng = np.random.default_rng((self.seed, self._epoch, idx))
            if rng.random() < 0.5:
                img = img[:, ::-1].copy()
        return {"image": img}


class LSUNDataset(ImageFolderDataset):
    """An LSUN-style folder: no flip by default."""

    def __init__(self, root: str, image_size: int = 256, **kw):
        kw.setdefault("random_flip", False)
        super().__init__(root, image_size, **kw)


class ImagePathsDataset:
    """An explicit list of paths with optional per-item labels (each
    label list indexed as the paths), centre-cropped by default."""

    def __init__(self, paths: Sequence[str], image_size: int = 256,
                 labels: dict | None = None, center_crop: bool = True):
        self.paths = list(paths)
        self.image_size = image_size
        self.labels = labels or {}
        self.center_crop = center_crop

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        out = {k: v[idx] for k, v in self.labels.items()}
        out["image"] = load_image(self.paths[idx], self.image_size, crop=self.center_crop)
        return out


class ClassCaptionDataset(ImageFolderDataset):
    """A folder whose class label, the file name before its first dot
    (`cat.123.png` → "cat") or the parent directory's name, becomes the
    caption `template.format(label)` (`txt_raw`)."""

    def __init__(self, root: str, image_size: int = 256,
                 label_from: str = "filename_prefix", template: str = "a photo of a {}",
                 **kw):
        super().__init__(root, image_size, **kw)
        if label_from not in ("filename_prefix", "dirname"):
            raise ValueError(f"label_from {label_from!r}")
        self.label_from = label_from
        self.template = template

    def label(self, idx: int) -> str:
        path = self.paths[idx]
        if self.label_from == "dirname":
            return os.path.basename(os.path.dirname(path))
        return os.path.basename(path).split(".")[0]

    def __getitem__(self, idx: int) -> dict:
        out = super().__getitem__(idx)
        out["txt_raw"] = self.template.format(self.label(idx))
        return out


class CocoCaptionDataset:
    """(image, caption) pairs of a COCO captions file ({'images': [{id,
    file_name}], 'annotations': [{image_id, caption}]}), one item per pair."""

    def __init__(self, image_dir: str, annotation_file: str, image_size: int = 256,
                 max_items: int | None = None):
        self.image_dir = image_dir
        self.image_size = image_size
        with open(annotation_file) as f:
            meta = json.load(f)
        id_to_file = {im["id"]: im["file_name"] for im in meta["images"]}
        self.items = []
        for ann in meta["annotations"]:
            fn = id_to_file.get(ann["image_id"])
            if fn is None:
                continue
            self.items.append((fn, ann["caption"]))
            if max_items is not None and len(self.items) >= max_items:
                break

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        fn, caption = self.items[idx]
        img = load_image(os.path.join(self.image_dir, fn), self.image_size)
        return {"image": img, "txt_raw": caption.strip()}


SR_DEGRADATIONS = ("bicubic", "bsrgan", "bsrgan_light", "bsrgan_variant")

# the degradation stream's last key: (seed, epoch, index, SR_KEY)
SR_KEY = 0x5F


def degrade_to_lr(hr01: np.ndarray, how: str, sf: int, rng: np.random.Generator) -> np.ndarray:
    """An HR image in [0, 1] → its LR image (1/sf) in [0, 1]: bicubic
    downsampling, or the BSRGAN composite `how` names drawing from `rng`."""
    from sd_tpu_torch.data import degradation as deg

    if how == "bicubic":
        return deg.bicubic_degradation(hr01, sf)
    if how == "bsrgan_variant":
        return deg.degradation_bsrgan_variant(hr01, sf, rng)[0]
    if how in ("bsrgan", "bsrgan_light"):
        return deg.degradation_bsrgan(hr01, sf, rng, light=how == "bsrgan_light")[0]
    raise ValueError(f"unknown degradation {how!r} (one of {', '.join(SR_DEGRADATIONS)})")


class SRDataset(ImageFolderDataset):
    """HR/LR pairs for super-resolution training: {'image': HR [size, size,
    3], 'lr': LR [size/sf, size/sf, 3]}, both in [-1, 1]. The LR side is the
    flipped HR item degraded in [0, 1] by `degradation`: plain bicubic
    1/sf downsampling, or the BSRGAN composite (`bsrgan`, its light ranges
    `bsrgan_light`, `bsrgan_variant`) drawing from a generator of its own
    per (seed, epoch, index, 0x5F), so the loader's threads stay
    reproducible."""

    def __init__(self, root: str, image_size: int = 256, sf: int = 4,
                 degradation: str = "bicubic", **kw):
        super().__init__(root, image_size=image_size, **kw)
        if image_size % sf:
            raise ValueError(f"image_size={image_size} not divisible by sf={sf}")
        if degradation not in SR_DEGRADATIONS:
            raise ValueError(f"unknown degradation {degradation!r} "
                             f"(one of {', '.join(SR_DEGRADATIONS)})")
        self.sf = sf
        self.degradation = degradation

    def __getitem__(self, idx: int) -> dict:
        item = super().__getitem__(idx)
        rng = np.random.default_rng((self.seed, self._epoch, idx, SR_KEY))
        lr01 = degrade_to_lr((item["image"] + 1.0) * 0.5, self.degradation, self.sf, rng)
        item["lr"] = np.clip(lr01, 0, 1).astype(np.float32) * 2.0 - 1.0
        return item
