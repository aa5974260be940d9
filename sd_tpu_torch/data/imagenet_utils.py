"""ImageNet preparation helpers.

Counterpart of `sd_tpu/data/imagenet_utils.py` (the port's own copy): a
nested config lookup by "/"-separated key (`retrieve`, callables expanded),
the prepared-marker file (`.ready`), the synset ↔ class-index maps of a
YAML of `idx: synset` lines (read with PyYAML), index-range strings
("0,3-5,9") and a sorted image filelist.
"""

from __future__ import annotations

import os
from typing import Any


def retrieve(d: Any, key: str, default=None, expand: bool = True):
    """The value under a '/'-separated nested key of dicts and lists
    (`default` where a level is missing); callables on the way are called
    when `expand`."""
    node = d
    try:
        for k in key.split("/"):
            if callable(node) and expand:
                node = node()
            node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
        if callable(node) and expand:
            node = node()
    except (KeyError, IndexError, TypeError, ValueError):
        return default
    return node


def mark_prepared(root: str) -> None:
    """Touch the prepared-marker file `root/.ready`."""
    os.makedirs(root, exist_ok=True)
    open(os.path.join(root, ".ready"), "a").close()


def is_prepared(root: str) -> bool:
    return os.path.exists(os.path.join(root, ".ready"))


def _index_to_synset(path_to_yaml: str) -> dict:
    import yaml

    with open(path_to_yaml) as f:
        return yaml.safe_load(f)


def synset2idx(path_to_yaml: str) -> dict[str, int]:
    """Synset id (n01440764, ...) → class index, from a YAML of
    `idx: synset` lines."""
    return {v: int(k) for k, v in _index_to_synset(path_to_yaml).items()}


def str_to_indices(string: str) -> list[int]:
    """'0,3-5,9' → [0, 3, 4, 5, 9]."""
    assert not string.endswith(","), "provided string ends with a comma"
    out = []
    for part in string.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def give_synsets_from_indices(indices: list[int] | None,
                              path_to_yaml: str) -> list[str] | None:
    """Class indices → synset ids through the YAML map (None stays None)."""
    if indices is None:
        return None
    di2s = _index_to_synset(path_to_yaml)
    return [di2s[i] for i in indices]


def write_filelist(image_dir: str, out_path: str, suffix: str = ".JPEG") -> int:
    """Write the sorted names of `image_dir`'s files ending in `suffix` to
    `out_path`, one a line; returns their number."""
    names = sorted(f for f in os.listdir(image_dir) if f.endswith(suffix))
    with open(out_path, "w") as f:
        f.write("\n".join(names))
    return len(names)
