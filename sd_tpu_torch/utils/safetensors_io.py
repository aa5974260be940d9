"""safetensors read and write on the standard library and torch.

Counterpart of `sd_tpu/utils/safetensors_io.py`: an 8-byte little-endian
header length, a JSON header mapping each tensor's name to its dtype tag,
shape and byte range (and an optional "__metadata__" string map), padded
with spaces to 8 bytes, then the raw little-endian tensor bytes, names in
sorted order. No `safetensors` package is needed; bf16 is torch's own.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch

# the format's dtype tags (little-endian on disk, as torch stores on every
# platform it supports)
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "U16": torch.uint16, "U32": torch.uint32, "U64": torch.uint64,
    "BOOL": torch.bool,
}
_TAGS = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100_000_000


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor | np.ndarray],
                     metadata: Mapping[str, str] | None = None) -> None:
    """Write `tensors` (name → tensor or numpy array) to `path`, names in
    sorted order, so one tree always gives the same bytes."""
    arrays: dict[str, torch.Tensor] = {}
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.asarray(t)) if not torch.is_tensor(t) else t
        t = t.detach().cpu().contiguous()
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        arrays[name] = t
    header: dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in arrays.items():
        end = offset + t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, end]}
        offset = end
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in arrays.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def load_safetensors(path: str, return_metadata: bool = False):
    """{name: CPU tensor} of a safetensors file (and its metadata map with
    `return_metadata`); each tensor's byte range is checked against its
    dtype and shape."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        if hlen > _MAX_HEADER:
            raise ValueError(f"implausible safetensors header length {hlen}")
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = bytearray(f.read())
    metadata = header.pop("__metadata__", {}) or {}
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dt = _DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{name}: unsupported dtype tag {info['dtype']}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        size = torch.empty((), dtype=dt).element_size()
        if end - start != n * size or end > len(data):
            raise ValueError(f"{name}: data_offsets span {end - start} bytes, expected "
                             f"{n * size} for shape {shape} {info['dtype']}")
        out[name] = (torch.frombuffer(data, dtype=dt, count=n, offset=start).reshape(shape)
                     if n else torch.empty(shape, dtype=dt))
    if return_metadata:
        return out, {str(k): str(v) for k, v in metadata.items()}
    return out
