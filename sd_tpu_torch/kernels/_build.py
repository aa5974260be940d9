"""Build and load the hand-written CUDA kernels (`sd_tpu_torch/csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface and loaded with `ctypes` — no PyTorch headers, so a build
takes seconds. Libraries are built at first use into `build/sd_tpu_torch/`
at the root of the checkout (override with `SD_TPU_TORCH_BUILD_DIR`), named
by a hash of their sources (every header included) and flags so an edited
source rebuilds. All missing libraries are compiled at once, one `nvcc`
process per source, under a file lock on the build directory: the ranks of
a process group that start on a fresh tree build each library once (the
first takes the lock and builds, the others then find the libraries).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention", "flash_attention_sm90", "flash_attention_sm90_pv8",
           "flash_attention_wide", "flash_attention_bwd", "flash_attention_bwd_sm90",
           "flash_attention_bwd_wide_sm90", "geglu",
           "geglu_sm90", "conv2d", "conv2d_sm90", "conv2d_gn_sm90", "groupnorm",
           "groupnorm_sm90", "cross_attention", "cross_attention_sm90")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    d = os.environ.get("SD_TPU_TORCH_BUILD_DIR")
    return Path(d) if d else CSRC.parents[1] / "build" / "sd_tpu_torch"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel; returns wall seconds per
    library compiled (0.0 for one already built). The compiler's output
    (`-Xptxas -v`: registers, shared memory, spills) is kept beside each
    library as `<name>.log`. Raises on a failed build."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with _locked(out_dir / ".lock"):
        return _build_missing(out_dir, names)


@contextlib.contextmanager
def _locked(path: Path):
    """An exclusive lock on `path` (blocking) for the block."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_missing(out_dir: Path, names) -> dict[str, float]:
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    secs = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building what is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all()
        lib = ctypes.CDLL(str(target))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point `symbol` of csrc/<name>.cu with its argument types
    declared (pointers and the stream as c_void_p, so ctypes does not cut
    them to 32 bits); every entry point returns a CUDA error code."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def on_device(device):
    """The context a Hopper launch runs in: `device` (the tensors') made
    current where it is not, since its stream is that device's and the
    tensor maps are encoded against the current device's context
    (`csrc/sm90.cuh bind_context`); no work where it already is."""
    import contextlib

    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
