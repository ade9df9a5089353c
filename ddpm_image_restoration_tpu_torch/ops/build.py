"""Builds the port's CUDA sources with `nvcc` into plain C shared libraries.

Each `csrc/<name>.cu` exposes an `extern "C"` launcher that takes pointers,
sizes and a `cudaStream_t`; it includes no PyTorch headers, so `nvcc` builds
it in seconds. The library lands in `<repo>/build/torch_kernels/` under a name
that carries a hash of the source and of the flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """`nvcc` from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "port's kernels"
    )


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists.
    Returns the library's path and the seconds spent compiling (0 if none)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it at first use."""
    if name not in _LOADED:
        path, _ = build(name)
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
