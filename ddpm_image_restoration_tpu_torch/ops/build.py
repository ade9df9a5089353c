"""Builds the port's CUDA sources with `nvcc` into plain C shared libraries.

Each `csrc/<name>.cu` exposes an `extern "C"` launcher that takes pointers,
sizes and a `cudaStream_t`; it includes no PyTorch headers (only the shared
`csrc/*.cuh`), so `nvcc` builds it in seconds. The library lands in
`<repo>/build/torch_kernels/` under a name that carries a hash of the source,
the headers and the flags, so a changed source is rebuilt and an unchanged
one is loaded as it is. Beside it, `<library>.log` keeps what nvcc and
`ptxas -v` printed (registers, spills and shared memory per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
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
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds


def kernel_label(mangled: str) -> str:
    """'flash_fwd_mma_kernel D=32 bf16' for the mangled name of a kernel
    instance (the mangled name itself where it names no flash kernel)."""
    k = re.search(r"flash_(?:fwd|bwd)_\w*?kernel(?=I)", mangled)
    d = re.search(r"kernelI.*?Li(\d+)E", mangled)
    if not k:
        return mangled
    return (f"{k.group(0)} D={d.group(1) if d else '?'} "
            f"{'bf16' if 'bfloat16' in mangled else 'f32'}")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel from `ptxas -v` output: the kernel's name, head
    dim and element type, its registers, spill bytes and shared memory."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = kernel_label(m.group(1)), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {spill or 'spills ?'}, "
                         f"{m.group(2) or 0} B smem")
            name = None
    return lines


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it at first use."""
    if name not in _LOADED:
        path, _ = build(name)
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
