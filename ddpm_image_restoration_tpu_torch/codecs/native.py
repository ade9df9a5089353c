"""ctypes binding for the native C++ codec engine (port of codecs/native.py).

`native/codec_engine.cpp` applies the on-device surrogate's degradation
model (the same tables, quality scaling, calibration, deblocking and smooth
4:2:0 blend as `codecs/surrogate.py codec_surrogate`) on the host, batched
and threaded, so the input pipeline can make training pairs whose
degradation matches the sampler's consistency step.

The engine is built from that source at first use, with the flags of
`native/Makefile`, into `<repo>/build/codec_engine/` under a name that
carries a hash of the source, the compiler and the flags; `native/` itself is
never written to, and the library checked in there (built with
`-march=native` on some other host) is never loaded. Where no C++ compiler
works, the wrapper warns once and computes the port's own `codec_surrogate`
on CPU tensors instead, as the JAX package falls back to its jnp surrogate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ddpm_image_restoration_tpu_torch.codecs.surrogate import _CALIBRATION, _DEBLOCK

REPO_DIR = Path(__file__).resolve().parent.parent.parent
SOURCE = REPO_DIR / "native" / "codec_engine.cpp"
BUILD_DIR = REPO_DIR / "build" / "codec_engine"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")  # native/Makefile
ABI_VERSION = 3  # codec_engine_version() of the deblocking ABI

_CODEC_IDS = {"jpeg": 0, "webp": 1, "avif": 2}
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def build_command(out: Path) -> list:
    """The Makefile's compile command: $CXX (default g++) with its flags,
    and `-march=native` where the compiler takes it."""
    cxx = os.environ.get("CXX", "g++")
    probe = subprocess.run([cxx, "-march=native", "-E", "-x", "c++", os.devnull],
                           capture_output=True)
    march = ["-march=native"] if probe.returncode == 0 else []
    return [cxx, *CXXFLAGS, *march, "-o", str(out), str(SOURCE)]


def library_path() -> Path:
    """Where the library for this source, compiler and host is built."""
    cmd = " ".join(build_command(Path("lib.so")))
    digest = hashlib.sha256(SOURCE.read_bytes() + cmd.encode()
                            + platform.machine().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcodec_engine_{digest}.so"


def build() -> Path:
    """Compile the engine unless an up-to-date library exists; its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        lib = ctypes.CDLL(str(build()))
        lib.codec_engine_version.restype = ctypes.c_int
        lib.codec_engine_version.argtypes = []
        if lib.codec_engine_version() < ABI_VERSION:
            raise RuntimeError("stale codec engine (pre-deblock ABI)")
        lib.codec_surrogate_batch.restype = ctypes.c_int
        lib.codec_surrogate_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
    except (OSError, RuntimeError) as e:  # no compiler, a failed build or load
        warnings.warn(f"native codec engine unavailable ({e}); using the torch surrogate "
                      "on the CPU")
        _LIB_FAILED = True
    return _LIB


def native_available() -> bool:
    return _load() is not None


def _f32(v) -> np.ndarray:
    return np.ascontiguousarray(v, dtype=np.float32)


def codec_surrogate_native(x: np.ndarray, quality: Union[int, np.ndarray],
                           codec: str = "jpeg", subsample: bool = True,
                           n_threads: int = 0) -> np.ndarray:
    """Host-side surrogate round-trip of [B,H,W,3] float32 in [-1,1] at
    `quality` (a scalar or [B] vector); `n_threads` 0 means one per core.
    The result does not depend on the thread count."""
    lib = _load()
    x = _f32(x)
    b, h, w, c = x.shape
    if c != 3:
        raise ValueError(f"NHWC RGB expected, got {c} channels")
    q = np.ascontiguousarray(np.broadcast_to(np.asarray(quality, np.int32).reshape(-1), (b,)))
    if lib is None:
        import torch

        from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate

        return codec_surrogate(torch.from_numpy(x), torch.from_numpy(q.astype(np.float32)),
                               codec=codec, subsample=subsample).numpy()
    qf = q.astype(np.float64)
    q_grid, m_grid = _CALIBRATION[codec]
    dq_grid, s_grid, t_grid = _DEBLOCK[codec]
    mult = _f32(np.interp(qf, q_grid, m_grid))
    dbs, dbt = _f32(np.interp(qf, dq_grid, s_grid)), _f32(np.interp(qf, dq_grid, t_grid))
    out = np.empty_like(x)
    ptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.codec_surrogate_batch(
        x.ctypes.data_as(ptr), out.ctypes.data_as(ptr),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mult.ctypes.data_as(ptr), dbs.ctypes.data_as(ptr), dbt.ctypes.data_as(ptr),
        b, h, w, _CODEC_IDS[codec], int(subsample), n_threads,
    )
    if rc != 0:
        raise ValueError(f"codec_engine error {rc}: shape ({h},{w}) must be divisible by the "
                         f"{codec} block size (and by 2 with subsampling)")
    return out
