"""Host-side lossy-codec round-trips (JPEG / WebP / AVIF) on numpy batches.

Copy of `codecs/pil_codecs.py` in the JAX package (the exact codec behind
the sampler's `final_exact` projection), with Pillow imported lazily at the
call that needs it, so the rest of the port runs without Pillow.

Semantics (from the reference):
  * JPEG: quality clamped to [1,100], subsampling 4:4:4 if q>30 else 4:2:0.
  * WebP: quality clamped to [0,100].
  * AVIF: quality clamped to [1,100]; encoder speed 6/4/2 for q>50/q>20/else;
    range='full'; 4:4:4 if q>50 else 4:2:0; on encode failure falls back to
    JPEG.
  * [-1,1] float -> uint8 via (x*127.5+127.5) clamp, and back via /255*2-1.
"""

from __future__ import annotations

import io
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np


def _image():
    from PIL import Image

    return Image


def pil_available() -> bool:
    """Whether Pillow can be imported (the exact host codecs need it)."""
    try:
        _image()
    except ImportError:
        return False
    return True


_AVIF_AVAILABLE: Optional[bool] = None


def avif_available() -> bool:
    global _AVIF_AVAILABLE
    if _AVIF_AVAILABLE is None:
        Image = _image()
        try:  # Pillow >= 11 has AVIF; older installs need the pillow_avif plugin
            import pillow_avif  # noqa: F401
        except ImportError:
            pass
        try:
            buf = io.BytesIO()
            Image.new("RGB", (8, 8)).save(buf, format="AVIF", quality=50)
            _AVIF_AVAILABLE = True
        except Exception:
            _AVIF_AVAILABLE = False
    return _AVIF_AVAILABLE


def _jpeg_roundtrip(img, quality: int):
    quality = max(1, min(100, int(quality)))
    subsampling = "4:4:4" if quality > 30 else "4:2:0"
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality, subsampling=subsampling)
    buf.seek(0)
    out = _image().open(buf)
    out.load()
    return out


def _webp_roundtrip(img, quality: int):
    quality = max(0, min(100, int(quality)))
    buf = io.BytesIO()
    img.save(buf, format="WEBP", quality=quality)
    buf.seek(0)
    out = _image().open(buf)
    out.load()
    return out


def _avif_roundtrip(img, quality: int):
    quality = max(1, min(100, int(quality)))
    speed = 6 if quality > 50 else 4 if quality > 20 else 2
    try:
        buf = io.BytesIO()
        img.save(
            buf,
            format="AVIF",
            quality=quality,
            speed=speed,
            range="full",
            subsampling="4:4:4" if quality > 50 else "4:2:0",
        )
        buf.seek(0)
        out = _image().open(buf)
        out.load()
        if out.mode != "RGB":
            out = out.convert("RGB")
        return out
    except Exception as e:  # AVIF encode failure -> high-quality-JPEG fallback (avif.py:111-120)
        warnings.warn(f"AVIF encoding failed, falling back to JPEG: {e}")
        sub = "4:4:4" if quality > 30 else "4:2:0"
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=quality, subsampling=sub)
        buf.seek(0)
        out = _image().open(buf)
        out.load()
        return out


_ROUNDTRIPS = {"jpeg": _jpeg_roundtrip, "webp": _webp_roundtrip, "avif": _avif_roundtrip}


def compress_uint8(img_u8: np.ndarray, codec: str, quality: int) -> np.ndarray:
    """Round-trip a single HxWx3 uint8 image through the codec."""
    pil = _image().fromarray(img_u8, mode="RGB")
    out = _ROUNDTRIPS[codec](pil, quality)
    if out.mode != "RGB":
        out = out.convert("RGB")
    return np.asarray(out, dtype=np.uint8)


def _to_uint8(x: np.ndarray) -> np.ndarray:
    # [-1,1] float -> uint8
    return np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8)


def _from_uint8(u8: np.ndarray) -> np.ndarray:
    # uint8 -> [-1,1] float
    return (u8.astype(np.float32) / 255.0 - 0.5) * 2.0


class HostCodecPool:
    """Threaded codec worker pool for batched round-trips.

    PIL's encoders release the GIL while inside libjpeg/libwebp/libaom, so a
    thread pool gives real parallel encode/decode on multi-core hosts. The
    sampler's `final_exact` projection lands here.
    """

    def __init__(self, num_workers: Optional[int] = None):
        if num_workers is None:
            num_workers = min(16, (os.cpu_count() or 1))
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 1 else None

    def compress_batch(
        self,
        x: np.ndarray,
        codec: str,
        quality: Union[int, Sequence[int], np.ndarray],
    ) -> np.ndarray:
        """Round-trip a [B,H,W,3] float batch in [-1,1]; per-image quality allowed."""
        x = np.asarray(x)
        squeeze = False
        if x.ndim == 3:
            x, squeeze = x[None], True
        b = x.shape[0]
        qs = np.broadcast_to(np.asarray(quality, dtype=np.int32).reshape(-1), (b,)) \
            if np.ndim(quality) > 0 else np.full((b,), int(quality), dtype=np.int32)
        u8 = _to_uint8(x)

        def work(i):
            return compress_uint8(u8[i], codec, int(qs[i]))

        if self._pool is not None and b > 1:
            outs = list(self._pool.map(work, range(b)))
        else:
            outs = [work(i) for i in range(b)]
        out = _from_uint8(np.stack(outs))
        return out[0] if squeeze else out


_DEFAULT_POOL: Optional[HostCodecPool] = None


def default_pool() -> HostCodecPool:
    global _DEFAULT_POOL
    if _DEFAULT_POOL is None:
        _DEFAULT_POOL = HostCodecPool()
    return _DEFAULT_POOL


def compress_batch(x, codec: str, quality) -> np.ndarray:
    """Module-level convenience wrapper over a shared `HostCodecPool`."""
    if codec == "avif" and not avif_available():
        codec = "jpeg"  # mirror the reference's AVIF->JPEG fallback at batch level
    return default_pool().compress_batch(np.asarray(x), codec, quality)
