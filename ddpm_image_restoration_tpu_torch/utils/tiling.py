"""Overlap-tiled restoration of arbitrary-size images (a copy of
`utils/tiling.py` in the JAX package; numpy only, `restore_fn` is the
caller's).

The reference operates on fixed 64x64 crops only (every input is resized,
webp_training.py:54-58). Tiling restores a photograph at native resolution:
an image of any size becomes batches of fixed-size tiles, so the model only
ever sees its training size and every batch has the same shape.

Correctness note on tiling a *codec-consistency* sampler: JPEG and WebP are
block-local transforms (8x8 DCT blocks, 16x16 macroblocks / 4:2:0 chroma
pairs), so the degradation of a pixel depends only on its codec block. A tile
whose offset is a multiple of 16 therefore sees exactly the same artifact
pattern as the full image, and the per-tile consistency step
`x' = x_hat - codec(x_hat) + y` is faithful to the full-image measurement.
We keep every tile offset 16-aligned by reflect-padding the image up to the
tile grid instead of sliding the last tile back to the edge.

Seams are removed by a separable raised-cosine taper over the overlap band;
accumulated weights are normalised per pixel, so coverage (not the window
shape) determines the final blend and the reconstruction is exact wherever a
single tile covers a pixel.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np

# JPEG block 8, 4:2:0 chroma doubles it; WebP macroblocks are 16x16.
CODEC_BLOCK_ALIGN = 16


def plan_tiles(
    height: int, width: int, tile: int, overlap: int
) -> Tuple[List[Tuple[int, int]], int, int]:
    """Plan a covering grid of `tile` x `tile` windows.

    Returns (offsets, padded_h, padded_w): `offsets` are (y, x) positions on
    the reflect-padded canvas, every one a multiple of CODEC_BLOCK_ALIGN (see
    module docstring); padded_h/w are the canvas dims the offsets cover
    exactly.
    """
    if tile % CODEC_BLOCK_ALIGN:
        raise ValueError(f"tile must be a multiple of {CODEC_BLOCK_ALIGN}, got {tile}")
    if not 0 <= overlap < tile:
        raise ValueError(f"overlap must be in [0, tile), got {overlap}")
    stride = tile - overlap
    # Round the stride down to alignment so every k*stride offset stays
    # aligned (overlap grows slightly rather than breaking block phase).
    stride = max(CODEC_BLOCK_ALIGN, (stride // CODEC_BLOCK_ALIGN) * CODEC_BLOCK_ALIGN)

    def n_and_pad(dim: int) -> Tuple[int, int]:
        if dim <= tile:
            return 1, tile
        n = math.ceil((dim - tile) / stride) + 1
        return n, tile + (n - 1) * stride

    ny, ph = n_and_pad(height)
    nx, pw = n_and_pad(width)
    offsets = [(iy * stride, ix * stride) for iy in range(ny) for ix in range(nx)]
    return offsets, ph, pw


def extract_tiles(
    img: np.ndarray, offsets: List[Tuple[int, int]], tile: int, ph: int, pw: int
) -> np.ndarray:
    """Cut [N, tile, tile, C] tiles out of HWC `img` reflect-padded to (ph, pw)."""
    h, w = img.shape[:2]
    pad_y, pad_x = ph - h, pw - w
    # np.pad reflect cannot exceed dim-1 per call; images smaller than half a
    # tile are rare, loop until covered.
    padded = img
    while pad_y or pad_x:
        ey = min(pad_y, max(padded.shape[0] - 1, 1))
        ex = min(pad_x, max(padded.shape[1] - 1, 1))
        mode = "reflect" if min(padded.shape[:2]) > 1 else "edge"
        padded = np.pad(padded, ((0, ey), (0, ex), (0, 0)), mode=mode)
        pad_y -= ey
        pad_x -= ex
    return np.stack([padded[y : y + tile, x : x + tile] for y, x in offsets])


def blend_window(tile: int, overlap: int) -> np.ndarray:
    """[tile, tile] separable raised-cosine taper, strictly positive.

    Ramps 0->1 over the overlap band at every edge; per-pixel weight
    normalisation in `assemble_tiles` makes the outer image border (where no
    neighbouring tile contributes) exact despite the taper.
    """
    ramp_len = max(overlap, 1)
    line = np.ones(tile, np.float32)
    # midpoint-sampled half-cosine: strictly positive, symmetric
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(ramp_len) + 0.5) / ramp_len)
    line[:ramp_len] = ramp
    line[tile - ramp_len :] = ramp[::-1]
    return np.outer(line, line)


def assemble_tiles(
    tiles: np.ndarray,
    offsets: List[Tuple[int, int]],
    height: int,
    width: int,
    ph: int,
    pw: int,
    overlap: int,
) -> np.ndarray:
    """Blend [N, tile, tile, C] tiles back to an HWC image of (height, width)."""
    tile = tiles.shape[1]
    win = blend_window(tile, overlap)[:, :, None]
    acc = np.zeros((ph, pw, tiles.shape[-1]), np.float32)
    wacc = np.zeros((ph, pw, 1), np.float32)
    for t, (y, x) in zip(tiles, offsets):
        acc[y : y + tile, x : x + tile] += t.astype(np.float32) * win
        wacc[y : y + tile, x : x + tile] += win
    return (acc / wacc)[:height, :width]


def restore_tiled(
    restore_fn: Callable[[np.ndarray], np.ndarray],
    img: np.ndarray,
    tile: int,
    overlap: int = 32,
    batch_size: int = 16,
) -> np.ndarray:
    """Restore an HWC image of any size through a fixed-shape batch restorer.

    `restore_fn` maps [B, tile, tile, C] -> [B, tile, tile, C] and is called
    with batches of exactly `batch_size` tiles (the tail batch is padded by
    repeating its last tile) so every batch has one shape.
    """
    h, w = img.shape[:2]
    offsets, ph, pw = plan_tiles(h, w, tile, overlap)
    tiles = extract_tiles(img, offsets, tile, ph, pw)
    out = np.empty_like(tiles, dtype=np.float32)
    n = len(tiles)
    for s in range(0, n, batch_size):
        batch = tiles[s : s + batch_size]
        k = len(batch)
        if k < batch_size:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], batch_size - k, axis=0)]
            )
        out[s : s + k] = np.asarray(restore_fn(batch))[:k]
    return assemble_tiles(out, offsets, h, w, ph, pw, overlap)
