"""Frequency-domain ops for the UNet's codec-specialised modules (NCHW).

Port of `ops/dct.py` in the JAX package. The JAX package works in NHWC; the
port's UNet keeps PyTorch's NCHW inside, so these ops take NCHW and the tests
transpose when they compare the two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.codecs.surrogate import kron_dct_matrix


def spatial_block_dct(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Blockwise 2-D DCT of NCHW `x` in the spatial layout: each bxb tile of
    the output holds that tile's DCT coefficients (DCTLayer.forward,
    webp_training.py:161-192). One [N, b²] x [b², b²] Kronecker matmul over
    the tiles, flattened row-major within a tile as the JAX package's
    (0,1,3,5,2,4) tile order does. Sizes that are not block multiples are
    zero-padded, transformed and cropped."""
    b, c, h, w = x.shape
    bs = block_size
    if h % bs or w % bs:
        x_p = torch.nn.functional.pad(x, (0, (-w) % bs, 0, (-h) % bs))
        return spatial_block_dct(x_p, bs)[:, :, :h, :w]
    k = torch.from_numpy(kron_dct_matrix(bs)).to(device=x.device, dtype=x.dtype)
    hb, wb = h // bs, w // bs
    tiles = x.reshape(b, c, hb, bs, wb, bs).permute(0, 1, 2, 4, 3, 5)
    coeffs = torch.matmul(tiles.reshape(b, c, hb, wb, bs * bs), k.T)
    coeffs = coeffs.reshape(b, c, hb, wb, bs, bs).permute(0, 1, 2, 4, 3, 5)
    return coeffs.reshape(b, c, h, w)


@functools.lru_cache(maxsize=None)
def _low_freq_mask_np(h: int, w: int, block_size: int, low_size: int) -> np.ndarray:
    """[h,w] float32 mask: 1 where the coefficient is 'low frequency' — per
    bxb tile the top-left low_size x low_size corner, with low_size cut to
    the tile for edge tiles (webp_training.py:241-252)."""
    mask = np.zeros((h, w), dtype=np.float32)
    for i in range(0, h, block_size):
        i_end = min(i + block_size, h)
        for j in range(0, w, block_size):
            j_end = min(j + block_size, w)
            ls = max(1, min(low_size, min(i_end - i, j_end - j)))
            mask[i : i + ls, j : j + ls] = 1.0
    return mask


def low_freq_mask(h: int, w: int, block_size: int, low_size: int,
                  device=None, dtype=torch.float32) -> torch.Tensor:
    """Static low-frequency mask shaped [1,1,h,w] for NCHW broadcast."""
    m = torch.from_numpy(_low_freq_mask_np(h, w, block_size, low_size))
    return m.to(device=device, dtype=dtype)[None, None]


def adjusted_group_count(channels: int, max_groups: int = 8) -> int:
    """GroupNorm group count with the reference's divisor-adjust rule
    (webp_training.py:277-279): min(8, C) reduced until it divides C."""
    g = min(max_groups, channels)
    while channels % g != 0 and g > 1:
        g -= 1
    return g
