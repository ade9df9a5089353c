"""Spatial resize ops over NCHW: pooling, bilinear 2x upsampling, adaptive
pooling. Port of `ops/resize.py` in the JAX package (which is NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool."""
    return F.max_pool2d(x, 2, 2)


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres (align_corners=False),
    the semantics of jax.image.resize 'linear' for upsampling."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, window)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Average-pool x to out_size x out_size: exact window pooling when H and
    W are multiples of out_size, else (including upsampling) a linear resize
    with half-pixel centres, antialiased when it shrinks, as the JAX
    package's jax.image.resize fallback."""
    h, w = x.shape[-2:]
    if h == out_size and w == out_size:
        return x
    if h % out_size == 0 and w % out_size == 0 and h >= out_size:
        return avg_pool(x, h // out_size)
    return F.interpolate(x, size=(out_size, out_size), mode="bilinear",
                         align_corners=False, antialias=out_size < min(h, w))
