"""Spatial resize ops over NCHW: pooling, bilinear 2x upsampling, linear
resize, adaptive pooling. Port of `ops/resize.py` in the JAX package (which is NHWC)."""

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


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """`jax.image.resize(..., method="linear")` to `size` = (H', W'): half-
    pixel centres, and a triangle filter widened by the scale (antialiased)
    where it shrinks, which is jax.image.resize's default. The antialiased
    filter runs in f32 (PyTorch has no bf16 version of it)."""
    h, w = x.shape[-2:]
    if size[0] < h or size[1] < w:
        return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=True).to(x.dtype)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Average-pool x to out_size x out_size: exact window pooling when H and
    W are multiples of out_size, else (including upsampling) `resize_linear`,
    as the JAX package's jax.image.resize fallback."""
    h, w = x.shape[-2:]
    if h == out_size and w == out_size:
        return x
    if h % out_size == 0 and w % out_size == 0 and h >= out_size:
        return avg_pool(x, h // out_size)
    return resize_linear(x, (out_size, out_size))
