"""Codec-specialised frequency modules for the UNet (port of
models/freq_blocks.py), NCHW inside, one interface
(`forward(x, compression_level)`):

  * `DCTFreqAwareBlock`: WebP (4x4 blocks) and JPEG (8x8) static low/high
    DCT-band gates;
  * `AVIFAdaptiveTransform`: a learnable per-channel 8x8 block transform
    T·X·Tᵀ with an adaptive-quantization sigmoid gate (avif.py:186-247);
  * `AVIFFreqAwareBlock`: that transform, multi-scale SE gates at pooled
    sizes 1, 2, 4, 8, colour and edge gates and compression-conditioned
    boosts, combined multiplicatively (avif.py:250-322).

Parameter names follow the Flax modules (`low_attn_in`, `adaptive_transform`,
`ms4_out`, ...), so the release npz maps onto them key for key.

Given a `parallel.spatial.SpatialLevel` (`sp`), `x` is this rank's rows of
a level split over a spatial mesh: the block transforms and the 1x1 gates
stay local (each shard holds whole blocks), the 3x3 convolutions take a
halo, and the AVIF gates pool every rank's rows.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddpm_image_restoration_tpu_torch.codecs.surrogate import dct_matrix
from ddpm_image_restoration_tpu_torch.ops.dct import low_freq_mask, spatial_block_dct
from ddpm_image_restoration_tpu_torch.ops.resize import resize_linear
from ddpm_image_restoration_tpu_torch.parallel import spatial


def _level_col(level: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-sample compression level as [B,1,1,1] in x's dtype."""
    return level.to(x.dtype).reshape(-1, 1, 1, 1)


class DCTFreqAwareBlock(nn.Module):
    """WebP/JPEG frequency-aware module with static low/high masks
    (webp_training.py:206-270): sigmoid gates over the low and high DCT
    bands, the high gate boosted by clamp(1 - level), fused back through a
    3x3 conv."""

    def __init__(self, channels: int, block_size: int, low_size: int,
                 high_boost_clamp: Tuple[float, float]):
        super().__init__()
        self.block_size = block_size
        self.low_size = low_size
        self.high_boost_clamp = high_boost_clamp
        half = channels // 2
        self.low_attn_in = nn.Conv2d(channels, half, 1)
        self.low_attn_out = nn.Conv2d(half, channels, 1)
        self.high_attn_in = nn.Conv2d(channels, half, 1)
        self.high_attn_out = nn.Conv2d(half, channels, 1)
        self.conv_out = nn.Conv2d(channels, channels, 3, padding=1)

    @staticmethod
    def _gate(h, conv_in, conv_out):
        return torch.sigmoid(conv_out(F.leaky_relu(conv_in(h), 0.2)))

    def forward(self, x: torch.Tensor, compression_level: torch.Tensor,
                sp=None) -> torch.Tensor:
        x_dct = spatial_block_dct(x, self.block_size)
        mask = low_freq_mask(x.shape[2], x.shape[3], self.block_size,
                             self.low_size, device=x.device, dtype=x.dtype)
        low = x_dct * mask
        high = x_dct * (1.0 - mask)
        low_attn = self._gate(low, self.low_attn_in, self.low_attn_out)
        high_attn = self._gate(high, self.high_attn_in, self.high_attn_out)
        lo, hi = self.high_boost_clamp
        high_attn = high_attn * torch.clamp(1.0 - _level_col(compression_level, x), lo, hi)
        return spatial.conv3x3(self.conv_out, x + low_attn * low + high_attn * high, sp)


class AVIFAdaptiveTransform(nn.Module):
    """Learnable per-channel block transform + adaptive quantization gate.

    `transform_weights` [C, bs, bs] start at the orthonormal DCT plus
    0.02·N(0, 1), as in the JAX package. Sizes that are not block multiples
    are zero-padded, transformed and cropped (avif.py:208-242)."""

    def __init__(self, channels: int, block_size: int = 8):
        super().__init__()
        self.block_size = block_size
        base = torch.tensor(dct_matrix(block_size))  # on the default device, as randn
        self.transform_weights = nn.Parameter(
            base.expand(channels, block_size, block_size)
            + 0.02 * torch.randn(channels, block_size, block_size))
        self.quant_in = nn.Conv2d(channels, channels, 1)
        self.quant_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        bs = self.block_size
        hp, wp = (-h) % bs, (-w) % bs
        x_p = F.pad(x, (0, wp, 0, hp)) if (hp or wp) else x
        hb, wb = (h + hp) // bs, (w + wp) // bs
        tiles = x_p.reshape(b, c, hb, bs, wb, bs).transpose(3, 4)   # [B,C,hb,wb,bs,bs]
        tw = self.transform_weights.to(x.dtype)[None, :, None, None]
        out = torch.matmul(torch.matmul(tw, tiles), tw.transpose(-1, -2))  # per-channel T·X·Tᵀ
        transformed = out.transpose(3, 4).reshape(b, c, h + hp, w + wp)[:, :, :h, :w]
        q = self.quant_out(torch.relu(self.quant_in(transformed)))
        return transformed * torch.sigmoid(q)


class AVIFFreqAwareBlock(nn.Module):
    """The AVIF frequency module: the adaptive transform x_t, gated by the
    mean of the multi-scale SE gates (each pooled to 1, 2, 4, 8, then
    resized back to the feature map), a colour gate (1x1 convs) and an edge
    gate (3x3 convs), the last two boosted by the compression level within
    their clamps; out = conv_out(x + x_t·attn·colour·edge)."""

    SCALES = (1, 2, 4, 8)

    def __init__(self, channels: int, block_size: int = 8,
                 color_boost_clamp: Tuple[float, float] = (0.3, 1.5),
                 edge_boost_clamp: Tuple[float, float] = (0.5, 1.3)):
        super().__init__()
        c = channels
        self.color_boost_clamp = color_boost_clamp
        self.edge_boost_clamp = edge_boost_clamp
        self.adaptive_transform = AVIFAdaptiveTransform(c, block_size)
        for s in self.SCALES:
            setattr(self, f"ms{s}_in", nn.Conv2d(c, c // 4, 1))
            setattr(self, f"ms{s}_out", nn.Conv2d(c // 4, c, 1))
        self.color_in = nn.Conv2d(c, c, 1)
        self.color_out = nn.Conv2d(c, c, 1)
        self.edge_in = nn.Conv2d(c, c // 2, 3, padding=1)
        self.edge_out = nn.Conv2d(c // 2, c, 3, padding=1)
        self.conv_out = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor, compression_level: torch.Tensor,
                sp=None) -> torch.Tensor:
        x_t = self.adaptive_transform(x)
        size = x.shape[-2:] if sp is None else (sp.height, x.shape[-1])
        attn_sum = 0.0
        for s in self.SCALES:
            conv_in, conv_out = getattr(self, f"ms{s}_in"), getattr(self, f"ms{s}_out")
            a = torch.sigmoid(conv_out(torch.relu(conv_in(spatial.pooled(x, s, sp)))))
            if a.shape[-2:] != size:
                a = resize_linear(a, size)
            attn_sum = attn_sum + spatial.take_rows(a, sp)
        attn_avg = attn_sum / 4.0
        color_attn = torch.sigmoid(self.color_out(torch.relu(self.color_in(x))))
        edge_attn = torch.sigmoid(spatial.conv3x3(
            self.edge_out, torch.relu(spatial.conv3x3(self.edge_in, x, sp)), sp))
        lvl = _level_col(compression_level, x)
        clo, chi = self.color_boost_clamp
        elo, ehi = self.edge_boost_clamp
        color_attn = color_attn * torch.clamp(0.5 + 0.5 * (1.0 - lvl), clo, chi)
        edge_attn = edge_attn * torch.clamp(0.7 + 0.3 * (1.0 - lvl), elo, ehi)
        return spatial.conv3x3(self.conv_out, x + x_t * attn_avg * color_attn * edge_attn, sp)
