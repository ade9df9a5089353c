"""Codec-specialised frequency module for the UNet: `DCTFreqAwareBlock`
(WebP and JPEG), port of models/freq_blocks.py. NCHW inside."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddpm_image_restoration_tpu_torch.ops.dct import low_freq_mask, spatial_block_dct


class DCTFreqAwareBlock(nn.Module):
    """WebP/JPEG frequency-aware module with static low/high masks
    (webp_training.py:206-270): sigmoid gates over the low and high DCT
    bands, the high gate boosted by clamp(1 - level), fused back through a
    3x3 conv. Parameter names follow the Flax module (`low_attn_in`, ...)."""

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

    def forward(self, x: torch.Tensor, compression_level: torch.Tensor) -> torch.Tensor:
        x_dct = spatial_block_dct(x, self.block_size)
        mask = low_freq_mask(x.shape[2], x.shape[3], self.block_size,
                             self.low_size, device=x.device, dtype=x.dtype)
        low = x_dct * mask
        high = x_dct * (1.0 - mask)
        low_attn = self._gate(low, self.low_attn_in, self.low_attn_out)
        high_attn = self._gate(high, self.high_attn_in, self.high_attn_out)
        lo, hi = self.high_boost_clamp
        lvl = compression_level.to(x.dtype).reshape(-1, 1, 1, 1)
        high_attn = high_attn * torch.clamp(1.0 - lvl, lo, hi)
        return self.conv_out(x + low_attn * low + high_attn * high)
