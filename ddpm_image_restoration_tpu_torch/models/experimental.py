"""The historical / experimental model family (port of
models/experimental.py; the reference's experiments/code/*):

  * `MLPDenoiser`        — flatten + linear t-encoder + MLP + tanh
                           (ddpm.ipynb);
  * `SimpleConvUNet`     — plain DoubleConv UNet predicting the DDPM ε
                           (conv.ipynb);
  * `DCTDenoiser`        — that UNet with a tanh head, predicting x0
                           directly (dct.ipynb);
  * `HFCM`               — high-frequency compensation: block-DCT features x
                           a learned sigmoid mask x (1 - compression level),
                           added to x;
  * `ExperimentalFreqAwareBlock` — DCT -> conv -> global-pool SE gate,
                           modulated by (1 - level) + 0.5;
  * `SelectiveFreqUNet`  — the new_method UNet: frequency guidance only at
                           down2/down3, bottleneck 1/3 and up2/up3; a bare
                           1x1-conv head.

NCHW throughout, f32. Submodules carry the Flax modules' names, so
`train/checkpoint.py params_from_jax` / `params_to_jax` carry the JAX
package's weights across unchanged. PyTorch needs each layer's input width
where Flax infers it, so the constructors take the image size
(`MLPDenoiser`) or the input channels. Flax's `nn.gelu` is the tanh form
and its GroupNorm's epsilon 1e-6; both are kept. The DDPM-schedule
companions are in diffusion/ddpm_schedule.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddpm_image_restoration_tpu_torch.models.time_embedding import TimeEmbedding
from ddpm_image_restoration_tpu_torch.ops.dct import adjusted_group_count, spatial_block_dct
from ddpm_image_restoration_tpu_torch.ops.resize import max_pool_2x, upsample_2x_bilinear

_GN_EPS = 1e-6  # Flax GroupNorm's epsilon


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """A stride-1 convolution with Flax's 'SAME' padding (odd k)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _level_col(level, x: torch.Tensor) -> Optional[torch.Tensor]:
    """A scalar or per-sample compression level as [B,1,1,1] in x's dtype
    (None stays None)."""
    if level is None:
        return None
    return torch.as_tensor(level, dtype=x.dtype, device=x.device).reshape(-1, 1, 1, 1)


def _t_vec(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


class MLPDenoiser(nn.Module):
    """Flatten + Linear(1 -> t_dim) t-encoder + MLP + tanh. The image is
    flattened in NHWC order, as the JAX package's, so its Dense weights
    carry across as they are."""

    def __init__(self, image_size: int = 32, hidden: Tuple[int, ...] = (1024, 2048, 1024),
                 t_dim: int = 512, channels: int = 3):
        super().__init__()
        n = image_size * image_size * channels
        self.t_encoder = nn.Linear(1, t_dim)
        widths = [n + t_dim, *hidden]
        for i in range(len(hidden)):
            setattr(self, f"fc{i}", nn.Linear(widths[i], widths[i + 1]))
        self.n_hidden = len(hidden)
        self.out = nn.Linear(widths[-1], n)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(b, -1)
        t_embed = self.t_encoder(_t_vec(t, x).reshape(b, 1))
        z = torch.cat([flat, t_embed], dim=-1)
        for i in range(self.n_hidden):
            z = F.relu(getattr(self, f"fc{i}")(z))
        return torch.tanh(self.out(z)).reshape(b, h, w, c).permute(0, 3, 1, 2)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _conv(in_channels, out_channels, 3)
        self.conv2 = _conv(out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class SimpleConvUNet(nn.Module):
    """Plain DoubleConv UNet with sinusoidal time conditioning."""

    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256), time_dim: int = 128,
                 in_channels: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        self.time_embed = TimeEmbedding(time_dim)
        c = in_channels
        for i, w_ in enumerate(self.widths):
            setattr(self, f"down{i}", DoubleConv(c, w_))
            setattr(self, f"tproj{i}", nn.Linear(time_dim, w_))
            c = w_
        for i, w_ in enumerate(self.widths[-2::-1]):
            setattr(self, f"up{i}", DoubleConv(c + w_, w_))
            c = w_
        self.out = _conv(c, in_channels, 1)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        t_emb = self.time_embed(_t_vec(t, x))
        skips, h = [], x
        for i in range(len(self.widths)):
            h = getattr(self, f"down{i}")(h)
            h = h + getattr(self, f"tproj{i}")(t_emb)[:, :, None, None]
            skips.append(h)
            if i < len(self.widths) - 1:
                h = max_pool_2x(h)
        for i in range(len(self.widths) - 1):
            h = torch.cat([upsample_2x_bilinear(h), skips[-(i + 2)]], dim=1)
            h = getattr(self, f"up{i}")(h)
        return self.out(h)


class DCTDenoiser(nn.Module):
    """Direct x0-predictor over codec-degraded inputs: the UNet trunk with a
    tanh head (outputs in [-1, 1])."""

    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256), time_dim: int = 128,
                 in_channels: int = 3):
        super().__init__()
        self.trunk = SimpleConvUNet(widths, time_dim, in_channels)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        return torch.tanh(self.trunk(x, t))


class HFCM(nn.Module):
    """High-frequency compensation: x + mask(dct) * dct * (1 - level)."""

    def __init__(self, channels: int, block_size: int = 8):
        super().__init__()
        self.block_size = block_size
        self.mask_conv = _conv(channels, channels, 1)

    def forward(self, x: torch.Tensor, compression_level=None) -> torch.Tensor:
        dct = spatial_block_dct(x, self.block_size)
        comp = dct * torch.sigmoid(self.mask_conv(dct))
        lvl = _level_col(compression_level, x)
        if lvl is not None:
            comp = comp * (1.0 - lvl)
        return x + comp


class ExperimentalFreqAwareBlock(nn.Module):
    """DCT -> conv -> global-pool SE gate, modulated by (1 - level) + 0.5."""

    def __init__(self, channels: int, block_size: int = 8):
        super().__init__()
        self.block_size = block_size
        self.freq_conv = _conv(channels, channels, 3)
        self.se = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, compression_level=None) -> torch.Tensor:
        f = F.relu(self.freq_conv(spatial_block_dct(x, self.block_size)))
        attn = torch.sigmoid(self.se(f.mean(dim=(2, 3))))[:, :, None, None]
        lvl = _level_col(compression_level, x)
        if lvl is not None:
            attn = attn * (1.0 - lvl) + 0.5
        return x + f * attn


class _ExpResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 use_freq_guide: bool = False):
        super().__init__()
        self.norm1 = nn.GroupNorm(adjusted_group_count(in_channels), in_channels, eps=_GN_EPS)
        self.conv1 = _conv(in_channels, out_channels, 3)
        self.time_proj = nn.Linear(time_dim, out_channels)
        self.norm2 = nn.GroupNorm(adjusted_group_count(out_channels), out_channels,
                                  eps=_GN_EPS)
        self.conv2 = _conv(out_channels, out_channels, 3)
        self.use_freq_guide = use_freq_guide
        if use_freq_guide:
            self.hfcm = HFCM(out_channels)
            self.freq = ExperimentalFreqAwareBlock(out_channels)
        if in_channels != out_channels:
            self.shortcut = _conv(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, level) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.time_proj(t_emb)[:, :, None, None]
        h = self.conv2(F.gelu(self.norm2(h), approximate="tanh"))
        if self.use_freq_guide:
            h = self.freq(self.hfcm(h, level), level)
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class SelectiveFreqUNet(nn.Module):
    """new_method.ipynb UNet: frequency guidance only at down2/down3,
    bottleneck1/3 and up2/up3; a bare 1x1-conv head (no tanh). The default
    widths are the release model's."""

    FREQ_DOWN, FREQ_BOTTLENECK, FREQ_UP = {1, 2}, {0, 2}, {1, 2}   # 0-indexed

    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256, 512, 512),
                 bottleneck: Tuple[int, ...] = (1024, 1024, 512), time_dim: int = 256,
                 in_channels: int = 3):
        super().__init__()
        self.widths, self.bottleneck = tuple(widths), tuple(bottleneck)
        self.time_embed = TimeEmbedding(time_dim)
        c = in_channels
        for i, w_ in enumerate(self.widths):
            setattr(self, f"down{i + 1}", _ExpResBlock(c, w_, time_dim, i in self.FREQ_DOWN))
            c = w_
        for i, w_ in enumerate(self.bottleneck):
            setattr(self, f"bottleneck{i + 1}",
                    _ExpResBlock(c, w_, time_dim, i in self.FREQ_BOTTLENECK))
            c = w_
        dec = list(self.widths[-2::-1]) + [self.widths[0]]
        for i, w_ in enumerate(dec):
            setattr(self, f"up{i + 1}",
                    _ExpResBlock(c + self.widths[-(i + 1)], w_, time_dim, i in self.FREQ_UP))
            c = w_
        self.out = _conv(c, in_channels, 1)

    def forward(self, x: torch.Tensor, t, compression_level=None) -> torch.Tensor:
        t = _t_vec(t, x)
        level = t if compression_level is None else compression_level
        t_emb = self.time_embed(t)
        skips, h = [], x
        for i in range(len(self.widths)):
            if i > 0:
                h = max_pool_2x(h)
            h = getattr(self, f"down{i + 1}")(h, t_emb, level)
            skips.append(h)
        h = max_pool_2x(h)
        for i in range(len(self.bottleneck)):
            h = getattr(self, f"bottleneck{i + 1}")(h, t_emb, level)
        for i in range(len(self.widths)):
            h = torch.cat([upsample_2x_bilinear(h), skips[-(i + 1)]], dim=1)
            h = getattr(self, f"up{i + 1}")(h, t_emb, level)
        return self.out(h)
