"""Quality metrics (port of evaluation/metrics.py).

  * PSNR: −10·log10(MSE + 1e-8) on [0,1]-clamped images (webp_inference.py:697).
  * SSIM: pytorch_msssim-compatible (diffusion/losses.ssim).
  * normalized L2: ‖a−b‖ / sqrt(numel) (webp_inference.py:700).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ddpm_image_restoration_tpu_torch.diffusion.losses import ssim


def _to01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.float() * 0.5 + 0.5, 0.0, 1.0)


def psnr(pred: torch.Tensor, target: torch.Tensor, from_minus1: bool = True) -> torch.Tensor:
    """Scalar PSNR in dB over the whole batch (the batch MSE is averaged
    before the log, as in the reference)."""
    a = _to01(pred) if from_minus1 else pred
    b = _to01(target) if from_minus1 else target
    return -10.0 * torch.log10(torch.mean((a - b) ** 2) + 1e-8)


def ssim_metric(pred: torch.Tensor, target: torch.Tensor, from_minus1: bool = True) -> torch.Tensor:
    a = _to01(pred) if from_minus1 else pred
    b = _to01(target) if from_minus1 else target
    return ssim(a, b, data_range=1.0)


def normalized_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    a, b = _to01(pred), _to01(target)
    return torch.linalg.vector_norm((a - b).reshape(-1)) / math.sqrt(a.numel())


def batch_metrics(pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"psnr": psnr(pred, target), "ssim": ssim_metric(pred, target),
            "l2": normalized_l2(pred, target)}
