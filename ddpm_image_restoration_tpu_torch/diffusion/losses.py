"""Training losses (port of diffusion/losses.py).

  * `frequency_aware_loss`  — MSE + 0.5·Σ_c[|rfft2| MSE + 0.5·angle MSE]
                              + 0.3·(1−SSIM), on [0,1]-rescaled tensors
                              (webp_training.py:105-132)
  * `avif_frequency_aware_loss` — full fft2, + gradient/edge loss; weights
                              spatial + 0.3 freq + 0.4 ssim + 0.2 edge
                              (avif.py:126-164)
  * `color_preservation_loss` — channel-weighted L1 (R .25 / G .5 / B .25)
                              + 0.5·(1−SSIM)
  * `hybrid_loss`           — MSE + 0.5·L1(Laplacian)
  * `ssim`                  — pytorch_msssim's settings: 11x11 Gaussian
                              window, sigma 1.5, K = (0.01, 0.03), valid
                              padding, mean over the batch

All take NHWC in [-1,1] and compute in float32 (the loss drives f32
optimizer statistics even when the model computes in bf16).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.codecs.surrogate import device_constant


@functools.lru_cache(maxsize=None)
def _gaussian_band(n: int, size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """[n - size + 1, n] f32 matrix whose row i holds the 1-D Gaussian
    window at columns i..i+size-1: `band @ x` is the valid-padding filter."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g /= g.sum()
    band = np.zeros((n - size + 1, n), np.float32)
    for i in range(n - size + 1):
        band[i, i:i + size] = g
    return band


def _gaussian_filter(x: torch.Tensor) -> torch.Tensor:
    """Valid-padding 11x11 Gaussian filter over the last two axes, as two
    f32 products with banded matrices (the window is separable).

    Full f32 is load-bearing: SSIM's variance terms E[a²]−mu² cancel
    catastrophically for high-PSNR pairs, which is why the JAX package runs
    its window convolution at precision=HIGHEST. A float32 matmul on the card
    is full f32 unless `torch.backends.cuda.matmul.allow_tf32` is set, which
    the port never does (cuDNN's f32 convolutions, by contrast, default to
    TF32).

    The bands are held on the device once per size (`device_constant`): a
    copy from the host each call would make the host wait, and could not be
    captured in the train step's CUDA graph."""
    h, w = x.shape[-2:]
    band_h = device_constant(_gaussian_band, (h,), x.device)
    band_w = device_constant(_gaussian_band, (w,), x.device)
    return torch.matmul(torch.matmul(band_h, x), band_w.T)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         size_average: bool = True) -> torch.Tensor:
    """SSIM with pytorch_msssim-compatible settings. NHWC inputs in
    [0, data_range]."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_a, mu_b, e_aa, e_bb, e_ab = _gaussian_filter(torch.stack([a, b, a * a, b * b, a * b]))
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa, sigma_bb, sigma_ab = e_aa - mu_aa, e_bb - mu_bb, e_ab - mu_ab
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def frequency_aware_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pred, target = pred.float(), target.float()
    spatial = _mse(pred, target)
    p01, t01 = pred * 0.5 + 0.5, target * 0.5 + 0.5
    # per-channel rfft2 over (H, W)
    pf = torch.fft.rfft2(p01.permute(0, 3, 1, 2))
    tf = torch.fft.rfft2(t01.permute(0, 3, 1, 2))
    freq = 0.0
    for c in range(3):
        freq = freq + _mse(pf[:, c].abs(), tf[:, c].abs())
        freq = freq + 0.5 * _mse(torch.angle(pf[:, c]), torch.angle(tf[:, c]))
    ssim_loss = 1.0 - ssim(p01, t01, data_range=1.0)
    return spatial + 0.5 * freq + 0.3 * ssim_loss


def avif_frequency_aware_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pred, target = pred.float(), target.float()
    spatial = _mse(pred, target)
    p01, t01 = pred * 0.5 + 0.5, target * 0.5 + 0.5

    def grad_loss(x, y):
        # NHWC spatial gradients (avif.py:136-142)
        gx_h = (x[:, :-1] - x[:, 1:]).abs()
        gx_w = (x[:, :, :-1] - x[:, :, 1:]).abs()
        gy_h = (y[:, :-1] - y[:, 1:]).abs()
        gy_w = (y[:, :, :-1] - y[:, :, 1:]).abs()
        return _mse(gx_h, gy_h) + _mse(gx_w, gy_w)

    edge = grad_loss(p01, t01)
    pf = torch.fft.fft2(p01.permute(0, 3, 1, 2))
    tf = torch.fft.fft2(t01.permute(0, 3, 1, 2))
    freq = 0.0
    for c in range(3):
        freq = freq + _mse(pf[:, c].abs(), tf[:, c].abs())
        freq = freq + 0.3 * _mse(torch.angle(pf[:, c]), torch.angle(tf[:, c]))
    ssim_loss = 1.0 - ssim(p01, t01, data_range=1.0)
    return spatial + 0.3 * freq + 0.4 * ssim_loss + 0.2 * edge


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """`jnp.clip(x, 0, 1)` with its gradient: min(max(x, 0), 1), which at a
    value exactly on a bound passes half the gradient (`torch.clamp` passes
    all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def color_preservation_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p01 = _clip01(pred.float() * 0.5 + 0.5)
    t01 = _clip01(target.float() * 0.5 + 0.5)

    def l1(a, b):
        return torch.mean((a - b).abs())

    color = (0.25 * l1(p01[..., 0], t01[..., 0]) + 0.5 * l1(p01[..., 1], t01[..., 1])
             + 0.25 * l1(p01[..., 2], t01[..., 2]))
    return color + 0.5 * (1.0 - ssim(p01, t01, data_range=1.0))


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    """Valid 3x3 [[0,1,0],[1,-4,1],[0,1,0]] filter over NHWC's H and W."""
    return (x[:, :-2, 1:-1] + x[:, 2:, 1:-1] + x[:, 1:-1, :-2] + x[:, 1:-1, 2:]
            - 4 * x[:, 1:-1, 1:-1])


def hybrid_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE + 0.5 · L1 of Laplacian responses (dct.ipynb HybridLoss)."""
    pred, target = pred.float(), target.float()
    return _mse(pred, target) + 0.5 * torch.mean((_laplacian(pred) - _laplacian(target)).abs())


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    d = (pred.float() - target.float()).abs()
    return torch.mean(torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta)))


_LOSSES = {
    "frequency_aware": frequency_aware_loss,
    "avif_frequency_aware": avif_frequency_aware_loss,
    "color_preservation": color_preservation_loss,
    "hybrid": hybrid_loss,
    "huber": huber_loss,
}


def loss_for_preset(kind: str):
    return _LOSSES[kind]
