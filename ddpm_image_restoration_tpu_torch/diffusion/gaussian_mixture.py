"""Experimental Gaussian-mixture solver with SVD structure guidance (port of
diffusion/gaussian_mixture.py; the reference's new_method.ipynb).

Per reverse step i = steps-1 .. 0, t = i/steps:

    pred = model(x_t, t, t)
    if svd_guide and i > steps // 2:
        k_ratio = i/steps
        prior   = svd_lowrank(x_t, k_ratio)
        g       = 0.3 * k_ratio
        pred    = (1-g)*pred + g*(y - prior)
    if i > 0:
        x0  = x_t + pred
        mu1 = 0.9*x0 + 0.1*x_t          # conservative
        mu2 = 1.1*x0 - 0.1*x_t          # aggressive
        p   = clamp(i/steps, 0.2, 0.8)  # P(choose conservative)
        mu  = mu1 with prob p else mu2  # one choice for the whole batch
        x_t = mu + (0.1 * i/steps * guidance) * N(0,1)
        every 5 steps: x_t = phase_consistency(x_t, y, 0.6 + 0.3*(1 - i/steps))
    else:
        x_t = x_t + pred

The JAX package runs the loop as one `lax.scan` with `lax.cond` branches;
here it is a Python loop and the branches are host decisions. The
guidance is forward only (no gradient). Images are NHWC, as `DDRMSampler`'s.
Randomness is the JAX package's own stream: the key is a JAX-layout
[2] uint32 key, and each step's mixture choice (one uniform for the whole
batch) and noise (drawn in NHWC order) come from `evaluation/prng.py`, so the
port restores what the JAX package restores from the same key. No global RNG
is touched.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.config import CodecPreset
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import phase_consistency
from ddpm_image_restoration_tpu_torch.evaluation import prng
from ddpm_image_restoration_tpu_torch.parallel.mesh import take_rows


def svd_rank(h: int, w: int, k_ratio) -> int:
    """max(1, int32(min(h, w) · k_ratio)) with the product in float32, as
    the JAX package truncates (a float64 product can fall on the other side
    of an integer)."""
    return max(1, int(np.float32(min(h, w)) * np.float32(k_ratio)))


def svd_structure_preservation(x: torch.Tensor, k_ratio) -> torch.Tensor:
    """Low-rank structure prior: per image and channel of NHWC `x`, keep the
    top k = `svd_rank(h, w, k_ratio)` singular values of the HxW plane. One
    batched f32 SVD over the [B·C, H, W] planes; returns x's dtype."""
    b, h, w, c = x.shape
    planes = x.float().permute(0, 3, 1, 2).reshape(b * c, h, w)
    u, s, vh = torch.linalg.svd(planes, full_matrices=False)
    k = svd_rank(h, w, k_ratio)
    recon = (u[:, :, :k] * s[:, None, :k]) @ vh[:, :k, :]
    return recon.reshape(b, c, h, w).permute(0, 2, 3, 1).to(x.dtype)


class GaussianMixtureSampler:
    def __init__(self, model, preset: CodecPreset, codec_id: Optional[int] = None):
        """`codec_id`: conditioning index of a unified multi-codec model."""
        self.model = model
        self.preset = preset
        self.codec_id = codec_id

    @torch.no_grad()
    def sample(self, y: torch.Tensor, steps: int = 100, key: Optional[np.ndarray] = None,
               use_phase_consistency: bool = True, use_svd_guide: bool = True,
               guidance_scale: float = 1.0,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Restore the NHWC observation y in [-1,1] over `steps` reverse
        steps from `key` (default `prng.prng_key(0)`, the JAX CLI's
        `PRNGKey(0)`). With `rows` = (start, stop) only those rows of the
        batch are restored, from the noise of the whole batch, so each row
        comes out as a restore of the whole batch gives it."""
        key = prng.prng_key(0) if key is None else np.asarray(key, np.uint32)
        full_shape = tuple(y.shape)
        y = take_rows(y.float(), rows)
        b, dev = y.shape[0], y.device
        steps_f = np.float32(steps)
        x_t = y
        for i in range(steps - 1, -1, -1):
            key, k_noise, k_choice = prng.split(key, 3)
            frac = np.float32(i) / steps_f            # i/steps, in float32 as JAX
            t = torch.full((b,), float(frac), dtype=torch.float32, device=dev)
            pred = self.model(x_t, t, t, codec_id=self.codec_id).float()
            if use_svd_guide and i > steps // 2:
                prior = svd_structure_preservation(x_t, frac)
                g = float(frac * np.float32(0.3))
                pred = (1.0 - g) * pred + g * (y - prior)
            if i == 0:
                x_t = x_t + pred
                break
            x0_pred = x_t + pred
            p_conservative = np.clip(frac, np.float32(0.2), np.float32(0.8))
            if prng.uniform(k_choice, ()) < p_conservative:
                mean = x0_pred * 0.9 + x_t * 0.1
            else:
                mean = x0_pred * 1.1 - x_t * 0.1
            noise_scale = np.float32(0.1) * np.float32(i) / steps_f * np.float32(guidance_scale)
            noise = torch.from_numpy(take_rows(prng.normal(k_noise, full_shape), rows))
            x_t = mean + float(noise_scale) * noise.to(dev)
            if use_phase_consistency and i % 5 == 0:
                alpha = np.float32(0.6) + np.float32(0.3) * (np.float32(1.0) - frac)
                x_t = phase_consistency(x_t, y, float(alpha))
        return x_t
