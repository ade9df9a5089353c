"""Fréchet distance with pluggable feature extractors (port of
evaluation/fid.py).

The statistics are computed on the host (float64 numpy, scipy's sqrtm);
the features on the device:

  * `InceptionFeatureExtractor`: torchvision InceptionV3 pool3 features,
    the canonical FID's, usable only where torchvision and its pretrained
    weights are on disk (probe with `available()`);
  * `RandomConvFeatureExtractor`: a fixed-seed random conv net ("FD_rand"),
    a deterministic distribution distance, not the canonical FID. Its
    kernels are the JAX package's draws from `jax.random.PRNGKey(seed)`
    (`evaluation/prng.py`), so both packages compute the same distance.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.evaluation import prng
from ddpm_image_restoration_tpu_torch.evaluation.lpips import (
    as_nchw,
    conv_same,
    full_f32,
    hwio_to_oihw,
)


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features [N, D] -> (mean [D], covariance [D, D])."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """|mu1 - mu2|² + Tr(s1 + s2 - 2·sqrtm(s1·s2))."""
    from scipy import linalg

    def _sqrtm(a):
        out = linalg.sqrtm(a)  # older scipy returns (sqrtm, errest) with disp=False
        return out[0] if isinstance(out, tuple) else out

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class RandomConvFeatureExtractor:
    """Fixed-seed 4-layer stride-2 conv net -> [N, 2·dim] features (the
    global mean and max of the last layer), on `device`."""

    def __init__(self, dim: int = 192, seed: int = 0, device: str | torch.device = "cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        key = prng.prng_key(seed)
        self.kernels = []
        in_c = 3
        for w in (24, 48, 96, dim):
            key, sub = prng.split(key)
            k = prng.normal(sub, (3, 3, in_c, w)) / np.float32(np.sqrt(9 * in_c))
            self.kernels.append(hwio_to_oihw(k, self.device))
            in_c = w
        self.name = "random_conv"

    @torch.no_grad()
    def _extract(self, x01) -> torch.Tensor:
        h = as_nchw(x01, self.device) * 2.0 - 1.0
        with full_f32():
            for k in self.kernels:
                h = F.leaky_relu(conv_same(h, k, 2), 0.2)
        return torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], dim=-1)

    def __call__(self, images01, batch: int = 64) -> np.ndarray:
        """images01: [N,H,W,3] in [0,1] -> [N, 2·dim] features."""
        return np.concatenate([self._extract(images01[i: i + batch]).cpu().numpy()
                               for i in range(0, len(images01), batch)])


class InceptionFeatureExtractor:
    """torchvision InceptionV3 pool3 features (the canonical FID features).

    Usable only when torchvision and its pretrained weights are already on
    disk: nothing is downloaded. Probe with `available()`."""

    def __init__(self, device: str | torch.device = "cuda"):
        import torchvision  # noqa: F401  (raises if absent)
        from torchvision.models import inception_v3

        self.device = resolve_device(device)
        net = inception_v3(weights="DEFAULT")
        net.fc = torch.nn.Identity()
        self.net = net.eval().to(self.device)
        self.name = "inception_v3"

    @staticmethod
    def available() -> bool:
        try:
            import torchvision  # noqa: F401
        except ImportError:
            return False
        try:
            InceptionFeatureExtractor(device="cpu")
            return True
        except Exception:
            return False

    @torch.no_grad()
    def __call__(self, images01, batch: int = 32) -> np.ndarray:
        outs = []
        for i in range(0, len(images01), batch):
            x = as_nchw(images01[i: i + batch], self.device)
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
            outs.append(self.net((x - 0.5) / 0.5).cpu().numpy())
        return np.concatenate(outs)


def default_feature_extractor(device: str | torch.device = "cuda"):
    if InceptionFeatureExtractor.available():  # pragma: no cover - needs weights
        return InceptionFeatureExtractor(device)
    return RandomConvFeatureExtractor(device=device)


def fid_between(images_a01, images_b01, extractor=None, device: str | torch.device = "cuda"
                ) -> float:
    """Fréchet distance between two image sets ([N,H,W,3] in [0,1])."""
    extractor = extractor or default_feature_extractor(device)
    fa = extractor(images_a01)
    fb = extractor(images_b01)
    return frechet_distance(*compute_statistics(fa), *compute_statistics(fb))
