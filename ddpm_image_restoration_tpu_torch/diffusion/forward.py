"""Forward (degradation) process: codec compression as the noising operator
(copy of diffusion/forward.py in the JAX package; numpy on the host).

The reference's training loop compresses each sample at a timestep-derived
quality (webp_training.py:499-508); the DriftRec-style variant adds a small
Gaussian dither 0.01·t/T·N(0,1) for stability (new_method.ipynb
forward_process). It runs in the data pipeline, before the batch reaches the
device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch
from ddpm_image_restoration_tpu_torch.codecs.quality import quality_for_timestep


def forward_process(
    x0: np.ndarray,
    t: np.ndarray,
    steps: int,
    codec: str,
    quality_range: Tuple[int, int] = (1, 100),
    rng: Optional[np.random.Generator] = None,
    dither: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Degrade a clean [B,H,W,3] batch in [-1,1] at integer timesteps t
    ([B], in [1, steps)) under the curriculum's `quality_range`; returns
    (xt, the per-sample integer qualities used)."""
    quality = quality_for_timestep(t, steps, quality_range)
    xt = compress_batch(x0, codec, quality)
    if dither:
        rng = rng or np.random.default_rng()
        scale = (0.01 * np.asarray(t, np.float32) / steps)[:, None, None, None]
        xt = xt + scale * rng.standard_normal(xt.shape).astype(np.float32)
    return xt.astype(np.float32), quality
