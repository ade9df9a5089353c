"""Quality <-> diffusion-timestep maps and the training quality curriculum.

Copies of `codecs/quality.py` `init_timestep_for_quality`,
`quality_for_timestep` and `sample_quality_range`, and of
`train/distill.py student_stride`, from the JAX package (numpy only).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ddpm_image_restoration_tpu_torch.config import CodecPreset


def init_timestep_for_quality(quality: int, steps: int, preset: CodecPreset) -> int:
    """Restoration start step: clamp((100 - q)/100 * steps, lo, hi) with the
    preset's (lo, hi) = init_t_clamp (webp_training.py:561-562)."""
    lo, hi = preset.init_t_clamp
    t = int((100 - quality) / 100.0 * steps)
    return int(np.clip(t, lo, hi))


def student_stride(init_t: int, n_eval: int) -> int:
    """The solver stride that makes `sample(steps=init_t)` run n_eval model
    evaluations (see diffusion/ddrm.py _solver_indices: descending from
    init_t-1 by `stride`, always ending at 0)."""
    if n_eval < 1:
        raise ValueError(f"n_eval must be >= 1, got {n_eval}")
    if n_eval >= init_t:
        return 1
    # len(range(init_t-1, -1, -s)) == ceil(init_t / s); find the smallest
    # s whose count (plus the appended 0 when missed) is <= n_eval
    for s in range(math.ceil(init_t / n_eval), init_t + 1):
        idxs = np.arange(init_t - 1, -1, -s)
        n = len(idxs) + (idxs[-1] != 0)
        if n <= n_eval:
            return int(s)
    return int(init_t)


def quality_for_timestep(t: np.ndarray, steps: int,
                         quality_range: Tuple[int, int]) -> np.ndarray:
    """Per-sample training quality for integer timesteps t in [1, steps):
    clamp(min_q + (max_q - min_q)·(1 − t/steps), 0, 100) (webp_training.py:503)."""
    min_q, max_q = quality_range
    q = min_q + (max_q - min_q) * (1.0 - np.asarray(t, np.float32) / steps)
    return np.clip(q, 0, 100).astype(np.int32)


def sample_quality_range(rng: np.random.Generator, epoch: int,
                         preset: CodecPreset) -> Tuple[int, int]:
    """This batch's quality range under the curriculum: P(high) = 0.3 +
    0.4·min(1, epoch/100), then P(mid) = 0.5 of the rest, else low
    (webp_training.py:487-496)."""
    progress = min(1.0, epoch / 100.0)
    if rng.random() < 0.3 + 0.4 * progress:
        return (70, 100)
    if rng.random() < 0.5:
        return (40, 70)
    return (preset.quality_min, 40)   # WebP's low range starts at 0 (webp_training.py:496)
