"""Quality -> diffusion-timestep maps used by the restore path.

Copies of `codecs/quality.py init_timestep_for_quality` and
`train/distill.py student_stride` from the JAX package (pure Python).
"""

from __future__ import annotations

import math

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
