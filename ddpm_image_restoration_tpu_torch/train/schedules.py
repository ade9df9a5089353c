"""Learning-rate schedule (port of train/schedules.py).

The reference uses torch CosineAnnealingWarmRestarts(T_0=100, T_mult=2),
stepped once per epoch (webp_training.py:776, :531); the JAX package builds
it from optax cosine-decay segments of doubling length joined at their
boundaries, and counts in the caller's units (the train loop passes
epoch-granular periods scaled by steps per epoch). Here it is a plain
function of the step count with the same values, in the same f32
arithmetic: at a boundary the next segment starts, at the base rate.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def cosine_warm_restarts(base_lr: float, t0: int, t_mult: int = 2, eta_min: float = 0.0,
                         max_steps: int = 1_000_000) -> Callable[[int], np.float32]:
    """count -> learning rate (an f32 scalar): segment k (of length
    t0·t_mult^k, starting where segment k−1 ends) is eta_min + (base_lr −
    eta_min)·½(1 + cos(π·c/L)) at c steps into it. Past the last segment
    that starts before `max_steps`, that segment's value stays at eta_min.

    Each operation rounds to f32 in optax's order (`cosine_decay_schedule`
    under `join_schedules`), with the cosine rounded from its f64 value: the
    result is optax's f32 value where XLA's f32 cosine and its folding of
    π/L round as libm does (counts 0, 1 and 2 and every boundary among
    them), and within an ulp of the cosine elsewhere."""
    starts, periods = [], []
    period, total = t0, 0
    while total < max_steps:
        starts.append(total)
        periods.append(max(1, period))
        total += period
        period *= t_mult
    init, low = np.float32(base_lr - eta_min), np.float32(eta_min)
    pi, half, one = np.float32(math.pi), np.float32(0.5), np.float32(1.0)

    def schedule(count: int) -> np.float32:
        k = max(i for i, s in enumerate(starts) if count >= s) if count >= 0 else 0
        c = np.float32(min(count - starts[k], periods[k]))
        cos = np.float32(math.cos(float(pi * c / np.float32(periods[k]))))
        return init * (half * (one + cos)) + low

    return schedule
