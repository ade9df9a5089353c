"""Learning-rate schedule (port of train/schedules.py).

The reference uses torch CosineAnnealingWarmRestarts(T_0=100, T_mult=2),
stepped once per epoch (webp_training.py:776, :531); the JAX package builds
it from optax cosine-decay segments of doubling length joined at their
boundaries, and counts in the caller's units (the train loop passes
epoch-granular periods scaled by steps per epoch). Here it is a plain
function of the step count with the same values: at a boundary the next
segment starts, at the base rate.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warm_restarts(base_lr: float, t0: int, t_mult: int = 2, eta_min: float = 0.0,
                         max_steps: int = 1_000_000) -> Callable[[int], float]:
    """count -> learning rate: segment k (of length t0·t_mult^k, starting
    where segment k−1 ends) is eta_min + (base_lr − eta_min)·½(1 + cos(π·c/L))
    at c steps into it. Past the last segment that starts before
    `max_steps`, that segment's value stays at eta_min."""
    starts, periods = [], []
    period, total = t0, 0
    while total < max_steps:
        starts.append(total)
        periods.append(max(1, period))
        total += period
        period *= t_mult

    def schedule(count: int) -> float:
        k = max(i for i, s in enumerate(starts) if count >= s) if count >= 0 else 0
        c = min(count - starts[k], periods[k])
        return (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * c / periods[k])) + eta_min

    return schedule
