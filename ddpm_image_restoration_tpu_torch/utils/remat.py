"""Activation rematerialisation that replays explicit `torch.Generator`s.

`torch.utils.checkpoint.checkpoint` (non-reentrant) keeps a region's inputs
and recomputes its forward during the backward. Its `preserve_rng_state`
restores the global CPU and CUDA RNGs only: a region that draws from an
explicit generator (training dropout, the sampler's noise) would draw other
numbers in the recompute, and its gradients would be silently wrong.
`checkpoint` here saves those generators' states where the region starts;
each recompute starts them from there and puts them back where it found
them afterwards, so the recompute draws what the forward drew.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.utils.checkpoint


def checkpoint(fn: Callable, *args, generators: Iterable[Optional[torch.Generator]] = ()):
    """fn(*args) under `torch.utils.checkpoint.checkpoint(use_reentrant=False)`,
    with every generator in `generators` (None entries are skipped) replayed
    from its state at this call in each recompute."""
    gens = [g for g in generators if g is not None]
    if not gens:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    start = [g.get_state() for g in gens]
    calls = 0

    def replay(*a):
        nonlocal calls
        calls += 1
        if calls == 1:  # the forward itself: the generators are at `start`
            return fn(*a)
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)

    return torch.utils.checkpoint.checkpoint(replay, *args, use_reentrant=False)
