"""Profiling and tracing (port of utils/profiling.py):

  * `trace(logdir)`  — context manager around `torch.profiler` (host ops,
                       and the card's kernels when there is one) that writes
                       a Chrome trace, `<logdir>/trace.json`, viewable in
                       Perfetto or chrome://tracing with no TensorBoard;
  * `annotate(name)` — a named region inside a trace (`record_function`);
  * `sync(x)`        — waits for the work queued on x's card (or the
                       current card); nothing to wait for on the CPU;
  * `StepTimer`      — wall-clock per-step times that end in a `sync`;
                       `summary()` drops the first (warm-up) step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the Chrome trace lands in `<logdir>/trace.json`
    (also when the block raises). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x=None) -> None:
    """Wait for the work feeding `x` (a tensor or a nest of them): the
    card of its first tensor, or the current card when there is none; a
    no-op for CPU tensors and on a host without a card."""
    t = _first_tensor(x)
    if t is not None:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates per-step wall times; `summary()` gives mean/p50/p90."""

    def __init__(self, sync_every: int = 1):
        self.times: List[float] = []
        self.sync_every = sync_every
        self._count = 0

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.perf_counter()
        yield
        self._count += 1
        if self._count % self.sync_every == 0:
            sync(result)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times[1:] or self.times)  # drop the warm-up step
        return {
            "steps": len(self.times),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
        }
