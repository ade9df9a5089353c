"""The port's profiling helpers (utils/profiling.py) on the CPU: StepTimer
against the JAX package's on the same clock readings (its summary keys,
the first step dropped), the Chrome trace and its named regions, and sync
on CPU tensors."""

import json

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.utils import profiling as jprof
from ddpm_image_restoration_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


def _clock(monkeypatch, module, readings):
    it = iter(readings)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("sync_every", [1, 2])
def test_step_timer_matches_jax(monkeypatch, sync_every):
    """Six steps of 1.0 (the warm-up), then 0.01..0.05 s: the summaries
    are equal key for key (to 1e-9 ms: the same float64 arithmetic)."""
    starts = np.cumsum([0.0, 1.0, 0.01, 0.02, 0.03, 0.04])
    durations = [1.0, 0.01, 0.02, 0.03, 0.04, 0.05]
    readings = [v for s, d in zip(starts, durations) for v in (s, s + d)]
    summaries = []
    for module in (prof, jprof):
        _clock(monkeypatch, module, readings)
        timer = module.StepTimer(sync_every=sync_every)
        assert timer.summary() == {}
        for _ in durations:
            with timer.step(torch.ones(2) if module is prof else None):
                pass
        summaries.append(timer.summary())
    got, want = summaries
    assert set(got) == set(want) == {"steps", "mean_ms", "p50_ms", "p90_ms"}
    assert got["steps"] == want["steps"] == 6
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert got["mean_ms"] == pytest.approx(30.0)


def test_one_step_is_kept():
    timer = prof.StepTimer()
    with timer.step():
        pass
    s = timer.summary()
    assert s["steps"] == 1 and s["mean_ms"] >= 0


def test_trace_writes_a_chrome_trace_with_regions(tmp_path):
    conv = torch.nn.Conv2d(3, 4, 3)
    with prof.trace(str(tmp_path / "tr")) as p:
        with prof.annotate("restore_batch"):
            out = conv(torch.randn(1, 3, 8, 8))
        prof.sync(out)
    assert p is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "restore_batch" in names
    assert any("conv" in (n or "") for n in names)


def test_sync_takes_tensors_and_nests():
    prof.sync(torch.zeros(1))
    prof.sync({"a": [torch.zeros(1)], "b": 3})
    prof.sync((1, 2))
    prof.sync()
