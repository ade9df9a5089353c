"""chip_smoke.py's `path1024` phase rehearsed on the CPU at width/16: the
launches per kernel and head dim that the phase predicts from the model's
structure must equal the calls that reach each wrapper's launch
(`ops.flash_attention._launch`, where the card launches its kernels),
through the restore CLI at 1024², a train step with block remat and one UNet
evaluation."""

import collections
import functools
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import attention  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cpu_launches(monkeypatch):
    """Each wrapper as on the card, on the CPU: its plain version, then one
    call of `_launch` (a no-op here) at the head dim the kernel would run
    at, counted in the wrapper's `launches`."""
    monkeypatch.setattr(fa, "_launch", lambda *args: None)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        real = getattr(fa, name)

        @functools.wraps(real)
        def launching(q, *args, real=real, name=name, **kw):
            out = real(q, *args, **kw)
            bh, t, d = q.shape
            fa._launch(name, None, bh, t, fa.kernel_head_dim(name, d, q.dtype), q.dtype, d,
                       q.device)
            getattr(fa, name).launches += 1
            return out

        launching.launches = 0
        monkeypatch.setattr(fa, name, launching)
    monkeypatch.setattr(attention, "flash_attention_fwd", fa.flash_attention_fwd)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_path1024_phase_counts_on_cpu(tmp_path, monkeypatch, cpu_launches, capsys):
    """The whole phase at width/16 (bottleneck widths 64, 64, 32 over 4
    heads: D = 16, 16 and 8 at T = 1024): each run's launches per kernel and
    head dim equal the structure's prediction, 3g forward launches for the
    restore's g encoder groups, 6 forward (the remat recompute) and 3 dQ
    and dK/dV launches for each of the train step's three calls (eager,
    capture, replay: all eager on the CPU), each in bf16 and in f32, and 3
    forward for each of the bf16 and the f32 evaluation. The train step's
    gates (`graph_gates`, rehearsed in tests/test_torch_distill_phase.py
    and tests/test_torch_avif_phase.py) are recorded and its profiles
    skipped: a width/16 step at 1024² takes seconds here."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "PATH1024_SCALE", 16)
    monkeypatch.setattr(chip_smoke, "profile_run",
                        lambda label, run: collections.Counter())
    gates = []
    monkeypatch.setattr(chip_smoke, "graph_gates", lambda label, *a, **k: gates.append(label) or [])
    monkeypatch.setattr(chip_smoke, "RESTORE_FLAGS",
                        ["--device", "cpu", *chip_smoke.RESTORE_FLAGS[2:]])
    state = {"smi": "CPU"}
    chip_smoke.phase_path1024(state)
    log = capsys.readouterr().out
    assert log.count("the structure predicts") == 10, log
    assert gates == ["train step 1024² bfloat16, remat", "train step 1024² float32, remat"]
    assert "head dims per encode [16, 16, 8], per decode []" in log, log
    n, g = chip_smoke.static_schedule(chip_smoke.PATH1024_QUALITY, "webp",
                                      *chip_smoke.restore_budget())
    assert state["launches_path1024"] == {"flash_attention_fwd": 2 * (3 * g + 3 * 6 + 3),
                                          "flash_attention_bwd_dq": 2 * 3 * 3,
                                          "flash_attention_bwd_dkv": 2 * 3 * 3}
    assert not (tmp_path / "build" / "chip_smoke_path1024").exists()
