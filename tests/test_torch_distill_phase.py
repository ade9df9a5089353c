"""chip_smoke.py's `distill` phase, run on the CPU at width/16 with the
counting kernel call sites of tests/test_torch_evaluate_phase.py: each
run's launches (the forward, dQ and dK/dV) must equal what the phase
derives from its schedules, the recompute of the rematerialised solver
included."""

import argparse
import collections
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import attention  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402
from tests.test_torch_evaluate_phase import CPU_FLAGS, counted_kernels  # noqa: E402,F401

torch.set_num_threads(1)


@pytest.fixture
def launching_kernels(monkeypatch, counted_kernels):  # noqa: F811
    """The counting call sites of `counted_kernels`, each call also reaching
    `ops.flash_attention._launch` (a no-op here) at the head dim the kernel
    would run at, where the phase counts the f32 run's launches per head
    dim."""
    monkeypatch.setattr(fa, "_launch", lambda *args: None)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        counting = getattr(fa, name)

        def launching(q, *args, counting=counting, name=name, **kw):
            out = counting(q, *args, **kw)
            bh, t, d = q.shape
            fa._launch(name, None, bh, t, fa.kernel_head_dim(name, d, q.dtype), q.dtype, d,
                       q.device)
            getattr(fa, name).launches += 1
            return out

        launching.__name__, launching.launches = name, 0
        monkeypatch.setattr(fa, name, launching)
    monkeypatch.setattr(attention, "flash_attention_fwd", fa.flash_attention_fwd)


def test_distill_phase_counts_on_cpu(tmp_path, monkeypatch, launching_kernels, capsys):
    """The phase over 20 diffusion steps (both qualities start at step 20)
    from a teacher checkpoint of seeded weights, at batch 2: 5 images (2
    steps) against a stride-4 teacher (6 evaluations, not 20: the CPU takes
    ~0.2 s an evaluation), the same with `--compute-dtype float32`, the
    progressive chain from it (budgets 3, 2) on 3 images (one step a
    stage), the shared-pool run (`distill_pool`: 2 steps a bucket, each
    way, all eager here, held to each other bit for bit), the step alone in
    both dtypes timed once each way (eager, and its graph path, which the
    CPU runs eager), not profiled; of its four
    gates (`graph_gates`: remat on and off, each dtype) only the first
    remat-off one runs (two eager runs and the graph path of one step,
    with a one-evaluation teacher), the others are recorded."""
    from ddpm_image_restoration_tpu_torch.cli.common import add_model_flags, model_config_from
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.checkpoint import CheckpointManager
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CARD_FLAGS", CPU_FLAGS)
    monkeypatch.setattr(chip_smoke, "DIFFUSION_STEPS", 20)
    monkeypatch.setattr(chip_smoke, "DISTILL_IMAGES", 5)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "RESTORE_QUALITIES", (10,))
    monkeypatch.setattr(chip_smoke, "DISTILL_TEACHER_STRIDE", 4)
    monkeypatch.setattr(chip_smoke, "DISTILL_TIMED_EAGER", 1)
    monkeypatch.setattr(chip_smoke, "DISTILL_POOL_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "DISTILL_TIMED_REPLAYS", 1)
    monkeypatch.setattr(chip_smoke, "DISTILL_GATE_TEACHER_STRIDE", 20)
    monkeypatch.setattr(chip_smoke, "DISTILL_GATE_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "GATE_RUNS", 2)
    monkeypatch.setattr(chip_smoke, "profile_run",
                        lambda label, run: collections.Counter())
    gates, real_gates = [], chip_smoke.graph_gates

    def gate(label, *a, default_setting=True, **k):
        gates.append(default_setting)
        if len(gates) == 2:
            return real_gates(label, *a, default_setting=default_setting, **k)
        return []

    monkeypatch.setattr(chip_smoke, "graph_gates", gate)
    monkeypatch.setattr(chip_smoke, "DISTILL_PROGRESSIVE_IMAGES", 3)
    monkeypatch.setattr(chip_smoke, "DISTILL_PROGRESSIVE_STRIDE", 4)
    monkeypatch.setattr(chip_smoke, "DISTILL_PROGRESSIVE_BUDGETS", [3, 2])
    # the teacher: a checkpoint of the port's trainer (seeded weights and
    # their EMA), as phase `train` leaves one
    ck = tmp_path / "teacher"
    ap = argparse.ArgumentParser()
    add_model_flags(ap)
    cfg = TrainConfig(model=model_config_from(ap.parse_args(CPU_FLAGS)), ema_decay=0.9)
    torch.manual_seed(0)
    teacher = create_train_state(build_model("webp", cfg.model, device="cpu"), cfg)
    CheckpointManager(str(ck)).save(0, teacher, {"epoch": 0, "val_psnr": 20.0})
    state = {"smi": "CPU", "train_ckpt": str(ck)}
    chip_smoke.phase_distill(state)
    log = capsys.readouterr().out
    # the CLI runs (5 lines), the shared-pool runs (2), and per dtype the
    # step alone with and without remat eager and its graph path (3)
    assert log.count("schedule implies") == 13, log
    assert "distill shared pool, graph against eager, max |diff| (bit for bit)" in log, log
    assert gates == [True, False, True, False], gates
    assert log.count("under deterministic algorithms") == 1, log
    assert "progressive budgets [3, 2]" in log and "stage directories ['stage0']" in log, log
    assert "distill f32 [--compute-dtype float32" in log, log
    counts = state["launches_distill"]
    # 2 + 2 (f32) + 1 + 1 steps of 2, 2, 3 and 2 student evaluations at two
    # flash levels
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 26
    assert state["train_ckpt"] == str(ck) and ck.exists()
    assert not (tmp_path / "build" / "chip_smoke_distill").exists()
