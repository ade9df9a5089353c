"""chip_smoke.py's `distill` phase, run on the CPU at width/16 with the
counting kernel call sites of tests/test_torch_evaluate_phase.py: each
run's launches (the forward, dQ and dK/dV) must equal what the phase
derives from its schedules, the recompute of the rematerialised solver
included."""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tests.test_torch_evaluate_phase import CPU_FLAGS, counted_kernels  # noqa: E402,F401

torch.set_num_threads(1)


def test_distill_phase_counts_on_cpu(tmp_path, monkeypatch, counted_kernels, capsys):
    """The phase over 20 diffusion steps (both qualities start at step 20)
    from a teacher checkpoint of seeded weights, at batch 2: 5 images (2
    steps) against a stride-4 teacher (6 evaluations, not 20: the CPU takes
    ~0.2 s an evaluation), the progressive chain from it (budgets 3, 2) on
    3 images (one step a stage), the step alone timed once."""
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
    monkeypatch.setattr(chip_smoke, "DISTILL_TIMED_STEPS", 1)
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
    assert log.count("schedule implies") == 5, log
    assert "progressive budgets [3, 2]" in log and "stage directories ['stage0']" in log, log
    counts = state["launches_distill"]
    # 2 + 1 + 1 steps of 2, 3 and 2 student evaluations at two flash levels
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 18
    assert state["train_ckpt"] == str(ck) and ck.exists()
    assert not (tmp_path / "build" / "chip_smoke_distill").exists()
