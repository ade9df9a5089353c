"""chip_smoke.py's `avif` phase, run on the CPU at width/16 with the
counting kernel call sites of tests/test_torch_evaluate_phase.py: each
run's launches (the forward, dQ and dK/dV) must equal what the phase
derives from its schedules."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tests.test_torch_evaluate_phase import CPU_FLAGS, counted_kernels  # noqa: E402,F401

torch.set_num_threads(1)


def test_avif_phase_counts_on_cpu(tmp_path, monkeypatch, counted_kernels, capsys):
    """The phase with 20 AVIF training images (2 steps of 8), 2 evaluation
    images and 4 AVIF files at q20/q50, and 23 unified training images (one
    step of 18), over 20 diffusion steps: the two trainers' validation
    restores, most of the time, run 46 and 55 model evaluations instead of
    145 and 190."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CARD_FLAGS", CPU_FLAGS)
    monkeypatch.setattr(chip_smoke, "RESTORE_FLAGS",
                        [*CPU_FLAGS, *chip_smoke.RESTORE_FLAGS[6:]])
    monkeypatch.setattr(chip_smoke, "AVIF_TRAIN_IMAGES", 20)
    monkeypatch.setattr(chip_smoke, "AVIF_EVAL_IMAGES", 2)
    monkeypatch.setattr(chip_smoke, "AVIF_QUALITIES", (20, 50))
    monkeypatch.setattr(chip_smoke, "ALL_TRAIN_IMAGES", 23)
    monkeypatch.setattr(chip_smoke, "DIFFUSION_STEPS", 20)
    state = {"smi": "CPU", "avif": True}
    chip_smoke.phase_avif(state)
    log = capsys.readouterr().out
    assert log.count("schedule implies") == 4, log
    assert "heads 8" in log and "written at [20, 20, 50, 50], estimated" in log, log
    counts = state["launches_avif"]
    # 2 AVIF steps and 1 unified step, each one dQ and one dK/dV at two levels
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 6
    assert not (tmp_path / "build" / "chip_smoke_avif").exists()
