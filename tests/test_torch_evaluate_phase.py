"""chip_smoke.py's `evaluate` phase, run on the CPU at width/16: the
launch counts the phase derives from its schedules must equal the calls
that reach the three kernels' call sites (where the card counts its
launches), with the kernels' layout rules checked there, and the metrics
summaries must hold what the phase asserts on the card. The `avif` phase's
rehearsal is tests/test_torch_avif_phase.py."""

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

NARROW = ["--width-scale", "16", "--compute-dtype", "float32"]
CPU_FLAGS = ["--device", "cpu", "--attn", "flash", "--attn-max-res", "32", *NARROW]


def _counting(name, plain):
    """A stand-in for the kernel wrapper `name`: checks the wrapper's input
    rules (contiguous, 16-byte aligned), counts, computes the plain
    version."""
    def fn(*args, **kw):
        assert all(z.is_contiguous() and z.data_ptr() % 16 == 0
                   for z in args if torch.is_tensor(z)), name
        fn.launches += 1
        return plain(*args, **kw)

    fn.__name__, fn.launches = name, 0
    return fn


@pytest.fixture
def counted_kernels(monkeypatch):
    """The forward (inference and the Function's), dQ and dK/dV call sites
    count like the card's wrappers, which chip_smoke reads."""
    fwd = _counting("flash_attention_fwd", fa.flash_attention_plain)
    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(attention, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq",
                        _counting("flash_attention_bwd_dq", fa.flash_attention_bwd_dq_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv",
                        _counting("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv_plain))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_evaluate_phase_counts_on_cpu(tmp_path, monkeypatch, counted_kernels, capsys):
    """The phase with 6 images at batch 4 (a last batch of 2 padded to 4)
    at q10/q50, static and traced, over 20 diffusion steps (start step 20
    at both instead of 80 and 50)."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CARD_FLAGS", CPU_FLAGS)
    monkeypatch.setattr(chip_smoke, "EVAL_IMAGES", 6)
    monkeypatch.setattr(chip_smoke, "EVAL_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "EVAL_QUALITIES", (10, 50))
    monkeypatch.setattr(chip_smoke, "DIFFUSION_STEPS", 20)
    state = {"smi": "CPU"}
    chip_smoke.phase_evaluate(state)
    log = capsys.readouterr().out
    assert log.count("schedule implies") == 2 and "q10 " in log and "q50 " in log, log
    # 2 batches x 2 qualities x 21 launches (14 slots, 7 groups), traced
    assert "schedule implies 84 forward" in log, log
    assert state["launches_evaluate"]["flash_attention_fwd"] > 84
    assert state["launches_evaluate"]["flash_attention_bwd_dq"] == 0
    assert not (tmp_path / "build" / "chip_smoke_evaluate").exists()
