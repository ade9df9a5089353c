"""chip_smoke.py's `restore` phase and its traced reference batch, run on
the CPU at a narrow width: the launch counts the phase derives from each
variant's schedule must equal the calls that reach the forward kernel's call
site (which is where the card counts its launches), with the kernel's layout
rules checked there; and the traced reference batch must not be chaotic,
or the card-against-CPU gate could not hold."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import attention  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def counted_kernel(monkeypatch):
    """The forward kernel's call site counts like the card's wrapper and
    enforces its input rules (contiguous, 16-byte aligned), then computes
    the plain version."""
    def counting(q, k, v, save_lse=False):
        assert all(z.is_contiguous() and z.data_ptr() % 16 == 0 for z in (q, k, v))
        fa.flash_attention_fwd.launches += 1
        return fa.flash_attention_plain(q, k, v, save_lse)

    monkeypatch.setattr(attention, "flash_attention_fwd", counting)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


NARROW = ["--width-scale", "16", "--compute-dtype", "float32"]


def test_restore_phase_counts_on_cpu(tmp_path, monkeypatch, counted_kernel, capsys):
    """The whole phase (six restore-CLI variants, the checkpoint of a short
    training run, the serve CLI on mixed codecs) at width/16 on the CPU,
    with 4 WebPs (q10 and q90, two each) in place of 8 and a 72x100 image
    in 6 tiles."""
    from ddpm_image_restoration_tpu_torch.cli.train import main as train_main

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "RESTORE_QUALITIES", (10, 90))
    monkeypatch.setattr(chip_smoke, "TILE_SIZE_HW", (72, 100))
    monkeypatch.setattr(chip_smoke, "RESTORE_FLAGS",
                        ["--device", "cpu", *NARROW, *chip_smoke.RESTORE_FLAGS[2:]])
    ck = tmp_path / "ck"
    train_main(["--device", "cpu", *NARROW, "--synthetic", "12", "--epochs", "1",
                "--batch-size", "4", "--attn", "flash", "--attn-max-res", "32", "--steps", "20",
                "--ema-decay", "0.9", "--data-workers", "1", "--checkpoint-dir", str(ck)])
    state = {"smi": "CPU", "train_ckpt": str(ck)}
    chip_smoke.phase_restore(state)
    log = capsys.readouterr().out
    assert log.count("schedule implies") == 7, log
    assert "6 tiles" in log and "in batches of [3, 2, 1]" in log, log
    assert state["launches_restore"]["flash_attention_fwd"] > 0
    assert not ck.exists() and not (tmp_path / "build" / "chip_smoke_restore").exists()


def test_traced_reference_batch_is_not_chaotic(counted_kernel):
    """The reference phase's traced q10/q70 batch (half width, f32, decoder
    reuse 1) launches the kernel 14 times, and a 1e-6 change of its input
    moves the output well inside the card gate (mean |diff| <= 1e-4, max
    <= 2e-2)."""
    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    cfg = ModelConfig(compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(2)
    torch.manual_seed(chip_smoke.SEED)
    model = build_model("webp", cfg, device="cpu")
    x0 = torch.from_numpy(chip_smoke.synthetic_images(2, 64, chip_smoke.SEED + 1))
    y = codec_surrogate(x0, torch.tensor([10.0, 70.0]), codec="webp")
    kw = dict(bucket=30, traced=True, decoder_reuse_depth=1, final_exact=False)
    before = fa.flash_attention_fwd.launches
    a = restore_batch(model, y, [10.0, 70.0], **kw)
    assert fa.flash_attention_fwd.launches - before == 14
    b = restore_batch(model, y + 1e-6, [10.0, 70.0], **kw)
    diff = (a - b).abs()
    print(f"traced reference batch, CPU against CPU with a 1e-6 input change: "
          f"max |diff| {diff.max().item():.3g}, mean {diff.mean().item():.3g}")
    assert np.isfinite(a.numpy()).all()
    assert diff.mean().item() <= 1e-5 and diff.max().item() <= 1e-4
