"""chip_smoke.py's `gaussian_mixture` phase, run on the CPU at a narrow
width: the forward launches the phase derives (init_t x 2 a batch) must
equal the calls that reach the kernel's call site, with the kernel's layout
rules checked there; and the phase's card-against-CPU sampler inputs must
not be chaotic (the JAX package's own sampler barely moves for a 1e-6
input change there). The `modules` phase's rehearsal is
tests/test_torch_modules_phase.py."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ddpm_image_restoration_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ddpm_image_restoration_tpu.config import get_preset as jax_preset  # noqa: E402
from ddpm_image_restoration_tpu.diffusion import gaussian_mixture as jgm  # noqa: E402
from ddpm_image_restoration_tpu.models import build_model as jax_build_model  # noqa: E402
from ddpm_image_restoration_tpu.train.checkpoint import (  # noqa: E402
    load_release_params as jax_load_release_params,
)
from ddpm_image_restoration_tpu_torch.config import get_preset  # noqa: E402
from ddpm_image_restoration_tpu_torch.diffusion import gaussian_mixture as gm  # noqa: E402
from ddpm_image_restoration_tpu_torch.models import build_model  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import attention  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ddpm_image_restoration_tpu_torch.train.checkpoint import params_to_jax  # noqa: E402

torch.set_num_threads(1)

NARROW = ["--width-scale", "16", "--compute-dtype", "float32"]


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    """The phases with the CPU for the card: the forward kernel's call site
    counts like the card's wrapper and enforces its input rules
    (contiguous, 16-byte aligned), then computes the plain version."""
    def counting(q, k, v, save_lse=False):
        assert all(z.is_contiguous() and z.data_ptr() % 16 == 0 for z in (q, k, v))
        fa.flash_attention_fwd.launches += 1
        return fa.flash_attention_plain(q, k, v, save_lse)

    monkeypatch.setattr(attention, "flash_attention_fwd", counting)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")


def test_gaussian_mixture_phase_counts_on_cpu(monkeypatch, on_cpu, capsys):
    """The whole phase at width/16 over 20 diffusion steps (init_t 20 at
    q30), with 2 WebPs (twice) in place of 8 and a 64x96 image in 2 tiles
    (one batch of 2):
    each call's launches against init_t x 2 a batch; the per-step costs and
    the profiled batch; the reference run (at width/16 here, the CPU
    against itself)."""
    cfg, y = chip_smoke.gm_reference_case()
    monkeypatch.setattr(chip_smoke, "gm_reference_case", lambda: (cfg.scaled(8), y))
    monkeypatch.setattr(chip_smoke, "GM_FLAGS", ["--device", "cpu", "--attn", "flash",
                                                 "--attn-max-res", "32", "--random-init",
                                                 *NARROW])
    monkeypatch.setattr(chip_smoke, "DIFFUSION_STEPS", 20)
    monkeypatch.setattr(chip_smoke, "GM_FILES", 2)
    monkeypatch.setattr(chip_smoke, "GM_TILE_HW", (64, 96))
    monkeypatch.setattr(chip_smoke, "GM_TILE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "MODULES_SCALE", 16)
    state = {"smi": "CPU"}
    chip_smoke.phase_gaussian_mixture(state)
    log = capsys.readouterr().out
    assert log.count("implies 40 forward") == 3 and "2 tiles" in log, log
    assert state["launches_gaussian_mixture"] == {"flash_attention_fwd": 120,
                                                  "flash_attention_bwd_dq": 0,
                                                  "flash_attention_bwd_dkv": 0}
    assert "22 kernel launches on the card, 22 implied" in log, log
    assert set(state["gm_step_ms"]) == {"draws_host", "svd"}
    assert not (Path(chip_smoke.ROOT) / "build" / "chip_smoke_gaussian_mixture").exists()


def test_gaussian_mixture_reference_is_not_chaotic(tmp_path):
    """The reference case (half width, f32, 11 steps, key 0) through the
    JAX package's sampler on the phase's weights (its 'xla' attention: the
    same function as flash): a 1e-6 change of the input moves the output by
    a mean of at most 1e-5, a tenth of the card gate; and the port on the
    CPU agrees with it to the gate's 1e-4."""
    cfg, y = chip_smoke.gm_reference_case()
    torch.manual_seed(chip_smoke.SEED)
    tm = build_model("webp", cfg, device="cpu")
    np.savez(tmp_path / "w.npz", **params_to_jax(tm))
    jcfg = JaxModelConfig(**{**dataclasses.asdict(cfg), "attention_impl": "xla"})
    jm = jax_build_model("webp", jcfg)
    jv = {"params": jax_load_release_params(str(tmp_path / "w.npz"))}
    smp = jgm.GaussianMixtureSampler(jm, jax_preset("webp"))
    steps = chip_smoke.GM_REFERENCE_STEPS
    a = np.asarray(smp.sample(jv, jnp.asarray(y), steps=steps, key=jax.random.PRNGKey(0)))
    b = np.asarray(smp.sample(jv, jnp.asarray(y + 1e-6), steps=steps,
                              key=jax.random.PRNGKey(0)))
    moved = np.abs(a - b)
    got = gm.GaussianMixtureSampler(tm, get_preset("webp")).sample(torch.from_numpy(y),
                                                                  steps=steps).numpy()
    diff = np.abs(got - a)
    print(f"JAX against JAX with a 1e-6 input change: mean {moved.mean():.3g}, max "
          f"{moved.max():.3g}; the port against JAX: mean {diff.mean():.3g}, max "
          f"{diff.max():.3g}")
    assert np.isfinite(a).all()
    assert moved.mean() <= 1e-5 and diff.mean() <= 1e-4
