"""The JAX package's restores on the release WebP weights, as a fixture that
the card reads without JAX (`chip_smoke.py` phase `release`):
`tests/torch_release/webp_real_r5_jax.npz`.

    JAX_PLATFORMS=cpu python -m tests._torch_release      # regenerate it

The fixture holds N_IMAGES `natural` synthetic images at 64² (`x0`, the
`SyntheticImageDataset` both packages have, seed SEED) and, for each quality
q of QUALITIES, the JAX package's `codec_surrogate(x0, q, codec="webp")`
(`y_q`), its f32 restore of `y_q` at full width (`restored_q`; flash
attention at <= 32², which on the CPU runs the package's plain attention)
under the production policy as its `cli/serve.py solver_for` picks it
(budget 14, encoder reuse 2, eta 0) with the surrogate's own last
projection (`final_exact=False`: no host codec, so no libwebp version,
enters), the batch PSNR of each against `x0`, and the weights' sha256, the
JAX version and the evaluations per quality. Nothing in it is random: the
generator is the code that `tests/test_torch_release.py` re-runs.

Imports the JAX package (as `tests/_torch_parity.py` does); the port and
`chip_smoke.py` never import this module.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ddpm_image_restoration_tpu.codecs.quality import init_timestep_for_quality
from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate
from ddpm_image_restoration_tpu.config import ModelConfig, get_preset
from ddpm_image_restoration_tpu.data.dataset import SyntheticImageDataset
from ddpm_image_restoration_tpu.diffusion.ddrm import DDRMSampler, _solver_indices
from ddpm_image_restoration_tpu.diffusion.policy import production_solver_config
from ddpm_image_restoration_tpu.evaluation.metrics import psnr
from ddpm_image_restoration_tpu.models import build_model
from ddpm_image_restoration_tpu.train.checkpoint import load_release_params
from ddpm_image_restoration_tpu.train.distill import student_stride

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import file_sha256  # noqa: E402

WEIGHTS = ROOT / "artifacts_release" / "webp_real_r5.npz"
FIXTURE = ROOT / "tests" / "torch_release" / "webp_real_r5_jax.npz"
CODEC = "webp"
QUALITIES = (10, 30, 50)
N_IMAGES = 2
SEED = 7
STEPS = 100
# The release model as the card serves it, in f32.
MODEL_CFG = ModelConfig(compute_dtype="float32", attention_impl="flash",
                        attn_max_resolution=32)


def clean_images(image_size: int = 64) -> np.ndarray:
    """x0: N_IMAGES `natural` images, NHWC in [-1, 1]."""
    ds = SyntheticImageDataset(N_IMAGES, image_size, seed=SEED, kind="natural")
    return np.stack([ds[i] for i in range(N_IMAGES)])


def schedule(quality: int) -> dict:
    """The production policy at `quality`, as the JAX `cli/serve.py`
    `solver_for` picks it for a batch at that bucket: init_t, stride,
    encoder reuse, eta, and the model evaluations that gives."""
    init_t = init_timestep_for_quality(quality, STEPS, get_preset(CODEC))
    pc = production_solver_config(quality, CODEC)
    stride = student_stride(init_t, pc["max_evals"])
    return {"init_t": init_t, "stride": stride, "encoder_reuse": pc["encoder_reuse"],
            "eta": pc["eta"], "evals": len(_solver_indices(init_t, stride))}


_SAMPLERS: dict = {}


def jax_restore(model, params, y, quality: int):
    """The JAX package's restore of the batch `y` at `quality` under the
    production `schedule`, with the surrogate's own last projection (one
    sampler a model, which keeps its compiled solvers)."""
    s = schedule(quality)
    sampler = _SAMPLERS.setdefault(id(model), (model, DDRMSampler(model, get_preset(CODEC))))[1]
    return sampler.sample(
        params, jnp.asarray(y), quality, s["init_t"], stride=s["stride"],
        encoder_reuse=s["encoder_reuse"], eta=s["eta"], final_exact=False)


def make_fixture(model, params, x0: np.ndarray, weights_sha256: str) -> dict:
    """The fixture's arrays for a JAX `model` holding `params` ({'params':
    tree}) on the clean batch `x0`."""
    out = {"x0": x0.astype(np.float32), "qualities": np.asarray(QUALITIES, np.int32),
           "weights_sha256": np.asarray(weights_sha256), "jax_version": np.asarray(jax.__version__),
           "seed": np.asarray(SEED, np.int32)}
    for q in QUALITIES:
        y = codec_surrogate(jnp.asarray(x0), q, codec=CODEC)
        restored = jax_restore(model, params, y, q)
        out[f"y_{q}"] = np.asarray(y, np.float32)
        out[f"restored_{q}"] = np.asarray(restored, np.float32)
        out[f"psnr_y_{q}"] = np.float32(psnr(y, jnp.asarray(x0)))
        out[f"psnr_restored_{q}"] = np.float32(psnr(restored, jnp.asarray(x0)))
        out[f"evals_{q}"] = np.int32(schedule(q)["evals"])
    return out


def release_fixture(weights=WEIGHTS) -> dict:
    """The fixture on the release weights, made anew (minutes on the CPU)."""
    model = build_model(CODEC, MODEL_CFG)
    params = {"params": load_release_params(str(weights))}
    return make_fixture(model, params, clean_images(MODEL_CFG.image_size),
                        file_sha256(str(weights)))


def load_fixture(path=FIXTURE) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    fixture = release_fixture()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **fixture)
    for q in QUALITIES:
        print(f"q{q}: {int(fixture[f'evals_{q}'])} evaluations, PSNR y "
              f"{float(fixture[f'psnr_y_{q}']):.4f} dB, restored "
              f"{float(fixture[f'psnr_restored_{q}']):.4f} dB")
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
