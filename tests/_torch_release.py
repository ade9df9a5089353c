"""The JAX package's restores on the release weights, as fixtures that the
card reads without JAX (`chip_smoke.py` phase `release`), one a release:
`tests/torch_release/<name>_jax.npz` for each name of RELEASES.

    JAX_PLATFORMS=cpu python -m tests._torch_release [NAME ...]   # regenerate

A fixture holds N_IMAGES `natural` synthetic images at 64² (`x0`, the
`SyntheticImageDataset` both packages have, seed SEED) and, for each
(codec, quality) case of its release, the JAX package's `codec_surrogate(x0,
q, codec=...)` (`y_<tag>`), its f32 restore of that input at full width
(`restored_<tag>`; flash attention at <= 32², which on the CPU runs the
package's plain attention) under the production policy as its
`cli/serve.py solver_for` picks it (budget 14, encoder reuse 2, eta 0, the
codec's `protect`) with the surrogate's own last projection
(`final_exact=False`: no host codec, so no libwebp version, enters), the
batch PSNR of each against `x0`, the evaluations per case, and the
weights' sha256 and the JAX version. A release with `spread` also holds how
far the JAX package's own restore moves: the per-image max|diff| of its
restore when the input moves by a seeded 1e-6 (`self_move_<tag>`), the
images where that passes `chip_smoke.RESTORE_MAX_DIFF` (`reference_edges`,
"<tag>/<image>": there the JAX output sits at a rounding edge of the
surrogate, and the card holds those images by PSNR instead), and the PSNR
of its restore in bf16 (`psnr_restored_bf16_<tag>`; the card's bf16
restore is held to the span of JAX's f32 and bf16 PSNRs). The tag of a
case is its quality for a one-codec release (the WebP fixture) and
"<codec>_<quality>" otherwise (the fixture then lists `codecs` beside
`qualities`). Nothing in it is random: the generator is
the code that the tests re-run.

Imports the JAX package (as `tests/_torch_parity.py` does); the port and
`chip_smoke.py` never import this module.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ddpm_image_restoration_tpu.codecs.quality import init_timestep_for_quality
from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate
from ddpm_image_restoration_tpu.config import ModelConfig, codec_index, get_preset
from ddpm_image_restoration_tpu.data.dataset import SyntheticImageDataset
from ddpm_image_restoration_tpu.diffusion.ddrm import DDRMSampler, _solver_indices
from ddpm_image_restoration_tpu.diffusion.policy import production_solver_config
from ddpm_image_restoration_tpu.evaluation.metrics import psnr
from ddpm_image_restoration_tpu.models import build_model
from ddpm_image_restoration_tpu.train.checkpoint import load_release_params
from ddpm_image_restoration_tpu.train.distill import student_stride

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@dataclass(frozen=True)
class Release:
    cases: tuple       # (codec, quality) of each restore
    spread: bool       # record JAX's own move (a 1e-6 input move; bf16)


# each name's model preset is `chip_smoke.RELEASES[name]`
RELEASES = {
    "webp_real_r5": Release((("webp", 10), ("webp", 30), ("webp", 50)), False),
    # the unified model (JPEG architecture + codec_embed); AVIF q70 is inside
    # PRODUCTION_PROTECT's fade (60, 90)
    "all_teacher_r3": Release((*((c, q) for c in ("jpeg", "webp", "avif")
                                 for q in (10, 30, 50)), ("avif", 70)), True),
}
DEFAULT = "webp_real_r5"
WEIGHTS = ROOT / "artifacts_release" / f"{DEFAULT}.npz"
FIXTURE = ROOT / "tests" / "torch_release" / f"{DEFAULT}_jax.npz"
CODEC = "webp"
QUALITIES = (10, 30, 50)
N_IMAGES = 2
SEED = 7
STEPS = 100
MOVE = 1e-6
# The release model as the card serves it, in f32.
MODEL_CFG = ModelConfig(compute_dtype="float32", attention_impl="flash",
                        attn_max_resolution=32)


def weights_path(name: str) -> Path:
    return ROOT / "artifacts_release" / f"{name}.npz"


def fixture_path(name: str) -> Path:
    return ROOT / "tests" / "torch_release" / f"{name}_jax.npz"


def case_tag(release: Release, codec: str, quality: int) -> str:
    """The key suffix of a case in the fixture."""
    return str(quality) if len({c for c, _ in release.cases}) == 1 else f"{codec}_{quality}"


def clean_images(image_size: int = 64) -> np.ndarray:
    """x0: N_IMAGES `natural` images, NHWC in [-1, 1]."""
    ds = SyntheticImageDataset(N_IMAGES, image_size, seed=SEED, kind="natural")
    return np.stack([ds[i] for i in range(N_IMAGES)])


def schedule(quality: int, codec: str = CODEC) -> dict:
    """The production policy at `quality` for `codec`, as the JAX `cli/
    serve.py` `solver_for` picks it for a batch at that bucket: init_t,
    stride, encoder reuse, eta, protect, and the model evaluations that
    gives."""
    init_t = init_timestep_for_quality(quality, STEPS, get_preset(codec))
    pc = production_solver_config(quality, codec)
    stride = student_stride(init_t, pc["max_evals"])
    return {"init_t": init_t, "stride": stride, "encoder_reuse": pc["encoder_reuse"],
            "eta": pc["eta"], "protect": pc.get("protect"),
            "evals": len(_solver_indices(init_t, stride))}


_SAMPLERS: dict = {}


def jax_restore(model, params, y, quality: int, codec: str = CODEC):
    """The JAX package's restore of the batch `y` at `quality`, compressed
    by `codec`, under the production `schedule`, with the surrogate's own
    last projection (one sampler a model and codec, which keeps its compiled
    solvers; a unified model is conditioned on the codec's index)."""
    s = schedule(quality, codec)
    key = (id(model), codec)
    if key not in _SAMPLERS:
        cond = codec_index(codec) if model.cfg.codec_conditioning else None
        _SAMPLERS[key] = model, DDRMSampler(model, get_preset(codec), codec_id=cond)
    return _SAMPLERS[key][1].sample(
        params, jnp.asarray(y), quality, s["init_t"], stride=s["stride"],
        encoder_reuse=s["encoder_reuse"], eta=s["eta"], protect=s["protect"],
        final_exact=False)


def make_fixture(model, params, x0: np.ndarray, weights_sha256: str,
                 release: Release = RELEASES[DEFAULT], bf16_model=None) -> dict:
    """The fixture's arrays for a JAX `model` holding `params` ({'params':
    tree}) on the clean batch `x0`, for the cases of `release`;
    `bf16_model` (the same model in bf16) for a release with `spread`."""
    codecs = [c for c, _ in release.cases]
    out = {"x0": x0.astype(np.float32),
           "qualities": np.asarray([q for _, q in release.cases], np.int32),
           "weights_sha256": np.asarray(weights_sha256), "jax_version": np.asarray(jax.__version__),
           "seed": np.asarray(SEED, np.int32)}
    if len(set(codecs)) > 1:
        out["codecs"] = np.asarray(codecs)
    edges = []
    for codec, q in release.cases:
        tag = case_tag(release, codec, q)
        y = codec_surrogate(jnp.asarray(x0), q, codec=codec)
        restored = np.asarray(jax_restore(model, params, y, q, codec), np.float32)
        out[f"y_{tag}"] = np.asarray(y, np.float32)
        out[f"restored_{tag}"] = restored
        out[f"psnr_y_{tag}"] = np.float32(psnr(y, jnp.asarray(x0)))
        out[f"psnr_restored_{tag}"] = np.float32(psnr(jnp.asarray(restored), jnp.asarray(x0)))
        out[f"evals_{tag}"] = np.int32(schedule(q, codec)["evals"])
        if release.spread:
            sign = np.random.default_rng(SEED).choice(np.float32([-1, 1]), size=y.shape)
            moved = np.asarray(jax_restore(model, params, np.asarray(y) + MOVE * sign, q, codec))
            move = np.abs(moved - restored).reshape(len(x0), -1).max(axis=1).astype(np.float32)
            out[f"self_move_{tag}"] = move
            edges += [f"{tag}/{i}" for i in np.flatnonzero(move > chip_smoke.RESTORE_MAX_DIFF)]
            low = jnp.asarray(jax_restore(bf16_model, params, y, q, codec), jnp.float32)
            out[f"psnr_restored_bf16_{tag}"] = np.float32(psnr(low, jnp.asarray(x0)))
    if release.spread:
        out["reference_edges"] = np.asarray(edges, dtype=str).reshape(-1)
    return out


def release_fixture(name: str = DEFAULT) -> dict:
    """The fixture of release `name` made anew (minutes on the CPU)."""
    release, preset = RELEASES[name], chip_smoke.RELEASES[name]
    model = build_model(preset, MODEL_CFG)
    bf16 = build_model(preset, dataclasses.replace(MODEL_CFG, compute_dtype="bfloat16"))
    params = {"params": load_release_params(str(weights_path(name)))}
    return make_fixture(model, params, clean_images(MODEL_CFG.image_size),
                        chip_smoke.file_sha256(str(weights_path(name))), release, bf16)


def load_fixture(path=FIXTURE) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def main(names=None) -> None:
    jax.config.update("jax_platforms", "cpu")
    for name in names or RELEASES:
        fixture, release, path = release_fixture(name), RELEASES[name], fixture_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, **fixture)
        for codec, q in release.cases:
            tag = case_tag(release, codec, q)
            move = (f", JAX's own move {fixture[f'self_move_{tag}']}, in bf16 "
                    f"{float(fixture[f'psnr_restored_bf16_{tag}']):.4f} dB" if release.spread
                    else "")
            print(f"{name} {codec} q{q}: {int(fixture[f'evals_{tag}'])} evaluations, PSNR y "
                  f"{float(fixture[f'psnr_y_{tag}']):.4f} dB, restored "
                  f"{float(fixture[f'psnr_restored_{tag}']):.4f} dB{move}")
        if release.spread:
            print(f"{name}: reference edges {list(fixture['reference_edges'])}")
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
