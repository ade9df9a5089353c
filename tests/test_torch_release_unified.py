"""Every release npz in the port, and the unified multi-codec release
(`artifacts_release/all_teacher_r3.npz`, the `all` preset: the JPEG
architecture plus `codec_embed`) with the JAX package's own JPEG, WebP and
AVIF restores on it (`tests/torch_release/all_teacher_r3_jax.npz`, written
by `tests/_torch_release.py`), which `chip_smoke.py --release
all_teacher_r3` holds the card to: each npz loaded strictly into the model
of its preset, the unified fixture's provenance, the refusals of the
`--release` argument, phase `release` on the unified model rehearsed at
width/16 on the CPU on a fixture made from the JAX package on the fly, and
(slow) the fixture made anew and the port's full-width f32 restore of every
case on the CPU against it.

Costs on one CPU thread (this machine): the four strict loads ~5 s each,
the provenance ~3 s, the refusals < 1 s, the rehearsal ~60-90 s (the JAX
restores of its fixture included); the slow test ~10 minutes."""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ddpm_image_restoration_tpu.train.checkpoint import (  # noqa: E402
    load_release_params as jax_load_release_params,
)
from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate  # noqa: E402
from ddpm_image_restoration_tpu_torch.config import ModelConfig  # noqa: E402
from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset  # noqa: E402
from ddpm_image_restoration_tpu_torch.models import build_model  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ddpm_image_restoration_tpu_torch.train.checkpoint import (  # noqa: E402
    export_release_params,
    load_release_params,
)
from tests import _torch_release as rel  # noqa: E402
from tests._torch_parity import model_pair  # noqa: E402
# the wrappers counted as on the card, on the CPU (a fixture)
from tests.test_torch_path1024_phase import cpu_launches  # noqa: E402,F401
from tests.test_torch_release import OUT_SCALE  # noqa: E402

torch.set_num_threads(1)

UNIFIED = "all_teacher_r3"
# release name -> (the preset of its model, its tensors)
NPZ = {"all_teacher_r3": ("all", 335), "webp_real_r4": ("webp", 334),
       "webp_real_r5": ("webp", 334), "webp_teacher_r3": ("webp", 334)}
FWD_ONLY = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


@pytest.mark.parametrize("name", sorted(NPZ))
def test_release_npz_loads_strictly(name):
    """Each `artifacts_release/*.npz` into the port's full-width model of its
    preset, strict: every tensor of the model and no other, at its shape;
    `codec_embed` present exactly in the unified one (114,365,897
    parameters)."""
    npz = ROOT / "artifacts_release" / f"{name}.npz"
    if not npz.exists():
        pytest.skip(f"artifacts_release/{name}.npz is not in this checkout")
    preset, n_tensors = NPZ[name]
    params = load_release_params(str(npz))
    assert len(params) == n_tensors
    assert any(k.startswith("codec_embed.") for k in params) == (preset == "all")
    model = build_model(preset, ModelConfig(compute_dtype="float32", attention_impl="flash",
                                            attn_max_resolution=32), device="cpu")
    model.load_state_dict(params, strict=True)
    if preset == "all":
        assert sum(p.numel() for p in model.parameters()) == 114_365_897


@pytest.fixture(scope="module")
def unified():
    return rel.load_fixture(rel.fixture_path(UNIFIED))


def test_unified_fixture_provenance(unified):
    """The unified fixture was made from the tracked npz (sha256), from the
    `natural` images the port's dataset remakes bit for bit, and from the
    jitted JAX surrogate's outputs, which the port's surrogate remakes
    within 1e-6 at every case (AVIF q70 differed by 0.023 before the
    port's quant tables rounded as the compiled JAX function does); its
    cases are the release's, its evaluation counts the production
    schedule's; each case records JAX's own move for a 1e-6 input move,
    and the images where that passes RESTORE_MAX_DIFF are few and named in
    `reference_edges`, and the PSNR of JAX's own bf16 restore; it stays
    under 2 MiB."""
    fixture = unified
    npz, fixture_file = (ROOT / p for p in chip_smoke.release_files(UNIFIED))
    assert chip_smoke.file_sha256(str(npz)) == str(fixture["weights_sha256"])
    ds = SyntheticImageDataset(rel.N_IMAGES, 64, seed=int(fixture["seed"]), kind="natural")
    np.testing.assert_array_equal(np.stack([ds[i] for i in range(rel.N_IMAGES)]), fixture["x0"])
    cases = chip_smoke.fixture_cases(fixture)
    assert [(c, q) for c, q, _ in cases] == list(rel.RELEASES[UNIFIED].cases)
    edges, quiet = [], []
    for codec, q, tag in cases:
        y = codec_surrogate(torch.from_numpy(fixture["x0"]), q, codec=codec).numpy()
        np.testing.assert_allclose(y, fixture[f"y_{tag}"], rtol=0, atol=1e-6, err_msg=tag)
        assert int(fixture[f"evals_{tag}"]) == chip_smoke.static_schedule(q, codec)[0]
        assert fixture[f"restored_{tag}"].shape == fixture["x0"].shape
        assert np.isfinite(fixture[f"restored_{tag}"]).all()
        move = fixture[f"self_move_{tag}"]
        assert move.shape == (rel.N_IMAGES,) and np.isfinite(move).all()
        assert np.isfinite(fixture[f"psnr_restored_bf16_{tag}"])
        edges += [f"{tag}/{i}" for i in np.flatnonzero(move > chip_smoke.RESTORE_MAX_DIFF)]
        quiet += list(move[move <= chip_smoke.RESTORE_MAX_DIFF])
    assert list(fixture["reference_edges"]) == edges
    assert 0 < len(edges) <= 2, edges
    assert max(quiet) < 1e-4
    assert fixture_file.stat().st_size < 2 * 2 ** 20


def test_bf16_rule_spans_the_jax_restores(unified):
    """The bf16 PSNR rule on the unified fixture's own numbers: a PSNR
    between the JAX package's f32 and bf16 restores' passes, one farther
    than RELEASE_PSNR_DB beyond either fails. The span is there because the
    JAX package's own bf16 restore lies farther than RELEASE_PSNR_DB from
    its f32 one in some case (0.23 dB at AVIF q30 on the CPU)."""
    near = chip_smoke.RELEASE_PSNR_DB
    gaps = []
    for _, _, tag in chip_smoke.fixture_cases(unified):
        f32, bf16 = (float(unified[k]) for k in (f"psnr_restored_{tag}",
                                                 f"psnr_restored_bf16_{tag}"))
        gaps.append(abs(f32 - bf16))

        def rule(got_db, tag=tag):
            return chip_smoke.release_psnr_failures("bf16", unified, tag, got_db,
                                                    float(unified[f"psnr_y_{tag}"]), near_db=near)

        assert rule(f32) == rule(bf16) == rule((f32 + bf16) / 2) == []
        assert rule(min(f32, bf16) - near - 0.01) and rule(max(f32, bf16) + near + 0.01)
    assert max(gaps) > near


def test_release_argument_refusals(tmp_path, monkeypatch, capsys):
    """`chip_smoke.py --release NAME` refuses, with exit code 2 and a
    message before any device work, when the copy lacks the named npz or
    its fixture, when it holds a second release npz, or when the name is
    unknown; a copy holding the npz and its fixture alone passes on to the
    CUDA check (which refuses here). Without `--release` a second npz is no
    refusal: a checkout holds all four."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(sys, "path", list(sys.path))
    (tmp_path / chip_smoke.PACKAGE).mkdir()
    (tmp_path / "artifacts_release").mkdir()
    npz, fixture = (tmp_path / p for p in chip_smoke.release_files(UNIFIED))

    def run(*argv) -> str:
        monkeypatch.setattr(sys, "argv", ["chip_smoke.py", *argv])
        assert chip_smoke.main() == 2
        return capsys.readouterr().err

    assert f"{UNIFIED}.npz is not in this copy" in run("--release", UNIFIED)
    np.savez(npz, **{"out_conv/bias": np.zeros(3, np.float16)})
    assert f"{UNIFIED}_jax.npz is not in this copy" in run("--release", UNIFIED)
    fixture.parent.mkdir(parents=True)
    fixture.write_bytes(b"fixture")
    second = tmp_path / chip_smoke.RELEASE_NPZ
    shutil.copy(npz, second)
    assert f"holds webp_real_r5.npz beside {UNIFIED}.npz" in run("--release", UNIFIED)
    assert "torch.cuda.is_available() is False" in run()
    second.unlink()
    assert chip_smoke.release_refusal(UNIFIED, str(tmp_path)) is None
    assert "torch.cuda.is_available() is False" in run("--release", UNIFIED)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--release", "webp_real_r9"])
    with pytest.raises(SystemExit) as refused:
        chip_smoke.main()
    assert refused.value.code == 2
    assert "invalid choice: 'webp_real_r9'" in capsys.readouterr().err


@pytest.fixture(scope="module")
def narrow_unified(tmp_path_factory):
    """(port model, fixture, root): the unified model at width/16 with
    `model_pair`'s seeded weights, its output layer scaled by OUT_SCALE
    (tests/test_torch_release.py `narrow` says why), in both packages; the
    fixture the generator makes from the JAX package's restores on them at
    one case a codec (JPEG q10, WebP q30, AVIF q70 inside the protection
    fade), with WebP q30's image 1 named a reference edge, as the release
    fixture names JPEG q30's; and a directory holding those weights and
    that fixture where chip_smoke.py reads the unified ones."""
    root = tmp_path_factory.mktemp("unified")
    npz_rel, fixture_rel = chip_smoke.release_files(UNIFIED)
    npz = root / npz_rel
    npz.parent.mkdir()
    jm, _, tm = model_pair("all", rel.MODEL_CFG.scaled(16), npz)
    with torch.no_grad():
        tm.out_conv.weight.mul_(OUT_SCALE)
        tm.out_conv.bias.mul_(OUT_SCALE)
    export_release_params(tm, str(npz), codec="all")
    tm.load_state_dict(load_release_params(str(npz)), strict=True)
    jv = {"params": jax_load_release_params(str(npz))}
    release = rel.Release((("jpeg", 10), ("webp", 30), ("avif", 70)), False)
    fixture = rel.make_fixture(jm, jv, rel.clean_images(), chip_smoke.file_sha256(str(npz)),
                               release)
    fixture["self_move_webp_30"] = np.float32([0.0, 2 * chip_smoke.RESTORE_MAX_DIFF])
    fixture["reference_edges"] = np.asarray(["webp_30/1"])
    (root / fixture_rel).parent.mkdir(parents=True)
    np.savez_compressed(root / fixture_rel, **fixture)
    return tm.eval(), fixture, root


def test_unified_release_phase_on_cpu_width16(narrow_unified, cpu_launches, monkeypatch,
                                              capsys):
    """Phase `release` under `--release all_teacher_r3` at width/16 on the
    CPU, in a copy that holds `narrow_unified`'s weights and fixture where
    the unified ones lie: the load and its sha256, each case's f32 restore
    held to the JAX package's (the named edge image by PSNR, the other
    element by element) and its bf16 restore by PSNR, n + g forward
    launches each, then the restore CLI on a JPEG, a WebP and an AVIF, the
    server on a directory of the three (three codec-pure batches, counted)
    and the evaluator on JPEG, all with `--model-codec all --codec auto`,
    each run's launches against its schedule (the phase fails otherwise).
    The evaluator on 8 images and the server's batches of 2 (the fixture's
    two images a codec) to keep it short; the CLIs' files at the fixture's
    cases."""
    tm, fixture, root = narrow_unified
    monkeypatch.setattr(chip_smoke, "ROOT", str(root))
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "RELEASE_SCALE", 16)
    monkeypatch.setattr(chip_smoke, "RELEASE_EVAL_IMAGES", 8)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    # the CLIs' files at the cases this fixture holds
    monkeypatch.setattr(chip_smoke, "UNIFIED_RESTORE_FILES",
                        (("jpeg", 0, 10), ("webp", 1, 30), ("avif", 0, 70)))
    monkeypatch.setattr(chip_smoke, "UNIFIED_SERVE_FILES", {"jpeg": 10, "webp": 30, "avif": 70})
    for name in ("RESTORE_FLAGS", "CARD_FLAGS"):
        flags = getattr(chip_smoke, name)
        monkeypatch.setattr(chip_smoke, name, ["--device", "cpu", "--width-scale", "16",
                                               *flags[2:]])
    state = {"smi": "CPU", "pil": True, "release": UNIFIED}
    chip_smoke.phase_release(state)
    log = capsys.readouterr().out
    assert log.count("f32 restore against the JAX package's") == 3, log
    assert "webp q30 image 1: a reference edge" in log, log
    assert log.count(f"[--params-npz artifacts_release/{UNIFIED}.npz]") == 3, log
    assert "serve --once --codec auto --model-codec all [--params-npz" in log, log
    assert "; 3 batches;" in log, log
    schedules = [chip_smoke.static_schedule(q, c) for c, q, _ in chip_smoke.fixture_cases(fixture)]
    totals = state["launches_release"]
    assert totals[fa.KERNEL] > 2 * sum(n + g for n, g in schedules)
    assert [totals[k] for k in FWD_ONLY] == [0, 0]
    assert set(state["release_params"]) == set(tm.state_dict())
    assert not (root / "build" / "chip_smoke_release").exists()


@pytest.mark.slow
def test_unified_fixture_regenerates_and_full_width_port_meets_card_bounds(unified,
                                                                           cpu_launches):
    """The unified fixture made anew from the JAX package equals the
    committed one within 1e-6, and the port's f32 restore at full width on
    the CPU meets the card's bounds against it at every case (the phase's
    own loading and checks; the reference edges by PSNR)."""
    fresh = rel.release_fixture(UNIFIED)
    assert set(fresh) == set(unified)
    for key, value in unified.items():
        if value.dtype.kind == "f":
            np.testing.assert_allclose(fresh[key], value, rtol=0, atol=1e-6, err_msg=key)
        elif key != "jax_version":
            np.testing.assert_array_equal(fresh[key], value, err_msg=key)
    state = {"release": UNIFIED}
    chip_smoke.load_release(state)
    model = chip_smoke.release_model(state, "float32", "cpu")
    totals = dict.fromkeys(chip_smoke._counts(), 0)
    _, failures = chip_smoke.release_restores(model, unified, "cpu", totals)
    assert failures == []
