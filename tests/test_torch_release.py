"""The release WebP weights (`artifacts_release/webp_real_r5.npz`) and the
JAX package's own restores on them (`tests/torch_release/webp_real_r5_jax.npz`,
written by `tests/_torch_release.py`), which chip_smoke.py's phase `release`
holds the card to: the fixture's provenance, the copy of the tree sent to
the card that carries both, the phase's comparison rehearsed on the CPU at
width/16 on a fixture made from the JAX package on the fly, the refusal of
a copy without the weights, and (slow) the fixture made anew and the port's full-width f32
restore on the CPU against it."""

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
from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ddpm_image_restoration_tpu_torch.train.checkpoint import (  # noqa: E402
    export_release_params,
    load_release_params,
)
from tests import _torch_release as rel  # noqa: E402
from tests._torch_parity import model_pair  # noqa: E402
# the wrappers counted as on the card, on the CPU (a fixture)
from tests.test_torch_path1024_phase import cpu_launches  # noqa: E402,F401

torch.set_num_threads(1)

# A copy of the tree for the card is refused over 256 MiB; this leaves room
# for the tree to grow.
COPY_LIMIT_BYTES = 240 * 2 ** 20
FWD_ONLY = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# The width/16 model's output layer is scaled by this (`narrow`).
OUT_SCALE = 0.05


@pytest.fixture(scope="module")
def fixture():
    return rel.load_fixture()


def test_fixture_provenance(fixture):
    """The fixture was made from the tracked npz (sha256), from the
    `natural` images the port's dataset remakes bit for bit, and from the
    surrogate's outputs the port's surrogate remakes within 1e-6 (q10, q30
    and q50 are none of the jit rounding-edge qualities); its evaluation
    counts are the production schedule's; it stays under 1 MB."""
    assert chip_smoke.file_sha256(str(ROOT / chip_smoke.RELEASE_NPZ)) == \
        str(fixture["weights_sha256"])
    ds = SyntheticImageDataset(rel.N_IMAGES, 64, seed=int(fixture["seed"]), kind="natural")
    np.testing.assert_array_equal(np.stack([ds[i] for i in range(rel.N_IMAGES)]), fixture["x0"])
    assert tuple(fixture["qualities"]) == rel.QUALITIES
    for q in rel.QUALITIES:
        y = codec_surrogate(torch.from_numpy(fixture["x0"]), q, codec="webp").numpy()
        np.testing.assert_allclose(y, fixture[f"y_{q}"], rtol=0, atol=1e-6)
        assert int(fixture[f"evals_{q}"]) == chip_smoke.static_schedule(q, "webp")[0]
        assert fixture[f"restored_{q}"].shape == fixture["x0"].shape
        assert np.isfinite(fixture[f"restored_{q}"]).all()
    assert (ROOT / chip_smoke.RELEASE_FIXTURE).stat().st_size < 2 ** 20


def test_card_copy_holds_one_npz_and_fits():
    """The tree as copied to the card (`.chiprunignore`, no pattern ending
    in '/', which the copy does not honour) holds the release npz and its
    fixture, none of the other three npz and no `results/`, and stays under
    COPY_LIMIT_BYTES."""
    assert not [p for p in (ROOT / ".chiprunignore").read_text().split() if p.endswith("/")]
    files = dict(chip_smoke.copy_files(str(ROOT)))
    total = sum(files.values())
    assert chip_smoke.RELEASE_NPZ in files and chip_smoke.RELEASE_FIXTURE in files
    assert not [f for f in files if f.startswith("results/") or f.endswith(
        ("all_teacher_r3.npz", "webp_real_r4.npz", "webp_teacher_r3.npz"))]
    assert total <= COPY_LIMIT_BYTES, f"the copy for the card is {total / 2 ** 20:.1f} MiB"


def test_copy_files_reads_the_ignore_rules(tmp_path):
    """`copy_files` reads `.chiprunignore` as its docstring says: a bare
    name at any depth, a slash for a path from the root, comments, and a
    trailing '/' matching nothing (as the copy reads it); `.git/` and
    `chiprun_out/` always left out."""
    for rel_path in ("keep.py", "results/a.png", "sub/results/b.png", "sub/results.txt",
                     "artifacts_release/webp_real_r4.npz", "artifacts_release/webp_real_r5.npz",
                     "copy/artifacts_release/webp_real_r4.npz", "build/x.so", "only/here.txt",
                     "deep/only/here.txt", ".git/HEAD", "chiprun_out/log"):
        (tmp_path / rel_path).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel_path).write_bytes(b"x" * 3)
    (tmp_path / ".chiprunignore").write_text(
        "# a comment\nresults\nartifacts_release/webp_real_r4.npz\nbuild/\n/only/here.txt\n")
    got = dict(chip_smoke.copy_files(str(tmp_path)))
    assert sorted(got) == [".chiprunignore", "artifacts_release/webp_real_r5.npz", "build/x.so",
                           "copy/artifacts_release/webp_real_r4.npz", "deep/only/here.txt",
                           "keep.py", "sub/results.txt"]
    assert got["keep.py"] == 3
    assert len(dict(chip_smoke.copy_files(str(tmp_path), None))) == 11


def test_release_and_serve_refuse_a_copy_without_the_npz(tmp_path, monkeypatch, fixture):
    """Phases `release` and `serve` run on the release weights only: a copy
    without the npz (or without its fixture) fails `release`, `serve` fails
    without the weights `release` loads, and an npz that is not the
    fixture's is refused; all before any device work."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    state = {"smi": "CPU", "pil": True}
    with pytest.raises(FileNotFoundError, match="webp_real_r5.npz is not in this copy"):
        chip_smoke.phase_release(state)
    with pytest.raises(AssertionError, match="no release weights"):
        chip_smoke.phase_serve(state)
    (tmp_path / "tests" / "torch_release").mkdir(parents=True)
    shutil.copy(ROOT / chip_smoke.RELEASE_FIXTURE, tmp_path / chip_smoke.RELEASE_FIXTURE)
    with pytest.raises(FileNotFoundError, match="webp_real_r5.npz is not in this copy"):
        chip_smoke.phase_release(state)
    (tmp_path / "artifacts_release").mkdir()
    np.savez(tmp_path / chip_smoke.RELEASE_NPZ, **{"out_conv/bias": np.zeros(3, np.float16)})
    with pytest.raises(AssertionError, match="not the file the fixture was made from"):
        chip_smoke.phase_release(state)
    assert "release_params" not in state


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """(port model, fixture, {q: the JAX restore of y_q + 1e-6}, root): the
    WebP model at width/16 with `model_pair`'s seeded weights, its output
    layer scaled by OUT_SCALE, in both packages; the fixture the generator
    makes from the JAX package's restores on them; the JAX package's own
    restores of inputs moved by 1e-6; and a directory holding those weights
    and that fixture where chip_smoke.py reads the release ones.

    Why the scale: trained weights keep the prediction x̂ near y, whose DCT
    coefficients the surrogate's rounding leaves at the middle of their
    steps, so a last-bit difference between two implementations moves
    nothing (on the release weights at full width the packages agree within
    3e-6: the slow test below). Random weights put x̂'s coefficients
    anywhere, and one that lands on a rounding edge moves a whole block by a
    step: at width/16 over model seeds 0-8 the packages differed by
    0.05-0.95 at some quality at seven seeds of nine, and the port at 1
    and 4 threads by 0.6 at seed 8, q30 (ROADMAP Queue 3). A small x̂ keeps
    the coefficients near 0, a middle: then the packages agree within 1e-6
    at seeds 0, 1 and 8 at every quality, at 1 and 4 threads, and the model
    still moves the restore's PSNR by 0.3-0.6 dB."""
    root = tmp_path_factory.mktemp("release")
    npz = root / chip_smoke.RELEASE_NPZ
    npz.parent.mkdir()
    jm, _, tm = model_pair("webp", rel.MODEL_CFG.scaled(16), npz)
    with torch.no_grad():
        tm.out_conv.weight.mul_(OUT_SCALE)
        tm.out_conv.bias.mul_(OUT_SCALE)
    export_release_params(tm, str(npz), codec="webp")
    tm.load_state_dict(load_release_params(str(npz)), strict=True)
    jv = {"params": jax_load_release_params(str(npz))}
    fixture = rel.make_fixture(jm, jv, rel.clean_images(), chip_smoke.file_sha256(str(npz)))
    moved = {q: np.asarray(rel.jax_restore(jm, jv, fixture[f"y_{q}"] + 1e-6, q))
             for q in rel.QUALITIES}
    (root / chip_smoke.RELEASE_FIXTURE).parent.mkdir(parents=True)
    np.savez_compressed(root / chip_smoke.RELEASE_FIXTURE, **fixture)
    return tm.eval(), fixture, moved, root


def test_release_restores_on_cpu_width16(narrow, cpu_launches):
    """The phase's f32 comparison at width/16 on the CPU: each quality's
    restore through the serve core within the card bounds of the JAX
    package's, n + g forward launches and no backward one, the PSNRs the
    fixture's (keyed by the fixture's case tag, the quality here); a
    restore with one element moved past the max bound, one moved past the
    mean bound, or a launch short of the schedule fails, and an image left
    to PSNR (a reference edge) drops out of the bounds."""
    tm, fixture, moved, _ = narrow
    for q in rel.QUALITIES:  # the JAX package's own output is stable here
        line, bad = chip_smoke.release_compare(q, moved[q], fixture[f"restored_{q}"], 0, 0, 0)
        assert bad == [], line
    totals = dict.fromkeys(chip_smoke._counts(), 0)
    psnrs, failures = chip_smoke.release_restores(tm, fixture, "cpu", totals)
    assert failures == []
    schedules = {q: chip_smoke.static_schedule(q, "webp") for q in rel.QUALITIES}
    assert totals == {fa.KERNEL: sum(n + g for n, g in schedules.values()),
                      **dict.fromkeys(FWD_ONLY, 0)}
    for q in rel.QUALITIES:
        assert psnrs[str(q)] == pytest.approx(float(fixture[f"psnr_restored_{q}"]), abs=1e-3)

    want = fixture["restored_30"]
    n, g = schedules[30]
    assert chip_smoke.release_compare(30, want.copy(), want, n + g, n, g)[1] == []
    moved = want.copy()
    moved.flat[17] += 1.5 * chip_smoke.RESTORE_MAX_DIFF
    assert "disagrees" in " ".join(chip_smoke.release_compare(30, moved, want, n + g, n, g)[1])
    shifted = want + 1.5 * chip_smoke.RESTORE_MEAN_DIFF
    assert "disagrees" in " ".join(chip_smoke.release_compare(30, shifted, want, n + g, n, g)[1])
    assert "forward launches" in " ".join(
        chip_smoke.release_compare(30, want, want, n + g - 1, n, g)[1])
    image0 = want.copy()
    image0[0] += 1.5 * chip_smoke.RESTORE_MAX_DIFF
    assert chip_smoke.release_compare(30, image0, want, n + g, n, g, by_psnr=[0])[1] == []


def test_release_phase_on_cpu_width16(narrow, cpu_launches, monkeypatch, capsys):
    """The whole phase at width/16 on the CPU, in a copy that holds
    `narrow`'s weights and fixture where the release ones lie: the load and
    its sha256, the f32 and bf16 restores, then the restore, serve,
    evaluate and Gaussian-mixture restore CLIs on `--params-npz`, each
    run's launches against its schedule (the phase fails otherwise), its
    work directory removed. The evaluator on 8 images (one batch) and a
    72x100 image in tiles (one tile batch) to keep it short."""
    root = narrow[3]
    monkeypatch.setattr(chip_smoke, "ROOT", str(root))
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "RELEASE_SCALE", 16)
    monkeypatch.setattr(chip_smoke, "RELEASE_EVAL_IMAGES", 8)
    monkeypatch.setattr(chip_smoke, "TILE_SIZE_HW", (72, 100))
    for name in ("RESTORE_FLAGS", "CARD_FLAGS"):
        flags = getattr(chip_smoke, name)
        monkeypatch.setattr(chip_smoke, name, ["--device", "cpu", "--width-scale", "16",
                                               *flags[2:]])
    state = {"smi": "CPU", "pil": True}
    chip_smoke.phase_release(state)
    log = capsys.readouterr().out
    assert log.count("f32 restore against the JAX package's") == 3, log
    assert log.count("[--params-npz artifacts_release/webp_real_r5.npz]") == 5, log
    assert "restore --solver gaussian_mixture --quality 30 [--params-npz" in log, log
    schedules = [chip_smoke.static_schedule(q, "webp") for q in rel.QUALITIES]
    totals = state["launches_release"]
    assert totals[fa.KERNEL] > 2 * sum(n + g for n, g in schedules)
    assert [totals[k] for k in FWD_ONLY] == [0, 0]
    assert set(state["release_params"]) == set(narrow[0].state_dict())
    assert not (root / "build" / "chip_smoke_release").exists()


def test_release_psnr_rules(fixture):
    """The PSNR rules on the release fixture's own numbers: the gain rule
    binds only where the JAX restore gained RELEASE_GAIN_DB or more, and a
    PSNR farther than RELEASE_PSNR_DB from the JAX restore's fails."""
    for q in rel.QUALITIES:
        ref, base = float(fixture[f"psnr_restored_{q}"]), float(fixture[f"psnr_y_{q}"])
        assert chip_smoke.release_psnr_failures("bf16", fixture, q, ref, base,
                                                near_db=chip_smoke.RELEASE_PSNR_DB) == []
        far = chip_smoke.release_psnr_failures("bf16", fixture, q, ref - 0.11, base,
                                               near_db=chip_smoke.RELEASE_PSNR_DB)
        assert any("dB apart" in f for f in far)
        binds = chip_smoke.fixture_gain(fixture, q) >= chip_smoke.RELEASE_GAIN_DB
        lost = chip_smoke.release_psnr_failures("cli", fixture, q, base - 0.5, base)
        assert bool(lost) == binds


@pytest.mark.slow
def test_release_fixture_regenerates_and_full_width_port_meets_card_bounds(fixture, cpu_launches):
    """The fixture made anew from the JAX package equals the committed one
    within 1e-6, and the port's f32 restore at full width on the CPU meets
    the card's bounds against it (the phase's own loading and checks)."""
    fresh = rel.release_fixture()
    assert set(fresh) == set(fixture)
    for key, value in fixture.items():
        if value.dtype.kind == "f":
            np.testing.assert_allclose(fresh[key], value, rtol=0, atol=1e-6, err_msg=key)
        elif key != "jax_version":
            np.testing.assert_array_equal(fresh[key], value, err_msg=key)
    state = {}
    chip_smoke.load_release(state)
    model = chip_smoke.release_model(state, "float32", "cpu")
    totals = dict.fromkeys(chip_smoke._counts(), 0)
    _, failures = chip_smoke.release_restores(model, fixture, "cpu", totals)
    assert failures == []
