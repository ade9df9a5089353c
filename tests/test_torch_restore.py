"""The port's restore path against the JAX package's on the same npz
weights (CPU): the dihedral self-ensemble, and `cli/restore.py main` of
both packages on the same image files, flag for flag; a restore from the
port's own training checkpoint; and the flags the port refuses."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ddpm_image_restoration_tpu import config as jconfig
from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate as jax_surrogate
from ddpm_image_restoration_tpu.config import ModelConfig
from ddpm_image_restoration_tpu.config import get_preset as jax_preset
from ddpm_image_restoration_tpu.diffusion import ddrm as jddrm
from ddpm_image_restoration_tpu.diffusion import ensemble as jensemble
from ddpm_image_restoration_tpu_torch import config as tconfig
from ddpm_image_restoration_tpu_torch.config import get_preset
from ddpm_image_restoration_tpu_torch.diffusion import ddrm, ensemble
from tests._tiny import MINI
from tests._torch_parity import model_pair, smooth_images

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY_FLAGS = ["--image-size", "32", "--width-scale", "8", "--compute-dtype", "float32",
              "--attn", "flash", "--attn-max-res", "32"]
TINY_CFG = ModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                       attn_max_resolution=32).scaled(8)


def test_dihedral_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    xr = np.random.default_rng(1).normal(size=(2, 8, 12, 3)).astype(np.float32)
    for k in range(8):
        got = ensemble.dihedral(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jensemble.dihedral(jnp.asarray(x), k)))
        np.testing.assert_array_equal(ensemble.dihedral_inverse(got, k).numpy(), x)
        np.testing.assert_array_equal(
            ensemble.dihedral_inverse(torch.from_numpy(x), k).numpy(),
            np.asarray(jensemble.dihedral_inverse(jnp.asarray(x), k)))
        if k < 4:  # flips keep a rectangle's shape
            np.testing.assert_array_equal(
                ensemble.dihedral(torch.from_numpy(xr), k).numpy(),
                np.asarray(jensemble.dihedral(jnp.asarray(xr), k)))
    for k in (4, 7):
        with pytest.raises(ValueError):
            ensemble.dihedral(torch.from_numpy(xr), k)
    with pytest.raises(ValueError):
        ensemble.dihedral(torch.from_numpy(x), 8)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    jm, jv, tm = model_pair("webp", MINI, tmp_path_factory.mktemp("w") / "mini.npz", seed=1)
    y = np.array(jax_surrogate(jnp.asarray(smooth_images(2, 16, seed=4)), 30, codec="webp"))
    return jm, jv, tm, y


@pytest.mark.parametrize("n", [2, 8])
def test_sample_ensemble_matches_jax(mini, n):
    """n dihedral variants of a q30 restore (steps 20, stride 5, encoder
    reuse 2, exact final projection), averaged; atol 1e-4."""
    jm, jv, tm, y = mini
    kw = dict(eta=0.0, stride=5, encoder_reuse=2, final_exact=True)
    want = jensemble.sample_ensemble(jddrm.DDRMSampler(jm, jax_preset("webp")), jv,
                                     jnp.asarray(y), 30, 20, n_transforms=n, **kw)
    got = ensemble.sample_ensemble(ddrm.DDRMSampler(tm, get_preset("webp")),
                                   torch.from_numpy(y), 30, 20, n_transforms=n, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError):
        ensemble.sample_ensemble(None, torch.from_numpy(y), 30, 20, n_transforms=3)


@pytest.fixture
def eta0(monkeypatch):
    """Every preset at eta 0 in both packages. The restore CLI runs the
    preset's eta (0.85) with noise from each package's own generator, and a
    torch.Generator cannot draw JAX's threefry stream; at eta 0 (the
    production policy's) the two solvers are deterministic and comparable."""
    for mod in (jconfig, tconfig):
        for name, preset in list(mod._PRESETS.items()):
            monkeypatch.setitem(mod._PRESETS, name, dataclasses.replace(preset, eta=0.0))


def _write(path: Path, x: np.ndarray, **save_kw):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(((x * 0.5 + 0.5) * 255).round().astype(np.uint8)).save(path, **save_kw)
    return str(path)


def _inputs(d: Path) -> dict:
    imgs = smooth_images(4, 32, seed=5)
    big = smooth_images(1, 48, seed=8)[0][:40]  # 40 high, 48 wide
    return {
        "png": [_write(d / f"im{i}.png", imgs[i]) for i in range(2)],
        "webp": [_write(d / "w10.webp", imgs[0], quality=10),
                 _write(d / "w50.webp", imgs[1], quality=50)],
        "jpeg": [_write(d / "j30.jpg", imgs[2], quality=30)],
        "avif": [_write(d / "a20.avif", imgs[2], quality=20),
                 _write(d / "a60.avif", imgs[3], quality=60)],
        "big": [_write(d / "big.png", big)],
    }


def _assert_pngs_close(a_dir: Path, b_dir: Path, names):
    """The CLI bound: at most one 8-bit step, on fewer than 1% of pixels
    (an f32 difference can cross a rounding edge)."""
    for name in names:
        ia, ib = (np.asarray(Image.open(d / name), np.int16) for d in (a_dir, b_dir))
        assert ia.shape == ib.shape
        assert np.abs(ia - ib).max() <= 1 and np.mean(ia != ib) < 0.01, name


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    model_pair("webp", TINY_CFG, d / "webp.npz", seed=2)
    model_pair("all", TINY_CFG, d / "all.npz", seed=3)
    model_pair("avif", TINY_CFG, d / "avif.npz", seed=4)
    return d


RESTORE_CASES = {
    "fixed_q30": ("png", ["--quality", "30", "--max-evals", "14", "--encoder-reuse", "2"]),
    "quality_auto": ("webp", ["--quality", "auto", "--max-evals", "6", "--encoder-reuse", "2"]),
    "codec_auto_unified": ("webp+jpeg", ["--model-codec", "all", "--codec", "auto",
                                         "--quality", "auto", "--max-evals", "6",
                                         "--encoder-reuse", "2"]),
    "tile": ("big", ["--quality", "30", "--max-evals", "4", "--size-mode", "tile",
                     "--tile-overlap", "16", "--tile-batch", "4"]),
    "ensemble_protect": ("png", ["--quality", "30", "--max-evals", "6", "--ensemble", "2",
                                 "--protect", "40", "90", "--protect-adaptive", "0.5"]),
    "decoder_reuse": ("png", ["--quality", "10", "--max-evals", "6", "--encoder-reuse", "2",
                              "--decoder-reuse-depth", "1"]),
    # a model of the avif preset on AVIF files at their exact estimated
    # qualities (one file at a time), the AVIF sampler constants
    "avif_model": ("avif", ["--codec", "avif", "--quality", "auto", "--max-evals", "6",
                            "--encoder-reuse", "2"]),
    # the exact host codec each step (the JAX package's callback inside its
    # scan; the port's eager loop), no final projection
    "host_codec": ("webp", ["--quality", "auto", "--max-evals", "6", "--encoder-reuse", "2",
                            "--consistency", "callback"]),
}


@pytest.mark.parametrize("case", list(RESTORE_CASES))
def test_restore_cli_matches_jax(tmp_path, npz, eta0, case):
    from ddpm_image_restoration_tpu.cli.restore import main as jax_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as torch_main

    kind, flags = RESTORE_CASES[case]
    files = _inputs(tmp_path / "in")
    inputs = sum((files[k] for k in kind.split("+")), [])
    weights = npz / (next((c for c in ("all", "avif") if c in flags), "webp") + ".npz")
    names = [Path(p).stem + "_restored.png" for p in inputs]
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        main([*inputs, *TINY_FLAGS, "--params-npz", str(weights), "--output-dir",
              str(tmp_path / name), *flags, *extra])
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == sorted(names)
    _assert_pngs_close(tmp_path / "jax", tmp_path / "torch", names)
    if kind == "big":
        assert Image.open(tmp_path / "torch" / names[0]).size == (48, 40)


def test_restore_from_own_checkpoint_with_ema(tmp_path, capsys):
    """Train two steps with the port's trainer (EMA 0.9), then restore with
    --checkpoint-dir --use-ema: the CLI loads exactly the checkpoint's EMA,
    and writes the same PNGs as a restore from those EMA weights in the
    release npz layout (`params_to_jax`, which `export_release_params`
    writes, kept in f32: the fp16 export rounds the weights, and a restore
    from random-like weights moves further than the CLI bound for that)."""
    from ddpm_image_restoration_tpu_torch.cli.common import weights_from
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.cli.train import main as train_main
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.checkpoint import (
        export_release_params,
        load_release_params,
        params_to_jax,
    )

    flags = ["--image-size", "32", "--width-scale", "16", "--attn", "flash",
             "--attn-max-res", "32", "--device", "cpu"]
    ck = tmp_path / "ck"
    state, _ = train_main([*flags, "--synthetic", "12", "--epochs", "1", "--batch-size", "4",
                           "--steps", "20", "--ema-decay", "0.9", "--data-workers", "1",
                           "--checkpoint-dir", str(ck)])
    assert state.step == 2
    args = type("Args", (), dict(params_npz=None, random_init=False, checkpoint_dir=str(ck),
                                 use_ema=True))
    ema, what = weights_from(args)
    assert "checkpoint" in what and ema.keys() == state.ema.keys()
    assert all(torch.equal(ema[k], state.ema[k].cpu()) for k in ema)
    assert not all(torch.equal(ema[k], state.params[k].cpu()) for k in ema)

    model = build_model("webp", tconfig.ModelConfig(image_size=32, attention_impl="flash",
                                                   attn_max_resolution=32).scaled(16),
                        device="cpu")
    model.load_state_dict(ema)
    npz_path = str(tmp_path / "ema.npz")
    np.savez(npz_path, **params_to_jax(model))
    fp16 = load_release_params(export_release_params(model, str(tmp_path / "ema16.npz")))
    held = model.state_dict()  # the EMA in the parameters' dtypes (bf16 body)
    assert all(torch.equal(fp16[k], held[k].half().float()) for k in ema)
    inputs = _inputs(tmp_path / "in")["png"]
    common = [*inputs, *flags, "--quality", "30", "--max-evals", "6", "--encoder-reuse", "2"]
    restore_main([*common, "--checkpoint-dir", str(ck), "--use-ema",
                  "--output-dir", str(tmp_path / "ck_out")])
    restore_main([*common, "--params-npz", npz_path, "--output-dir", str(tmp_path / "npz_out")])
    for p in inputs:
        name = Path(p).stem + "_restored.png"
        assert np.array_equal(*(np.asarray(Image.open(tmp_path / d / name))
                                for d in ("ck_out", "npz_out"))), name

    # a checkpoint trained without an EMA has none to restore
    state, _ = train_main([*flags, "--synthetic", "12", "--epochs", "1", "--batch-size", "4",
                           "--steps", "20", "--data-workers", "1",
                           "--checkpoint-dir", str(tmp_path / "no_ema")])
    with pytest.raises(SystemExit, match="no EMA"):
        restore_main([*common, "--checkpoint-dir", str(tmp_path / "no_ema"), "--use-ema",
                      "--output-dir", str(tmp_path / "x")])


def test_restore_refusals(tmp_path):
    """The unported flags name their ROADMAP item, and --dp with --sp is
    refused as in the JAX CLI; a directory without the port's checkpoints
    (an Orbax one, or none) says so; all before any model is built."""
    from ddpm_image_restoration_tpu_torch.cli.restore import main

    img = _inputs(tmp_path / "in")["png"][:1]
    for flags, item in ((["--solver", "gaussian_mixture"], "item 4"),
                        (["--sp", "2"], "item 7")):
        with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {item}"):
            main([*img, *flags, "--random-init"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main([*img, "--dp", "2", "--sp", "2", "--random-init"])
    for flags in (["--codec", "all"], ["--codec", "auto"]):
        with pytest.raises(SystemExit, match="--model-codec"):
            main([*img, *flags, "--random-init"])
    (tmp_path / "orbax" / "1").mkdir(parents=True)
    with pytest.raises(SystemExit, match="Orbax"):
        main([*img, "--checkpoint-dir", str(tmp_path / "orbax")])


@pytest.mark.slow
def test_restore_cli_full_width_release_weights(tmp_path, eta0):
    """The release WebP teacher at full width (64², flash at <= 32²) through
    both CLIs on two WebPs at their own qualities, in f32 as the full-width
    model test runs (in bf16 the two packages round in other orders, and
    the q10 PNG differed by up to 3 steps)."""
    from ddpm_image_restoration_tpu.cli.restore import main as jax_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as torch_main

    weights = ROOT / "artifacts_release" / "webp_real_r5.npz"
    if not weights.exists():
        pytest.skip(f"{weights} is not in this checkout")
    imgs = smooth_images(2, 64, seed=9)
    inputs = [_write(tmp_path / "in" / f"w{q}.webp", x, quality=q) for x, q in zip(imgs, (10, 50))]
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        main([*inputs, "--compute-dtype", "float32", "--attn", "flash", "--attn-max-res", "32",
              "--params-npz", str(weights),
              "--quality", "auto", "--max-evals", "14", "--encoder-reuse", "2",
              "--output-dir", str(tmp_path / name), *extra])
    _assert_pngs_close(tmp_path / "jax", tmp_path / "torch",
                       [Path(p).stem + "_restored.png" for p in inputs])
