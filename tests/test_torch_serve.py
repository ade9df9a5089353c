"""The port's serving slice end to end: `serve --once` against the JAX
package's server on the same npz weights (PNGs under the production policy;
per-file estimated qualities; codec-pure batches from mixed codecs; the
traced budget; tiles; the processed directory); the card path importing
neither JAX nor Pillow; chip_smoke.py refusing to run without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ddpm_image_restoration_tpu.config import ModelConfig
from tests._torch_parity import model_pair, smooth_images

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY_FLAGS = ["--image-size", "32", "--width-scale", "8", "--compute-dtype", "float32",
              "--attn", "flash", "--attn-max-res", "32"]


def _write_pngs(d: Path, n=2, size=32):
    d.mkdir(parents=True)
    imgs = smooth_images(n, size, seed=5)
    for i, x in enumerate(imgs):
        Image.fromarray(((x * 0.5 + 0.5) * 255).round().astype(np.uint8)).save(d / f"im{i}.png")


def test_serve_once_matches_jax(tmp_path):
    """Two PNGs through both servers: production policy at q30 (13
    evaluations, encoder reuse 2, exact final projection), flash attention
    at 32² (T = 1024). The PNGs may differ by one 8-bit step where an f32
    difference crosses a rounding edge."""
    from ddpm_image_restoration_tpu.cli.serve import main as jax_main
    from ddpm_image_restoration_tpu_torch.cli.serve import main as torch_main

    cfg = ModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(8)
    npz = tmp_path / "w.npz"
    model_pair("webp", cfg, npz, seed=2)
    common = ["--codec", "webp", *TINY_FLAGS, "--params-npz", str(npz), "--quality", "30",
              "--solver", "auto", "--batch-size", "2", "--once"]
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        _write_pngs(tmp_path / name / "in")
        main(["--watch", str(tmp_path / name / "in"), "--output-dir",
              str(tmp_path / name / "out"), *common, *extra])
        outs[name] = sorted((tmp_path / name / "out").glob("*_restored.png"))
        assert [p.name for p in outs[name]] == ["im0_restored.png", "im1_restored.png"]
        assert sorted(p.name for p in (tmp_path / name / "in" / "done").iterdir()) == \
            ["im0.png", "im1.png"]
    for a, b in zip(outs["jax"], outs["torch"]):
        ia, ib = (np.asarray(Image.open(p), np.int16) for p in (a, b))
        assert ia.shape == ib.shape == (32, 32, 3)
        assert np.abs(ia - ib).max() <= 1 and np.mean(ia != ib) < 0.01


def _write_files(d: Path, files: dict) -> None:
    """{name: (HWC image in [-1,1], Pillow save kwargs)} into d."""
    d.mkdir(parents=True)
    for name, (x, kw) in files.items():
        Image.fromarray(((x * 0.5 + 0.5) * 255).round().astype(np.uint8)).save(d / name, **kw)


def _serve_files():
    imgs = smooth_images(4, 32, seed=5)
    big = smooth_images(1, 48, seed=8)[0][:40]  # 40 high, 48 wide
    return {
        # The exact final projection re-encodes x̂ with libwebp, whose
        # decisions can flip on a last-bit change of x̂: with imgs[2] at q70
        # (estimated 76) the two packages' x̂ differed by 2.2e-5 (the JAX
        # package's own x̂ moves as much for a 1e-6 change of its input) and
        # the re-encoded PNGs on 68% of pixels, by up to 20 steps; at q90
        # (estimated 91) the JAX package's own x̂ moved by 1.8e-4. So the
        # third file is imgs[3] at q70, where the encoder held its decisions.
        "quality_auto": {"a10.webp": (imgs[0], dict(quality=10)),
                         "b50.webp": (imgs[1], dict(quality=50)),
                         "c70.webp": (imgs[3], dict(quality=70))},
        "codec_auto": {"a.webp": (imgs[0], dict(quality=30)), "b.webp": (imgs[1], dict(quality=30)),
                       "c.jpg": (imgs[2], dict(quality=30))},
        "tile": {"big.png": (big, {})},
        "avif": {"a20.avif": (imgs[0], dict(quality=20)), "b50.avif": (imgs[1], dict(quality=50))},
    }


# case: (files, flags, the port's log lines that must appear)
SERVE_CASES = {
    # per-file estimated qualities, init_t at the bucket of their median
    "quality_auto": ("quality_auto", ["--codec", "webp", "--quality", "auto", "--batch-size", "4"],
                     ["init_t bucket"]),
    # a WebP batch of 2 first (the larger group), then the JPEG alone
    "codec_auto": ("codec_auto", ["--codec", "auto", "--model-codec", "all", "--quality", "30",
                                  "--batch-size", "2"],
                   ["restored 2 images (total 2)", "restored 1 images (total 3)"]),
    # each file at its own init_t in one 14-slot batch
    "traced": ("quality_auto", ["--codec", "webp", "--quality", "auto", "--traced",
                                "--batch-size", "4"], ["restored 3 images (total 3)"]),
    "tile": ("tile", ["--codec", "webp", "--quality", "30", "--size-mode", "tile",
                      "--tile-overlap", "16", "--batch-size", "4"], []),
    # a model of the avif preset (8 heads, AVIF frequency blocks) on AVIF
    # files at their exact estimated qualities, the policy's AVIF protection
    "avif_model": ("avif", ["--codec", "avif", "--quality", "auto", "--batch-size", "2"],
                   ["restored 2 images (total 2)"]),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_cli_matches_jax(tmp_path, case, capsys):
    """Both servers drain the same files under the production policy (eta
    0) and write PNGs within the CLI bound; inputs move to --processed-dir."""
    from ddpm_image_restoration_tpu.cli.serve import main as jax_main
    from ddpm_image_restoration_tpu_torch.cli.serve import main as torch_main

    files_key, flags, log_lines = SERVE_CASES[case]
    files = _serve_files()[files_key]
    codec = next((c for c in ("all", "avif") if c in flags), "webp")
    cfg = ModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(8)
    npz = tmp_path / "w.npz"
    model_pair(codec, cfg, npz, seed=2)
    names = sorted(Path(f).stem + "_restored.png" for f in files)
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        _write_files(tmp_path / name / "in", files)
        capsys.readouterr()
        main(["--watch", str(tmp_path / name / "in"), "--output-dir", str(tmp_path / name / "out"),
              "--processed-dir", str(tmp_path / name / "processed"), *TINY_FLAGS,
              "--params-npz", str(npz), "--solver", "auto", "--once", *flags, *extra])
        log = capsys.readouterr().out
        assert sorted(p.name for p in (tmp_path / name / "out").iterdir()) == names
        assert sorted(p.name for p in (tmp_path / name / "processed").iterdir()) == sorted(files)
        assert not any((tmp_path / name / "in").iterdir())
    for line in log_lines:
        assert line in log, log
    for n in names:
        ia, ib = (np.asarray(Image.open(tmp_path / d / "out" / n), np.int16)
                  for d in ("jax", "torch"))
        assert ia.shape == ib.shape
        assert np.abs(ia - ib).max() <= 1 and np.mean(ia != ib) < 0.01, n
    if case == "tile":
        assert Image.open(tmp_path / "torch" / "out" / names[0]).size == (48, 40)


def test_serve_refusals(tmp_path):
    """--traced without a budget, and --dp with tile mode (as in the JAX
    CLI), refuse at startup, before any model is built."""
    from ddpm_image_restoration_tpu_torch.cli.serve import main

    base = ["--watch", str(tmp_path), "--output-dir", str(tmp_path / "out"), "--random-init",
            "--once"]
    with pytest.raises(SystemExit):
        main([*base, "--traced"])
    with pytest.raises(SystemExit, match="fixed-size mode"):
        main([*base, "--dp", "2", "--size-mode", "tile"])


def test_serve_rejects_and_requires_weights(tmp_path):
    from ddpm_image_restoration_tpu_torch.cli.serve import main

    watch = tmp_path / "in"
    _write_pngs(watch, n=1)
    (watch / "broken.png").write_bytes(b"not an image")
    with pytest.raises(SystemExit):
        main(["--watch", str(watch), "--output-dir", str(tmp_path / "out"), "--once"])
    main(["--watch", str(watch), "--output-dir", str(tmp_path / "out"), *TINY_FLAGS,
          "--random-init", "--steps", "4", "--once", "--device", "cpu"])
    assert (watch / "rejected" / "broken.png").exists()
    assert (tmp_path / "out" / "im0_restored.png").exists()


def _run(code: str, cwd=ROOT, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_card_path_needs_neither_jax_nor_pillow():
    """With jax, flax, orbax and PIL made unimportable: every module of the
    port and chip_smoke's module-level code import, and a restore without
    the exact final projection runs."""
    code = """
import importlib, pkgutil, sys
for m in ("jax", "jaxlib", "flax", "orbax", "PIL"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
import ddpm_image_restoration_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
new = {pkg.__name__ + "." + m for m in ("diffusion.gaussian_mixture", "diffusion.ddpm_schedule",
                                        "models.experimental", "codecs.native",
                                        "utils.profiling")}
assert new <= set(names), new - set(names)
for n in names:
    importlib.import_module(n)
import chip_smoke
from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch
from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import pil_available
from ddpm_image_restoration_tpu_torch.config import ModelConfig
from ddpm_image_restoration_tpu_torch.models import build_model
m = build_model("webp", ModelConfig(image_size=32, compute_dtype="float32").scaled(8), device="cpu")
out = restore_batch(m, torch.zeros(1, 32, 32, 3), 50, final_exact=False)
assert out.shape == (1, 32, 32, 3) and bool(torch.isfinite(out).all())
assert not pil_available()
bad = [k for k in sys.modules if k.split(".")[0] in
       ("ddpm_image_restoration_tpu", "jax", "flax", "orbax", "PIL") and sys.modules[k] is not None]
assert not bad, bad
print("OK", len(names))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")
    assert int(r.stdout.split()[1]) >= 20


def _assert_refused(r):
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and not any(
        line.startswith("{") for line in r.stdout.splitlines())


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _assert_refused(subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                                   capture_output=True, text=True, timeout=120))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                                   capture_output=True, text=True, timeout=120))


def test_chip_smoke_bound_and_kernel_line():
    """The roofline bounds the script reports, and the JSON line's keys: one
    row per kernel (the forward and the two backward kernels), each naming
    its source and the Pallas kernel it replaces."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ms, by = chip_smoke.attention_bound_ms(32, 1024, 32, "bfloat16")
    assert by == "operations" and ms == pytest.approx(1e3 * 4 * 32 * 1024 ** 2 * 32 / 989e12)
    ms, by = chip_smoke.attention_bound_ms(4, 300, 64, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(1e3 * 4 * 4 * 300 * 64 * 2 / 3.35e12)
    ms, by = chip_smoke.bwd_bound_ms("dq", 72, 1024, 32, "bfloat16")
    assert by == "operations" and ms == pytest.approx(1e3 * 6 * 72 * 1024 ** 2 * 32 / 989e12)
    # f32: the 3xTF32 split's three TF32 products for each f32 one at the
    # TF32 peak; the FMA bound of the replaced designs at the f32 peak
    ms, by = chip_smoke.bwd_bound_ms("dkv", 72, 1024, 16, "float32")
    assert by == "operations" and ms == pytest.approx(1e3 * 24 * 72 * 1024 ** 2 * 16 / 495e12)
    ms, by = chip_smoke.attention_bound_ms(4, 1024, 128, "float32")
    assert by == "operations" and ms == pytest.approx(1e3 * 12 * 4 * 1024 ** 2 * 128 / 495e12)
    assert chip_smoke.fma_bound_ms(4, 72, 1024, 16) == pytest.approx(
        1e3 * 8 * 72 * 1024 ** 2 * 16 / 67e12)
    ms, by = chip_smoke.bwd_bound_ms("dkv", 4, 30, 64, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(1e3 * (6 * 4 * 30 * 64 * 2 + 8 * 4 * 30) / 3.35e12)
    row = dict(max_abs_err=1e-3, ms=0.3, plain_ms=0.7, library_ms=0.03, bound_ms=0.004,
               bound_by="operations")
    ms, by = chip_smoke.attention_bound_ms(4, 300, 64, "bfloat16", save_lse=True)
    assert by == "bytes" and ms == pytest.approx(1e3 * (4 * 4 * 300 * 64 * 2 + 4 * 4 * 300)
                                                 / 3.35e12)
    state = {"kernel_rows": {(bh, t, d, "bfloat16", lse): row for bh, t, d in
                             chip_smoke.KERNEL_SHAPES for lse in (False, True)},
             "bwd_rows": {(kind, bh, t, d, "bfloat16"): row for kind in ("dq", "dkv")
                          for bh, t, d in chip_smoke.BWD_SHAPES},
             "launches": {"flash_attention_fwd": 60, "flash_attention_bwd_dq": 0,
                          "flash_attention_bwd_dkv": 0},
             "launches_train": {"flash_attention_fwd": 824, "flash_attention_bwd_dq": 24,
                                "flash_attention_bwd_dkv": 24}}
    kernels = json.loads(chip_smoke.kernels_json(state))["kernels"]
    assert [k["name"] for k in kernels] == ["flash_attention_fwd", "flash_attention_bwd_dq",
                                            "flash_attention_bwd_dkv"]
    assert [k["launches"] for k in kernels] == [884, 24, 24]
    # every shape the main paths give a kernel has its own row: the forward
    # at serving, training (with the LSE) and validation shapes
    fwd_shapes = [(s["path"], *s["shape_bh_t_d"], s["save_lse"])
                  for s in kernels[0]["main_path_shapes"]]
    assert fwd_shapes == [tuple(s) for s in chip_smoke.FWD_PATH_SHAPES]
    assert ("train step", 72, 1024, 32, True) in fwd_shapes
    for k in kernels[1:]:
        assert [s["shape_bh_t_d"] for s in k["main_path_shapes"]] == [
            list(s) for s in chip_smoke.TRAIN_SHAPES]
    for k, body in zip(kernels, ("def _kernel(", "def _bwd_dq_kernel(", "def _bwd_dkv_kernel(")):
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(k)
        assert (ROOT / k["source"]).exists() and k["route"] == "cuda"
        path, line = k["replaces"].split(":")
        assert body in (ROOT / path).read_text().splitlines()[int(line) - 1]
