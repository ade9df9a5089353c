"""The port's serving slice end to end: `serve --once` on PNGs against the
JAX package's server on the same npz weights; the card path importing
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
    """The roofline bound the script reports, and the JSON line's keys."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ms, by = chip_smoke.attention_bound_ms(32, 1024, 32, "bfloat16")
    assert by == "operations" and ms == pytest.approx(1e3 * 4 * 32 * 1024 ** 2 * 32 / 989e12)
    ms, by = chip_smoke.attention_bound_ms(4, 300, 64, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(1e3 * 4 * 4 * 300 * 64 * 2 / 3.35e12)
    row = dict(max_abs_err=1e-3, ms=0.3, plain_ms=0.7, library_ms=0.03, bound_ms=0.004,
               bound_by="operations")
    state = {"kernel_rows": {(bh, t, d, "bfloat16"): row for bh, t, d in chip_smoke.KERNEL_SHAPES},
             "launches": {"flash_attention_fwd": 60}}
    (k,) = json.loads(chip_smoke.kernels_json(state))["kernels"]
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"} <= set(k)
    assert (ROOT / k["source"]).exists() and k["route"] == "cuda" and k["launches"] == 60
    path, line = k["replaces"].split(":")
    assert "def _kernel(" in (ROOT / path).read_text().splitlines()[int(line) - 1]
