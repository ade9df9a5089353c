"""The port's evaluation (`evaluation/harness.py`, `cli/evaluate.py`)
against the JAX package's on the same npz weights (CPU): the harness end to
end, `metrics_summary.json` field for field, both CLIs on the same
arguments, and the flags the port refuses.

Which runs are compared, and why. On random weights the solver can be
chaotic: the surrogate's per-step rounding and the exact final projection
(the host codec re-encoding x̂) can turn a last-bit difference into a
visible one (ROADMAP.md Queue 3). At MINI the JPEG q10/q50 static restores
and the WebP q10/q50 traced-budget restores under the production policy
agree to ~1e-6 dB between the two packages, while the AVIF q50 one moved by
7e-3 dB (the JAX package's own AVIF q50 restores move by up to 0.78 for a
1e-6 input change on these weights). So the parity runs take JPEG and WebP;
the AVIF model's own parity is held by tests/test_torch_model.py,
test_torch_train.py and the restore/serve CLI tests."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.config import EvalConfig as JEvalConfig
from ddpm_image_restoration_tpu.evaluation.harness import evaluate_restoration as j_evaluate
from ddpm_image_restoration_tpu_torch.config import EvalConfig
from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
from ddpm_image_restoration_tpu_torch.evaluation.harness import (
    evaluate_restoration,
    format_comparative_table,
)
from tests._tiny import MINI
from tests._torch_parity import model_pair, torch_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# The tolerances of the summary's fields between the two packages.
# compressed_*: the same host codec on the same images, metrics in f32.
# restored_* and the Fréchet distances: f32 sums in other orders through
# the solver's steps; the runs below agreed 30-100x inside these.
TOL = {"psnr": 1e-4, "ssim": 1e-5, "l2": 1e-5, "lpips": 1e-6}
COMPRESSED_ATOL = 1e-5
FID_RTOL = 1e-4


def _images(n=10, size=16):
    ds = SyntheticImageDataset(n, size, seed=99)
    return np.stack([ds[i] for i in range(n)])


def _assert_summaries_match(got: dict, want: dict):
    """Every field of two metrics summaries: the run's settings exactly,
    each quality's numbers within the tolerances above (images_per_sec is
    a time, not compared)."""
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"}
    assert got["results"].keys() == want["results"].keys()
    for q, w in want["results"].items():
        g = got["results"][q]
        assert g.keys() == w.keys(), q
        for k, v in w.items():
            if k == "images_per_sec":
                continue
            if not isinstance(v, float) or k.startswith("solver_"):
                assert g[k] == v, (q, k)
            elif k.endswith("_fid"):
                np.testing.assert_allclose(g[k], v, rtol=FID_RTOL, err_msg=f"{q} {k}")
            elif k.startswith("compressed_"):
                np.testing.assert_allclose(g[k], v, atol=COMPRESSED_ATOL, err_msg=f"{q} {k}")
            else:  # restored_<m>, delta_<m>, delta_<m>_ci95
                np.testing.assert_allclose(g[k], v, atol=TOL[k.split("_")[1]],
                                           err_msg=f"{q} {k}")


def test_harness_end_to_end(tmp_path):
    """The port's harness at MINI (jpeg q10/q50, 10 images at batch 4, so
    the last batch is 2 real images padded to 4): every key, n counts real
    images only, finite positive CIs, the table, the files, and the
    partial flag cleared by the final write."""
    torch.manual_seed(0)
    from ddpm_image_restoration_tpu_torch.models import build_model

    cfg = EvalConfig(codec="jpeg", model=torch_cfg(MINI), steps=10, output_dir=str(tmp_path),
                     qualities_override=(10, 50))
    summary = evaluate_restoration(cfg, build_model("jpeg", cfg.model, device="cpu"),
                                   _images(), batch_size=4, verbose=False)
    assert set(summary["results"]) == {"10", "50"}
    r10 = summary["results"]["10"]
    for k in ["compressed_psnr", "restored_psnr", "compressed_ssim", "restored_ssim",
              "compressed_lpips", "restored_lpips", "compressed_l2", "restored_l2",
              "compressed_fid", "restored_fid", "images_per_sec", "n", "delta_psnr",
              "delta_psnr_ci95", "delta_ssim_ci95", "fid_kind", "solver_stride"]:
        assert k in r10, k
    assert r10["n"] == 10
    assert np.isfinite(r10["delta_psnr_ci95"]) and r10["delta_psnr_ci95"] > 0
    assert abs(r10["delta_psnr"] - (r10["restored_psnr"] - r10["compressed_psnr"])) < 1e-6
    assert r10["compressed_psnr"] < summary["results"]["50"]["compressed_psnr"]
    assert summary["lpips_kind"] == "lpips_proxy" and r10["fid_kind"] == "random_conv"
    on_disk = json.loads((tmp_path / "metrics_summary.json").read_text())
    assert "partial" not in on_disk and on_disk["results"].keys() == summary["results"].keys()
    assert not (tmp_path / "metrics_summary.json.tmp").exists()
    table = format_comparative_table(summary)
    assert "JPEG" in table and "n=10" in table and "±" in table and "FID(random_conv)" in table
    if importlib.util.find_spec("matplotlib") is not None:  # the plots need it
        for name in ("examples_q10.png", "metric_panels.png"):
            assert (tmp_path / name).exists()


# case: (codec, harness keyword arguments)
PARITY_CASES = {
    "jpeg_static": ("jpeg", {}),
    "webp_auto_traced": ("webp", dict(solver="auto", traced=True)),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_summary_matches_jax(tmp_path, case):
    """metrics_summary.json of both harnesses on the same MINI weights and
    images at eta 0 (each package draws its own solver noise), q10/q50, 10
    images at batch 4, field for field within the tolerances above."""
    codec, kw = PARITY_CASES[case]
    jm, jv, tm = model_pair(codec, MINI, tmp_path / "w.npz", seed=1)
    images = _images()
    common = dict(steps=10, qualities_override=(10, 50))
    want = j_evaluate(JEvalConfig(codec=codec, model=MINI, output_dir=str(tmp_path / "jax"),
                                  **common),
                      jm, jv["params"], images, batch_size=4, verbose=False, eta=0.0, **kw)
    got = evaluate_restoration(EvalConfig(codec=codec, model=torch_cfg(MINI),
                                          output_dir=str(tmp_path / "torch"), **common),
                               tm, images, batch_size=4, verbose=False, eta=0.0, **kw)
    _assert_summaries_match(got, want)
    _assert_summaries_match(json.loads((tmp_path / "torch" / "metrics_summary.json").read_text()),
                            json.loads((tmp_path / "jax" / "metrics_summary.json").read_text()))


TINY_FLAGS = ["--image-size", "32", "--width-scale", "8", "--compute-dtype", "float32",
              "--attn", "flash", "--attn-max-res", "32"]


def test_evaluate_cli_matches_jax(tmp_path):
    """Both packages' `cli/evaluate.py main` on the same arguments and npz
    (width/8 at 32², flash attention at 32², 6 synthetic images at batch 4,
    q10/q50 under the production policy with an explicit eta 0): the
    summaries within the tolerances above. JPEG on the default `waves`
    images: on these weights the WebP restores of `natural` images are
    chaotic (the JAX package's own q10 restore moved by 0.76 for a 1e-6
    input change; the two packages' PSNRs by 0.05 dB), the JPEG `waves`
    ones agree to ~3e-6 dB."""
    from ddpm_image_restoration_tpu.cli.evaluate import main as jax_main
    from ddpm_image_restoration_tpu.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.cli.evaluate import main as torch_main

    cfg = ModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(8)
    npz = tmp_path / "w.npz"
    model_pair("jpeg", cfg, npz, seed=2)
    args = ["--codec", "jpeg", *TINY_FLAGS, "--params-npz", str(npz), "--synthetic", "6",
            "--batch-size", "4", "--qualities", "10", "50", "--solver", "auto", "--eta", "0"]
    jax_main([*args, "--output-dir", str(tmp_path / "jax")])
    got = torch_main([*args, "--output-dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert got["num_images"] == 6 and got["results"]["10"]["n"] == 6
    _assert_summaries_match(json.loads((tmp_path / "torch" / "metrics_summary.json").read_text()),
                            json.loads((tmp_path / "jax" / "metrics_summary.json").read_text()))


def test_evaluate_refusals(tmp_path):
    """--real and the exact-codec consistency modes name their ROADMAP
    item; --codec auto and all are refused as in the JAX CLI; a traced
    run needs a budget; all before any restore runs."""
    from ddpm_image_restoration_tpu_torch.cli.evaluate import main

    base = ["--device", "cpu", "--random-init", "--synthetic", "2", *TINY_FLAGS,
            "--output-dir", str(tmp_path)]
    for flags in (["--real", "4"], ["--consistency", "callback"], ["--consistency", "host_loop"]):
        with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 6"):
            main([*base, *flags])
    with pytest.raises(SystemExit, match="restore/serve only"):
        main([*base, "--codec", "auto"])
    with pytest.raises(SystemExit, match="TRAINING preset"):
        main([*base, "--codec", "all"])
    with pytest.raises(ValueError, match="budget"):
        main([*base, "--traced", "--qualities", "30"])
    assert not (tmp_path / "metrics_summary.json").exists()


@pytest.mark.slow
def test_evaluate_full_width_release_weights(tmp_path):
    """The release WebP teacher at full width (64², flash at <= 32², f32 as
    the full-width model test runs) through both harnesses: 8 natural
    synthetic images at batch 4, q10/q50 under the production policy."""
    import os

    from ddpm_image_restoration_tpu.config import ModelConfig
    from ddpm_image_restoration_tpu.models import build_model as jax_build_model
    from ddpm_image_restoration_tpu.train.checkpoint import load_release_params as jax_load
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.checkpoint import load_release_params

    npz = ROOT / "artifacts_release" / "webp_real_r5.npz"
    if not os.path.exists(npz):
        pytest.skip("artifacts_release/webp_real_r5.npz is not in this checkout")
    cfg = ModelConfig(compute_dtype="float32", attention_impl="flash", attn_max_resolution=32)
    tm = build_model("webp", torch_cfg(cfg), device="cpu")
    tm.load_state_dict(load_release_params(str(npz)), strict=True)
    ds = SyntheticImageDataset(8, 64, seed=99, kind="natural")
    images = np.stack([ds[i] for i in range(8)])
    common = dict(qualities_override=(10, 50))
    want = j_evaluate(JEvalConfig(codec="webp", model=cfg, output_dir=str(tmp_path / "jax"),
                                  **common),
                      jax_build_model("webp", cfg), jax_load(str(npz)), images, batch_size=4,
                      verbose=False, solver="auto")
    got = evaluate_restoration(EvalConfig(codec="webp", model=torch_cfg(cfg),
                                          output_dir=str(tmp_path / "torch"), **common),
                               tm, images, batch_size=4, verbose=False, solver="auto")
    _assert_summaries_match(got, want)
