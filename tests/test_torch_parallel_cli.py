"""The restore, serve and train CLIs data-parallel over spawned gloo ranks
(tests/_torch_parallel_worker.py) against the same CLIs in one process, and
chip_smoke.py's `parallel` phase rehearsed on the CPU.

The restore CLI runs the WebP preset's eta (0.85), so its noise is drawn:
the ranks draw the whole batch's and keep their rows, and an odd batch pads
its last block; its Gaussian-mixture solver does the same. Outputs are
compared as the floats the CLIs hand to `save_image`, atol 1e-5 (the
unclipped Gaussian-mixture restore: 1e-5 of its largest entry)."""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ddpm_image_restoration_tpu.config import ModelConfig
from ddpm_image_restoration_tpu_torch.config import get_preset

from . import _torch_parallel_worker as w
from ._torch_parity import model_pair, smooth_images

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TINY_FLAGS = ["--device", "cpu", "--image-size", "32", "--width-scale", "8",
              "--compute-dtype", "float32", "--attn", "flash", "--attn-max-res", "32"]
TRAIN_FLAGS = ["--device", "cpu", "--synthetic", "12", "--epochs", "1", "--image-size", "32",
               "--width-scale", "16", "--compute-dtype", "float32", "--batch-size", "4",
               "--attn", "flash", "--attn-max-res", "32", "--steps", "20", "--ema-decay", "0.9",
               "--data-workers", "1"]


def _write_inputs(d: Path) -> list:
    """Three WebPs (an odd batch for two ranks) at q10, q30 and q50."""
    d.mkdir(parents=True)
    paths = []
    for i, (x, q) in enumerate(zip(smooth_images(3, 32, seed=5), (10, 30, 50))):
        p = d / f"w{i}.webp"
        Image.fromarray(((x * 0.5 + 0.5) * 255).round().astype(np.uint8)).save(p, quality=q)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLIs over two ranks (one spawn) and in one process."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = ModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(8)
    npz = tmp / "w.npz"
    model_pair("webp", cfg, npz, seed=2)
    files = _write_inputs(tmp / "in")
    restore = [*files, *TINY_FLAGS, "--params-npz", str(npz), "--quality", "30",
               "--max-evals", "4", "--output-dir"]
    restore_gm = [*files, *TINY_FLAGS, "--params-npz", str(npz), "--quality", "30",
                  "--steps", "20", "--solver", "gaussian_mixture", "--output-dir"]
    serve = [*TINY_FLAGS, "--params-npz", str(npz), "--quality", "auto", "--solver", "auto",
             "--traced", "--batch-size", "4", "--once", "--output-dir"]

    def watch(name):
        d = tmp / name
        shutil.copytree(tmp / "in", d)
        return ["--watch", str(d)]

    jobs = [("restore", w.scenario_cli, ("restore", [*restore, str(tmp / "r2"), "--dp", "2"])),
            ("restore_gm", w.scenario_cli, ("restore", [*restore_gm, str(tmp / "g2"),
                                                        "--dp", "2"])),
            ("serve", w.scenario_cli, ("serve", [*watch("s2"), *serve, str(tmp / "s2o"),
                                                 "--dp", "-1"])),
            ("serve_batch", w.scenario_cli, ("serve", [*watch("s3"), *serve, str(tmp / "s3o"),
                                                       "--dp", "2", "--batch-size", "3"])),
            ("train", w.scenario_cli, ("train", [*TRAIN_FLAGS, "--fsdp", "--checkpoint-dir",
                                                 str(tmp / "t2")])),
            ("idle", w.scenario_cli, ("train", [*TRAIN_FLAGS, "--batch-size", "3",
                                                "--checkpoint-dir", str(tmp / "t3")]))]
    join = w.start(w.scenario_many, 2, tmp / "spawn", jobs)
    one = {"restore": w.scenario_cli(0, 1, tmp, "restore", [*restore, str(tmp / "r1")]),
           "restore_gm": w.scenario_cli(0, 1, tmp, "restore", [*restore_gm, str(tmp / "g1")]),
           "serve": w.scenario_cli(0, 1, tmp, "serve", [*watch("s1"), *serve, str(tmp / "s1o")]),
           "train": w.scenario_cli(0, 1, tmp, "train", [*TRAIN_FLAGS, "--checkpoint-dir",
                                                        str(tmp / "t1")])}
    return {"tmp": tmp, "ranks": join(), "one": one}


def _assert_saved_equal(got: dict, want: dict, scaled: bool = False):
    """atol 1e-5, or with `scaled` 1e-5 of each image's largest entry."""
    assert sorted(got) == sorted(want) and want
    for name, x in want.items():
        atol = 1e-5 * max(1.0, float(np.abs(x).max())) if scaled else 1e-5
        np.testing.assert_allclose(got[name], x, rtol=0, atol=atol, err_msg=name)


def test_restore_dp_pads_odd_batch(runs):
    """`restore --dp 2` on 3 files (rows 0-1 and 2-3, the last padding)
    writes, from rank 0 only, what one process writes."""
    rank0, rank1 = (r["restore"] for r in runs["ranks"])
    assert rank0["exit"] is None and rank1["exit"] is None
    assert "data-parallel restore over 2 device(s)" in rank0["printed"]
    _assert_saved_equal(rank0["saved"], runs["one"]["restore"]["saved"])
    assert rank1["saved"] == {}
    assert sorted(p.name for p in (runs["tmp"] / "r2").iterdir()) == \
        ["w0_restored.png", "w1_restored.png", "w2_restored.png"]


def test_restore_dp_gaussian_mixture_matches_one_process(runs):
    """`restore --dp 2 --solver gaussian_mixture` on the same 3 files: every
    rank draws the whole batch's noise and mixture choices from the same
    threefry key and keeps its rows, so rank 0 writes what one process
    writes. The solver's last step is x_t + pred, unclipped, which on
    random weights reaches ~11 here: held to 1e-5 of each image's largest
    entry (the ranks run the f32 model on 2 rows, one process on 3)."""
    rank0, rank1 = (r["restore_gm"] for r in runs["ranks"])
    assert rank0["exit"] is None and rank1["exit"] is None
    assert "data-parallel restore over 2 device(s)" in rank0["printed"]
    want = runs["one"]["restore_gm"]["saved"]
    _assert_saved_equal(rank0["saved"], want, scaled=True)
    assert rank1["saved"] == {}


def test_serve_dp_matches_one_process(runs):
    """`serve --dp -1` (both ranks) with per-file estimated qualities and
    the traced budget, the 3 files in one batch padded to 4: rank 0 writes
    and moves what one process does; `--batch-size` must be a multiple of
    the mesh."""
    rank0, rank1 = (r["serve"] for r in runs["ranks"])
    assert "data-parallel serving over 2 device(s)" in rank0["printed"]
    _assert_saved_equal(rank0["saved"], runs["one"]["serve"]["saved"])
    assert rank1["saved"] == {}
    done = runs["tmp"] / "s2" / "done"
    assert sorted(p.name for p in done.iterdir()) == ["w0.webp", "w1.webp", "w2.webp"]
    for r in runs["ranks"]:
        assert "must be a multiple of --dp 2" in r["serve_batch"]["exit"]


def test_train_fsdp_world2_matches_one_process(runs):
    """`cli/train.py --fsdp` over two ranks (batch 4, 2 each; 1 epoch of 2
    steps, validation, a checkpoint) against one process: the logged loss
    rel 1e-5, and the checkpoint's masters (tests/test_torch_parallel.py
    for the step's tolerances: here at least 99.9% of entries within 1e-5,
    all within 2·lr per step). Validation is one process's on the ranks'
    weights: both ranks log the numbers that `validate_by_restoration` in
    this process gives on the EMA of the checkpoint rank 0 alone wrote, to
    1e-6. (Against the one-process run's own validation it would not hold:
    on random weights the solver turns the masters' last-bit differences
    into 0.02 dB.)"""
    from ddpm_image_restoration_tpu_torch.config import ModelConfig as TModelConfig
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.data.dataset import (
        SyntheticImageDataset,
        split_indices,
    )
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.loop import validate_by_restoration

    hist2 = [r["train"]["result"][1] for r in runs["ranks"]]
    hist1 = runs["one"]["train"]["result"][1]
    for h in hist2:
        np.testing.assert_allclose(h["loss"], hist1["loss"], rtol=1e-5)
    for k in ("loss", "val_psnr", "val_ssim"):
        assert hist2[0][k] == hist2[1][k], k
    assert "data-parallel training over 2 rank(s) with FSDP" in runs["ranks"][0]["train"]["printed"]
    assert runs["ranks"][1]["train"]["printed"] == ""
    log = (runs["tmp"] / "t2" / "metrics.jsonl").read_text().splitlines()
    assert len(log) == 1
    ck2, ck1 = (torch.load(next((runs["tmp"] / d).glob("ckpt_*.pt")), weights_only=True)
                for d in ("t2", "t1"))
    lr, close, total = get_preset("webp").lr, 0, 0
    for k, v in ck1["state"]["params"].items():
        diff = (ck2["state"]["params"][k] - v).abs()
        assert diff.max().item() <= 2 * 2 * lr * 1.01, k
        close += int((diff <= 1e-5).sum())
        total += diff.numel()
    assert close >= 0.999 * total, close / total

    mcfg = TModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                        attn_max_resolution=32).scaled(16)
    model = build_model("webp", mcfg, device="cpu")
    model.load_state_dict(ck2["state"]["ema"])
    data = SyntheticImageDataset(12, 32)
    train_idx, val_idx, _ = split_indices(len(data))
    val = np.stack([data[int(i)] for i in (val_idx if len(val_idx) else train_idx)[:4]])
    want = validate_by_restoration(model, TrainConfig(codec="webp", model=mcfg, steps=20), val)
    for h in hist2:
        np.testing.assert_allclose(h["val_psnr"], [want["val_psnr"]], rtol=0, atol=1e-6)
        np.testing.assert_allclose(h["val_ssim"], [want["val_ssim"]], rtol=0, atol=1e-6)
    assert ck2["metadata"]["val_psnr"] == pytest.approx(want["val_psnr"], abs=1e-6)


def test_train_rank_outside_the_mesh_says_so(runs):
    """Batch 3 over 2 ranks: the mesh is gcd(3, 2) = 1 rank; rank 1 says it
    takes no part and returns at once, rank 0 trains alone."""
    rank0, rank1 = (r["idle"] for r in runs["ranks"])
    assert rank1["result"] == (None, {})
    assert "outside the data mesh of 1 of 2 ranks" in rank1["printed"]
    assert len(rank0["result"][1]["loss"]) == 1
