"""The port's trainer around the step: f32 masters under a bf16 body, the
generator-driven dropout, checkpoints with retention and exact resume, the
validation-by-restoration loop and the `cli/train.py` entry point, all on
the CPU at MINI/tiny widths."""

import dataclasses

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu_torch.cli.train import main as train_main
from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
from ddpm_image_restoration_tpu_torch.models.unet import Dropout, set_dropout_generator
from ddpm_image_restoration_tpu_torch.train.checkpoint import CheckpointManager
from ddpm_image_restoration_tpu_torch.train.loop import train_model

from ._tiny import MINI
from ._torch_parity import as_jax_layout, flatten_jax, torch_cfg
from .test_torch_train import _assert_adam_first_step_close, _one_step

torch.set_num_threads(1)


def test_train_step_bf16_keeps_f32_masters(tmp_path):
    """bf16 body against the JAX package's f32 params after one step. Loss
    rtol 1e-2 (bf16 rounds in other places in the two). Params: every
    element within 2·lr and 90% of them within 1e-6 (94.8% are): bf16
    gradients carry more rounding noise than f32 ones, so more near-zero
    gradients change sign (see _assert_adam_first_step_close). Masters kept
    in bf16 (the fault this repairs) would round away most 2e-4 updates (a
    bf16 step is 4.9e-4 at 0.1) and miss both bounds. The module holds the
    masters rounded to bf16."""
    jstate, jmetrics, state, metrics, tm, _ = _one_step(tmp_path, "bfloat16", False)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-2)
    _assert_adam_first_step_close(as_jax_layout(tm, state.params), flatten_jax(jstate.params),
                                  0.90)
    for n, p in tm.named_parameters():
        assert state.params[n].dtype == torch.float32
        assert torch.equal(p.detach(), state.params[n].to(p.dtype))
    assert tm.down2.conv1.weight.dtype == torch.bfloat16


def test_dropout_draws_from_its_generator():
    d = Dropout(0.25)
    x = torch.ones(4000)
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(d, torch.Generator().manual_seed(7))
        outs.append(d(x))
    torch.testing.assert_close(outs[0], outs[1])
    kept = outs[0] != 0
    assert 0.70 < kept.float().mean().item() < 0.80
    torch.testing.assert_close(outs[0][kept], torch.full_like(outs[0][kept], 1 / 0.75))
    d.eval()
    assert d(x) is x


def test_eval_loss_step_is_the_train_loss_without_update(rng, tmp_path):
    """make_eval_loss_step's loss on a batch equals the loss that the next
    train step reports (dropout 0, same weights), and leaves the weights."""
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.steps import (
        create_train_state,
        make_eval_loss_step,
        make_train_step,
    )

    cfg = _mini_cfg(tmp_path)
    torch.manual_seed(0)
    model = build_model("webp", cfg.model, device="cpu")
    state = create_train_state(model, cfg)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32))
    batch = {"x0": x0, "xt": (x0 * 0.9).contiguous(), "t": torch.tensor([3, 50, 97])}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = make_eval_loss_step(model, cfg)(batch)
    assert all(torch.equal(before[n], p) for n, p in model.named_parameters())
    np.testing.assert_allclose(make_train_step(model, cfg)(state, batch, None)["loss"].item(),
                               loss.item(), rtol=1e-6)


def _mini_cfg(tmp_path, **kw):
    model = dataclasses.replace(torch_cfg(MINI), dropout=0.0)
    return TrainConfig(codec="webp", model=model, epochs=2, steps=20, batch_size=4,
                       checkpoint_dir=str(tmp_path), data_workers=0, ema_decay=0.9, **kw)


def test_resume_matches_uninterrupted_run(tmp_path):
    """Two epochs straight against one epoch, then a resumed second: the
    same params, moments, EMA and step (bitwise on the CPU; dropout 0, since
    neither package checkpoints the dropout RNG)."""
    ds = SyntheticImageDataset(20, 16)  # 16 train images: 4 steps an epoch
    straight, hist = train_model(_mini_cfg(tmp_path / "a"), ds, val_batch=2, verbose=False,
                                 device="cpu")
    assert straight.step == 8 and np.isfinite(hist["val_psnr"]).all()
    assert len(hist["step_ms"]) == 2
    train_model(_mini_cfg(tmp_path / "b"), ds, epochs=1, val_batch=2, verbose=False,
                device="cpu")
    resumed, hist_b = train_model(_mini_cfg(tmp_path / "b"), ds, val_batch=2, verbose=False,
                                  device="cpu")
    assert resumed.step == 8 and len(hist_b["loss"]) == 1
    for name in ("params", "mu", "nu", "ema"):
        a, b = getattr(straight, name), getattr(resumed, name)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [0, 1]


def test_checkpoint_retention_keeps_latest_and_best(tmp_path):
    """The best three by val PSNR and the latest two stay (the JAX
    package's policy); a new manager on the same directory sees them."""
    ds = SyntheticImageDataset(10, 16)
    cfg = _mini_cfg(tmp_path / "run")
    state, _ = train_model(cfg, ds, epochs=1, val_batch=2, verbose=False, device="cpu")
    m = CheckpointManager(str(tmp_path / "ckpt"))
    history = [(0, 19.0), (1, 19.95), (2, 19.93), (3, 19.94), (10, 19.5), (59, 19.91)]
    for step, psnr in history:
        state.step = step
        m.save(step, state, {"epoch": step, "val_psnr": psnr})
    m2 = CheckpointManager(str(tmp_path / "ckpt"))
    assert m2.all_steps() == [1, 2, 3, 10, 59]
    assert m2.latest_step() == 59 and m2.best_step() == 1
    _, meta = m2.restore_latest(state)
    assert meta["epoch"] == 59 and state.step == 59
    _, meta = m2.restore_best(state)
    assert meta["epoch"] == 1 and state.step == 1


def test_cli_train_runs_to_the_end(tmp_path, capsys):
    """`cli/train.py main` on the CPU: two epochs of a width/16 WebP model
    with flash attention at 32² (the autograd Function at T = 1024) and the
    EMA, validated by restoration; the val PSNR is finite and the flash
    block's qkv weight got a gradient."""
    state, hist = train_main([
        "--device", "cpu", "--synthetic", "24", "--epochs", "2", "--image-size", "32",
        "--width-scale", "16", "--batch-size", "4", "--attn", "flash", "--attn-max-res", "32",
        "--steps", "20", "--ema-decay", "0.999", "--data-workers", "2",
        "--checkpoint-dir", str(tmp_path)])
    assert np.isfinite(hist["val_psnr"]).all() and len(hist["val_psnr"]) == 2
    assert np.isfinite(hist["loss"]).all()
    assert state.model.down1.attn.qkv.weight.grad.abs().max() > 0
    assert "webp [1]" in capsys.readouterr().out
    assert (tmp_path / "metrics.jsonl").exists()


@pytest.mark.parametrize("codec", ["avif", "all"])
def test_cli_train_avif_and_all(tmp_path, capsys, codec):
    """`cli/train.py main --codec avif|all` on the CPU: one epoch of a
    width/16 model with flash attention at 32² (for avif: 8 heads and the
    AVIF frequency blocks; for all: mixed-codec batches with per-sample
    conditioning ids, validated once per codec); loss and val PSNR finite,
    the flash level's qkv and (avif) the adaptive transform got gradients."""
    state, hist = train_main([
        "--device", "cpu", "--codec", codec, "--synthetic", "12", "--epochs", "1",
        "--image-size", "32", "--width-scale", "16", "--batch-size", "4", "--attn", "flash",
        "--attn-max-res", "32", "--steps", "20", "--data-workers", "1",
        "--checkpoint-dir", str(tmp_path)])
    assert np.isfinite(hist["val_psnr"]).all() and np.isfinite(hist["loss"]).all()
    m = state.model
    assert m.down1.attn.qkv.weight.grad.abs().max() > 0
    if codec == "avif":
        assert m.down1.attn.num_heads == 8
        assert m.down1.freq_guide.adaptive_transform.transform_weights.grad.abs().max() > 0
    else:
        assert m.codec_embed.weight.grad.abs().max() > 0
    assert f"{codec} [0]" in capsys.readouterr().out


def test_validate_all_matches_jax(tmp_path, monkeypatch):
    """The unified ('all') validation of both packages on the same MINI
    weights: one restore per codec (jpeg q30, webp q30, avif q50, each
    codec's middle val quality) at its full init_t, averaged. Both presets
    at eta 0, since each package draws its own noise; the exact final
    projection on. val_psnr within 1e-3 dB and val_ssim within 1e-4 (f32
    sums in other orders through 20 solver steps per codec).

    The images are `smooth_images(2, 16, seed=7)`: on these random weights
    the AVIF q50 restore is chaotic for most inputs (with seed 6 the JAX
    package's own output moved by 0.78 for a 1e-6 change of its input, and
    the two packages' by 0.19), while at seed 7 that change moves it by
    3e-5."""
    import jax.numpy as jnp

    from ddpm_image_restoration_tpu import config as jconfig
    from ddpm_image_restoration_tpu.config import TrainConfig as JTrainConfig
    from ddpm_image_restoration_tpu.train.loop import (
        unified_samplers as j_unified_samplers,
        validate_by_restoration as j_validate,
    )
    from ddpm_image_restoration_tpu_torch import config as tconfig
    from ddpm_image_restoration_tpu_torch.train.loop import (
        unified_samplers,
        validate_by_restoration,
    )

    from ._torch_parity import model_pair, smooth_images

    for mod in (jconfig, tconfig):
        for name, preset in list(mod._PRESETS.items()):
            monkeypatch.setitem(mod._PRESETS, name, dataclasses.replace(preset, eta=0.0))
    jm, jv, tm = model_pair("all", MINI, tmp_path / "all.npz", seed=5)
    val = smooth_images(2, 16, seed=7)
    samplers = unified_samplers(tm)
    assert {c: (s.preset.name, s.codec_id) for c, s in samplers.items()} == {
        "jpeg": ("jpeg", 0), "webp": ("webp", 1), "avif": ("avif", 2)}
    got = validate_by_restoration(tm, TrainConfig(codec="all", model=torch_cfg(MINI), steps=20),
                                  val, samplers)
    want = j_validate(jm, jv["params"], JTrainConfig(codec="all", model=MINI, steps=20), val,
                      j_unified_samplers(jm, "surrogate"))
    np.testing.assert_allclose(got["val_psnr"], float(want["val_psnr"]), atol=1e-3)
    np.testing.assert_allclose(got["val_ssim"], float(want["val_ssim"]), atol=1e-4)
    assert np.isfinite(jnp.asarray(got["val_psnr"]))


@pytest.mark.parametrize("flags", [["--fsdp"]])
def test_cli_refuses_unported_config(flags, monkeypatch):
    """`--fsdp` is ported: the CLI hands it to the trainer, whose check
    accepts it, as it accepts a ('data', 'model') mesh (no CLI flag reaches
    it); what it still refuses is any other mesh."""
    import dataclasses

    from ddpm_image_restoration_tpu_torch.train import loop

    seen = {}

    def fake_train_model(cfg, **kw):
        loop.check_supported(cfg)
        seen["cfg"] = cfg
        return None, {}

    monkeypatch.setattr(loop, "train_model", fake_train_model)
    train_main(["--device", "cpu", *flags])
    assert seen["cfg"].fsdp
    loop.check_supported(dataclasses.replace(seen["cfg"], mesh_shape=(1, 1),
                                             mesh_axes=("data", "model")))
    with pytest.raises(NotImplementedError, match="'data', 'model'"):
        loop.check_supported(dataclasses.replace(seen["cfg"], mesh_shape=(1, 1),
                                                 mesh_axes=("model", "data")))


def test_trainer_refuses_what_it_lacks():
    from ddpm_image_restoration_tpu_torch.train.loop import check_supported

    for cfg in (TrainConfig(mesh_shape=(2,), mesh_axes=("data", "model")),
                TrainConfig(mesh_shape=(4,), mesh_axes=("spatial",))):
        with pytest.raises(NotImplementedError):
            check_supported(cfg)
    check_supported(TrainConfig(mesh_shape=(2, 2), mesh_axes=("data", "model")))
    for cfg in (TrainConfig(model=ModelConfig(remat=True)),
                TrainConfig(consistency_mode="host_loop"), TrainConfig(fsdp=True),
                TrainConfig(mesh_shape=(2,))):
        check_supported(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_model(TrainConfig(), SyntheticImageDataset(4, 64), device="cuda")


def test_validate_with_n_eval_matches_jax(tmp_path, monkeypatch):
    """A distilled student's validation: `n_eval=1` restores each webp val
    quality (q10/30/50 from init_t 20, 20, 20 over 20 steps) in one
    evaluation at stride `student_stride(init_t, 1)` = 20, then the exact
    final projection. Both packages at eta 0 on the same MINI weights:
    val_psnr within 1e-3 dB, val_ssim within 1e-4."""
    from ddpm_image_restoration_tpu import config as jconfig
    from ddpm_image_restoration_tpu.config import TrainConfig as JTrainConfig
    from ddpm_image_restoration_tpu.train.loop import validate_by_restoration as j_validate
    from ddpm_image_restoration_tpu_torch import config as tconfig
    from ddpm_image_restoration_tpu_torch.train.loop import validate_by_restoration

    from ._torch_parity import model_pair, smooth_images

    for mod in (jconfig, tconfig):
        monkeypatch.setitem(mod._PRESETS, "webp",
                            dataclasses.replace(mod._PRESETS["webp"], eta=0.0))
    jm, jv, tm = model_pair("webp", MINI, tmp_path / "w.npz", seed=4)
    val = smooth_images(2, 16, seed=3)
    got = validate_by_restoration(tm, TrainConfig(codec="webp", model=torch_cfg(MINI), steps=20),
                                  val, n_eval=1)
    want = j_validate(jm, jv["params"], JTrainConfig(codec="webp", model=MINI, steps=20), val,
                      n_eval=1)
    np.testing.assert_allclose(got["val_psnr"], float(want["val_psnr"]), atol=1e-3)
    np.testing.assert_allclose(got["val_ssim"], float(want["val_ssim"]), atol=1e-4)


# attention at <= 16² only (T <= 256): the CPU's plain attention at T = 1024
# would take most of these runs' time (0.2 s a call at batch 4)
TINY_TRAIN = ["--device", "cpu", "--image-size", "32", "--width-scale", "16", "--batch-size",
              "4", "--attn", "flash", "--attn-max-res", "16", "--steps", "20",
              "--data-workers", "1"]


def test_cli_auto_restart_resumes_after_a_crash(tmp_path, monkeypatch, capsys):
    """`--auto-restart 1`: the first attempt crashes right after epoch 0's
    checkpoint is written; the second resumes from it (though `--no-resume`
    is given, as the JAX CLI does) and trains epoch 1 alone. Without the
    flag the crash propagates."""
    from ddpm_image_restoration_tpu_torch.train import checkpoint

    real_save = checkpoint.CheckpointManager.save
    crashes = []

    def save_then_crash(self, step, state, metrics=None):
        path = real_save(self, step, state, metrics)
        if not crashes:
            crashes.append(step)
            raise RuntimeError("injected crash")
        return path

    monkeypatch.setattr(checkpoint.CheckpointManager, "save", save_then_crash)
    argv = [*TINY_TRAIN, "--synthetic", "10", "--epochs", "2", "--no-resume"]
    with pytest.raises(RuntimeError, match="injected"):
        train_main([*argv, "--checkpoint-dir", str(tmp_path / "a")])
    crashes.clear()
    state, hist = train_main([*argv, "--auto-restart", "1", "--checkpoint-dir",
                              str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "training crashed (RuntimeError: injected crash)" in out and "attempt 1/1" in out
    assert "resumed from epoch 0" in out
    assert crashes == [0] and len(hist["loss"]) == 1 and state.step == 4
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [0, 1]


def test_cli_train_remat_host_codec_curves_and_grid(tmp_path):
    """`--remat` and `--consistency host_loop`, which the trainer refused
    before: one epoch of the width/16 model with each block rematerialised
    (dropout on) and validation through the exact host codec; the training
    curves and epoch 0's restoration grid are written (matplotlib here)."""
    pytest.importorskip("matplotlib")
    state, hist = train_main([*TINY_TRAIN, "--synthetic", "6", "--epochs", "1", "--remat",
                              "--consistency", "host_loop", "--checkpoint-dir", str(tmp_path)])
    assert state.model.cfg.remat and state.model.down1.remat
    assert np.isfinite(hist["val_psnr"]).all()
    assert state.model.down2.attn.qkv.weight.grad.abs().max() > 0
    assert (tmp_path / "curves" / "training.png").exists()
    assert (tmp_path / "viz" / "epoch_0000.png").exists()
