"""`cli/export.py`, the counterpart of the JAX package's
scripts/export_release_ckpt.py: a checkpoint the port's trainer wrote
becomes the release npz, which both packages' `load_release_params` read to
the same weights (exactly: the same fp16 values, in each package's layout),
those of the checkpoint's EMA by default (its masters with `--raw-params`,
or where it has no EMA), rounded once to fp16."""

import jax
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.config import ModelConfig as JModelConfig
from ddpm_image_restoration_tpu.models import build_model as j_build_model
from ddpm_image_restoration_tpu.train.checkpoint import (
    load_release_params as j_load_release_params,
)
from ddpm_image_restoration_tpu_torch.cli.export import main as export_main
from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_release_params,
)
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

from ._torch_parity import as_jax_layout, flatten_jax

torch.set_num_threads(1)

# The CLI's model: 32² (five pooling stages), widths / 16, attention <= 32².
FLAGS = ["--image-size", "32", "--width-scale", "16", "--attn-max-res", "32", "--device", "cpu"]
CFG = ModelConfig(image_size=32, attn_max_resolution=32, compute_dtype="float32").scaled(16)


def _train(directory, ema_decay: float, psnrs=(1.0,)):
    """A step of the port's train step on the MINI-sized model for each
    entry of `psnrs`, each saved as a checkpoint with that val_psnr; the
    states' masters and EMA after each step."""
    torch.manual_seed(0)
    model = build_model("webp", CFG, device="cpu")
    cfg = TrainConfig(codec="webp", model=CFG, batch_size=2, ema_decay=ema_decay)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    batch = {"x0": torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "xt": torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "t": torch.tensor([10, 60], dtype=torch.int32),
             "quality": torch.tensor([30, 30], dtype=torch.int32)}
    mgr, saved = CheckpointManager(str(directory)), []
    gen = torch.Generator().manual_seed(1)
    for i, psnr in enumerate(psnrs, 1):
        step(state, batch, gen)
        mgr.save(i, state, {"val_psnr": psnr})
        # a copy: on the CPU the state dict holds the live tensors
        saved.append({k: None if v is None else {n: t.clone() for n, t in v.items()}
                      for k, v in state.state_dict().items() if k in ("params", "ema")})
    return saved


def _export(tmp_path, ck, *flags):
    out = str(tmp_path / "release.npz")
    assert export_main([str(ck), "--out", out, *FLAGS, *flags]) == 0
    return out


def _assert_both_read(out, want):
    """Both packages' `load_release_params` read `out` to `want` (a
    parameter dict of the port) rounded once to fp16, and the JAX package's
    tree has its own model's parameter names and shapes."""
    port = load_release_params(out)
    model = build_model("webp", CFG, device="cpu")
    assert port.keys() == dict(model.named_parameters()).keys()
    for k, v in want.items():
        np.testing.assert_array_equal(port[k].numpy(), v.half().float().numpy(), err_msg=k)
    jax_flat = flatten_jax(j_load_release_params(out))
    port_flat = as_jax_layout(model, port)
    assert jax_flat.keys() == port_flat.keys()
    for k, v in port_flat.items():
        np.testing.assert_array_equal(jax_flat[k], v, err_msg=k)
    jcfg = JModelConfig(image_size=32, attn_max_resolution=32).scaled(16)
    jmodel = j_build_model("webp", jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                                         np.float32),
                            np.zeros((1,), np.float32))
    want_shapes = {k: v.shape for k, v in flatten_jax_shapes(shapes["params"]).items()}
    assert {k: v.shape for k, v in jax_flat.items()} == want_shapes


def flatten_jax_shapes(tree):
    from flax.traverse_util import flatten_dict

    return flatten_dict(tree, sep="/")


def test_export_writes_the_best_checkpoints_ema(tmp_path, capsys):
    """With an EMA: the best of two checkpoints by val_psnr (step 1, the
    earlier) and its EMA, which differs from its masters; `--raw-params`
    takes the masters. The CLI prints the parameter count and the
    checkpoint's metadata, as the JAX script does."""
    saved = _train(tmp_path / "ck", ema_decay=0.9, psnrs=(2.0, 1.0))
    best = saved[0]
    assert any(not torch.equal(best["ema"][k], best["params"][k]) for k in best["params"])
    out = _export(tmp_path, tmp_path / "ck")
    printed = capsys.readouterr().out
    assert "exported" in printed and "M params" in printed and "'step': 1" in printed
    with np.load(out) as d:
        assert str(d["__codec__"]) == "webp" and "'val_psnr': 2.0" in str(d["__meta__"])
        assert all(d[k].dtype == np.float16 for k in d.files if not k.startswith("__"))
    _assert_both_read(out, best["ema"])
    _assert_both_read(_export(tmp_path, tmp_path / "ck", "--raw-params"), best["params"])


def test_export_without_ema_writes_the_raw_params(tmp_path):
    """A checkpoint trained without an EMA exports its masters by default,
    as the JAX script falls back to the raw params."""
    saved = _train(tmp_path / "ck", ema_decay=0.0)
    assert saved[0]["ema"] is None
    _assert_both_read(_export(tmp_path, tmp_path / "ck"), saved[0]["params"])


def test_export_refuses_what_it_cannot_read(tmp_path):
    """An empty directory, or a missing one, exits with the JAX script's
    message (and no file, nor the directory, is made); a template of other
    widths than the checkpoint's says which flags must match."""
    (tmp_path / "empty").mkdir()
    for d in (tmp_path / "empty", tmp_path / "missing"):
        with pytest.raises(SystemExit, match=f"no checkpoint under {d}"):
            export_main([str(d), "--out", str(tmp_path / "x.npz"), *FLAGS])
    assert not (tmp_path / "x.npz").exists() and not (tmp_path / "missing").exists()
    _train(tmp_path / "ck", ema_decay=0.0)
    with pytest.raises(SystemExit, match="--width-scale 8"):
        export_main([str(tmp_path / "ck"), "--out", str(tmp_path / "x.npz"),
                     *FLAGS, "--width-scale", "8"])
