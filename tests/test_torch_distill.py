"""Solver distillation of the port against the JAX package's (CPU, MINI,
f32, eta 0 as the production policy sets it): the student stride and the
progressive budget chain, one distill step (loss, every gradient, the
params after AdamW, the EMA) on the same teacher npz, and `cli/distill.py
main` end to end: from a port checkpoint and from a release npz, a resume,
and the student restored by `cli/restore.py --max-evals 2`."""

import argparse
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.config import TrainConfig as JTrainConfig
from ddpm_image_restoration_tpu.diffusion.ddrm import DDRMSampler as JDDRMSampler
from ddpm_image_restoration_tpu.diffusion.losses import loss_for_preset as j_loss_for_preset
from ddpm_image_restoration_tpu.train import distill as jdistill
from ddpm_image_restoration_tpu_torch.codecs.quality import student_stride
from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import _solver_indices
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.train import distill
from ddpm_image_restoration_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_release_params,
    load_release_params,
)
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state

from ._tiny import MINI
from ._torch_parity import (
    as_jax_layout,
    flatten_jax,
    jax_train_state,
    model_pair,
    smooth_images,
    torch_cfg,
)
from .test_torch_train import _assert_adam_first_step_close

torch.set_num_threads(1)


def test_student_stride_matches_jax():
    """Every (init_t, n_eval) of the JAX package's own test and more: the
    same stride, and at most n_eval evaluations."""
    for init_t in (1, 2, 3, 14, 20, 35, 50, 70, 75, 80):
        for n_eval in (1, 2, 3, 4, 5, 8, 14, 100):
            s = student_stride(init_t, n_eval)
            assert s == jdistill.student_stride(init_t, n_eval), (init_t, n_eval)
            assert 1 <= len(_solver_indices(init_t, s)) <= n_eval
    with pytest.raises(ValueError):
        student_stride(20, 0)


def _chain(module, cfg, dcfg):
    """(n_eval, teacher_dir, teacher_n_eval, checkpoint_dir, teacher_npz)
    of each stage `module._distill_progressive` runs."""
    calls = []

    def fake(cfg_k, dcfg_k, **kw):
        calls.append((dcfg_k.n_eval, dcfg_k.teacher_dir, dcfg_k.teacher_n_eval,
                      cfg_k.checkpoint_dir, dcfg_k.teacher_npz))
        return "state", {}

    with mock.patch.object(module, "distill_model", side_effect=fake):
        module._distill_progressive(cfg, dcfg, epochs=1)
    return calls


@pytest.mark.parametrize("case", [
    # the JAX package's own case: a stride-10 teacher from q30's init_t 70
    # (8 evaluations) halves to 4, 2, 1
    dict(qualities=(30,), teacher_stride=10, n_eval=1, want=[4, 2, 1]),
    # chip_smoke's: q10 and q50 from a stride-10 teacher, down to 2
    dict(qualities=(10, 50), teacher_stride=10, n_eval=2, want=[4, 2]),
    # the full solver over the preset's whole eval grid, an npz teacher
    dict(qualities=(), teacher_stride=1, n_eval=3, want=[40, 20, 10, 5, 3], npz="t.npz"),
])
def test_progressive_chain_matches_jax(tmp_path, case):
    """The stages of `_distill_progressive` (each stage's budget, teacher,
    teacher budget and directory) equal the JAX package's: stage k saves
    under stage<k>, the last in the root, each stage teaching the next; a
    release-npz teacher seeds only stage 0."""
    out = str(tmp_path / "out")
    kw = dict(teacher_dir="T", n_eval=case["n_eval"], teacher_stride=case["teacher_stride"],
              qualities=case["qualities"], progressive=True, teacher_npz=case.get("npz", ""))
    got = _chain(distill, TrainConfig(codec="webp", checkpoint_dir=out),
                 distill.DistillConfig(**kw))
    want = _chain(jdistill, JTrainConfig(codec="webp", checkpoint_dir=out),
                  jdistill.DistillConfig(**kw))
    assert got == want
    assert [c[0] for c in got] == case["want"]
    assert distill.progressive_budgets(TrainConfig(codec="webp"),
                                       distill.DistillConfig(**kw)) == case["want"]
    assert got[-1][3] == out and got[0][1] == "T"


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """MINI f32 teacher weights (dropout 0) in both packages, via the npz."""
    jmc = dataclasses.replace(MINI, dropout=0.0)
    d = tmp_path_factory.mktemp("teacher")
    jm, jv, tm = model_pair("webp", jmc, d / "teacher.npz", seed=2)
    return jmc, jm, jv, tm, str(d / "teacher.npz")


def test_distill_step_matches_jax(teacher):
    """One distill step at q30 over 20 diffusion steps (init_t 20): the
    teacher at stride 10 (3 evaluations), the student at 2 through the
    rematerialised solver, EMA on. Against the JAX package's jitted step on
    the same teacher npz, to the train step's bounds: loss and grad norm
    rtol 1e-5; every gradient entry (against `jax.grad` of the step's loss
    through `build_run`) within 1e-5 of the largest; params and EMA after
    AdamW as `_assert_adam_first_step_close`, every element within 2·lr and
    98% within 1e-6, not the f32 train step's 99%: a distill step's
    gradients carry more f32 noise, so more near-zero ones change sign, and
    the JAX package's own step, its observation moved by 1e-6, agrees with
    itself on only 98.5-98.7% of the elements at every input tried.

    The images are `smooth_images(2, 16, seed=11)`: a 1e-6 change of the
    observation moves the JAX package's own gradients by 5.8e-6 of the
    largest there (asserted below), while at seeds 9, 10 and 12 it moved
    them by 1.1e-5 to 2.5e-5, more than the bound (the unrolled solver's
    leaky-ReLU kinks and the surrogate's rounding)."""
    jmc, jm, jv, tm, npz = teacher
    jcfg = JTrainConfig(codec="webp", model=jmc, steps=20, ema_decay=0.999)
    cfg = TrainConfig(codec="webp", model=torch_cfg(jmc), steps=20, ema_decay=0.999)
    kw = dict(n_eval=2, teacher_stride=10)
    x0 = smooth_images(2, 16, seed=11)
    xt = np.clip(x0 + np.random.default_rng(1).normal(0, 0.08, x0.shape), -1, 1)
    xt = xt.astype(np.float32)

    jstep, init_t, s_stride, t_stride = jdistill.make_distill_step(
        jm, jcfg, jdistill.DistillConfig(**kw), 30)
    jstate = jax_train_state(jm, jcfg, jv["params"])
    jbatch = {"x0": jnp.asarray(x0), "xt": jnp.asarray(xt)}
    jstate1, jmetrics = jstep(jstate, jv["params"], jbatch, jax.random.PRNGKey(0))

    sampler = JDDRMSampler(jm, jcfg.preset)
    eta_b = jcfg.preset.eta_b
    teacher_run = sampler.build_run(init_t, t_stride)
    student_run = sampler.build_run(init_t, s_stride, remat=True)
    loss_fn = j_loss_for_preset(jcfg.preset.loss_kind)

    @jax.jit
    def jax_grads(p, y):
        target = teacher_run(jv, y, 30, jax.random.PRNGKey(1), 0.0, eta_b)

        def loss(p):
            out = student_run({"params": p}, y, 30, jax.random.PRNGKey(2), 0.0, eta_b)
            return loss_fn(out, target) + 0.3 * loss_fn(out, jbatch["x0"])

        return jax.grad(loss)(p)

    jgrads = flatten_jax(jax_grads(jv["params"], jbatch["xt"]))
    moved = flatten_jax(jax_grads(jv["params"], jbatch["xt"] + 1e-6))
    g_max = max(np.abs(g).max() for g in jgrads.values())
    assert max(np.abs(moved[k] - g).max() for k, g in jgrads.items()) <= 0.6e-5 * g_max

    student = build_model("webp", torch_cfg(jmc), device="cpu")
    student.load_state_dict(load_release_params(npz))
    state = create_train_state(student, cfg)
    step, t_init, st, tt = distill.make_distill_step(student, tm, cfg,
                                                     distill.DistillConfig(**kw), 30)
    assert (t_init, st, tt) == (init_t, s_stride, t_stride) == (20, 19, 10)
    metrics = step(state, {"x0": torch.from_numpy(x0), "xt": torch.from_numpy(xt)})

    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    grads = as_jax_layout(student, {n: p.grad for n, p in student.named_parameters()})
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], g, atol=1e-5 * g_max, rtol=0, err_msg=k)
    assert state.step == int(jstate1.step) == 1
    _assert_adam_first_step_close(as_jax_layout(student, state.params),
                                  flatten_jax(jstate1.params), 0.98)
    _assert_adam_first_step_close(as_jax_layout(student, state.ema),
                                  flatten_jax(jstate1.ema_params), 0.98)
    # the teacher stays frozen: no gradient reaches it
    assert all(p.grad is None and not p.requires_grad for p in tm.parameters())


TINY = ["--device", "cpu", "--image-size", "32", "--width-scale", "16", "--compute-dtype",
        "float32", "--attn", "flash", "--attn-max-res", "32"]


def test_cli_distill_end_to_end(tmp_path, capsys):
    """`cli/distill.py main` on the CPU (width/16 at 32², flash at 32²: the
    student's backward goes through the FlashAttention Function inside the
    rematerialised solver): from a port checkpoint (its EMA) and from a
    release npz of the same weights, the same student; run again, it
    resumes past its last epoch and trains nothing; `cli/restore.py
    --max-evals 2` restores from the student's checkpoint; `--codec all`
    and a missing teacher are refused."""
    from ddpm_image_restoration_tpu_torch.cli.common import add_model_flags, model_config_from
    from ddpm_image_restoration_tpu_torch.cli.distill import main as distill_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main

    ap = argparse.ArgumentParser()
    add_model_flags(ap)
    mcfg = model_config_from(ap.parse_args(TINY))
    torch.manual_seed(0)
    model = build_model("webp", mcfg, device="cpu")
    cfg = TrainConfig(model=mcfg, ema_decay=0.9)
    CheckpointManager(str(tmp_path / "teacher")).save(0, create_train_state(model, cfg),
                                                      {"epoch": 0, "val_psnr": 20.0})
    export_release_params(model, str(tmp_path / "teacher.npz"))
    common = [*TINY, "--synthetic", "5", "--epochs", "1", "--batch-size", "2", "--steps", "20",
              "--n-eval", "2", "--teacher-stride", "10", "--qualities", "10", "50",
              "--ema-decay", "0.9", "--data-workers", "1"]
    runs = {}
    for src in (["--teacher-dir", str(tmp_path / "teacher")],
                ["--teacher-npz", str(tmp_path / "teacher.npz")]):
        out = tmp_path / src[0][2:]
        state, hist = distill_main([*common, *src, "--checkpoint-dir", str(out)])
        assert state.step == 2 and len(hist["loss"]) == 1
        assert np.isfinite(hist["loss"]).all() and np.isfinite(hist["val_psnr"]).all()
        assert state.model.down1.attn.qkv.weight.grad.abs().max() > 0
        runs[src[0]] = state
    printed = capsys.readouterr().out
    assert "quality 10: teacher 20 steps/stride 10 -> student stride 19 (2 evals)" in printed
    assert "(ema params)" in printed
    # the npz holds the weights in fp16, the checkpoint's EMA them in f32
    a, b = runs["--teacher-dir"].params, runs["--teacher-npz"].params
    assert max((a[n] - b[n]).abs().max().item() for n in a) < 1e-2

    student_dir = str(tmp_path / "teacher-dir")
    state, hist = distill_main([*common, "--teacher-dir", str(tmp_path / "teacher"),
                                "--checkpoint-dir", student_dir])
    assert state.step == 2 and not hist.get("loss")
    assert "resumed distillation from epoch 0" in capsys.readouterr().out

    from PIL import Image

    img = (smooth_images(1, 32, seed=2)[0] * 127.5 + 127.5).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "in.webp", quality=20)
    restore_main([str(tmp_path / "in.webp"), *TINY, "--quality", "auto", "--max-evals", "2",
                  "--checkpoint-dir", student_dir, "--use-ema", "--steps", "20",
                  "--output-dir", str(tmp_path / "restored")])
    assert Image.open(tmp_path / "restored" / "in_restored.png").size == (32, 32)

    with pytest.raises(SystemExit, match="per-codec"):
        distill_main([*common, "--codec", "all", "--teacher-dir", "x"])
    with pytest.raises(FileNotFoundError, match="no teacher checkpoint"):
        distill_main([*common, "--teacher-dir", str(tmp_path / "none"),
                      "--checkpoint-dir", str(tmp_path / "s2")])
