"""The port's training step against the JAX package's: the learning-rate
schedule, clip + AdamW fed the same gradients, and one whole f32 train step
of the TINY5 model (loss, every gradient, params and EMA) on the same
weights and the same batch. The bf16 step is in test_torch_trainer.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_image_restoration_tpu.config import TrainConfig as JTrainConfig
from ddpm_image_restoration_tpu.diffusion.losses import loss_for_preset
from ddpm_image_restoration_tpu.train.schedules import cosine_warm_restarts as j_cosine
from ddpm_image_restoration_tpu.train.steps import make_optimizer as j_make_optimizer
from ddpm_image_restoration_tpu.train.steps import make_train_step as j_make_train_step
from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
from ddpm_image_restoration_tpu_torch.train.schedules import cosine_warm_restarts
from ddpm_image_restoration_tpu_torch.train.steps import (
    create_train_state,
    make_optimizer,
    make_train_step,
    step_scalars,
)

from ._tiny import MINI, TINY5
from ._torch_parity import (
    as_jax_layout,
    flatten_jax,
    jax_train_state,
    model_pair,
    smooth_images,
    torch_cfg,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("t0", [3, 100])
def test_schedule_matches_optax(t0):
    """Counts around the first two restarts (t0 and 3·t0). rtol 1e-6, and
    atol 1e-6·base_lr: the JAX schedule is f32, and where the cosine nears 0
    at the end of a segment its own rounding is ~eps_f32·base_lr, a large
    relative error of a tiny value."""
    base = 2e-4
    mine, ref = cosine_warm_restarts(base, t0), j_cosine(base, t0)
    for count in (0, 1, t0 - 1, t0, t0 + 1, 3 * t0 - 1, 3 * t0, 3 * t0 + 1):
        np.testing.assert_allclose(mine(count), float(ref(count)), rtol=1e-6, atol=1e-6 * base,
                                   err_msg=f"count {count}")
    assert mine(t0) == mine(3 * t0) == mine(0) == np.float32(base)


def test_optimizer_matches_optax_on_same_gradients(rng):
    """Clip + AdamW on the same three gradients (norms 25 and 45 clip,
    0.05 does not): params and both moments after 3 steps, atol 1e-7."""
    cfg, jcfg = TrainConfig(cosine_t0=2), JTrainConfig(cosine_t0=2)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(0, 1, s)).astype(np.float32) for k, s in shapes.items()}
             for scale in (3.0, 0.005, 5.0)]

    tx = j_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)

    names = list(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    mu, nu = [torch.zeros_like(p) for p in tp], [torch.zeros_like(p) for p in tp]
    mine = make_optimizer(cfg)
    norms = [mine.update(tp, [torch.from_numpy(g[k]) for k in names], mu, nu,
                         torch.from_numpy(step_scalars(mine, count, 0.0))).item()
             for count, g in enumerate(grads)]
    np.testing.assert_allclose(
        norms, [np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())) for g in grads],
        rtol=1e-6)
    for i, k in enumerate(names):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), atol=1e-7, err_msg=k)
        np.testing.assert_allclose(mu[i].numpy(), np.asarray(optax.tree_utils.tree_get(opt, "mu")[k]),
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(nu[i].numpy(), np.asarray(optax.tree_utils.tree_get(opt, "nu")[k]),
                                   atol=1e-7, err_msg=k)


def _batch(image_size, i):
    """The i-th batch of two smooth images and their noisy versions."""
    x0 = smooth_images(2, image_size, seed=3 + i)
    xt = np.clip(x0 + np.random.default_rng(4 + i).normal(0, 0.1, x0.shape), -1, 1)
    return {"x0": x0, "xt": xt.astype(np.float32), "t": np.array([17 + 9 * i, 64 - 5 * i], np.int32)}


def _train_steps(tmp_path, compute_dtype, with_grads, codec="webp", base=TINY5, n_steps=1,
                 **train_kw):
    """`n_steps` train steps of both packages from the same weights of
    `base` (TINY5: flash attention at 32², i.e. T = 1024 at down1 and up5),
    each on its own batch, dropout 0, EMA on, for `codec`'s preset. Returns
    the JAX state and the port's state after the steps, the port's model,
    and per step the JAX metrics, the port's metrics and, `with_grads`, the
    JAX gradients at the weights the step started from and the port's
    gradients of that step (JAX layout). `train_kw` goes to both
    TrainConfigs."""
    jmc = dataclasses.replace(base, dropout=0.0, attention_impl="flash",
                              attn_max_resolution=32, compute_dtype=compute_dtype)
    jm, jvars, tm = model_pair(codec, jmc, tmp_path / "w.npz")
    jcfg = JTrainConfig(codec=codec, model=jmc, ema_decay=0.999, **train_kw)
    cfg = TrainConfig(codec=codec, model=torch_cfg(jmc), ema_decay=0.999, **train_kw)

    def jax_loss(p, b):
        tn = b["t"].astype(jnp.float32) / jcfg.steps
        pred = jm.apply({"params": p}, b["xt"], tn, tn)
        return loss_for_preset(jcfg.preset.loss_kind)(b["xt"] + pred, b["x0"])

    jstate = jax_train_state(jm, jcfg, jvars["params"])
    jstep, jgrad = jax.jit(j_make_train_step(jm, jcfg)), jax.jit(jax.grad(jax_loss))
    state = create_train_state(tm, cfg)
    step, gen = make_train_step(tm, cfg), torch.Generator().manual_seed(0)
    jmetrics, metrics, jgrads, grads = [], [], [], []
    for i in range(n_steps):
        batch = _batch(jmc.image_size, i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if with_grads:
            jgrads.append(flatten_jax(jgrad(jstate.params, jbatch)))
        jstate, jm_i = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        jmetrics.append(jm_i)
        before = fa.flash_attention_fwd.launches
        metrics.append(step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, gen))
        assert fa.flash_attention_fwd.launches == before  # CPU tensors: plain versions
        if with_grads:
            grads.append(as_jax_layout(tm, {n: p.grad for n, p in tm.named_parameters()}))
    return jstate, state, tm, jmetrics, metrics, jgrads, grads


def _one_step(tmp_path, compute_dtype, with_grads, codec="webp", base=TINY5):
    """One train step of both packages (`_train_steps`). Returns the JAX
    state and metrics, the port's state and metrics, the port's model and,
    `with_grads`, the JAX gradients."""
    jstate, state, tm, jmetrics, metrics, jgrads, _ = _train_steps(
        tmp_path, compute_dtype, with_grads, codec, base)
    return jstate, jmetrics[0], state, metrics[0], tm, jgrads[0] if with_grads else None


def _assert_adam_first_step_close(got, want, frac, steps=1):
    """Params (or EMA) after one step of independent gradients: Adam's first
    step is ~lr·sign(g) per element, so where a gradient is ~0 (GroupNorm
    makes some analytically 0) its rounding noise can take the other sign
    and move the element by up to 2·lr = 4e-4. Every element is within
    that (after `steps` steps, `steps` times that), and at least `frac` of
    them agree to 1e-6."""
    close = total = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        if diff.size == 0:
            continue
        assert diff.max() <= steps * 2 * 2e-4 * 1.01 + 1e-6, k
        close += int((diff <= 1e-6).sum())
        total += diff.size
    assert close >= frac * total, close / total


def test_train_step_matches_jax_f32(tmp_path):
    """f32: loss and grad norm rtol 1e-5. Every gradient entry within 1e-5
    of the model's largest gradient entry (the gradients that GroupNorm
    makes analytically 0 are f32 noise in both); each attention projection's
    gradient, the flash levels' included, within 1e-5 of its own largest
    entry. Params and EMA after the step: see _assert_adam_first_step_close
    (99% agree to 1e-6)."""
    jstate, jmetrics, state, metrics, tm, jgrads = _one_step(tmp_path, "float32", True)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    grads = as_jax_layout(tm, {n: p.grad for n, p in tm.named_parameters()})
    assert set(grads) == set(jgrads)
    g_max = max(np.abs(g).max() for g in jgrads.values())
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], g, atol=1e-5 * g_max, rtol=0, err_msg=k)
        if "/attn/" in k:
            np.testing.assert_allclose(grads[k], g, atol=1e-5 * np.abs(g).max(), rtol=0,
                                       err_msg=k)
    assert np.abs(grads["down1/attn/qkv/kernel"]).max() > 0
    assert state.step == int(jstate.step) == 1
    _assert_adam_first_step_close(as_jax_layout(tm, state.params), flatten_jax(jstate.params),
                                  0.99)
    _assert_adam_first_step_close(as_jax_layout(tm, state.ema), flatten_jax(jstate.ema_params),
                                  0.99)


def test_avif_train_step_matches_jax_f32(tmp_path):
    """The avif preset (AVIF frequency blocks, 8 heads, the AVIF loss) in
    f32 at MINI (16², so the 4x4 bottleneck takes the 8-pooled gate's
    upsample and antialiased shrink, and their backward; the flash route's
    backward is held by `test_train_step_matches_jax_f32`): loss and grad
    norm rtol 1e-5, every gradient entry within 1e-5 of the largest; the
    adaptive transforms' gradients included."""
    jstate, jmetrics, state, metrics, tm, jgrads = _one_step(tmp_path, "float32", True, "avif",
                                                             base=MINI)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    grads = as_jax_layout(tm, {n: p.grad for n, p in tm.named_parameters()})
    assert set(grads) == set(jgrads)
    assert "bottleneck1/freq_guide/adaptive_transform/transform_weights" in grads
    g_max = max(np.abs(g).max() for g in jgrads.values())
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], g, atol=1e-5 * g_max, rtol=0, err_msg=k)
    assert np.abs(grads["down1/freq_guide/adaptive_transform/transform_weights"]).max() > 0
    assert state.step == int(jstate.step) == 1


def test_three_steps_match_jax_f32(tmp_path):
    """Three consecutive steps of the port against three jitted JAX steps,
    each on its own batch (WebP at MINI, f32, dropout 0, EMA on, a cosine
    period of 2 steps: the learning rate is base, base/2, then base again
    at the restart): at every step the loss and grad norm rtol 1e-5 and
    every gradient entry within 1e-5 of the largest, as in
    `test_train_step_matches_jax_f32`. The params and EMA after the three
    steps: every entry within three steps of `_assert_adam_first_step_close`'s
    reach, and 99% of the entries whose JAX gradient stands above that
    gradient bound at every step agree to 1e-6. (At MINI's widths 1.4% of
    the entries are biases and time projections feeding a one-channel
    GroupNorm group: their gradients are analytically 0, f32 noise in both
    packages, and Adam moves them by up to 2·lr a step either way.) A
    learning rate, bias correction or EMA decay frozen at its first count
    fails the 99%."""
    jstate, state, tm, jmetrics, metrics, jgrads, grads = _train_steps(
        tmp_path, "float32", True, base=MINI, n_steps=3, cosine_t0=2)
    g_max = max(np.abs(v).max() for jg in jgrads for v in jg.values())
    for i, (jm_i, m_i, jg, g) in enumerate(zip(jmetrics, metrics, jgrads, grads)):
        np.testing.assert_allclose(m_i["loss"].item(), float(jm_i["loss"]), rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(m_i["grad_norm"].item(), float(jm_i["grad_norm"]), rtol=1e-5,
                                   err_msg=f"step {i}")
        assert set(g) == set(jg)
        step_max = max(np.abs(v).max() for v in jg.values())
        for k, v in jg.items():
            np.testing.assert_allclose(g[k], v, atol=1e-5 * step_max, rtol=0, err_msg=f"{i} {k}")
    assert len({m["loss"].item() for m in metrics}) == 3
    assert state.step == int(jstate.step) == 3
    real = {k: np.minimum.reduce([np.abs(jg[k]) for jg in jgrads]) > 1e-5 * g_max
            for k in jgrads[0]}
    for got, want in ((state.params, jstate.params), (state.ema, jstate.ema_params)):
        got, want = as_jax_layout(tm, got), flatten_jax(want)
        _assert_adam_first_step_close(got, want, 0.0, steps=3)
        _assert_adam_first_step_close({k: v[real[k]] for k, v in got.items()},
                                      {k: v[real[k]] for k, v in want.items()}, 0.99, steps=3)
