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
from ddpm_image_restoration_tpu.diffusion.losses import frequency_aware_loss
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
)

from ._tiny import TINY5
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
    assert mine(t0) == mine(3 * t0) == mine(0) == base


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
    norms = [mine.update(tp, [torch.from_numpy(g[k]) for k in names], mu, nu, count).item()
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


def _one_step(tmp_path, compute_dtype, with_grads):
    """One train step of both packages on the same TINY5 weights and batch
    (flash attention at 32², i.e. T = 1024 at down1 and up5, dropout 0, EMA
    on). Returns the JAX state and metrics, the port's state and metrics,
    the port's model and, `with_grads`, the JAX gradients."""
    jmc = dataclasses.replace(TINY5, dropout=0.0, attention_impl="flash",
                              attn_max_resolution=32, compute_dtype=compute_dtype)
    jm, jvars, tm = model_pair("webp", jmc, tmp_path / "w.npz")
    jcfg = JTrainConfig(codec="webp", model=jmc, ema_decay=0.999)
    cfg = TrainConfig(codec="webp", model=torch_cfg(jmc), ema_decay=0.999)

    x0 = smooth_images(2, 32, seed=3)
    xt = np.clip(x0 + np.random.default_rng(4).normal(0, 0.1, x0.shape), -1, 1).astype(np.float32)
    t = np.array([17, 64], np.int32)

    jstate = jax_train_state(jm, jcfg, jvars["params"])
    jbatch = {"x0": jnp.asarray(x0), "xt": jnp.asarray(xt), "t": jnp.asarray(t)}
    jstate1, jmetrics = jax.jit(j_make_train_step(jm, jcfg))(jstate, jbatch, jax.random.PRNGKey(0))

    def jax_loss(p):
        tn = jbatch["t"].astype(jnp.float32) / jcfg.steps
        pred = jm.apply({"params": p}, jbatch["xt"], tn, tn)
        return frequency_aware_loss(jbatch["xt"] + pred, jbatch["x0"])

    jgrads = flatten_jax(jax.jit(jax.grad(jax_loss))(jvars["params"])) if with_grads else None

    state = create_train_state(tm, cfg)
    before = fa.flash_attention_fwd.launches
    metrics = make_train_step(tm, cfg)(
        state, {"x0": torch.from_numpy(x0), "xt": torch.from_numpy(xt), "t": torch.from_numpy(t)},
        torch.Generator().manual_seed(0))
    assert fa.flash_attention_fwd.launches == before  # CPU tensors: plain versions
    return jstate1, jmetrics, state, metrics, tm, jgrads


def _assert_adam_first_step_close(got, want, frac):
    """Params (or EMA) after one step of independent gradients: Adam's first
    step is ~lr·sign(g) per element, so where a gradient is ~0 (GroupNorm
    makes some analytically 0) its rounding noise can take the other sign
    and move the element by up to 2·lr = 4e-4. Every element is within
    that, and at least `frac` of them agree to 1e-6."""
    close = total = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * 2e-4 * 1.01 + 1e-6, k
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
