"""Helpers for the port's parity tests: one seeded JAX model, its weights
passed through the release npz to the port, both on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddpm_image_restoration_tpu.models import build_model as jax_build_model
from ddpm_image_restoration_tpu.train.steps import TrainState, make_optimizer
from ddpm_image_restoration_tpu.train.checkpoint import (
    load_release_params as jax_load_release_params,
)
from ddpm_image_restoration_tpu_torch.config import ModelConfig as TorchModelConfig
from ddpm_image_restoration_tpu_torch.models import build_model as torch_build_model
from ddpm_image_restoration_tpu_torch.train.checkpoint import (
    export_release_params,
    load_release_params,
    params_to_jax,
)


def torch_cfg(jax_cfg):
    """The port's ModelConfig with the same field values."""
    return TorchModelConfig(**dataclasses.asdict(jax_cfg))


def model_pair(codec, jax_cfg, npz_path, seed=0):
    """(jax_model, jax_variables, torch_model) holding the same weights.

    Seeded random weights are made in the port (JAX's own init of even the
    tiny models takes tens of seconds on the CPU), written to the release
    npz and read back by both packages, so both hold the same fp16-exact
    values. The JAX tree is checked against the Flax model's own parameter
    shapes (`jax.eval_shape` of its init, which compiles nothing).

    Kernels keep PyTorch's default init; biases and GroupNorm scales get
    seeded noise so that they are not 0 and 1. (Noise on the kernels too
    doubles each layer's gain, and the solver's per-step rounding then makes
    a long restore chaotic: the JAX package's own output moved by 0.7 for a
    1e-7 change of its input, so no two implementations could agree.)"""
    jm = jax_build_model(codec, jax_cfg)
    torch.manual_seed(seed)
    tm = torch_build_model(codec, torch_cfg(jm.cfg), device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape))
    export_release_params(tm, str(npz_path), codec=codec)
    tm.load_state_dict(load_release_params(str(npz_path)), strict=True)
    jvars = {"params": jax_load_release_params(str(npz_path))}
    s = jax_cfg.image_size
    kwargs = {"codec_id": 0} if jm.cfg.codec_conditioning else {}
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
                                          jnp.zeros((1,)), **kwargs))["params"]
    got = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                                 jvars["params"])
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(got),
                                                    jax.tree_util.tree_leaves(want)))
    return jm, jvars, tm


def smooth_images(n, size, seed=0):
    """Smooth structured NHWC images in [-1,1] (compressible, like photos)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = np.stack([
        np.sin(xx / rng.uniform(2, 5) + i) * np.cos(yy / rng.uniform(2, 5) + 0.5 * i)
        for i in range(n * 3)
    ]).reshape(n, 3, size, size).transpose(0, 2, 3, 1)
    noise = rng.normal(0, 0.05, size=base.shape).astype(np.float32)
    return np.clip(0.7 * base + noise, -1, 1).astype(np.float32)


def nchw_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def jax_train_state(jax_model, jax_train_cfg, params, steps_per_epoch=1):
    """The JAX package's TrainState over `params` (e.g. `model_pair`'s npz
    weights), built with `TrainState.create` as its `create_train_state`
    does after `model.init`, which takes tens of seconds on the CPU."""
    ema = jax.tree_util.tree_map(jnp.copy, params) if jax_train_cfg.ema_decay > 0 else None
    return TrainState.create(apply_fn=jax_model.apply, params=params,
                             tx=make_optimizer(jax_train_cfg, steps_per_epoch), ema_params=ema)


def as_jax_layout(model, tensors):
    """Tensors keyed by `model`'s parameter names (a gradient, an EMA or a
    master copy) in the JAX package's flat '/'-keyed layout, f32 numpy."""
    with torch.no_grad():
        saved = {n: p.data for n, p in model.named_parameters()}
        try:
            for n, p in model.named_parameters():
                p.data = tensors[n].detach().float().cpu()
            return params_to_jax(model)
        finally:
            for n, p in model.named_parameters():
                p.data = saved[n]


def flatten_jax(tree):
    """A Flax params tree as {'a/b/kernel': numpy array}."""
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v, np.float32) for k, v in flatten_dict(tree, sep="/").items()}
