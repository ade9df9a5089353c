"""The port's UNet against the JAX package's on the same npz weights, f32
on the CPU: encode / decode / __call__, the codec-conditioned unified model,
and the submodules. atol 1e-4 (summation order over ~20 layers)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.models.time_embedding import TimeEmbedding as JTime
from tests._tiny import MINI, TINY5
from tests._torch_parity import model_pair, nchw_to_nhwc

torch.set_num_threads(1)

ATOL = 1e-4


def japply(jm, jv, *args, method=None, **kw):
    """The JAX model's apply under jit: one compile instead of one per op."""
    return jax.jit(functools.partial(jm.apply, method=method))(jv, *args, **kw)


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """TINY5 (the full 5-stage topology) with attention up to 32², so the
    32² level has T = 1024 and takes the flash route."""
    cfg = dataclasses.replace(TINY5, attention_impl="flash", attn_max_resolution=32)
    return model_pair("webp", cfg, tmp_path_factory.mktemp("w") / "tiny5.npz")


def _inputs(n=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    t = np.array([0.25, 0.8][:n], np.float32)
    return x, t


def test_call_matches(tiny_pair):
    jm, jv, tm = tiny_pair
    x, t = _inputs()
    want = np.asarray(japply(jm, jv, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # a scalar t broadcasts over the batch, as in the JAX model
    np.testing.assert_array_equal(tm(torch.from_numpy(x), 0.5).numpy(),
                                  tm(torch.from_numpy(x), torch.full((2,), 0.5)).numpy())


def test_encode_decode_split_matches(tiny_pair):
    """encode features (NCHW in the port) and decode from them, with an
    explicit compression level different from t."""
    jm, jv, tm = tiny_pair
    x, t = _inputs(seed=1)
    lvl = np.array([0.1, 0.9], np.float32)
    skips_j, h_j = japply(jm, jv, jnp.asarray(x), jnp.asarray(t), jnp.asarray(lvl),
                          method="encode")
    skips_t, h_t = tm.encode(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(lvl))
    assert len(skips_t) == len(skips_j) == 5
    for a, b in zip(skips_t, skips_j):
        np.testing.assert_allclose(nchw_to_nhwc(a), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(nchw_to_nhwc(h_t), np.asarray(h_j), atol=ATOL)
    want = np.asarray(japply(jm, jv, (skips_j, h_j), jnp.asarray(t), jnp.asarray(lvl),
                             method="decode"))
    got = tm.decode((skips_t, h_t), torch.from_numpy(t), torch.from_numpy(lvl))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    deep = tm.decode_deep((skips_t, h_t), torch.from_numpy(t), depth=2)
    shallow = tm.decode_shallow(deep, skips_t, torch.from_numpy(t), depth=2)
    np.testing.assert_allclose(shallow.numpy(),
                               tm.decode((skips_t, h_t), torch.from_numpy(t)).numpy(), atol=1e-6)


def test_unified_model_codec_embedding(tmp_path):
    jm, jv, tm = model_pair("all", MINI, tmp_path / "all.npz")
    x, t = _inputs(size=16, seed=2)
    for cid in (0, 2):
        want = np.asarray(japply(jm, jv, jnp.asarray(x), jnp.asarray(t),
                                 codec_id=jnp.asarray(cid)))
        got = tm(torch.from_numpy(x), torch.from_numpy(t), codec_id=cid)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="codec_id"):
        tm(torch.from_numpy(x), torch.from_numpy(t))


def test_time_embedding_matches(tiny_pair):
    jm, jv, tm = tiny_pair
    t = np.linspace(0, 1, 7).astype(np.float32)
    want = np.asarray(JTime(jm.cfg.time_dim).apply(
        {"params": jv["params"]["time_embed"]}, jnp.asarray(t)))
    np.testing.assert_allclose(tm.time_embed(torch.from_numpy(t)).numpy(), want, atol=1e-5)


def test_bf16_policy(tmp_path):
    """bf16 body, f32 norms / time embedding / head, f32 output. The two
    frameworks round to bf16 at different places, so the bf16 models are
    held to the f32 JAX model on the same weights: the port's bf16 error is
    at most 1.25x the JAX package's own bf16 error (mean over the output)."""
    from ddpm_image_restoration_tpu.models import build_model as jax_build_model

    cfg = dataclasses.replace(MINI, compute_dtype="bfloat16")
    jm, jv, tm = model_pair("webp", cfg, tmp_path / "bf16.npz")
    x, t = _inputs(size=16, seed=3)
    assert tm.down1.attn.qkv.weight.dtype == torch.bfloat16
    assert tm.down1.freq_guide.conv_out.weight.dtype == torch.bfloat16
    assert tm.time_embed.proj_in.weight.dtype == torch.float32
    assert tm.down1.norm2.weight.dtype == torch.float32
    got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32
    ref32 = np.asarray(japply(jax_build_model("webp", MINI), jv, jnp.asarray(x), jnp.asarray(t)))
    jax16 = np.asarray(japply(jm, jv, jnp.asarray(x), jnp.asarray(t)))
    err_port = np.abs(got.numpy() - ref32).mean()
    err_jax = np.abs(jax16 - ref32).mean()
    assert 0 < err_port <= 1.25 * err_jax, (err_port, err_jax)


def _flax_block_pair(jax_module, torch_module, inputs, seed):
    """Init the Flax module on `inputs` (NHWC), copy its parameters into
    the port's module through the release-npz mapping; returns (the Flax
    params, their flat '/'-keyed numpy copy)."""
    from flax.traverse_util import flatten_dict

    from ddpm_image_restoration_tpu_torch.train.checkpoint import params_from_jax

    params = jax_module.init(jax.random.PRNGKey(seed), *inputs)["params"]
    flat = {k: np.array(v) for k, v in flatten_dict(params, sep="/").items()}
    torch_module.load_state_dict(params_from_jax(flat), strict=True)
    return params, flat


# (H, W): not a block multiple; the 4x4 deepest encoder level of the 64²
# model (the 8-pooled gate is upsampled, then shrunk back with the
# antialiased resize); the 2x2 bottleneck; 32² (exact pooling)
AVIF_SIZES = [(12, 20), (4, 4), (2, 2), (32, 32)]


@pytest.mark.parametrize("hw", AVIF_SIZES)
def test_avif_adaptive_transform_matches(hw):
    """`AVIFAdaptiveTransform` against the Flax module on its own init,
    f32 (atol 1e-5); its `transform_weights` leaf passes the npz mapping
    unchanged ([C, bs, bs])."""
    from ddpm_image_restoration_tpu.models.freq_blocks import AVIFAdaptiveTransform as JT
    from ddpm_image_restoration_tpu_torch.models.freq_blocks import AVIFAdaptiveTransform

    c = 8
    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, c)).astype(np.float32)
    jm, tm = JT(c, 8), AVIFAdaptiveTransform(c, 8)
    params, flat = _flax_block_pair(jm, tm, (jnp.asarray(x),), seed=hw[1])
    np.testing.assert_array_equal(tm.transform_weights.detach().numpy(),
                                  flat["transform_weights"])
    assert flat["transform_weights"].shape == (c, 8, 8)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = nchw_to_nhwc(tm(torch.from_numpy(x).permute(0, 3, 1, 2)).detach())
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw", AVIF_SIZES)
def test_avif_freq_block_matches(hw):
    """`AVIFFreqAwareBlock` against the Flax module, f32, with per-sample
    compression levels on both sides of the boost clamps (atol 1e-5)."""
    from ddpm_image_restoration_tpu.models.freq_blocks import AVIFFreqAwareBlock as JB
    from ddpm_image_restoration_tpu_torch.models.freq_blocks import AVIFFreqAwareBlock

    c = 16
    rng = np.random.default_rng(10 + hw[0])
    x = rng.standard_normal((3, *hw, c)).astype(np.float32)
    lvl = np.array([0.0, 0.5, 1.0], np.float32)
    jm = JB(c, 8, (0.3, 1.5), (0.5, 1.3))
    tm = AVIFFreqAwareBlock(c, 8, (0.3, 1.5), (0.5, 1.3))
    params, _ = _flax_block_pair(jm, tm, (jnp.asarray(x), jnp.asarray(lvl)), seed=hw[0])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(lvl)))
    got = nchw_to_nhwc(tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(lvl)).detach())
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def avif_pair(tmp_path_factory):
    """The avif preset at TINY5 (8 heads, AVIF frequency blocks at every
    level, 1x1 bottleneck), flash attention at <= 32²."""
    cfg = dataclasses.replace(TINY5, attention_impl="flash", attn_max_resolution=32)
    return model_pair("avif", cfg, tmp_path_factory.mktemp("a") / "avif.npz")


def test_avif_bf16_policy(tmp_path):
    """The avif preset in bf16, held as `test_bf16_policy` holds the webp
    one: the port's bf16 error against the f32 JAX model is at most 1.25x
    the JAX package's own bf16 error; the transform weights are in bf16
    with the block body."""
    from ddpm_image_restoration_tpu.models import build_model as jax_build_model

    cfg = dataclasses.replace(MINI, compute_dtype="bfloat16")
    jm, jv, tm = model_pair("avif", cfg, tmp_path / "avif16.npz")
    x, t = _inputs(size=16, seed=7)
    assert tm.down1.freq_guide.adaptive_transform.transform_weights.dtype == torch.bfloat16
    got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32
    ref32 = np.asarray(japply(jax_build_model("avif", MINI), jv, jnp.asarray(x), jnp.asarray(t)))
    jax16 = np.asarray(japply(jm, jv, jnp.asarray(x), jnp.asarray(t)))
    err_port = np.abs(got.numpy() - ref32).mean()
    err_jax = np.abs(jax16 - ref32).mean()
    assert 0 < err_port <= 1.25 * err_jax, (err_port, err_jax)


def test_avif_model_call_matches(avif_pair):
    jm, jv, tm = avif_pair
    assert tm.down2.attn.num_heads == 8
    assert type(tm.down1.freq_guide).__name__ == "AVIFFreqAwareBlock"
    x, t = _inputs(seed=5)
    want = np.asarray(japply(jm, jv, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_avif_model_encode_decode_matches(avif_pair):
    jm, jv, tm = avif_pair
    x, t = _inputs(seed=6)
    lvl = np.array([0.05, 0.95], np.float32)
    skips_j, h_j = japply(jm, jv, jnp.asarray(x), jnp.asarray(t), jnp.asarray(lvl),
                          method="encode")
    skips_t, h_t = tm.encode(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(lvl))
    for a, b in zip(skips_t, skips_j):
        np.testing.assert_allclose(nchw_to_nhwc(a), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(nchw_to_nhwc(h_t), np.asarray(h_j), atol=ATOL)
    want = np.asarray(japply(jm, jv, (skips_j, h_j), jnp.asarray(t), jnp.asarray(lvl),
                             method="decode"))
    got = tm.decode((skips_t, h_t), torch.from_numpy(t), torch.from_numpy(lvl))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cuda_requested_without_card_raises():
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model("webp", ModelConfig(**dataclasses.asdict(MINI)))


@pytest.mark.slow
def test_release_npz_full_width_matches():
    """The WebP release weights at full width (f32, 64², flash at <= 32²):
    one forward of the port against the JAX model on the same npz."""
    import os

    from ddpm_image_restoration_tpu.config import ModelConfig
    from ddpm_image_restoration_tpu.models import build_model as jax_build_model
    from ddpm_image_restoration_tpu.train.checkpoint import load_release_params as jax_load
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.checkpoint import load_release_params
    from tests._torch_parity import torch_cfg

    npz = os.path.join(os.path.dirname(__file__), "..", "artifacts_release", "webp_real_r5.npz")
    if not os.path.exists(npz):
        pytest.skip("artifacts_release/webp_real_r5.npz is not in this checkout")
    cfg = ModelConfig(compute_dtype="float32", attention_impl="flash", attn_max_resolution=32)
    jm = jax_build_model("webp", cfg)
    tm = build_model("webp", torch_cfg(cfg), device="cpu")
    tm.load_state_dict(load_release_params(npz), strict=True)
    x, t = _inputs(n=1, size=64, seed=4)
    want = np.asarray(japply(jm, {"params": jax_load(npz)}, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
