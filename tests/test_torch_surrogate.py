"""The port's codec surrogate against the JAX package's over each codec's
calibration quality grid, f32. atol 1e-5: both round the same quantised
coefficients; only float summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.codecs import surrogate as jsur
from ddpm_image_restoration_tpu_torch.codecs import surrogate as tsur
from tests._torch_parity import smooth_images

torch.set_num_threads(1)


def _table_boundary_qualities(codec, qs):
    """Qualities at which the jitted JAX quant tables differ from the exact
    ones, checked to be rounding-boundary cases: XLA computes `scale / 100`
    as a multiply by 0.01, so an entry whose exact value is k + 0.5 (where
    floor(x + 0.5) must give k + 1, as libjpeg's integer formula does) can
    come out as k. The port divides, as the JAX code is written."""
    quirk = np.zeros(len(qs), bool)
    for base in jsur._base_tables(codec):
        tj = np.asarray(jax.jit(jsur._scaled_table)(jnp.asarray(base), jnp.asarray(qs)))
        tt = tsur._scaled_table(torch.from_numpy(base), torch.from_numpy(qs)).numpy()
        exact = base.astype(np.float64) * np.asarray(
            jsur.jpeg_quality_scale(jnp.asarray(qs)), np.float64)[:, None, None] / 100.0
        off = tj != tt
        assert np.all(tt[off] - tj[off] == 1)
        assert np.allclose((exact + 0.5)[off], np.round(exact + 0.5)[off], atol=1e-4)
        quirk |= off.reshape(len(qs), -1).any(axis=1)
    return quirk


@pytest.mark.parametrize("codec", ["jpeg", "webp", "avif"])
def test_surrogate_over_calibration_grid(codec):
    """One image per quality, f32. Every calibration knot, the midpoints
    between knots and both clamped ends against the JAX code run as written
    (jit disabled); the knots and ends also against the jitted JAX
    surrogate (the production path), except where its quant table hits the
    rounding quirk above (logged in ROADMAP.md, Queue 3)."""
    grid = np.asarray(jsur._CALIBRATION[codec][0], np.float32)
    knots = np.concatenate([grid, [0.0, 120.0]]).astype(np.float32)
    every = np.concatenate([knots, (grid[:-1] + grid[1:]) / 2]).astype(np.float32)
    x = smooth_images(len(every), 16, seed=1)
    got = tsur.codec_surrogate(torch.from_numpy(x), torch.from_numpy(every), codec=codec).numpy()
    with jax.disable_jit():
        want = np.asarray(jsur.codec_surrogate(jnp.asarray(x), jnp.asarray(every), codec=codec))
    np.testing.assert_allclose(got, want, atol=1e-5)
    n = len(knots)
    want_jit = np.asarray(jsur.codec_surrogate(jnp.asarray(x[:n]), jnp.asarray(knots),
                                               codec=codec))
    ok = ~_table_boundary_qualities(codec, knots)
    assert ok.sum() >= n - 4
    np.testing.assert_allclose(got[:n][ok], want_jit[ok], atol=1e-5)


@pytest.mark.parametrize("codec", ["webp", "jpeg"])
def test_surrogate_scalar_quality_no_subsample_and_dtype(codec):
    x = smooth_images(2, 16, seed=2)
    want = np.asarray(jsur.codec_surrogate(jnp.asarray(x), 30, codec=codec, subsample=False))
    got = tsur.codec_surrogate(torch.from_numpy(x), 30, codec=codec, subsample=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got16 = tsur.codec_surrogate(torch.from_numpy(x).to(torch.bfloat16), 30, codec=codec)
    assert got16.dtype == torch.bfloat16


def test_interp_matches_numpy():
    xp, fp = [1.0, 5.0, 10.0, 100.0], [0.5, 2.0, -1.0, 3.0]
    x = np.array([-3.0, 1.0, 2.5, 5.0, 7.0, 10.0, 99.0, 100.0, 200.0], np.float32)
    np.testing.assert_allclose(tsur.interp(torch.from_numpy(x), xp, fp).numpy(),
                               np.interp(x, xp, fp), atol=1e-6)


def test_block_dct_roundtrip_and_tables():
    x = torch.from_numpy(smooth_images(1, 16)[..., 0])
    for b in (4, 8):
        c = tsur.block_dct2(x, b)
        np.testing.assert_allclose(c.numpy(), np.asarray(jsur.block_dct2(jnp.asarray(x.numpy()), b)),
                                   atol=1e-5)
        np.testing.assert_allclose(tsur.block_idct2(c, 16, 16).numpy(), x.numpy(), atol=1e-5)
    for codec in ("jpeg", "webp", "avif"):
        for a, b in zip(tsur._base_tables(codec), jsur._base_tables(codec)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsur._base_tables("png")
