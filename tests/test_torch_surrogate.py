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
    """Qualities at which the jitted JAX quant tables differ from the ones
    the JAX code computes as written (jit disabled), checked to be
    rounding-boundary cases that the port shares with the jitted tables:
    XLA compiles `scale / 100` as a multiply by the f32 constant 0.01, so
    an entry whose exact value is k + 0.5 (where floor(x + 0.5) gives k + 1,
    as libjpeg's integer formula does) can come out as k. The port
    multiplies by the same constant: its tables equal the jitted ones bit
    for bit, and differ from the unjitted ones by -1 at such entries only."""
    edge = np.zeros(len(qs), bool)
    for base in jsur._base_tables(codec):
        tj = np.asarray(jax.jit(jsur._scaled_table)(jnp.asarray(base), jnp.asarray(qs)))
        tt = tsur._scaled_table(torch.from_numpy(base), torch.from_numpy(qs)).numpy()
        with jax.disable_jit():
            te = np.asarray(jsur._scaled_table(jnp.asarray(base), jnp.asarray(qs)))
        np.testing.assert_array_equal(tt, tj)
        exact = base.astype(np.float64) * np.asarray(
            jsur.jpeg_quality_scale(jnp.asarray(qs)), np.float64)[:, None, None] / 100.0
        off = tt != te
        assert np.all(tt[off] - te[off] == -1)
        assert np.allclose((exact + 0.5)[off], np.round(exact + 0.5)[off], atol=1e-4)
        edge |= off.reshape(len(qs), -1).any(axis=1)
    return edge


def test_scaled_table_equals_jitted_jax_bit_for_bit():
    """The port's quant tables against `jax.jit(_scaled_table)` at every
    integer quality 0-120 and every half quality 0.5-99.5 (the calibration
    grids' midpoints among them), for each base table of each codec: equal
    bit for bit (`_table_boundary_qualities` asserts it), and the qualities
    where both differ from the unjitted tables are the rounding edges
    recorded in ROADMAP.md (Queue 3)."""
    qs = np.concatenate([np.arange(0, 121), np.arange(0.5, 100, 1.0)]).astype(np.float32)
    edges = {codec: set(qs[_table_boundary_qualities(codec, qs)].tolist())
             for codec in ("jpeg", "webp", "avif")}
    grid = set(jsur._CALIBRATION["jpeg"][0])
    grid |= {(a + b) / 2 for a, b in zip(sorted(grid)[:-1], sorted(grid)[1:])}
    assert {c: sorted(e & grid) for c, e in edges.items()} == {
        "jpeg": [85.0, 92.5, 95.0], "webp": [92.5, 97.5],
        "avif": [70.0, 85.0, 90.0, 92.5, 95.0, 97.5]}


@pytest.mark.parametrize("codec", ["jpeg", "webp", "avif"])
def test_surrogate_over_calibration_grid(codec):
    """One image per quality, f32. Every calibration knot, the midpoints
    between knots and both clamped ends against the jitted JAX surrogate
    (the function the JAX package runs), with no exception; and against
    the JAX code run as written (jit disabled) at every quality except the
    quant-table rounding edges above (ROADMAP.md, Queue 3)."""
    grid = np.asarray(jsur._CALIBRATION[codec][0], np.float32)
    knots = np.concatenate([grid, [0.0, 120.0]]).astype(np.float32)
    every = np.concatenate([knots, (grid[:-1] + grid[1:]) / 2]).astype(np.float32)
    x = smooth_images(len(every), 16, seed=1)
    got = tsur.codec_surrogate(torch.from_numpy(x), torch.from_numpy(every), codec=codec).numpy()
    want_jit = np.asarray(jsur.codec_surrogate(jnp.asarray(x), jnp.asarray(every), codec=codec))
    np.testing.assert_allclose(got, want_jit, atol=1e-5)
    with jax.disable_jit():
        want = np.asarray(jsur.codec_surrogate(jnp.asarray(x), jnp.asarray(every), codec=codec))
    ok = ~_table_boundary_qualities(codec, every)
    assert ok.sum() >= len(every) - 6
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-5)


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


@pytest.mark.parametrize("codec", ["jpeg", "webp"])
def test_surrogate_gradient_matches_jax_grad(codec):
    """The input gradient of sum(w · codec_surrogate(x, q)) against jax.grad
    of the JAX surrogate run as written (jit disabled), f32, within 1e-5 of
    the largest entry. Rounding is straight-through in both (JAX's
    `ste_round`); a plain round would make the gradient 0 everywhere. The
    qualities keep clear of the quant-table rounding edges (92.5, 97.5)."""
    rng = np.random.default_rng(7)
    x = smooth_images(2, 16, seed=3)
    w = rng.normal(size=x.shape).astype(np.float32)
    qs = np.array([20.0, 55.0], np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * tsur.codec_surrogate(xt, torch.from_numpy(qs), codec=codec)).sum().backward()
    got = xt.grad.numpy()
    with jax.disable_jit():
        want = np.asarray(jax.grad(lambda z: jnp.sum(jnp.asarray(w) * jsur.codec_surrogate(
            z, jnp.asarray(qs), codec=codec)))(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
