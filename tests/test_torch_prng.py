"""The port's numpy copy of the JAX PRNG (`evaluation/prng.py`) against
`jax.random` itself: keys, splits and raw bits exactly; uniforms exactly;
normals within 5e-5 absolute (XLA's float32 erfinv against the float64 one)
at the shapes the metric backbones draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu_torch.evaluation import prng

torch.set_num_threads(1)

SEEDS = [0, 7, 99, 123456789, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_exact(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.prng_key(seed)
    np.testing.assert_array_equal(mine, np.asarray(key))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(mine, num), np.asarray(jax.random.split(key, num)))
    for shape in ((7,), (3, 5), (2, 3, 4, 5)):
        np.testing.assert_array_equal(prng.random_bits(mine, shape),
                                      np.asarray(jax.random.bits(key, shape)))
    lo = np.nextafter(np.float32(-1.0), np.float32(1.0))
    np.testing.assert_array_equal(
        prng.uniform(mine, (1000,), lo, 1.0),
        np.asarray(jax.random.uniform(key, (1000,), jnp.float32, lo, 1.0)))
    np.testing.assert_array_equal(prng.uniform(mine, (4, 9)),
                                  np.asarray(jax.random.uniform(key, (4, 9))))


def _chain(seed, shapes):
    """Both packages' draws for the backbones' pattern: split the key, draw
    from the second half, carry the first."""
    jkey, key = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in shapes:
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        np.testing.assert_array_equal(sub, np.asarray(jsub))
        yield prng.normal(sub, shape), np.asarray(jax.random.normal(jsub, shape, jnp.float32))


@pytest.mark.parametrize("seed,shapes", [
    # the LPIPS proxy pyramid (lpips.py:90-100)
    (7, [(11, 11, 3, 64), (5, 5, 64, 192), (3, 3, 192, 384), (3, 3, 384, 256), (3, 3, 256, 256)]),
    # the FD extractor (fid.py:61-70)
    (0, [(3, 3, 3, 24), (3, 3, 24, 48), (3, 3, 48, 96), (3, 3, 96, 192)]),
])
def test_normals_at_backbone_shapes(seed, shapes):
    for got, want in _chain(seed, shapes):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
        assert abs(float(got.std()) - 1.0) < 0.05
