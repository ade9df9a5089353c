"""The JAX PRNG that the metric backbones are drawn from, in numpy.

The LPIPS proxy (`evaluation/lpips.py`, key 7) and the Fréchet-distance
extractor (`evaluation/fid.py`, key 0) are fixed-seed random networks. The
JAX package draws them with `jax.random`; drawing them here with torch's RNG
would make another metric. So this module carries `PRNGKey(seed)`, `split`
and `normal` (float32) across:

  * Threefry-2x32, 20 rounds (Salmon et al., "Parallel random numbers: as
    easy as 1, 2, 3", SC 2011), as `jax.random`'s default implementation;
  * the counter layout of `jax_threefry_partitionable` (JAX's default since
    0.5): element i of a draw of shape S hashes the 64-bit counter i (the
    row-major index into S) split into (hi, lo) 32-bit words, and 32-bit
    draws are the XOR of the two output words;
  * uniforms as JAX makes them: the top 23 bits as the mantissa of a float
    in [1, 2), minus 1, scaled to [nextafter(-1, 1), 1);
  * normals as sqrt(2)·erfinv(u), erfinv in float64.

Keys and bits equal `jax.random`'s bit for bit; the normals differ from
XLA's float32 erfinv by its rounding (~1e-5 at the tails).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, c0: np.ndarray, c1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words (c0, c1) under the
    two-word key; returns the two output words (uint32 arrays)."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(c0, np.uint32) + ks[0]
    x1 = np.asarray(c1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = x0 ^ _rotl(x1, r)
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the seed's high and low 32-bit words."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _counters(shape) -> tuple:
    """The (hi, lo) words of the row-major iota over `shape`."""
    n = math.prod(shape)
    flat = np.arange(n, dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: [num, 2] uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit random words of `shape`, as `jax.random.bits(key, shape)`."""
    b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 uniforms in [minval, maxval), as `jax.random.uniform`."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """float32 standard normals, as `jax.random.normal(key, shape)`."""
    u = uniform(key, shape, np.nextafter(np.float32(-1.0), np.float32(1.0)), 1.0)
    z = torch.special.erfinv(torch.from_numpy(u.astype(np.float64))).numpy()
    return (np.sqrt(2.0) * z).astype(np.float32)
