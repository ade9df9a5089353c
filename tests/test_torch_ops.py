"""The port's DCT and resize ops against the JAX package's (NHWC there,
NCHW in the port), f32, atol 1e-5 (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._torch_parity import nchw_to_nhwc

from ddpm_image_restoration_tpu.ops import dct as jdct
from ddpm_image_restoration_tpu.ops import resize as jresize
from ddpm_image_restoration_tpu_torch.ops import dct, resize

torch.set_num_threads(1)


def _pair(rng, shape_nhwc):
    x = rng.normal(size=shape_nhwc).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("bs,hw", [(4, 16), (8, 16), (4, 12), (8, 12)])
def test_spatial_block_dct(rng, bs, hw):
    xj, xt = _pair(rng, (2, hw, hw, 5))
    np.testing.assert_allclose(nchw_to_nhwc(dct.spatial_block_dct(xt, bs)),
                               np.asarray(jdct.spatial_block_dct(xj, bs)), atol=1e-5)


@pytest.mark.parametrize("h,w,bs,low", [(16, 16, 4, 3), (16, 16, 8, 4), (12, 10, 8, 4)])
def test_low_freq_mask_and_groups(h, w, bs, low):
    np.testing.assert_array_equal(dct.low_freq_mask(h, w, bs, low)[0, 0].numpy(),
                                  np.asarray(jdct.low_freq_mask(h, w, bs, low))[0, :, :, 0])
    for c in (3, 6, 8, 12, 64, 1024):
        assert dct.adjusted_group_count(c) == jdct.adjusted_group_count(c)


def test_max_pool_and_upsample(rng):
    xj, xt = _pair(rng, (2, 8, 8, 3))
    np.testing.assert_allclose(nchw_to_nhwc(resize.max_pool_2x(xt)),
                               np.asarray(jresize.max_pool_2x(xj)), atol=0)
    np.testing.assert_allclose(nchw_to_nhwc(resize.upsample_2x_bilinear(xt)),
                               np.asarray(jresize.upsample_2x_bilinear(xj)), atol=1e-5)


@pytest.mark.parametrize("hw,out", [(8, 8), (8, 2), (8, 1), (4, 8), (6, 4)])
def test_adaptive_avg_pool(rng, hw, out):
    xj, xt = _pair(rng, (2, hw, hw, 3))
    np.testing.assert_allclose(nchw_to_nhwc(resize.adaptive_avg_pool(xt, out)),
                               np.asarray(jresize.adaptive_avg_pool(xj, out)), atol=1e-5)


@pytest.mark.parametrize("src,dst", [(8, 4), (8, 2), (4, 2), (2, 4), (1, 4), (8, 32), (5, 3)])
def test_resize_linear_matches_jax_image_resize(rng, src, dst):
    """`resize_linear` against jax.image.resize(..., "linear"), which
    antialiases when it shrinks (the AVIF block's gates: 8 -> 4 at the 4x4
    level, 8 -> 2 and 4 -> 2 at the 2x2 bottleneck); atol 1e-5. In bf16
    the shrinking filter runs in f32 and returns bf16."""
    xj, xt = _pair(rng, (2, src, src, 3))
    want = np.asarray(jax.image.resize(xj, (2, dst, dst, 3), method="linear"))
    np.testing.assert_allclose(nchw_to_nhwc(resize.resize_linear(xt, (dst, dst))), want,
                               atol=1e-5)
    got16 = resize.resize_linear(xt.to(torch.bfloat16), (dst, dst))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(nchw_to_nhwc(got16.float()), want, atol=3e-2)
