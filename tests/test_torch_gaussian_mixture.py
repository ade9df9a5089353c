"""The port's Gaussian-mixture solver against the JAX package's on the same
npz weights and the same key (MINI, f32, CPU): the SVD structure prior, and
`GaussianMixtureSampler.sample` with the SVD guidance and the phase
projection on and off, with and without noise, and on a unified model's
conditioning; plus the row blocks a data-parallel rank restores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate as jax_surrogate
from ddpm_image_restoration_tpu.config import get_preset as jax_preset
from ddpm_image_restoration_tpu.diffusion import gaussian_mixture as jgm
from ddpm_image_restoration_tpu_torch.config import codec_index, get_preset
from ddpm_image_restoration_tpu_torch.diffusion import gaussian_mixture as gm
from ddpm_image_restoration_tpu_torch.evaluation import prng
from tests._tiny import MINI
from tests._torch_parity import model_pair, smooth_images

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
@pytest.mark.parametrize("k_ratio", [1.0, 0.1, 0.7])
def test_svd_structure_preservation_matches_jax(hw, k_ratio):
    """Per image and channel, the top k singular values: atol 1e-5 (f32 SVDs
    of two libraries; the singular vectors of a plane agree up to sign,
    which the reconstruction cancels). At k_ratio 1.0 the prior is the
    image itself."""
    x = np.random.default_rng(3).normal(0, 0.5, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jgm.svd_structure_preservation(jnp.asarray(x), jnp.float32(k_ratio)))
    got = gm.svd_structure_preservation(torch.from_numpy(x), k_ratio)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if k_ratio == 1.0:
        np.testing.assert_allclose(got.numpy(), x, atol=1e-5)
    half = gm.svd_structure_preservation(torch.from_numpy(x).to(torch.bfloat16), k_ratio)
    assert half.dtype == torch.bfloat16


def test_svd_rank_truncates_in_float32():
    """k = int32(min(h, w) * k_ratio) with the product in float32: 0.7 is
    0.699999988 in float32, so 10 * 0.7 is 7 there but 6.99999988 in
    float64; and the rank never drops below 1."""
    assert gm.svd_rank(10, 30, np.float32(0.7)) == int(np.float32(10) * np.float32(0.7))
    assert gm.svd_rank(16, 16, np.float32(1) / np.float32(11)) == 1
    assert gm.svd_rank(16, 16, 0.0) == 1
    assert [gm.svd_rank(16, 16, np.float32(i) / np.float32(11)) for i in range(6, 11)] == \
        [int(np.float32(16) * (np.float32(i) / np.float32(11))) for i in range(6, 11)]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("w")
    y = np.array(jax_surrogate(jnp.asarray(smooth_images(2, 16, seed=4)), 30, codec="webp"))
    return {"webp": model_pair("webp", MINI, d / "webp.npz", seed=1),
            "all": model_pair("all", MINI, d / "all.npz", seed=2)}, y


# (codec, steps, phase, svd, guidance): steps 11 fires the SVD guidance at
# i = 10..6 and the phase projection at i = 10 and 5; steps 4 the guidance
# at i = 3 only and the phase never
CASES = [("webp", 11, True, True, 1.0), ("webp", 11, True, True, 0.0),
         ("webp", 11, False, False, 1.0), ("webp", 4, True, True, 1.0),
         ("all", 11, True, True, 1.0)]


@pytest.mark.parametrize("codec,steps,phase,svd,guidance", CASES)
def test_sample_matches_jax(pairs, codec, steps, phase, svd, guidance):
    """The same key (7) in both packages, so the same mixture choices and
    noise: atol 1e-4 (f32 model, SVD and FFT of two libraries; the noise's
    erfinv differs by ~1e-5 at the tails, times at most 0.1)."""
    models, y = pairs
    jm, jv, tm = models[codec]
    cid = codec_index("webp") if codec == "all" else None
    kw = dict(steps=steps, use_phase_consistency=phase, use_svd_guide=svd,
              guidance_scale=guidance)
    want = np.asarray(jgm.GaussianMixtureSampler(jm, jax_preset("webp"), codec_id=cid).sample(
        jv, jnp.asarray(y), key=jax.random.PRNGKey(7), **kw))
    smp = gm.GaussianMixtureSampler(tm, get_preset("webp"), codec_id=cid)
    got = smp.sample(torch.from_numpy(y), key=prng.prng_key(7), **kw)
    assert got.dtype == torch.float32 and got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if codec == "webp" and steps == 11 and guidance == 1.0 and svd:
        # the default key is PRNGKey(0); the sampler draws from no global RNG
        torch.manual_seed(0)
        a = smp.sample(torch.from_numpy(y), **kw)
        torch.manual_seed(1)
        b = smp.sample(torch.from_numpy(y), key=prng.prng_key(0), **kw)
        assert torch.equal(a, b) and not torch.allclose(a, got)


def test_rows_restore_what_the_whole_batch_gives(pairs):
    """A data-parallel rank's block of rows (the last one padded) comes out
    as in the whole batch's restore: every rank draws the whole batch's
    noise and one mixture choice per step."""
    models, y = pairs
    tm = models["webp"][2]
    y3 = torch.from_numpy(np.concatenate([y, y[:1] * 0.5]))
    smp = gm.GaussianMixtureSampler(tm, get_preset("webp"))
    whole = smp.sample(y3, steps=11)
    for rows in ((0, 2), (2, 4)):
        part = smp.sample(y3, steps=11, rows=rows)
        n = min(rows[1], 3) - rows[0]
        torch.testing.assert_close(part[:n], whole[rows[0]:rows[0] + n], atol=1e-5, rtol=0)
