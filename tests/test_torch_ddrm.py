"""The port's DDRM sampler (static schedule) against the JAX package's at
eta 0, the production setting, on the same npz weights (MINI, f32, CPU),
and its helpers against theirs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate as jax_surrogate
from ddpm_image_restoration_tpu.config import get_preset as jax_preset
from ddpm_image_restoration_tpu.diffusion import ddrm as jddrm
from ddpm_image_restoration_tpu.diffusion.policy import REAL_PHOTO_TRUST
from ddpm_image_restoration_tpu_torch.config import get_preset
from ddpm_image_restoration_tpu_torch.diffusion import ddrm
from tests._tiny import MINI
from tests._torch_parity import model_pair, smooth_images

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    jm, jv, tm = model_pair("webp", MINI, tmp_path_factory.mktemp("w") / "mini.npz", seed=1)
    x0 = smooth_images(2, 16, seed=4)
    y = np.array(jax_surrogate(jnp.asarray(x0), 10, codec="webp"))
    return jm, jv, tm, y


def _both(mini, quality, steps, **kw):
    jm, jv, tm, y = mini
    want = np.asarray(jddrm.DDRMSampler(jm, jax_preset("webp")).sample(
        jv, jnp.asarray(y), quality, steps, eta=0.0, **kw))
    got = ddrm.DDRMSampler(tm, get_preset("webp")).sample(
        torch.from_numpy(y), quality, steps, eta=0.0, **kw)
    return got.numpy(), want


def test_sample_stride_encoder_reuse_final_exact(mini):
    """steps 20, stride 5 -> 5 evaluations: two encoder-reuse groups of 2
    plus a tail of 1; q10 < 15 turns phase consistency on; the exact host
    codec makes the last projection. atol 1e-4 (f32 summation order)."""
    got, want = _both(mini, 10, 20, stride=5, encoder_reuse=2, final_exact=True)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sample_every_step_per_sample_quality_protect(mini):
    """stride 1 over 8 steps, a per-sample quality vector, the surrogate's
    own last projection and the quality-gated blend. atol 1e-3: eight
    chained UNet evaluations and phase projections in f32."""
    q = np.array([10.0, 60.0], np.float32)
    got, want = _both(mini, q, 8, encoder_reuse=1, final_exact=False, protect=(40.0, 90.0))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_noise_is_seeded_and_shaped(mini):
    _, _, tm, y = mini
    s = ddrm.DDRMSampler(tm, get_preset("webp"))
    run = [s.sample(torch.from_numpy(y), 30, 6, eta=0.85, final_exact=False,
                    generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    det = s.sample(torch.from_numpy(y), 30, 6, eta=0.0, final_exact=False)
    assert torch.equal(run[0], run[1]) and torch.isfinite(run[0]).all()
    assert not torch.equal(run[0], det)
    with pytest.raises(ValueError):
        s.sample(torch.from_numpy(y), 30, 6, encoder_reuse=0)


def test_solver_indices_match():
    for steps in (1, 2, 7, 20, 70, 80):
        for stride in (1, 2, 5, 6, 7, 100):
            np.testing.assert_array_equal(ddrm._solver_indices(steps, stride),
                                          jddrm._solver_indices(steps, stride))
            idx = ddrm._solver_indices(steps, stride)
            np.testing.assert_array_equal(ddrm._last_flags(idx), jddrm._last_flags(idx))


def test_blends_and_phase_match(rng):
    r = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    q = np.array([5.0, 50.0, 95.0], np.float32)
    rt, yt = torch.from_numpy(r), torch.from_numpy(y)
    np.testing.assert_allclose(ddrm.phase_consistency(rt, yt, 0.7).numpy(),
                               np.asarray(jddrm.phase_consistency(jnp.asarray(r), jnp.asarray(y), 0.7)),
                               atol=1e-5)
    for quality in (q, 30.0):
        np.testing.assert_allclose(
            ddrm.quality_gated_blend(rt, yt, torch.as_tensor(quality), 40.0, 90.0).numpy(),
            np.asarray(jddrm.quality_gated_blend(jnp.asarray(r), jnp.asarray(y), quality, 40.0, 90.0)),
            atol=1e-6)
    for codec in ("webp", "jpeg", "avif"):
        for beta in (0.25, 2.0, REAL_PHOTO_TRUST):
            # small rewrites so some windows are capped and some are not
            small = y + 0.03 * (r - y)
            np.testing.assert_allclose(
                ddrm.residual_trust_blend(torch.from_numpy(small), yt, torch.from_numpy(q),
                                          codec, beta=beta).numpy(),
                np.asarray(jddrm.residual_trust_blend(jnp.asarray(small), jnp.asarray(y), q,
                                                      codec, beta=beta)),
                atol=1e-5)
