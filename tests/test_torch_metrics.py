"""The port's evaluation metrics against the JAX package's on the same
images (CPU): LPIPS (the seeded proxy, and the canonical AlexNet path on a
seeded stand-in npz), the random-conv Fréchet features, the Fréchet
statistics and distance, and the harness's per-image PSNR / SSIM / L2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.evaluation import fid as jfid
from ddpm_image_restoration_tpu.evaluation import harness as jharness
from ddpm_image_restoration_tpu.evaluation import lpips as jlpips
from ddpm_image_restoration_tpu_torch.evaluation import fid, harness, lpips

torch.set_num_threads(1)


def _pair(rng, n, size, noise=0.1):
    a = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal(a.shape).astype(np.float32), -1, 1)
    return a, b


@pytest.mark.parametrize("size", [16, 37, 64])
def test_lpips_proxy_matches_jax(rng, size):
    """The proxy pyramid's distances, rtol 1e-4: the same kernels (drawn
    from jax.random's key 7) and XLA's asymmetric "SAME" padding (at 64²
    and k=11, s=4: 3 rows before, 4 after; 37 is odd at every stride)."""
    a, b = _pair(rng, 3, size)
    want = np.asarray(jlpips.LPIPS(weights_path=None)(a, b))
    mine = lpips.LPIPS(weights_path=None, device="cpu")
    assert mine.name == "lpips_proxy"
    got = mine(a, b)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # tensors in, the same distances; identical images are at distance 0
    np.testing.assert_allclose(mine(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               got.numpy(), rtol=1e-6)
    assert float(mine(a, a).abs().max()) == 0.0


def _alex_npz(path, rng, linear_only=False):
    """A seeded stand-in for weights/lpips_alex.npz in its layout (AlexNet
    conv{i}_w HWIO, conv{i}_b, lin{i}); the canonical weights are not in
    the repository."""
    chans = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
    arrays = {}
    for i, (ci, co, k) in enumerate(chans):
        arrays[f"conv{i}_w"] = (0.05 * rng.standard_normal((k, k, ci, co))).astype(np.float32)
        arrays[f"conv{i}_b"] = (0.01 * rng.standard_normal(co)).astype(np.float32)
        arrays[f"lin{i}"] = rng.uniform(0, 1, co).astype(np.float32)
    if linear_only:
        arrays = {k: v for k, v in arrays.items() if k.startswith("lin")}
    np.savez(path, **arrays)
    return str(path)


def test_lpips_canonical_path_matches_jax(rng, tmp_path, monkeypatch):
    """The AlexNet topology, the input scaling and the learned linear
    calibration on a stand-in npz, rtol 1e-4; the probe finds the npz
    through $DDPM_IR_LPIPS_WEIGHTS in both packages."""
    npz = _alex_npz(tmp_path / "alex.npz", rng)
    a, b = _pair(rng, 2, 64)
    want = np.asarray(jlpips.LPIPS(weights_path=npz)(a, b))
    mine = lpips.LPIPS(weights_path=npz, device="cpu")
    assert mine.name == "lpips_alex"
    np.testing.assert_allclose(mine(a, b).numpy(), want, rtol=1e-4)
    monkeypatch.setenv("DDPM_IR_LPIPS_WEIGHTS", npz)
    assert lpips.LPIPS(device="cpu").name == jlpips.LPIPS().name == "lpips_alex"
    monkeypatch.setenv("DDPM_IR_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert lpips.LPIPS(device="cpu").name == jlpips.LPIPS().name


def test_lpips_linear_calibration_on_proxy_matches_jax(rng, tmp_path):
    """The legacy `linear_weights_path`: a calibration on the proxy
    backbone, named 'lpips' in both; rtol 1e-4."""
    npz = _alex_npz(tmp_path / "lin.npz", rng, linear_only=True)
    a, b = _pair(rng, 2, 32)
    want = np.asarray(jlpips.LPIPS(weights_path=None, linear_weights_path=npz)(a, b))
    mine = lpips.LPIPS(weights_path=None, linear_weights_path=npz, device="cpu")
    assert mine.name == "lpips"
    np.testing.assert_allclose(mine(a, b).numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("size,dim", [(16, 192), (64, 192), (20, 32)])
def test_random_conv_features_match_jax(rng, size, dim):
    """Features [N, 2·dim] (global mean and max) within 1e-5 of the
    largest, in batches of 4 over 10 images."""
    x01 = rng.uniform(0, 1, (10, size, size, 3)).astype(np.float32)
    want = jfid.RandomConvFeatureExtractor(dim=dim)(x01, batch=4)
    ex = fid.RandomConvFeatureExtractor(dim=dim, device="cpu")
    got = ex(x01, batch=4)
    assert ex.name == "random_conv" and got.shape == (10, 2 * dim)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_frechet_statistics_and_distance_match_jax(rng):
    feats = rng.standard_normal((40, 12)).astype(np.float32)
    other = (rng.standard_normal((40, 12)) * 1.5 + 0.3).astype(np.float32)
    for a, b in zip(fid.compute_statistics(feats), jfid.compute_statistics(feats)):
        np.testing.assert_array_equal(a, b)
    s1, s2 = fid.compute_statistics(feats), fid.compute_statistics(other)
    assert fid.frechet_distance(*s1, *s2) == pytest.approx(jfid.frechet_distance(*s1, *s2),
                                                           rel=1e-9)
    assert fid.frechet_distance(*s1, *s1) == pytest.approx(0.0, abs=1e-6)
    # one image set: a singular covariance takes the eps-regularised path
    one = fid.compute_statistics(feats[:3])
    assert fid.frechet_distance(*one, *s2) == pytest.approx(jfid.frechet_distance(*one, *s2),
                                                            rel=1e-6)
    x = np.clip(0.5 + 0.2 * rng.standard_normal((24, 16, 16, 3)), 0, 1).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    got = fid.fid_between(x, y, fid.RandomConvFeatureExtractor(dim=32, device="cpu"))
    want = jfid.fid_between(x, y, jfid.RandomConvFeatureExtractor(dim=32))
    assert got == pytest.approx(want, rel=1e-3)
    assert fid.InceptionFeatureExtractor.available() == jfid.InceptionFeatureExtractor.available()


def test_per_image_metrics_match_jax(rng):
    """PSNR, SSIM and normalized L2 per image, [B] each: PSNR within 1e-4
    dB, SSIM and L2 within 1e-6."""
    a, b = _pair(rng, 5, 24, noise=0.05)
    b[0] = a[0]  # an exact pair: PSNR capped by the 1e-8 floor
    want = [np.asarray(w) for w in jharness._per_image_metrics(jnp.asarray(b), jnp.asarray(a))]
    got = [g.numpy() for g in harness._per_image_metrics(torch.from_numpy(b), torch.from_numpy(a))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    assert got[0][0] == pytest.approx(80.0, abs=1e-3)
