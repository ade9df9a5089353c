"""The port's training losses, SSIM and quality metrics against the JAX
package's on the same seeded inputs: values and gradients with respect to
the prediction, f32, atol 1e-5 (the same f32 arithmetic in another order;
the SSIM window is applied as two banded f32 products in the port and as a
2-D convolution in JAX).

Image sides are powers of two, as the model's are. The angle term of the
FFT losses is discontinuous at the real-valued bins (DC and Nyquist) whose
real part is negative: their angle is +pi or -pi by the sign of the
imaginary part, which is exactly 0 mathematically. At power-of-two sides
both FFT libraries compute those bins exactly; at mixed-radix sides such as
24x20 the JAX package's FFT leaves a roundoff-sized imaginary part there, so
the two can differ by (2 pi)^2 per such bin and no port could match it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.diffusion import losses as jlosses
from ddpm_image_restoration_tpu.evaluation import metrics as jmetrics
from ddpm_image_restoration_tpu_torch.diffusion import losses as tlosses
from ddpm_image_restoration_tpu_torch.evaluation import metrics as tmetrics

torch.set_num_threads(1)

KINDS = ["frequency_aware", "avif_frequency_aware", "color_preservation", "hybrid", "huber"]


def _pair(rng, shape=(3, 32, 16, 3)):
    """A target in [-1,1] and a prediction near it (as a trained model's)."""
    target = np.tanh(rng.normal(0, 0.7, shape)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.15, shape), -1, 1).astype(np.float32)
    return pred, target


def _value_and_grad_torch(fn, pred, target):
    p = torch.from_numpy(pred).requires_grad_()
    val = fn(p, torch.from_numpy(target))
    (g,) = torch.autograd.grad(val, p)
    return val.item(), g.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_loss_value_and_grad_match(rng, kind):
    pred, target = _pair(rng)
    jv, jg = jax.value_and_grad(jlosses.loss_for_preset(kind))(jnp.asarray(pred),
                                                               jnp.asarray(target))
    tv, tg = _value_and_grad_torch(tlosses.loss_for_preset(kind), pred, target)
    np.testing.assert_allclose(tv, float(jv), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-5)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_value_and_grad_match(rng, size_average):
    pred, target = (x * 0.5 + 0.5 for x in _pair(rng, (2, 32, 32, 3)))

    def jfn(a, b):
        return jnp.sum(jlosses.ssim(a, b, size_average=size_average))

    def tfn(a, b):
        return tlosses.ssim(a, b, size_average=size_average).sum()

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(pred), jnp.asarray(target))
    tv, tg = _value_and_grad_torch(tfn, pred, target)
    np.testing.assert_allclose(tv, float(jv), atol=1e-5)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-5)


def test_metrics_match(rng):
    pred, target = _pair(rng, (4, 32, 32, 3))
    want = jmetrics.batch_metrics(jnp.asarray(pred), jnp.asarray(target))
    got = tmetrics.batch_metrics(torch.from_numpy(pred), torch.from_numpy(target))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), atol=1e-5, rtol=1e-6,
                                   err_msg=k)
    same = torch.from_numpy(target)
    np.testing.assert_allclose(tmetrics.psnr(same, same).item(), 80.0, rtol=1e-6)
