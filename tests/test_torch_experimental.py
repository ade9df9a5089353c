"""The port's experimental model family and DDPM/DDIM schedule against the
JAX package's (CPU, f32, small widths): each model with its weights carried
across by `params_to_jax`, on the same seeded inputs (NCHW in the port,
NHWC in JAX); every `ddpm_schedule` function, and the DDPM and DDIM chains
over those models from the same key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ddpm_image_restoration_tpu.diffusion import ddpm_schedule as jds
from ddpm_image_restoration_tpu.models import experimental as jexp
from ddpm_image_restoration_tpu_torch.diffusion import ddpm_schedule as ds
from ddpm_image_restoration_tpu_torch.evaluation import prng
from ddpm_image_restoration_tpu_torch.models import experimental as exp
from ddpm_image_restoration_tpu_torch.train.checkpoint import params_from_jax, params_to_jax
from tests._torch_parity import nchw_to_nhwc

torch.set_num_threads(1)

# f32 convolutions, dense layers and DCTs of two libraries, a few layers deep
ATOL = 2e-5


def carried(torch_model, jax_model, *jax_inputs, seed=0, **jax_kw):
    """`torch_model` with seeded weights (PyTorch's init, seeded noise on
    the biases and norm scales) and the JAX variables holding the same
    values through `params_to_jax`, checked against the Flax model's own
    parameter tree (`jax.eval_shape` of its init)."""
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in torch_model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape))
    flat = params_to_jax(torch_model)
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    want = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), *jax_inputs, **jax_kw))
    got = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want["params"])
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(got),
                                                    jax.tree_util.tree_leaves(want["params"])))
    # and back: the carried weights load into the port's model unchanged
    state = params_from_jax(flat)
    assert all(torch.equal(state[k], v) for k, v in torch_model.state_dict().items())
    return {"params": params}


def images(shape, seed=0):
    return np.clip(np.random.default_rng(seed).normal(0, 0.4, shape), -1, 1).astype(np.float32)


def both(torch_model, jax_model, variables, x_nhwc, *args, **kw):
    """(port output in NHWC, JAX output) on the same inputs."""
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x_nhwc), *args, **kw))
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    tkw = {k: torch.as_tensor(np.asarray(v)) for k, v in kw.items()}
    with torch.no_grad():
        got = torch_model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2), *targs, **tkw)
    return nchw_to_nhwc(got), want


def test_mlp_denoiser_matches_jax():
    x = images((2, 8, 8, 3))
    t = np.array([50.0, 3.0], np.float32)
    tm, jm = exp.MLPDenoiser(image_size=8, hidden=(32, 48, 24), t_dim=16), \
        jexp.MLPDenoiser(image_size=8, hidden=(32, 48, 24), t_dim=16)
    v = carried(tm, jm, jnp.asarray(x), jnp.zeros(2))
    got, want = both(tm, jm, v, x, t)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got).max() <= 1.0


@pytest.mark.parametrize("cls", ["SimpleConvUNet", "DCTDenoiser"])
def test_conv_unets_match_jax(cls):
    x = images((2, 16, 16, 3), seed=1)
    t = np.array([0.3, 10.0], np.float32)
    kw = dict(widths=(8, 16, 16), time_dim=32)
    tm, jm = getattr(exp, cls)(**kw), getattr(jexp, cls)(**kw)
    v = carried(tm, jm, jnp.asarray(x), jnp.zeros(2), seed=1)
    got, want = both(tm, jm, v, x, t)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cls", ["HFCM", "ExperimentalFreqAwareBlock"])
@pytest.mark.parametrize("level", [None, "vector"])
@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_frequency_modules_match_jax(cls, level, hw):
    """With and without a per-sample compression level; 12x20 is padded to
    the 8x8 blocks and cropped."""
    x = images((2, *hw, 6), seed=2)
    tm, jm = getattr(exp, cls)(6), getattr(jexp, cls)(6)
    v = carried(tm, jm, jnp.asarray(x), seed=2)
    lvl = {} if level is None else {"compression_level": np.array([0.2, 0.9], np.float32)}
    got, want = both(tm, jm, v, x, **lvl)
    np.testing.assert_allclose(got, want, atol=ATOL)


SMALL_SFU = dict(widths=(8, 8, 16, 16, 16), bottleneck=(16, 24, 16), time_dim=16)


@pytest.fixture(scope="module")
def sfu():
    x = images((2, 32, 32, 3), seed=3)
    tm, jm = exp.SelectiveFreqUNet(**SMALL_SFU), jexp.SelectiveFreqUNet(**SMALL_SFU)
    return tm, jm, carried(tm, jm, jnp.asarray(x), jnp.zeros(2), seed=3), x


@pytest.mark.parametrize("level", [None, "given"])
def test_selective_freq_unet_matches_jax(sfu, level):
    """Frequency guidance at down2/down3, bottleneck1/3, up2/up3 (a 1x1
    bottleneck padded to the DCT block); the compression level defaults to
    t, or is given."""
    tm, jm, v, x = sfu
    t = np.array([0.25, 0.8], np.float32)
    lvl = {} if level is None else {"compression_level": np.array([0.9, 0.1], np.float32)}
    got, want = both(tm, jm, v, x, t, **lvl)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert {"down2.hfcm.mask_conv.weight", "bottleneck3.freq.se.weight",
            "up3.freq.freq_conv.weight", "up1.shortcut.weight"} <= set(tm.state_dict())
    assert not any(k.startswith(("down1.hfcm", "bottleneck2.freq", "up4.hfcm"))
                   for k in tm.state_dict())


def test_schedule_matches_jax():
    """linspace and cumprod in f32: rtol 1e-6 (an ulp apart where the two
    libraries round differently); the timestep map exactly; the ε target
    and the posterior step atol 1e-5."""
    for T in (100, 20):
        s, js = ds.make_ddpm_schedule(T), jds.make_ddpm_schedule(T)
        assert s.T == js.T == T
        for a, b in zip(s, js):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    q = np.array([1, 30, 100])
    np.testing.assert_array_equal(ds.quality_to_timestep(q).numpy(),
                                  np.asarray(jds.quality_to_timestep(q)))
    assert int(ds.quality_to_timestep(100)) == 1
    s, js = ds.make_ddpm_schedule(100), jds.make_ddpm_schedule(100)
    x0, xt = images((2, 8, 8, 3), 4), images((2, 8, 8, 3), 5)
    t = np.array([50, 3], np.int32)
    eps = ds.ddpm_noise_target(torch.from_numpy(x0), torch.from_numpy(xt), torch.from_numpy(t), s)
    want = jds.ddpm_noise_target(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t), js)
    np.testing.assert_allclose(eps.numpy(), np.asarray(want), atol=1e-5)
    step = ds.ddpm_posterior_step(torch.from_numpy(xt), eps, torch.from_numpy(t), s)
    want = jds.ddpm_posterior_step(jnp.asarray(xt), want, jnp.asarray(t), js)
    np.testing.assert_allclose(step.numpy(), np.asarray(want), atol=1e-5)
    for mode in ("cosine", "linear"):
        tt = np.linspace(0, 1, 7, dtype=np.float32)
        np.testing.assert_allclose(ds.cosine_quality_schedule(tt, mode).numpy(),
                                   np.asarray(jds.cosine_quality_schedule(tt, mode)),
                                   atol=1e-5)
    assert ds.ddim_grid(70, 5).tolist() == [[70, 53], [53, 36], [36, 18], [18, 1], [1, 0]]


def test_ddpm_inference_matches_jax():
    """The full posterior chain (T = 6) over an MLPDenoiser: atol 1e-4 (the
    chain divides by √α_t each step)."""
    x = images((2, 8, 8, 3), 6)
    kw = dict(image_size=8, hidden=(32, 32, 32), t_dim=16)
    tm, jm = exp.MLPDenoiser(**kw), jexp.MLPDenoiser(**kw)
    v = carried(tm, jm, jnp.asarray(x), jnp.zeros(2), seed=4)
    want = jds.ddpm_inference(jm.apply, v, jnp.asarray(x), T=6)
    got = ds.ddpm_inference(tm, torch.from_numpy(x).permute(0, 3, 1, 2), T=6)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("model", ["SimpleConvUNet", "SelectiveFreqUNet"])
def test_ddim_inference_matches_jax(sfu, model, eta):
    """DDIM over T = 20 on a 4-point grid from the same key (3): at eta 0.5
    the noise is JAX's (drawn in NHWC order); atol 1e-4."""
    if model == "SelectiveFreqUNet":
        tm, jm, v, x = sfu
    else:
        x = images((2, 16, 16, 3), 7)
        kw = dict(widths=(8, 16, 16), time_dim=32)
        tm, jm = exp.SimpleConvUNet(**kw), jexp.SimpleConvUNet(**kw)
        v = carried(tm, jm, jnp.asarray(x), jnp.zeros(2), seed=5)
    want = jds.ddim_inference(jm.apply, v, jnp.asarray(x), T=20, n_steps=4, eta=eta,
                              key=jax.random.PRNGKey(3))
    got = ds.ddim_inference(tm, torch.from_numpy(x).permute(0, 3, 1, 2), T=20, n_steps=4,
                            eta=eta, key=prng.prng_key(3))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), atol=1e-4)


def test_ddim_exact_with_true_eps():
    """With the trajectory's true constant ε, DDIM at eta 0 recovers x0 on
    the full grid and on a 5-step grid (the JAX package's own check)."""
    T, s = 20, ds.make_ddpm_schedule(20)
    x0 = torch.from_numpy(images((2, 3, 8, 8), 8))
    eps = torch.from_numpy(np.random.default_rng(9).standard_normal(x0.shape).astype("f"))
    ab = s.alpha_bars[T - 1]
    xT = torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * eps
    for n in (T, 5):
        out = ds.ddim_inference(lambda x, t: eps, xT, T=T, n_steps=n, eta=0.0, sched=s)
        np.testing.assert_allclose(out.numpy(), x0.numpy(), atol=1e-4)


@pytest.mark.slow
def test_selective_freq_unet_release_widths_match_jax():
    """The default (release) widths at 64², f32."""
    x = images((1, 64, 64, 3), 10)
    tm, jm = exp.SelectiveFreqUNet(), jexp.SelectiveFreqUNet()
    v = carried(tm, jm, jnp.asarray(x), jnp.zeros(1), seed=6)
    got, want = both(tm, jm, v, x, np.array([0.4], np.float32))
    np.testing.assert_allclose(got, want, atol=1e-4)
