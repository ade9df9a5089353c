"""The port's DDRM sampler against the JAX package's at eta 0, the
production setting, on the same npz weights (MINI and TINY5, f32, CPU): the
static schedule, decoder reuse and the traced-budget solver; and its helpers
against theirs."""

import jax
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
from tests._tiny import MINI, TINY5
from tests._torch_parity import model_pair, smooth_images

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    jm, jv, tm = model_pair("webp", MINI, tmp_path_factory.mktemp("w") / "mini.npz", seed=1)
    x0 = smooth_images(2, 16, seed=4)
    y = np.array(jax_surrogate(jnp.asarray(x0), 10, codec="webp"))
    return jm, jv, tm, y


@pytest.fixture(scope="module")
def tiny5(tmp_path_factory):
    """Five decoder stages: at depth 1 and 2 the deep part is not empty."""
    jm, jv, tm = model_pair("webp", TINY5, tmp_path_factory.mktemp("w") / "tiny5.npz", seed=3)
    x0 = smooth_images(2, 32, seed=6)
    y = np.array(jax_surrogate(jnp.asarray(x0), 10, codec="webp"))
    return jm, jv, tm, y


def _both(pair, quality, steps, prediction="direct", **kw):
    jm, jv, tm, y = pair
    want = np.asarray(jddrm.DDRMSampler(jm, jax_preset("webp"), prediction=prediction).sample(
        jv, jnp.asarray(y), quality, steps, eta=0.0, **kw))
    got = ddrm.DDRMSampler(tm, get_preset("webp"), prediction=prediction).sample(
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


@pytest.mark.parametrize("traced_budget", [0, 6])
def test_residual_prediction_matches_jax(mini, traced_budget):
    """prediction='residual' (x̂ = x_t + the model's output), on the static
    schedule (steps 20, stride 5, encoder reuse 2) and on the traced budget
    (6 slots); atol 1e-4, as the direct runs."""
    got, want = _both(mini, 30, 20, prediction="residual", stride=5, encoder_reuse=2,
                      final_exact=False, traced_budget=traced_budget)
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError):
        ddrm.DDRMSampler(mini[2], get_preset("webp"), prediction="x0")


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


@pytest.mark.parametrize("encoder_reuse,depth", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_decoder_reuse_matches_jax(tiny5, encoder_reuse, depth):
    """steps 20, stride 4 -> 5 evaluations: with reuse 2 two groups and a
    tail of 1, with reuse 3 one group and a tail of 2; the deep decoder
    (up1..up{5-depth}) runs once per group. q10 turns phase consistency on.
    atol 1e-4 (f32 summation order)."""
    got, want = _both(tiny5, 10, 20, stride=4, encoder_reuse=encoder_reuse,
                      decoder_reuse_depth=depth, final_exact=False)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_decoder_reuse_refusals(mini):
    jm, jv, tm, y = mini
    yt = torch.from_numpy(y)
    for kw in (dict(decoder_reuse_depth=-1, encoder_reuse=2),
               dict(decoder_reuse_depth=1, encoder_reuse=1)):
        with pytest.raises(ValueError):
            ddrm.DDRMSampler(tm, get_preset("webp")).sample(yt, 30, 6, **kw)
        with pytest.raises(ValueError):
            jddrm.DDRMSampler(jm, jax_preset("webp")).sample(jv, jnp.asarray(y), 30, 6, **kw)


def test_budget_schedule_matches_jax():
    """Exact equality over init_t 1..100 (one mixed batch per budget)."""
    init_t = np.arange(1, 101, dtype=np.int32)
    for n_slots in (1, 5, 14):
        got = ddrm._budget_schedule(init_t, n_slots)
        want = jddrm._budget_schedule(jnp.asarray(init_t), n_slots)
        for g, w in zip(got, want):
            assert g.shape == (n_slots, 100)
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("pair_name,encoder_reuse,depth,final_exact", [
    ("mini", 2, 0, True), ("mini", 1, 0, False), ("tiny5", 3, 1, False)])
def test_traced_budget_mixed_quality_matches_jax(request, pair_name, encoder_reuse, depth,
                                                 final_exact):
    """14 slots on a q10 / q70 batch, each sample at its own init_t (80 and
    30 at 100 steps: strides 6 and 3, 14 and 10 evaluations), so the q70
    lane runs 4 unused slots; q10 is inside the WebP phase regime (q < 15),
    q70 is not, which the traced path gates per sample. Reuse 3 pads the 14
    slots to 15. atol 1e-4."""
    q = np.array([10.0, 70.0], np.float32)
    got, want = _both(request.getfixturevalue(pair_name), q, np.array([80, 30], np.int32),
                      traced_budget=14, encoder_reuse=encoder_reuse,
                      decoder_reuse_depth=depth, final_exact=final_exact)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_traced_budget_uniform_batch_equals_static(mini):
    """A quality-uniform batch: the traced budget equals the port's own
    static path at stride student_stride(init_t, N), at reuse 1 and 2 (the
    check of the JAX package's test_traced_budget_matches_static_budget)."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import student_stride

    _, _, tm, y = mini
    s = ddrm.DDRMSampler(tm, get_preset("webp"))
    yt = torch.from_numpy(y)
    for enc in (1, 2):
        for q, init_t in ((10, 9), (50, 6), (30, 80)):
            kw = dict(eta=0.0, encoder_reuse=enc, final_exact=False)
            static = s.sample(yt, q, init_t, stride=student_stride(init_t, 4), **kw)
            traced = s.sample(yt, q, init_t, traced_budget=4, **kw)
            np.testing.assert_allclose(traced.numpy(), static.numpy(), atol=1e-6,
                                       err_msg=f"enc={enc} q={q}")


def _grads_of(model, loss):
    """The parameters' gradients of `loss` (the model's grads cleared
    first, and again after), keyed by name."""
    for p in model.parameters():
        p.grad = None
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return grads


@pytest.mark.parametrize("encoder_reuse", [1, 2])
def test_run_and_its_gradients_match_jax(mini, encoder_reuse):
    """`DDRMSampler.run` against the JAX package's `build_run` at q30 over
    20 steps at stride 19 (2 evaluations, t = 19/20 and 0: each a step of
    its own, or one encoder-reuse group of 2): the surrogate-projected x_t,
    no exact final projection, atol 1e-5. Then every parameter's gradient
    of mean((run(y) - x0)²) against `jax.grad` of the same through
    `build_run`, within 1e-4 of the largest entry."""
    from tests._torch_parity import as_jax_layout, flatten_jax

    jm, jv, tm, y = mini
    x0 = smooth_images(2, 16, seed=4)
    eta_b = get_preset("webp").eta_b
    jrun = jddrm.DDRMSampler(jm, jax_preset("webp")).build_run(20, 19, encoder_reuse)

    def jax_loss(params):
        out = jrun({"params": params}, jnp.asarray(y), 30, jax.random.PRNGKey(0), 0.0, eta_b)
        return jnp.mean((out - x0) ** 2), out

    (want_loss, want), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jv["params"])
    tm.requires_grad_(True)
    try:
        got = ddrm.DDRMSampler(tm, get_preset("webp")).run(
            torch.from_numpy(y), 30, 20, 19, encoder_reuse, eta=0.0)[0]
        loss = torch.mean((got - torch.from_numpy(x0)) ** 2)
        grads = as_jax_layout(tm, _grads_of(tm, loss))
    finally:
        tm.requires_grad_(False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    jgrads = flatten_jax(jgrads)
    assert set(grads) == set(jgrads)
    g_max = max(np.abs(g).max() for g in jgrads.values())
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], g, atol=1e-4 * g_max, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def tiny5_flash(tmp_path_factory):
    """TINY5 with flash attention at 32² (T = 1024 at down1 and up5), so
    the differentiable run goes through the FlashAttention Function."""
    import dataclasses

    jmc = dataclasses.replace(TINY5, attention_impl="flash", attn_max_resolution=32)
    _, _, tm = model_pair("webp", jmc, tmp_path_factory.mktemp("w") / "flash.npz", seed=2)
    return tm, smooth_images(2, 32, seed=8)


@pytest.mark.parametrize("encoder_reuse,traced_budget", [(1, 0), (3, 0), (2, 4)])
def test_run_remat_equals_plain_run(tiny5_flash, encoder_reuse, traced_budget):
    """`run(remat=True)` against `run(remat=False)` at eta 0.5 with seeded
    noise (the recompute must replay the generator): the same x_t and x̂
    and the same gradients, bitwise on the CPU, and the generator left
    where the plain run leaves it. Steps 20 at stride 6 (4 evaluations:
    per step, or one group of 3 and a tail of 1), or a traced budget of 4
    slots in groups of 2, at q10 (phase consistency on)."""
    tm, x0 = tiny5_flash
    y = ddrm.codec_surrogate(torch.from_numpy(x0), 10, codec="webp")
    sampler = ddrm.DDRMSampler(tm, get_preset("webp"))
    results = []
    tm.requires_grad_(True)
    try:
        for remat in (False, True):
            gen = torch.Generator().manual_seed(5)
            x_t, x_theta = sampler.run(y, 10, 20, 6, encoder_reuse, traced_budget=traced_budget,
                                       eta=0.5, generator=gen, remat=remat)
            loss = (x_t ** 2).mean() + (x_theta * y).mean()
            results.append((x_t.detach(), x_theta.detach(), _grads_of(tm, loss), gen.get_state()))
    finally:
        tm.requires_grad_(False)
    (t0, th0, g0, s0), (t1, th1, g1, s1) = results
    assert torch.equal(t0, t1) and torch.equal(th0, th1) and torch.equal(s0, s1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert g0["down1.attn.qkv.weight"].abs().max() > 0


def test_host_codec_run_refuses_grad(mini):
    """The host-codec modes have no gradient: `run` under grad says so;
    without grad (as `sample` runs it) it runs."""
    _, _, tm, y = mini
    for mode in ("callback", "host_loop"):
        sampler = ddrm.DDRMSampler(tm, get_preset("webp"), consistency_mode=mode)
        with pytest.raises(ValueError, match="surrogate"):
            sampler.run(torch.from_numpy(y), 30, 20, 19, eta=0.0)
        with torch.no_grad():
            assert sampler.run(torch.from_numpy(y), 30, 20, 19, eta=0.0)[0].shape == y.shape
    with pytest.raises(ValueError, match="consistency mode"):
        ddrm.DDRMSampler(tm, get_preset("webp"), consistency_mode="exact")


@pytest.mark.parametrize("encoder_reuse", [1, 2])
def test_host_codec_modes_match_jax_callback(mini, encoder_reuse):
    """'callback' and 'host_loop' (the exact host codec each step) against
    the JAX package's 'callback' restore at q10 over 20 steps at stride 5
    (4 evaluations, phase consistency on; per step, or in groups of 2): the
    port's two modes give the same samples bitwise, and those agree with
    JAX's to 1e-5. The final projection stays off in these modes (the last
    step projected through the host codec already). The host codec rounds
    x̂ to 8 bits each step; on these inputs a 1e-6 change of y moves the
    JAX package's own output by 3.4e-6 (asserted within 1e-5), no 8-bit
    rounding edge being crossed."""
    jm, jv, tm, y = mini
    want = np.asarray(jddrm.DDRMSampler(jm, jax_preset("webp"), "callback").sample(
        jv, jnp.asarray(y), 10, 20, eta=0.0, stride=5, encoder_reuse=encoder_reuse))
    moved = np.asarray(jddrm.DDRMSampler(jm, jax_preset("webp"), "callback").sample(
        jv, jnp.asarray(y + 1e-6), 10, 20, eta=0.0, stride=5, encoder_reuse=encoder_reuse))
    assert np.abs(moved - want).max() <= 1e-5
    got = [ddrm.DDRMSampler(tm, get_preset("webp"), consistency_mode=mode).sample(
        torch.from_numpy(y), 10, 20, eta=0.0, stride=5, encoder_reuse=encoder_reuse).numpy()
        for mode in ("callback", "host_loop")]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, atol=1e-5)
