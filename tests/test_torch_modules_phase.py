"""chip_smoke.py's `modules` phase, run on the CPU at width/16 with the
CPU standing in for the card: it runs end to end and its gates hold; and
the upsample and block-DCT formulations it swaps in against the JAX
package's (NHWC there, NCHW here) in f32 and bf16."""

import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._torch_parity import nchw_to_nhwc

from ddpm_image_restoration_tpu.ops import dct as jdct
from ddpm_image_restoration_tpu.ops import resize as jresize

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import attention, dct, resize  # noqa: E402
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    """The CPU for the card; the forward kernel's call site computes the
    plain version under the wrapper's input rules."""
    def plain(q, k, v, save_lse=False):
        assert all(z.is_contiguous() and z.data_ptr() % 16 == 0 for z in (q, k, v))
        return fa.flash_attention_plain(q, k, v, save_lse)

    monkeypatch.setattr(attention, "flash_attention_fwd", plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "cuda_time_ms", host_time_ms)


def host_time_ms(fn, iters: int = 2) -> float:
    """chip_smoke.cuda_time_ms on the host clock (no CUDA events here)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def test_modules_phase_on_cpu(monkeypatch, on_cpu, capsys):
    """The modules phase at width/16, serve batches of 2 and none timed
    (a bf16 batch takes seconds on the CPU): every card-against-CPU gate holds with the CPU on both
    sides, the native engine builds and its batch meets the surrogate's
    bounds, and each formulation's model output moves but stays within one
    bf16 step of the default's on average; the only failure is the trace's, which
    holds no card kernels on the CPU."""
    monkeypatch.setattr(chip_smoke, "MODULES_SCALE", 16)
    monkeypatch.setattr(chip_smoke, "MODULES_TIMED", 0)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "MODULES_LOADER_IMAGES", 36)
    state = {"smi": "CPU"}
    with pytest.raises(AssertionError) as err:
        chip_smoke.phase_modules(state)
    assert str(err.value) == "profiling.trace wrote no kernel events or lost the annotation"
    log = capsys.readouterr().out
    assert log.count("card vs CPU max|diff|") == 5, log
    assert "native engine: available True" in log, log
    assert [r["formulation"] for r in state["formulations"]] == \
        [f for f, _ in chip_smoke.FORMULATIONS]
    assert all(r["eval_mean_abs_diff"] <= 2 ** -7 for r in state["formulations"])
    assert state["formulations"][-1]["eval_mean_abs_diff"] == 0.0
    # each swapped-in form reached the model: bf16 rounds it elsewhere
    assert all(r["eval_mean_abs_diff"] > 0 for r in state["formulations"][1:-1])


def _pair(rng, shape_nhwc):
    x = rng.normal(size=shape_nhwc).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _bf16_close(got: torch.Tensor, want):
    """Within one bf16 step (2^-7) of the largest entry: the two packages
    round intermediates (a three-operand einsum's first product, XLA's
    fused elementwise chains) at other points."""
    want = np.asarray(want).astype(np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * np.abs(want).max()


UPSAMPLE_FORMS = {"resize": resize.upsample_2x_bilinear, "shifts": chip_smoke.upsample_2x_shifts}
DCT_FORMS = {"kron": dct.spatial_block_dct, "shifts": chip_smoke.block_dct_shifts,
             "blockdiag": chip_smoke.block_dct_blockdiag}


@pytest.mark.parametrize("impl", list(UPSAMPLE_FORMS))
def test_upsample_formulations_match_jax(rng, monkeypatch, impl):
    """Each form against the JAX package's under DDPM_IR_RESIZE_IMPL=impl,
    on a 6x10 map: f32 atol 1e-6 (the shifts form is exact in both:
    weights 0.25 and 0.75); in bf16 within one bf16 step of the largest
    entry; each form equals the port's op to 1e-6 in f32."""
    monkeypatch.setenv("DDPM_IR_RESIZE_IMPL", impl)
    form = UPSAMPLE_FORMS[impl]
    xj, xt = _pair(rng, (2, 6, 10, 3))
    got = form(xt)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(jresize.upsample_2x_bilinear(xj)),
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), resize.upsample_2x_bilinear(xt).numpy(), atol=1e-6)
    hb = form(xt.to(torch.bfloat16))
    assert hb.dtype == torch.bfloat16
    _bf16_close(hb.permute(0, 2, 3, 1),
                jresize.upsample_2x_bilinear(xj.astype(jnp.bfloat16)))


@pytest.mark.parametrize("impl", list(DCT_FORMS))
@pytest.mark.parametrize("bs,hw", [(4, (16, 16)), (8, (16, 24)), (8, (12, 20))])
def test_dct_formulations_match_jax(rng, monkeypatch, impl, bs, hw):
    """Each form against the JAX package's under DDPM_IR_DCT_IMPL=impl
    (12x20 at block 8 is padded and cropped): f32 atol 1e-5 (summation
    order); each form equals the port's kron op to 1e-5; in bf16 (f32
    accumulation in the shifts and blockdiag forms, rounded back once)
    within one bf16 step of the largest entry of JAX's."""
    monkeypatch.setenv("DDPM_IR_DCT_IMPL", impl)
    form = DCT_FORMS[impl]
    xj, xt = _pair(rng, (2, *hw, 5))
    got = form(xt, bs)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(jdct.spatial_block_dct(xj, bs)),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dct.spatial_block_dct(xt, bs).numpy(), atol=1e-5)
    hb = form(xt.to(torch.bfloat16), bs)
    assert hb.dtype == torch.bfloat16
    _bf16_close(hb.permute(0, 2, 3, 1),
                jdct.spatial_block_dct(xj.astype(jnp.bfloat16), bs))
