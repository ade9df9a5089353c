"""The port's flash-attention forward: its plain version (what a CPU tensor
takes) against the JAX package's Pallas kernel in interpret mode, at the
shapes of tests/test_flash_attention.py; the dispatch rules; and the build's
failure modes. The kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.ops.pallas.flash_attention import (
    _flash_bhtd,
    flash_attention as jax_flash_attention,
)
from ddpm_image_restoration_tpu_torch.ops import attention, build
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

SHAPES = [
    (2, 64, 4, 16),    # tiny T, small head dim
    (1, 256, 4, 32),   # T == one query block
    (2, 300, 2, 64),   # T not a block multiple (padding + key masking)
    (1, 1024, 8, 128),  # lane-aligned head dim
]


def _qkv(rng, b, t, h, d):
    return [rng.normal(0, 1, (b, t, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_plain_matches_pallas_interpret(rng, b, t, h, d):
    """f32, atol 2e-3 as the JAX package's own kernel test."""
    q, k, v = _qkv(rng, b, t, h, d)
    ref = jax_flash_attention(*map(jnp.asarray, (q, k, v)), interpret="always")
    out = attention.spatial_attention(*map(torch.from_numpy, (q, k, v)), impl="flash")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_lse_matches_pallas_interpret(rng):
    """The [BH,T] LSE against column 0 of the kernel's 128-lane LSE."""
    q, k, v = (rng.normal(0, 1, (2, 300, 128)).astype(np.float32) for _ in range(3))
    o_j, lse_j = _flash_bhtd(*map(jnp.asarray, (q, k, v)), real_d=128, interpret=True,
                             save_lse=True)
    o_t, lse_t = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), save_lse=True)
    assert lse_t.shape == (2, 300) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :, 0], atol=2e-3)


def test_bf16_inputs(rng):
    """bf16 in, bf16 out; atol 3e-2 against f32 as the JAX package's test."""
    q, k, v = _qkv(rng, 1, 256, 2, 32)
    ref = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)))
    out = attention.spatial_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), impl="flash")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), atol=3e-2, rtol=3e-2)


def test_softmax_scale_uses_head_dim(rng):
    q, k, v = _qkv(rng, 1, 256, 1, 16)
    ref = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)))
    out = attention.spatial_attention(*map(torch.from_numpy, (q, k, v)), impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_dispatch_threshold(rng, monkeypatch):
    """impl='flash' reaches the kernel wrapper from T=1024 on, the plain path
    below it and for impl='xla'; an unknown impl raises."""
    calls = []
    real = fa.flash_attention_fwd

    def spy(q, k, v, save_lse=False):
        calls.append(q.shape)
        return real(q, k, v, save_lse)

    monkeypatch.setattr(attention, "flash_attention_fwd", spy)
    for t, impl, want in ((1023, "flash", []), (1024, "flash", [(2, 1024, 16)]),
                          (1024, "xla", [])):
        q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, t, 2, 16))
        calls.clear()
        attention.spatial_attention(q, k, v, impl=impl)
        assert calls == want
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.spatial_attention(q, k, v, impl="sdpa")


def test_wrapper_routes_by_device():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other non-CUDA device is refused rather than computed."""
    q = torch.zeros(2, 8, 16)
    before = fa.flash_attention_fwd.launches
    fa.flash_attention_fwd(q, q, q)
    assert fa.flash_attention_fwd.launches == before
    m = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(m, m, m)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_finds_nvcc_and_names_library_by_source(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() == str(fake)
    p = build.library_path(fa.KERNEL)
    assert p.parent == build.BUILD_DIR and p.name.startswith("libflash_attention_fwd_")
    assert build.BUILD_DIR == build.PACKAGE_DIR.parent / "build" / "torch_kernels"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build(fa.KERNEL)
