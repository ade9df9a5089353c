"""The port's flash attention: the plain forward and backward (what a CPU
tensor takes) against the JAX package's Pallas kernels in interpret mode, at
the shapes of tests/test_flash_attention.py; the autograd Function against
`jax.grad` and against autograd through the plain attention; the dispatch
rules; and the build's failure modes. The kernels themselves are tested on
the card by tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.ops.pallas.flash_attention import (
    _flash_bhtd,
    _flash_bhtd_bwd,
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


@pytest.mark.parametrize("b", [1, 2])
def test_kernel_layout_is_contiguous(b):
    """The [BH,T,D] operands the kernels get are contiguous at every batch
    size: at B = 1 the transpose-reshape alone gave a strided view, which
    the CUDA wrappers refuse (a batch-1 restore failed on the card)."""
    x = torch.randn(b, 1024, 4, 32)
    got = attention._to_bhtd(x)
    assert got.shape == (b * 4, 1024, 32) and got.is_contiguous()
    assert torch.equal(got, x.permute(0, 2, 1, 3).reshape(b * 4, 1024, 32))


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
    assert build.library_path(fa.BWD_KERNEL).name.startswith("libflash_attention_bwd_")
    assert build.BUILD_DIR == build.PACKAGE_DIR.parent / "build" / "torch_kernels"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build(fa.KERNEL)


def test_library_name_tracks_shared_headers(monkeypatch, tmp_path):
    """A library's name hashes its source and the shared csrc/*.cuh, so an
    edit to the tensor-core header rebuilds both libraries."""
    import shutil

    shutil.copytree(build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    before = [build.library_path(n) for n in (fa.KERNEL, fa.BWD_KERNEL)]
    header = tmp_path / "csrc" / "flash_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build.library_path(n) for n in (fa.KERNEL, fa.BWD_KERNEL)]
    assert all(a != b for a, b in zip(before, after))
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        assert '#include "flash_mma.cuh"' in (build.CSRC_DIR / src).read_text()


def test_ptxas_summary_reads_registers_spills_and_smem():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi32EEEvPK13__nv_bfloat16S3_S3_PS1_Pfif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi32EEEvPK13__nv_bfloat16S3_S3_PS1_Pfif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 24576 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_if' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_if
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""
    assert build.ptxas_summary(log) == [
        "flash_fwd_mma_kernel D=32 bf16: 96 registers, spills 0/0 B, 24576 B smem",
        "flash_fwd_kernel D=16 f32: 40 registers, spills 8/4 B, 0 B smem"]
    assert build.kernel_label("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi64EEEvPKT_") == \
        "flash_bwd_dq_kernel D=64 f32"
    # nvcc 12.8 names the anonymous namespace after the source file
    assert build.kernel_label(
        "_ZN36_GLOBAL__N__2c138979_22_flash_attention_fwd_cu_2c13897920flash_fwd_mma_kernelILi128E"
        "EEvPK13__nv_bfloat16S3_S3_PS1_Pfif") == "flash_fwd_mma_kernel D=128 bf16"


def test_alignment_rule():
    """The wrappers' 16-byte rule (cp.async, ldmatrix) on the data pointer
    of a contiguous view; checked on CPU tensors, whose storage is aligned."""
    base = torch.zeros(2 * 64 * 16 + 8)
    fa._check_aligned("t", base[:2048].view(2, 64, 16), base[4:2052].view(2, 64, 16))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_aligned("t", base[:2048].view(2, 64, 16), base[1:2049].view(2, 64, 16))


@pytest.mark.parametrize("bh,t,d", [(4, 300, 64), (4, 1300, 16)])
def test_bwd_plain_matches_pallas_interpret(rng, bh, t, d):
    """dQ, dK, dV of the plain backward against the JAX backward kernels
    (`_flash_bhtd_bwd`, interpret mode) fed the same q, k, v, o, dO and LSE:
    one block with padding (T=300), and several 512-blocks with padding
    (T=1300). The JAX LSE is [BH,T,128]; column 0 is the port's [BH,T].
    f32, atol/rtol 1e-4: the same arithmetic summed in another order."""
    q, k, v, do = (rng.normal(0, 1, (bh, t, d)).astype(np.float32) for _ in range(4))
    o, lse = _flash_bhtd(*map(jnp.asarray, (q, k, v)), real_d=d, interpret=True, save_lse=True)
    want = _flash_bhtd_bwd(*map(jnp.asarray, (q, k, v)), o, lse, jnp.asarray(do), real_d=d,
                           interpret=True)
    got = fa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)),
        torch.from_numpy(np.array(lse)[:, :, 0]))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == (bh, t, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_bwd_plain_bf16(rng):
    """bf16 inputs give bf16 gradients, within one bf16 rounding (atol 1e-2
    for gradients below 1) of the JAX kernels on the same bf16 inputs."""
    q, k, v, do = (jnp.asarray(rng.normal(0, 1, (2, 300, 32)), jnp.bfloat16) for _ in range(4))
    o, lse = _flash_bhtd(q, k, v, real_d=32, interpret=True, save_lse=True)
    want = _flash_bhtd_bwd(q, k, v, o, lse, do, real_d=32, interpret=True)

    def to_torch(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    got = fa.flash_attention_bwd_plain(*map(to_torch, (q, k, v, o, do)),
                                       torch.from_numpy(np.array(lse)[:, :, 0]))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=1e-2)


def test_bwd_kernel_split_matches_plain(rng):
    """The per-kernel plain versions (dQ with Delta, then dK/dV on that
    Delta) give what the one-pass plain backward gives, on the CPU route of
    the kernel wrappers."""
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (3, 200, 16)).astype(np.float32))
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.testing.assert_close(delta, (do * o).sum(-1))
    for a, b in zip((dq, dk, dv), fa.flash_attention_bwd_plain(q, k, v, o, do, lse)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,t,h,d", [(2, 1024, 2, 32), (1, 1300, 2, 16)])
def test_function_grads_match_jax_grad(rng, b, t, h, d):
    """Gradients of spatial_attention(impl='flash') (the autograd Function,
    on the CPU through the plain backward) against `jax.grad` of the JAX
    package's flash_attention in interpret mode (its custom VJP with the
    Pallas backward kernels), [B,T,H,D]; atol/rtol 5e-3 as the JAX package's
    own gradient test."""
    q, k, v = _qkv(rng, b, t, h, d)
    w = rng.normal(0, 1, q.shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jax_flash_attention(q, k, v, interpret="always") * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.spatial_attention(*leaves, impl="flash")
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-3, rtol=5e-3,
                                   err_msg=f"d{name}")


def test_function_matches_plain_autograd_and_dispatch(rng, monkeypatch):
    """The Function's gradients equal autograd through the plain attention
    (f32, atol 1e-5); it is taken only when a gradient is needed, so a
    no-grad call runs the forward alone, without the LSE."""
    q, k, v = _qkv(rng, 1, 1024, 2, 16)
    w = torch.from_numpy(rng.normal(0, 1, q.shape).astype(np.float32))
    grads = []
    for impl in ("flash", "xla"):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(
            (attention.spatial_attention(*leaves, impl=impl) * w).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    calls = []
    real = fa.flash_attention_fwd

    def spy(q, k, v, save_lse=False):
        calls.append(save_lse)
        return real(q, k, v, save_lse)

    monkeypatch.setattr(attention, "flash_attention_fwd", spy)
    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        attention.spatial_attention(*leaves, impl="flash")
    attention.spatial_attention(*[torch.from_numpy(x) for x in (q, k, v)], impl="flash")
    assert calls == [False, False]
    attention.spatial_attention(*leaves, impl="flash")
    assert calls == [False, False, True]
