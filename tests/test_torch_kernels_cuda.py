"""The port's CUDA kernels on the card, each against its plain version.

These need a CUDA card and nvcc; without a card they skip. They import no
JAX, so they run on a machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(32, 1024, 32), (32, 1024, 16), (8, 4096, 16),
                                    (4, 300, 64), (2, 256, 128)])
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-3)])
def test_kernel_matches_plain_on_card(card, bh, t, d, dtype, atol):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.shape == (bh, t)
    assert (o.float() - ro.float()).abs().max().item() <= atol
    assert (lse - rlse).abs().max().item() <= atol
    # a head dim between the built ones is zero-padded to the next
    q8, k8, v8 = (z[..., :8].contiguous() for z in (q, k, v))
    o8 = fa.flash_attention_fwd(q8, k8, v8)
    torch.cuda.synchronize()
    assert o8.shape == (bh, t, 8)
    assert (o8.float() - fa.flash_attention_plain(q8, k8, v8).float()).abs().max().item() <= atol
    wide = torch.zeros(bh, t, 136, device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(wide, wide, wide)


@pytest.mark.cuda
def test_small_restore_on_card_matches_cpu(card):
    """A width/8 f32 restore with flash attention at 32² (T = 1024) on the
    card against the CPU path, with the kernel launched on the way."""
    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    cfg = ModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(8)
    torch.manual_seed(0)
    cpu = build_model("webp", cfg, device="cpu")
    gpu = build_model("webp", cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    y = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    before = fa.flash_attention_fwd.launches
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = restore_batch(cpu, y, 30, final_exact=False)
        got = restore_batch(gpu, y.to(card), 30, final_exact=False).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert fa.flash_attention_fwd.launches > before
    assert (got - want).abs().mean().item() <= 1e-4
