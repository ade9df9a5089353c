"""The port's CUDA kernels on the card, each against its plain version.

These need a CUDA card and nvcc; without a card they skip. They import no
JAX, so they run on a machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa


# A kernel against its plain version, entry by entry: |got - ref| <= step *
# |ref| + 1e-4 * max|ref|. Both accumulate in f32 on the same inputs (1e-4 of
# the largest entry covers their roundoff); a bf16 output is then rounded
# once on each side, at most one bf16 step (2^-7) of that entry apart. The
# LSE and Delta are f32 in either case.
STEPS = [(torch.bfloat16, 2 ** -7), (torch.float32, 0.0)]


def close(got, ref, step=0.0, rel_max=1e-4):
    ref = ref.float()
    bound = step * ref.abs() + rel_max * ref.abs().max()
    return bool(((got.float() - ref).abs() <= bound).all())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernels have no CPU mode")
    return torch.device("cuda")


# Ragged and short T for the tensor-core kernels' 64-row tiles: one partial
# tile, several tiles with a ragged last one, exactly one tile.
RAGGED_SHAPES = [(3, 17, 32), (2, 1000, 16), (4, 1300, 32), (2, 64, 16)]
# D = 256: the 1024² path's bottleneck (4 heads of 1024 channels at T = 1024,
# batch 1), a batch of 8 images there, a ragged T, and D = 192, which every
# wrapper zero-pads to 256.
WIDE_SHAPES = [(4, 1024, 256), (32, 1024, 256), (3, 300, 256), (2, 300, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(32, 1024, 32), (32, 1024, 16), (72, 1024, 32),
                                    (72, 1024, 16), (8, 4096, 16), (4, 300, 64),
                                    (2, 256, 128), *RAGGED_SHAPES, *WIDE_SHAPES])
@pytest.mark.parametrize("dtype,step", STEPS)
def test_kernel_matches_plain_on_card(card, bh, t, d, dtype, step):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.shape == (bh, t)
    assert close(o, ro, step)
    assert close(lse, rlse)
    # D = 8: the bf16 forward takes it natively, the f32 one pads it to 16
    q8, k8, v8 = (z[..., :8].contiguous() for z in (q, k, v))
    o8 = fa.flash_attention_fwd(q8, k8, v8)
    torch.cuda.synchronize()
    assert o8.shape == (bh, t, 8)
    assert close(o8, fa.flash_attention_plain(q8, k8, v8), step)
    # a head wider than any configuration's (D > 256) is refused
    wide = torch.zeros(bh, t, 264, device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(wide, wide, wide)


BWD_SHAPES = [(72, 1024, 32), (72, 1024, 16), (36, 1024, 32), (36, 1024, 16), (64, 1024, 8),
              (72, 1024, 64), (4, 300, 64), (4, 1300, 16), (2, 256, 128), (3, 200, 8),
              *RAGGED_SHAPES, *WIDE_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", BWD_SHAPES)
@pytest.mark.parametrize("dtype,step", STEPS)
def test_bwd_kernels_match_plain_on_card(card, bh, t, d, dtype, step):
    """dQ (with Delta) and dK/dV against the plain backward on the same
    inputs and the same LSE. The training shapes first (18 images x 4 heads,
    32x32 tokens, D 32 and 16; a rank of the (2, 2) model-axis step; the
    AVIF up4 level, D 8), the 32x32 level of the 128² model (D 64),
    then ragged T, a wide head and D = 8 (bf16 unpadded, f32 zero-padded to
    16), then D = 256 (`WIDE_SHAPES`: the dK/dV kernel's two blocks a key
    tile, each with half the columns), each entry within one bf16 `step` of the plain output's (see
    `close`)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    assert close(delta, rdelta)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == (bh, t, d)
        assert close(got, ref, step)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 256])
def test_launch_from_a_fresh_thread_on_card(card, d):
    """All three wrappers from a host thread in which no CUDA call has run
    yet, as autograd's worker thread is when the flash backward is its
    first CUDA work there: each launcher makes the device's context current
    in its calling thread (such launches were refused with CUDA error 1 at
    every head dim before), and the results equal the main thread's bit
    for bit (the kernels are deterministic)."""
    import threading

    g = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, do = (torch.randn(4, 1024, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))

    def run():
        o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
        return (o, lse, dq, delta, *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))

    want = run()
    got = []

    def in_thread():
        try:
            got.append(run())
        except Exception as e:  # noqa: BLE001 (handed to the test's thread)
            got.append(e)

    th = threading.Thread(target=in_thread)
    th.start()
    th.join()
    torch.cuda.synchronize()
    assert not isinstance(got[0], Exception), got[0]
    for a, b in zip(got[0], want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bwd_wrappers_refuse_bad_stats(card):
    q = torch.zeros(2, 64, 16, device="cuda")
    with pytest.raises(ValueError, match="per-row statistics"):
        fa.flash_attention_bwd_dq(q, q, q, q, q, torch.zeros(2, 64, device="cuda",
                                                             dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="per-row statistics"):
        fa.flash_attention_bwd_dkv(q, q, q, q, torch.zeros(2, 64, device="cuda"),
                                   torch.zeros(2, 63, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_refuse_misaligned_views(card, dtype):
    """The bf16 kernels load by TMA, whose tensor maps need 16-byte-aligned
    bases, and the wrappers hold both dtypes to that rule: a contiguous view
    that starts one element into its storage is refused by every wrapper,
    not copied."""
    n = 2 * 64 * 16
    base = torch.zeros(n + 8, device="cuda", dtype=dtype)
    bad = base[1:n + 1].view(2, 64, 16)
    ok = base[:n].view(2, 64, 16)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    stat = torch.zeros(2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_fwd(ok, ok, bad)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bwd_dq(ok, ok, ok, ok, bad, stat)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bwd_dkv(bad, ok, ok, ok, stat, stat)
    assert fa.flash_attention_fwd(ok, ok, ok).shape == (2, 64, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2 ** -6), (torch.float32, 1e-4)])
def test_function_grads_match_plain_autograd_on_card(card, dtype, rel):
    """spatial_attention(impl='flash') under autograd (the Function: forward
    kernel with LSE, dQ and dK/dV kernels) against autograd through the
    plain attention, [B,T,H,D] = [4,1024,4,32], within `rel` of the largest
    gradient entry: in bf16 the kernels take Delta from the rounded output
    where autograd keeps it in f32 (up to 0.8 bf16 steps of the largest
    entry measured on the card; two are allowed)."""
    from ddpm_image_restoration_tpu_torch.ops.attention import spatial_attention

    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(4, 1024, 4, 32, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    got = torch.autograd.grad(spatial_attention(*leaves, impl="flash"), leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref_leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    ref = torch.autograd.grad(spatial_attention(*ref_leaves, impl="xla"), ref_leaves, do)
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        assert close(a, b, rel_max=rel)
    # without a gradient to take, only the forward kernel runs (no LSE)
    with torch.no_grad():
        spatial_attention(q, k, v, impl="flash")
    assert fa.flash_attention_bwd_dq.launches == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 256), (3, 300, 192)])
@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2 ** -6), (torch.float32, 1e-4)])
def test_function_grads_d256_on_card(card, bh, t, d, dtype, rel):
    """The Function at the 1024² path's bottleneck shape (4, 1024, 256) and
    at a ragged D = 192 (zero-padded to 256 by every wrapper), against
    autograd through the plain attention: the output within the kernel
    bound, the gradients within `rel` of the largest entry (the bound of
    `test_function_grads_match_plain_autograd_on_card`)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = fa.FlashAttention.apply(*leaves)
    got = (out.detach(), *torch.autograd.grad(out, leaves, do))
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref_leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    ref_out = fa.flash_attention_plain(*ref_leaves)
    ref = (ref_out.detach(), *torch.autograd.grad(ref_out, ref_leaves, do))
    assert close(got[0], ref[0], 2 ** -7 if dtype == torch.bfloat16 else 0.0)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == dtype and a.shape == (bh, t, d) and close(a, b, rel_max=rel)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 16])
def test_function_under_checkpoint_on_card(card, d):
    """The Function inside activation checkpointing (utils/remat.py
    `checkpoint`, non-reentrant), as the rematerialised solver and UNet
    blocks run it, at the distilled student's shapes (72,1024,d) bf16: the
    backward recomputes the forward, which launches the forward kernel (with
    the LSE) a second time and saves the same O and LSE, so the output and
    the gradients equal those without the checkpoint, entry by entry within
    one bf16 step (both run the same deterministic kernels)."""
    from ddpm_image_restoration_tpu_torch.utils.remat import checkpoint

    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(72, 1024, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    results, launched = [], []
    for remat in (False, True):
        leaves = [z.clone().requires_grad_() for z in (q, k, v)]
        before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        out = (checkpoint(fa.FlashAttention.apply, *leaves) if remat
               else fa.FlashAttention.apply(*leaves))
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        launched.append(tuple(n - m for n, m in zip(
            (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches), before)))
        results.append((out.detach(), *grads))
    assert launched == [(1, 1, 1), (2, 1, 1)]
    for got, ref in zip(results[1], results[0]):
        assert got.dtype == torch.bfloat16
        assert close(got, ref, 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_spatial_attention_any_batch_on_card(card, b):
    """spatial_attention(impl='flash') at batch 1 (a single-file restore)
    and 3 launches the kernel and matches the plain attention."""
    from ddpm_image_restoration_tpu_torch.ops.attention import spatial_attention

    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(b, 1024, 4, 32, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = fa.flash_attention_fwd.launches
    got = spatial_attention(q, k, v, impl="flash")
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert close(got, spatial_attention(q, k, v, impl="xla"), step=2 ** -7)


@pytest.mark.cuda
def test_flash_block_qkv_grad_on_card(card):
    """A 32x32 flash attention block's qkv weight gets the gradient the plain
    route gives (it was None-or-residual-only before the Function)."""
    from ddpm_image_restoration_tpu_torch.models.unet import SpatialSelfAttention

    torch.manual_seed(0)
    flash = SpatialSelfAttention(64, 4, impl="flash").cuda()
    plain = SpatialSelfAttention(64, 4, impl="xla").cuda()
    plain.load_state_dict(flash.state_dict())
    x = torch.randn(2, 64, 32, 32, device="cuda")
    for m in (flash, plain):
        m(x).square().mean().backward()
    assert flash.qkv.weight.grad is not None and flash.qkv.weight.grad.abs().max() > 0
    ref = plain.qkv.weight.grad
    assert (flash.qkv.weight.grad - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


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


# The AVIF model's 8-head shapes: batch 8 at down2 (head dim 128/8 = 16) and
# up4 (64/8 = 8, which the bf16 forward and dK/dV take natively and the
# other wrappers zero-pad to 16).
AVIF_SHAPES = [(64, 1024, 16), (64, 1024, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", AVIF_SHAPES)
@pytest.mark.parametrize("dtype,step", STEPS)
def test_avif_shapes_all_kernels_on_card(card, bh, t, d, dtype, step):
    """The forward (with the LSE), dQ (with Delta) and dK/dV at the AVIF
    shapes against their plain versions on the unpadded tensors. At D = 8
    the plain versions scale by 1/√8 and see no padding, so agreement shows
    that the zero lanes add nothing and the scale stays 1/√8."""
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, rdelta)
    torch.cuda.synchronize()
    assert o.shape == dq.shape == dk.shape == dv.shape == (bh, t, d)
    assert all(z.is_contiguous() for z in (o, dq, dk, dv))
    assert close(o, ro, step) and close(lse, rlse)
    assert close(dq, rdq, step) and close(delta, rdelta)
    assert close(dk, rdk, step) and close(dv, rdv, step)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2 ** -6), (torch.float32, 1e-4)])
def test_avif_function_grads_on_card(card, d, dtype, rel):
    """The Function at the AVIF training shapes, [B,T,H,D] = [8,1024,8,D],
    against autograd through the plain attention (the bound of
    `test_function_grads_match_plain_autograd_on_card`)."""
    from ddpm_image_restoration_tpu_torch.ops.attention import spatial_attention

    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(8, 1024, 8, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = spatial_attention(*leaves, impl="flash")
    got = (out.detach(), *torch.autograd.grad(out, leaves, do))
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref_leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    ref_out = spatial_attention(*ref_leaves, impl="xla")
    ref = (ref_out.detach(), *torch.autograd.grad(ref_out, ref_leaves, do))
    assert close(got[0], ref[0], 2 ** -7 if dtype == torch.bfloat16 else 0.0)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == dtype and close(a, b, rel_max=rel)


@pytest.mark.cuda
def test_avif_model_full_width_on_card(card):
    """The AVIF-preset UNet at full width (64², release widths, 8 heads,
    flash at <= 32²) on a batch of 8: in f32 the flash route against the
    same weights on the plain attention (max |diff| <= 1e-3, the f32
    kernel's roundoff through ~20 layers), two forward launches (down2
    at D = 16, up4 at D = 8) per call; in bf16 (the tensor-core kernels)
    finite, with the same launches."""
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    x = torch.rand(8, 64, 64, 3, generator=torch.Generator().manual_seed(6)).to(card) * 2 - 1
    t = torch.linspace(0.1, 0.9, 8, device=card)
    outs = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in ("float32", "bfloat16"):
            for impl in ("flash", "xla"):
                cfg = ModelConfig(compute_dtype=dtype, attention_impl=impl, attn_max_resolution=32)
                torch.manual_seed(0)
                model = build_model("avif", cfg, device=card)
                assert model.down2.attn.num_heads == 8
                before = fa.flash_attention_fwd.launches
                with torch.no_grad():
                    outs[dtype, impl] = model(x, t).float()
                torch.cuda.synchronize()
                assert fa.flash_attention_fwd.launches - before == (2 if impl == "flash" else 0)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert (outs["float32", "flash"] - outs["float32", "xla"]).abs().max().item() <= 1e-3
    assert torch.isfinite(outs["bfloat16", "flash"]).all()
    assert outs["bfloat16", "flash"].shape == (8, 64, 64, 3)


# The spatial-parallel restore and the 'model' axis on the card: two ranks
# spawned here share it over gloo (tests/_torch_parallel_worker.py), each
# running the kernels on its own tensors; the test process runs the same
# work alone on the card.
PARALLEL_CFG = dict(image_size=64, compute_dtype="float32", attention_impl="flash",
                    attn_max_resolution=32)


def _card_model(codec="webp"):
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    torch.manual_seed(0)
    model = build_model(codec, ModelConfig(**PARALLEL_CFG).scaled(8), device="cpu")
    return model.to("cuda")


def _sp_restore(y, mesh=None):
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
    from ddpm_image_restoration_tpu_torch.parallel.mesh import shard_inference_spatial

    model = shard_inference_spatial(_card_model(), mesh)
    before = fa.flash_attention_fwd.launches
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = DDRMSampler(model, get_preset("webp")).sample(
            y.cuda(), 30, 20, stride=5, eta=0.85, final_exact=False,
            generator=torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return out.cpu(), fa.flash_attention_fwd.launches - before


def scenario_sp_on_card(rank, world, tmp, y):
    from ddpm_image_restoration_tpu_torch.parallel.mesh import make_mesh

    return _sp_restore(y, make_mesh((-1,), ("spatial",)))


@pytest.mark.cuda
def test_spatial_restore_on_card_matches_one_process(card, tmp_path):
    """A width/8 f32 restore of 3 images (eta 0.85, 4 evaluations, flash at
    32²: T = 1024) with each image's height over 2 ranks sharing the card
    equals the one-process card restore (mean |diff| <= 1e-4, max <= 1e-3),
    and each rank launches the forward kernel as often as one process: the
    attention runs on the gathered tokens."""
    from . import _torch_parallel_worker as w

    y = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    want, launches = _sp_restore(y)
    assert launches == 10   # 5 evaluations (20 steps, stride 5), 2 levels at 32²
    for got, n in w.spawn(scenario_sp_on_card, 2, tmp_path, y):
        assert n == launches
        diff = (got - want).abs()
        assert diff.mean().item() <= 1e-4 and diff.max().item() <= 1e-3


def _tp_step(mesh=None):
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.parallel.mesh import put_state, shard_batch
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    from . import _torch_parallel_worker as w

    model = _card_model()
    cfg = TrainConfig(codec="webp", model=model.cfg, batch_size=4, ema_decay=0.999)
    state = put_state(create_train_state(model, cfg), mesh)
    batch = {k: torch.from_numpy(shard_batch(v, mesh)).cuda()
             for k, v in w.make_batch(4, 64).items()}
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [k.launches for k in kernels]
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = make_train_step(model, cfg)(state, batch,
                                        torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    grads = (state.layout.full(state.layout.reduce_grads(model)) if state.layout else
             {k: p.grad.cpu() for k, p in model.named_parameters()})
    return m["loss"].item(), grads, [k.launches - b for k, b in zip(kernels, before)]


def scenario_tp_on_card(rank, world, tmp):
    from ddpm_image_restoration_tpu_torch.parallel.mesh import make_mesh

    return _tp_step(make_mesh((1, 2), ("data", "model")))


@pytest.mark.cuda
def test_model_axis_step_on_card_matches_one_process(card, tmp_path):
    """A width/8 f32 train step (batch 4, flash at 32²) on a (1, 2)
    ('data', 'model') mesh of 2 ranks sharing the card, its convolutions
    and dense layers column-parallel, against the one-process card step:
    loss rel 1e-4, every gradient within 1e-4 of the largest; each rank
    launches all three kernels as one process does."""
    from . import _torch_parallel_worker as w

    loss, grads, launches = _tp_step()
    assert launches == [2, 2, 2]
    top = max(g.abs().max().item() for g in grads.values())
    for got_loss, got, n in w.spawn(scenario_tp_on_card, 2, tmp_path):
        assert n == launches
        assert abs(got_loss - loss) <= 1e-4 * abs(loss)
        assert max((got[k] - g).abs().max().item() for k, g in grads.items()) <= 1e-4 * top


def _counting_pads(monkeypatch):
    """Counts torch.nn.functional.pad calls, which the wrappers' head-dim
    padding makes."""
    calls = []
    real = torch.nn.functional.pad

    def pad(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "pad", pad)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t", [(64, 1024), (3, 200)])
@pytest.mark.parametrize("dtype,step", STEPS)
def test_d8_forward_and_dkv_take_no_pad_on_card(card, monkeypatch, bh, t, dtype, step):
    """At D = 8 the three bf16 kernels (the forward, dQ and dK/dV) run on
    the [BH, T, 8] tensors as they are (the wgmma kernels zero-fill the head
    dim to 16 in shared memory; no pad and no slice), the f32 kernels pad
    to 16, and all three stay within their bounds: the AVIF up4 shape and a
    ragged one."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(bh, t, 8, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    pads = _counting_pads(monkeypatch)
    bf16 = dtype == torch.bfloat16
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    assert len(pads) == (0 if bf16 else 3)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    assert len(pads) == (0 if bf16 else 8)  # f32: q, k, v, o, dO for the dQ kernel
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert len(pads) == (0 if bf16 else 12)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, rdelta)
    assert close(o, ro, step) and close(lse, rlse)
    assert close(dq, rdq, step) and close(delta, rdelta)
    assert close(dk, rdk, step) and close(dv, rdv, step)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 32), (8, 1024, 16), (2, 300, 8),
                                    (4, 1024, 256)])
@pytest.mark.parametrize("split", [0, 1, 2, 4])
def test_forward_split_over_keys_on_card(card, bh, t, d, split):
    """The bf16 forward at the restore CLI's shape (4, 1024, 32), the AVIF
    restore's (8, 1024, 16), a ragged D = 8 one and the 1024² path's
    bottleneck (4, 1024, 256), with its keys split over a cluster of 1, 2
    or 4 blocks (the launcher's C entry point forced; 0: its own rule, which
    takes 4, 2, 4 and 2 here) and merged through distributed shared memory
    (at D = 256 from a merge area laid over the ring): O and the LSE within
    their bounds."""
    import ctypes

    from ddpm_image_restoration_tpu_torch.ops import build

    fn = build.load(fa.KERNEL).flash_attention_fwd_split
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(bh, t, device="cuda")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, t, d,
             1, d ** -0.5, split, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    assert close(o, ro, 2 ** -7) and close(lse, rlse)
    if split == 0:  # the wrapper's call, the same rule
        assert close(fa.flash_attention_fwd(q, k, v), ro, 2 ** -7)


# The warp-specialised bf16 forward and dK/dV at D = 128 and 256 (64-row
# blocks: the forward's two consumer warpgroups take a block's key tiles in
# turn; dK/dV's split one 64-key tile's query tiles over a cluster of 2):
# the 1024² path's shapes at BH = 4 and 1, ragged T over the 64-row tiles
# (one partial tile, several with a ragged last one, exactly one tile).
WS_SHAPES = [(4, 1024, 128), (1, 1024, 256), (1, 1024, 128), (3, 150, 128), (2, 64, 128),
             (1, 300, 256), (5, 70, 256)]


def _dkv_split_launcher():
    import ctypes

    from ddpm_image_restoration_tpu_torch.ops import build

    fn = build.load(fa.BWD_KERNEL).flash_attention_bwd_dkv_split
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", WS_SHAPES)
def test_ws_kernels_match_plain_on_card(card, bh, t, d):
    """The bf16 forward (with and without the LSE), dQ and dK/dV at the
    warp-specialised designs' shapes, each within its bound."""
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    o_only = fa.flash_attention_fwd(q, k, v)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    assert close(o, ro, 2 ** -7) and close(o_only, ro, 2 ** -7) and close(lse, rlse)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, rdelta)
    assert close(dq, rdq, 2 ** -7) and close(delta, rdelta)
    assert close(dk, rdk, 2 ** -7) and close(dv, rdv, 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 256), (4, 1024, 128), (1, 1024, 256),
                                    (3, 150, 128), (2, 300, 256)])
@pytest.mark.parametrize("split", [0, 1, 2])
def test_dkv_split_over_queries_on_card(card, bh, t, d, split):
    """The bf16 dK/dV at D = 128 and 256 with its query tiles dealt over a
    cluster of 1 or 2 blocks (the C entry point forced; 0: the launcher's
    rule, which takes 2 at every shape here) and the two blocks' sums added
    through distributed shared memory: dK and dV within their bounds."""
    fn = _dkv_split_launcher()
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, d, 1, d ** -0.5, split,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    assert close(dk, rdk, 2 ** -7) and close(dv, rdv, 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 256), (4, 1024, 128), (3, 300, 256)])
def test_dkv_is_deterministic_on_card(card, bh, t, d):
    """Two launches of the bf16 dK/dV on the same inputs give dK and dV bit
    for bit (no atomics: every element is written once, the cluster's two
    partial sums added in one fixed step); the forward likewise."""
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    first = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _dq_split_launcher():
    import ctypes

    from ddpm_image_restoration_tpu_torch.ops import build

    fn = build.load(fa.BWD_KERNEL).flash_attention_bwd_dq_split
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 256), (4, 1024, 128), (1, 1024, 256),
                                    (3, 150, 128), (2, 300, 256)])
@pytest.mark.parametrize("split", [0, 1, 2])
def test_dq_split_over_keys_on_card(card, bh, t, d, split):
    """The bf16 dQ at D = 128 and 256 (one 64-query tile a block) with its
    key tiles dealt over a cluster of 1 or 2 blocks (the C entry point
    forced; 0: the launcher's rule, which takes 2 at every shape here) and
    the two blocks' partial dQ added through distributed shared memory: dQ
    and Delta within their bounds, and a second launch bit for bit the
    same (every element written once, no atomics)."""
    fn = _dq_split_launcher()
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for _ in range(2):
        dq, delta = torch.empty_like(q), torch.empty(bh, t, device="cuda")
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), bh, t, d, 1, d ** -0.5,
                  split, stream) == 0
        outs.append((dq, delta))
    torch.cuda.synchronize()
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    (dq, delta), (dq2, delta2) = outs
    assert close(dq, rdq, 2 ** -7) and close(delta, rdelta)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)


# The f32 forward and dQ on TF32 wgmma with the 3xTF32 split: the f32 path
# shapes (the full-width f32 distillation's (72, 1024, 32|16), the 1024²
# path's (4, 1024, 256|128), the half-width f32 gates' D = 16), then ragged
# T over the 64-row tiles and the 16-, 32- and 64-key stages.
F32_SHAPES = [(72, 1024, 32), (72, 1024, 16), (4, 1024, 256), (4, 1024, 128), (8, 1024, 16),
              (16, 1024, 16), (3, 150, 128), (2, 70, 16), (1, 300, 64), (5, 200, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", F32_SHAPES)
def test_f32_tf32_kernels_match_plain_and_repeat_on_card(card, bh, t, d):
    """The f32 forward (with and without the LSE) and dQ (with Delta)
    within the f32 bound (1e-4 of the largest entry), and two calls of
    each bit-identical (no atomics; a cluster's shares merged in one fixed
    order)."""
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    o_only = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, save_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    assert close(o, ro) and close(o_only, ro) and close(lse, rlse)
    assert close(dq, rdq) and close(delta, rdelta)
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(o, o_only)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 256), (4, 1024, 128), (8, 1024, 16),
                                    (3, 300, 32)])
@pytest.mark.parametrize("split", [0, 1, 2, 4])
def test_f32_split_over_keys_on_card(card, bh, t, d, split):
    """The f32 forward and dQ with their keys dealt over a cluster of 1, 2
    or 4 blocks (the C entry points forced; 0: the launchers' rules; dQ at
    D = 256, whose cluster splits the head dim, ignores it) and each
    block's share merged through distributed shared memory: O, the LSE, dQ
    and Delta within the f32 bound."""
    import ctypes

    from ddpm_image_restoration_tpu_torch.ops import build

    fwd = build.load(fa.KERNEL).flash_attention_fwd_split
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    dq_fn = _dq_split_launcher()
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(4))
    stream = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty(bh, t, device="cuda")
    assert fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, t, d,
               0, d ** -0.5, split, stream) == 0
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    dq, delta = torch.empty_like(q), torch.empty(bh, t, device="cuda")
    assert dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ro.data_ptr(), do.data_ptr(),
                 rlse.data_ptr(), dq.data_ptr(), delta.data_ptr(), bh, t, d, 0, d ** -0.5,
                 split, stream) == 0
    torch.cuda.synchronize()
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, ro, do, rlse)
    assert close(o, ro) and close(lse, rlse)
    assert close(dq, rdq) and close(delta, rdelta)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 256), (72, 1024, 32)])
def test_f32_kernels_need_the_split_on_card(card, bh, t, d):
    """What the 3xTF32 split buys: the plain attention with its matmuls in
    one TF32 product (`allow_tf32`, what a single TF32 wgmma computes)
    fails the f32 bound that the kernels meet, at the 1024² path's and the
    f32 distillation's shapes."""
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    dq, _ = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    rdq, _ = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        to = fa.flash_attention_plain(q, k, v)
        tdq, _ = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.cuda.synchronize()
    assert close(o, ro) and close(dq, rdq)
    assert not close(to, ro) and not close(tdq, rdq)


# The f32 dK/dV on TF32 wgmma with the 3xTF32 split (one 64-key tile a
# block, warp-specialised by product): the 1024² path's (4, 1024, 128),
# ragged T at D = 128 and 32 (several 16- and 32-query stages, the last
# ragged), with its query tiles dealt over a cluster of 1 or 2 blocks, and
# D = 256, whose cluster splits the head dim (the split ignored).
@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 128), (3, 150, 128), (2, 300, 32), (4, 1024, 256)])
@pytest.mark.parametrize("split", [0, 1, 2])
def test_f32_dkv_split_over_queries_on_card(card, bh, t, d, split):
    """The f32 dK/dV through `flash_attention_bwd_dkv_split` (split 0: the
    launcher's rule, which takes 2 at (4, 1024, 128) and the ragged
    shapes), the two blocks' sums added through distributed shared memory:
    dK and dV within the f32 bound (1e-4 of the largest entry)."""
    fn = _dkv_split_launcher()
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
    delta = (do * o).sum(-1)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, d, 0, d ** -0.5, split,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    assert close(dk, rdk) and close(dv, rdv)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 128), (4, 1024, 256), (72, 1024, 32),
                                    (72, 1024, 16), (16, 1024, 16), (5, 200, 256)])
def test_f32_dkv_matches_plain_and_repeats_on_card(card, bh, t, d):
    """The f32 dK/dV at the f32 path shapes (the 1024² train step's, the
    f32 distillation's, the half-width f32 train gate's) and a ragged D =
    256, after the dQ kernel's Delta: within the f32 bound of the plain
    version, and two launches bit-identical (no atomics; the cluster's
    partial sums added in one fixed order)."""
    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    before = fa.flash_attention_bwd_dkv.launches
    first = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.launches == before + 2
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, rdelta)
    assert close(first[0], rdk) and close(first[1], rdv)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(4, 1024, 128), (72, 1024, 16), (16, 1024, 16)])
def test_function_f32_grads_on_card(card, bh, t, d):
    """The Function in f32 (the TF32 forward, dQ and dK/dV) at the 1024²
    train step's D = 128 and the f32 distillation's and train gate's D =
    16, against autograd through the plain attention: the output within
    the f32 kernel bound, the gradients within FUNCTION_REL's f32 share
    (1e-4) of the largest entry."""
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(4))
    leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    out = fa.FlashAttention.apply(*leaves)
    got = (out.detach(), *torch.autograd.grad(out, leaves, do))
    ref_leaves = [z.clone().requires_grad_() for z in (q, k, v)]
    ref_out = fa.flash_attention_plain(*ref_leaves)
    ref = (ref_out.detach(), *torch.autograd.grad(ref_out, ref_leaves, do))
    torch.cuda.synchronize()
    assert close(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == torch.float32 and close(a, b, rel_max=1e-4)


# -- The DDRM solver loop as a captured CUDA graph (diffusion/ddrm.py): the
# first call of a signature runs eager, the second captures and replays,
# later ones replay. A width/8 model at 64² with flash at 32² (T = 1024).

GRAPH_CFG = dict(image_size=64, attention_impl="flash", attn_max_resolution=32)


def _graph_model(codec="webp", dtype="float32", remat=False):
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    torch.manual_seed(0)
    cfg = ModelConfig(compute_dtype=dtype, remat=remat, **GRAPH_CFG).scaled(8)
    return build_model(codec, cfg, device="cpu").to("cuda")


def _graph_y(n=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 64, 64, 3, generator=g) * 2 - 1).cuda()


# static: 21 steps at stride 5 (20, 15, 10, 5, 0), q10 under the phase gate;
# traced: a budget of 4 slots per sample, a per-sample quality
GRAPH_RUNS = {"static": dict(quality=10, steps=21, stride=5, encoder_reuse=2),
              "traced": dict(quality=[10.0, 40.0, 70.0], steps=[16, 11, 30], traced_budget=4,
                             encoder_reuse=2)}


def _sampler(model, codec="webp", codec_id=None):
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler

    return DDRMSampler(model, get_preset(codec), codec_id=codec_id)


def _counted_run(sampler, y, **kw):
    """sampler.run under no_grad and the forward launches it counted."""
    before = fa.flash_attention_fwd.launches
    with torch.no_grad():
        out = sampler.run(y, **kw)
    torch.cuda.synchronize()
    return out, fa.flash_attention_fwd.launches - before


def _same(a, b):
    return all(torch.equal(x, z) for x, z in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("run", sorted(GRAPH_RUNS))
def test_solver_graph_equals_eager_on_card(card, dtype, run):
    """Static schedule and traced budget, f32 and bf16, eta 0: the second
    call captures and replays and equals the eager first call bit for bit;
    a third call on another batch replays and equals a fresh sampler's
    eager run of it; each call counts the same forward launches."""
    model = _graph_model("webp", dtype)
    kw = dict(GRAPH_RUNS[run], eta=0.0)
    y, y2 = _graph_y(), _graph_y(seed=2)
    s = _sampler(model)
    eager, n_eager = _counted_run(s, y, **kw)
    assert not s._cache.graphs and n_eager > 0
    graph, n_capture = _counted_run(s, y, **kw)
    assert len(s._cache.graphs) == 1 and n_capture == n_eager
    assert _same(graph, eager)
    again, n_replay = _counted_run(s, y2, **kw)
    want, _ = _counted_run(_sampler(model), y2, **kw)
    assert n_replay == n_eager and _same(again, want)
    assert torch.isfinite(again[0]).all() and not _same(again, graph)


@pytest.mark.cuda
def test_solver_graph_noise_and_generator_on_card(card):
    """eta 0.85 with an explicit generator: the replay reads the noise that
    eager draws (drawn before the loop, in slot order), leaves the
    generator where eager leaves it, and draws nothing from the default
    generator."""
    model = _graph_model()
    kw = dict(GRAPH_RUNS["static"], eta=0.85)
    y = _graph_y()
    g = torch.Generator(device="cuda")
    want, _ = _counted_run(_sampler(model), y, generator=g.manual_seed(5), **kw)
    after = g.get_state()
    s = _sampler(model)
    for call in range(3):
        default = torch.cuda.get_rng_state()
        got, _ = _counted_run(s, y, generator=g.manual_seed(5), **kw)
        assert len(s._cache.graphs) == min(call, 1)
        assert _same(got, want) and torch.equal(g.get_state(), after)
        assert torch.equal(torch.cuda.get_rng_state(), default)
    other, _ = _counted_run(s, y, generator=g.manual_seed(6), **kw)
    assert not _same(other, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, (1, 3)])
def test_solver_graph_rows_and_codec_id_on_card(card, rows):
    """The unified model conditioned on JPEG's codec id, all rows or a
    data-parallel rank's (1, 3) (row 3 is padding): the replays equal the
    eager restore of those rows."""
    from ddpm_image_restoration_tpu_torch.config import codec_index

    model = _graph_model("all")
    kw = dict(GRAPH_RUNS["static"], eta=0.0, rows=rows)
    y = _graph_y()
    want, _ = _counted_run(_sampler(model, "jpeg", codec_index("jpeg")), y, **kw)
    s = _sampler(model, "jpeg", codec_index("jpeg"))
    for call in range(3):
        got, _ = _counted_run(s, y, **kw)
        assert len(s._cache.graphs) == min(call, 1) and _same(got, want)
    assert got[0].shape[0] == (3 if rows is None else 2)


@pytest.mark.cuda
def test_solver_graph_reads_weights_by_address_on_card(card):
    """An in-place weight update between replays is seen by the replay (it
    equals a fresh eager run on the updated weights); a reassigned
    parameter changes the signature, so its first call runs eager."""
    model = _graph_model()
    kw = dict(GRAPH_RUNS["static"], eta=0.0)
    y = _graph_y()
    s = _sampler(model)
    for _ in range(2):
        before, _ = _counted_run(s, y, **kw)
    with torch.no_grad():
        model.out_conv.weight.mul_(0.5)
    got, _ = _counted_run(s, y, **kw)
    want, _ = _counted_run(_sampler(model), y, **kw)
    assert len(s._cache.graphs) == 1 and _same(got, want) and not _same(got, before)
    model.out_conv.weight = torch.nn.Parameter(model.out_conv.weight.clone(),
                                               requires_grad=False)
    seen = len(s._cache.seen)
    _counted_run(s, y, **kw)
    assert len(s._cache.graphs) == 1 and len(s._cache.seen) == seen + 1


@pytest.mark.cuda
def test_serve_core_replays_on_card(card):
    """`restore_batch` keeps one sampler per (model, codec): three calls
    of one signature give one graph, equal outputs and equal launches."""
    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch, sampler_for

    model = _graph_model()
    y = _graph_y()
    outs, counts = [], []
    for _ in range(3):
        before = fa.flash_attention_fwd.launches
        outs.append(restore_batch(model, y, 30, "webp", final_exact=False))
        torch.cuda.synchronize()
        counts.append(fa.flash_attention_fwd.launches - before)
    assert len(sampler_for(model, "webp")._cache.graphs) == 1
    assert len(set(counts)) == 1 and counts[0] > 0
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


# A failed capture leaves the process's CUDA state unusable (the default
# generator stays marked as capturing: PyTorch's own test of a failed
# capture runs in a subprocess too), so this one runs in a process of its own.
FAILED_CAPTURE = """
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
from tests.test_torch_kernels_cuda import GRAPH_RUNS, _counted_run, _graph_model, _graph_y, _sampler

model = _graph_model()
encode = model.encode


def waiting_encode(x, *a, **k):
    x.sum().item()
    return encode(x, *a, **k)


model.encode = waiting_encode
kw = dict(GRAPH_RUNS["static"], eta=0.0)
s = _sampler(model)
_counted_run(s, _graph_y(), **kw)
for _ in range(2):
    before = [fn.launches for fn in fa.COUNTED_KERNELS]
    try:
        _counted_run(s, _graph_y(), **kw)
    except RuntimeError as e:
        print("raised:", str(e).strip().splitlines()[0])
    else:
        raise SystemExit("the capture did not raise")
    assert not s._cache.graphs, s._cache.graphs
    assert [fn.launches for fn in fa.COUNTED_KERNELS] == before
print("ok")
"""


@pytest.mark.cuda
def test_solver_graph_failed_capture_raises_on_card(card):
    """A loop that waits on the device (here an `.item()` in the model's
    encoder) runs eager on its first call and raises on the capture, every
    time: no quiet eager fallback, no graph kept, the launch counters left
    as they were."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", FAILED_CAPTURE], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.count("raised:") == 2, \
        proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok"), proc.stdout


# -- The train step as a captured CUDA graph (train/steps.py): the first call
# of a signature runs eager, the second captures and replays, later ones
# replay. Width/8 models at 64², bf16, dropout 0.1, EMA on, flash at 32²
# (T = 1024), a batch of 3.

TRAIN_GRAPH_STEPS = 5
STATE_PARTS = ("params", "mu", "nu", "ema")


def _train_batches(codec, n=TRAIN_GRAPH_STEPS):
    batches = []
    for i in range(n):
        g = torch.Generator().manual_seed(10 + i)
        x0 = torch.rand(3, 64, 64, 3, generator=g) * 2 - 1
        b = {"x0": x0, "xt": (x0 + 0.1 * torch.randn(x0.shape, generator=g)).clamp(-1, 1),
             "t": torch.randint(1, 100, (3,), generator=g, dtype=torch.int32)}
        if codec == "all":
            b["codec_id"] = torch.tensor([0, 1, 2])
        batches.append({k: v.cuda() for k, v in b.items()})
    return batches


def _train_run(codec, graph: bool, dtype="bfloat16", remat=False):
    """TRAIN_GRAPH_STEPS steps from one seeded model and state on distinct
    batches, through `train_step` (graph) or `train_step.eager`: per step
    the loss, grad norm and flash launches; the state, `.grad` and the
    step after."""
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    model = _graph_model(codec, dtype, remat)
    cfg = TrainConfig(codec=codec, model=model.cfg, batch_size=3, ema_decay=0.999)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"loss": [], "grad_norm": [], "counts": []}
    for b in _train_batches(codec):
        before = [fn.launches for fn in fa.COUNTED_KERNELS]
        m = (step if graph else step.eager)(state, b, gen)
        torch.cuda.synchronize()
        out["counts"].append([fn.launches - n for fn, n in zip(fa.COUNTED_KERNELS, before)])
        out["loss"].append(m["loss"])
        out["grad_norm"].append(m["grad_norm"])
    out["loss"], out["grad_norm"] = torch.stack(out["loss"]), torch.stack(out["grad_norm"])
    for part in STATE_PARTS:
        out[part] = {k: v.clone() for k, v in getattr(state, part).items()}
    out["grad"] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    return out, state, step


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max((a[k].float() - b[k].float()).abs().max().item() for k in a)
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["webp", "avif", "all"])
def test_train_graph_equals_eager_on_card(card, codec):
    """Five steps from copies of one state (the unified model with a
    per-sample codec_id), under torch's deterministic algorithms (warn
    only: the AVIF gates' antialiased resize has no deterministic
    backward, and runs): the graph path (eager, capture, three replays)
    against the first of three eager runs, per quantity (losses, grad
    norms, masters, moments, EMA, the last step's `.grad`): bit for bit
    where the eager runs agree bit for bit, else within twice their
    spread. One graph, four replays, and each step counts the eager step's
    flash launches; the losses are distinct (copies, not the graph's
    static output)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs = [_train_run(codec, graph=False)[0] for _ in range(3)]
            graph, state, step = _train_run(codec, graph=True)
        finally:
            torch.use_deterministic_algorithms(False)
    eager = runs[0]
    assert len(step.graphs) == 1 and next(iter(step.graphs.values())).replays == 4
    assert state.step == TRAIN_GRAPH_STEPS
    assert graph["counts"] == eager["counts"] and eager["counts"][0] == [2, 2, 2]
    assert torch.isfinite(graph["loss"]).all()
    assert len(set(graph["loss"].tolist())) == TRAIN_GRAPH_STEPS
    for part in ("loss", "grad_norm", *STATE_PARTS, "grad"):
        spread = max(_max_diff(a[part], b[part]) for i, a in enumerate(runs) for b in runs[i + 1:])
        err = _max_diff(graph[part], eager[part])
        assert (err == 0) if spread == 0 else (err <= 2 * spread), (part, err, spread)


def _deterministic(run):
    """`run()` under torch's deterministic algorithms, warn only."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return run()
        finally:
            torch.use_deterministic_algorithms(False)


def _held_to_eager(graph, runs, parts):
    """Per quantity, the graph against the first eager run: bit for bit
    where the eager runs agree bit for bit, else within twice their
    spread."""
    for part in parts:
        spread = max(_max_diff(a[part], b[part]) for i, a in enumerate(runs) for b in runs[i + 1:])
        err = _max_diff(graph[part], runs[0][part])
        assert (err == 0) if spread == 0 else (err <= 2 * spread), (part, err, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_remat_train_graph_equals_eager_on_card(card, dtype):
    """Block remat with dropout 0.1 (each block's mask drawn before its
    checkpoint): five steps through the graph path against three eager
    runs under deterministic algorithms, as above; each step launches the
    forward twice per attention block (the recompute), dQ and dK/dV
    once."""
    runs = _deterministic(lambda: [_train_run("webp", False, dtype, remat=True)[0]
                                   for _ in range(3)])
    graph, state, step = _deterministic(lambda: _train_run("webp", True, dtype, remat=True))
    assert len(step.graphs) == 1 and next(iter(step.graphs.values())).replays == 4
    assert graph["counts"] == runs[0]["counts"] and runs[0]["counts"][0] == [4, 2, 2]
    assert len(set(graph["loss"].tolist())) == TRAIN_GRAPH_STEPS
    _held_to_eager(graph, runs, ("loss", "grad_norm", *STATE_PARTS, "grad"))


# -- The distill step as a captured CUDA graph (train/distill.py): the
# teacher and the student are the width/8 model above with one seed's
# weights; q30 over 20 diffusion steps, the teacher at stride 10 (3
# evaluations), the student at 2, EMA on, a batch of 3.

DISTILL_GRAPH_STEPS = 4


def _distill_run(dtype, remat: bool, graph: bool, steps=DISTILL_GRAPH_STEPS):
    """`steps` distill steps on distinct batches through the step (graph)
    or `step.eager`: per step the loss, grad norm and flash launches; the
    state and `.grad` after."""
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.train.distill import DistillConfig, make_distill_step
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state

    teacher, student = _graph_model("webp", dtype), _graph_model("webp", dtype)
    cfg = TrainConfig(codec="webp", model=student.cfg, steps=20, batch_size=3, ema_decay=0.999)
    state = create_train_state(student, cfg)
    step, *_ = make_distill_step(student, teacher, cfg,
                                 DistillConfig(n_eval=2, teacher_stride=10), 30, remat=remat)
    out = {"loss": [], "grad_norm": [], "counts": []}
    for b in _train_batches("webp", steps):
        before = [fn.launches for fn in fa.COUNTED_KERNELS]
        m = (step if graph else step.eager)(state, {"x0": b["x0"], "xt": b["xt"]})
        torch.cuda.synchronize()
        out["counts"].append([fn.launches - n for fn, n in zip(fa.COUNTED_KERNELS, before)])
        out["loss"].append(m["loss"])
        out["grad_norm"].append(m["grad_norm"])
    out["loss"], out["grad_norm"] = torch.stack(out["loss"]), torch.stack(out["grad_norm"])
    for part in STATE_PARTS:
        out[part] = {k: v.clone() for k, v in getattr(state, part).items()}
    out["grad"] = {n: p.grad.float().clone() for n, p in student.named_parameters()}
    return out, state, step


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_distill_graph_equals_eager_on_card(card, dtype, remat):
    """Four distill steps through the graph path (eager, capture, two
    replays) against three runs of `step.eager`, under deterministic
    algorithms: losses, grad norms, masters, moments, EMA and the last
    `.grad` bit for bit where the eager runs agree bit for bit, else within
    twice their spread. One graph, three replays; every step counts the
    eager step's flash launches: the forward 2·(3 + (1 + r)·2) times (r =
    1 with the solver's remat), dQ and dK/dV 2·2 times."""
    runs = _deterministic(lambda: [_distill_run(dtype, remat, False)[0] for _ in range(3)])
    graph, state, step = _deterministic(lambda: _distill_run(dtype, remat, True))
    want = [2 * (3 + (2 if remat else 1) * 2), 4, 4]
    assert len(step.cache.graphs) == 1
    assert next(iter(step.cache.graphs.values())).replays == DISTILL_GRAPH_STEPS - 1
    assert state.step == DISTILL_GRAPH_STEPS
    assert graph["counts"] == runs[0]["counts"] == [want] * DISTILL_GRAPH_STEPS
    assert torch.isfinite(graph["loss"]).all()
    assert len(set(graph["loss"].tolist())) == DISTILL_GRAPH_STEPS
    _held_to_eager(graph, runs, ("loss", "grad_norm", *STATE_PARTS, "grad"))


# As the solver's failed capture, in a process of its own; after each
# failure the default generator and the step's own draw again, and the
# step's generator is where it was before the call.
FAILED_DISTILL_CAPTURE = """
import torch
from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
from ddpm_image_restoration_tpu_torch.train.distill import DistillConfig, make_distill_step
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state
from tests.test_torch_kernels_cuda import _graph_model, _train_batches

teacher, student = _graph_model("webp", "bfloat16"), _graph_model("webp", "bfloat16")
encode = student.encode


def waiting_encode(x, *a, **k):
    x.sum().item()
    return encode(x, *a, **k)


student.encode = waiting_encode
cfg = TrainConfig(codec="webp", model=student.cfg, steps=20, batch_size=3, ema_decay=0.999)
state = create_train_state(student, cfg)
step, *_ = make_distill_step(student, teacher, cfg, DistillConfig(n_eval=2, teacher_stride=10), 30)
gen = torch.Generator(device="cuda").manual_seed(3)
b = _train_batches("webp", 1)[0]
batch = {"x0": b["x0"], "xt": b["xt"]}
step(state, batch, gen)
stream = torch.cuda.current_stream()
for _ in range(2):
    before = [fn.launches for fn in fa.COUNTED_KERNELS]
    gen_state = gen.get_state()
    try:
        step(state, batch, gen)
    except RuntimeError as e:
        print("raised:", str(e).strip().splitlines()[0])
    else:
        raise SystemExit("the capture did not raise")
    assert not step.cache.graphs, step.cache.graphs
    assert [fn.launches for fn in fa.COUNTED_KERNELS] == before
    assert state.step == 1, state.step
    assert torch.equal(gen.get_state(), gen_state)
    assert torch.cuda.current_stream() == stream
    torch.randn(4, device="cuda")
    torch.randn(4, device="cuda", generator=gen)
    torch.cuda.synchronize()
    gen.set_state(gen_state)
print("ok")
"""


@pytest.mark.cuda
def test_distill_graph_failed_capture_raises_on_card(card):
    """A distill step that waits on the device (an `.item()` in the
    student's encoder) runs eager on its first call and raises on the
    capture, every time: no eager fallback, no graph kept, the counters,
    the step count and the current stream left as they were, and no
    generator left marked as capturing (each draws again; the step's
    generator is where it was)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", FAILED_DISTILL_CAPTURE], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.count("raised:") == 2, \
        proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok"), proc.stdout


@pytest.mark.cuda
def test_train_graph_captures_on_its_stream_and_recaptures_on_resume(card, monkeypatch):
    """In the capturing call every flash launch, the backward's dQ and
    dK/dV from autograd's thread included, lands on a stream being
    captured, and none in the eager first call. A resume that loads a
    state dict (new EMA tensors) changes the signature: the next call runs
    eager, the one after captures a second graph, whose replay updates the
    new EMA (ema·d + params·(1 − d) at the call's scalars, bit for bit)
    and leaves the old EMA as it was."""
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    model = _graph_model("webp", "bfloat16")
    cfg = TrainConfig(codec="webp", model=model.cfg, batch_size=3, ema_decay=0.999)
    state = create_train_state(model, cfg)
    step, gen = make_train_step(model, cfg), torch.Generator(device="cuda").manual_seed(3)
    batches = _train_batches("webp")
    seen, launch = [], fa._launch

    def recording(name, *a, **k):
        seen.append((name, torch.cuda.is_current_stream_capturing()))
        return launch(name, *a, **k)

    monkeypatch.setattr(fa, "_launch", recording)
    per_call = []
    for b in batches[:3]:
        seen.clear()
        step(state, b, gen)
        torch.cuda.synchronize()
        per_call.append(list(seen))
    assert [c for _, c in per_call[0]] == [False] * 6
    assert sorted(per_call[1]) == sorted([(n, True) for n in ("flash_attention_fwd",
                                                              "flash_attention_bwd_dq",
                                                              "flash_attention_bwd_dkv")] * 2)
    assert per_call[2] == [] and len(step.graphs) == 1
    old_ema = state.ema
    old_values = {k: v.clone() for k, v in old_ema.items()}
    state.load_state_dict(state.state_dict())
    assert state.ema is not old_ema
    seen.clear()
    step(state, batches[3], gen)
    assert len(step.graphs) == 1 and len(seen) == 6 and not any(c for _, c in seen)
    step(state, batches[4], gen)  # captures the resumed state's graph
    assert len(step.graphs) == 2
    before = {k: v.clone() for k, v in state.ema.items()}
    step(state, batches[0], gen)
    torch.cuda.synchronize()
    d, keep = state.scalars.value[3], state.scalars.value[4]
    for k, v in state.ema.items():
        assert torch.equal(v, before[k] * d + state.params[k] * keep), k
    for k, v in old_ema.items():
        assert torch.equal(v, old_values[k]), k


# As the solver's failed capture, in a process of its own.
FAILED_STEP_CAPTURE = """
import torch
from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step
from tests.test_torch_kernels_cuda import _graph_model, _train_batches

model = _graph_model("webp", "bfloat16")
encode = model.encode


def waiting_encode(x, *a, **k):
    x.sum().item()
    return encode(x, *a, **k)


model.encode = waiting_encode
cfg = TrainConfig(codec="webp", model=model.cfg, batch_size=3, ema_decay=0.999)
state = create_train_state(model, cfg)
step, gen = make_train_step(model, cfg), torch.Generator(device="cuda").manual_seed(3)
batch = _train_batches("webp", 1)[0]
step(state, batch, gen)
for _ in range(2):
    before = [fn.launches for fn in fa.COUNTED_KERNELS]
    try:
        step(state, batch, gen)
    except RuntimeError as e:
        print("raised:", str(e).strip().splitlines()[0])
    else:
        raise SystemExit("the capture did not raise")
    assert not step.graphs, step.graphs
    assert [fn.launches for fn in fa.COUNTED_KERNELS] == before
    assert state.step == 1, state.step
print("ok")
"""


@pytest.mark.cuda
def test_train_graph_failed_capture_raises_on_card(card):
    """A step that waits on the device (an `.item()` in the model's
    encoder) runs eager on its first call and raises on the capture, every
    time: no eager fallback, no graph kept, the counters and the step count
    left as they were."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", FAILED_STEP_CAPTURE], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.count("raised:") == 2, \
        proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok"), proc.stdout
