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


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", [(32, 1024, 32), (32, 1024, 16), (72, 1024, 32),
                                    (72, 1024, 16), (8, 4096, 16), (4, 300, 64),
                                    (2, 256, 128), *RAGGED_SHAPES])
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
    # a head dim between the built ones is zero-padded to the next
    q8, k8, v8 = (z[..., :8].contiguous() for z in (q, k, v))
    o8 = fa.flash_attention_fwd(q8, k8, v8)
    torch.cuda.synchronize()
    assert o8.shape == (bh, t, 8)
    assert close(o8, fa.flash_attention_plain(q8, k8, v8), step)
    wide = torch.zeros(bh, t, 136, device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(wide, wide, wide)


BWD_SHAPES = [(72, 1024, 32), (72, 1024, 16), (72, 1024, 64), (4, 300, 64), (4, 1300, 16),
              (2, 256, 128), (3, 200, 8), *RAGGED_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d", BWD_SHAPES)
@pytest.mark.parametrize("dtype,step", STEPS)
def test_bwd_kernels_match_plain_on_card(card, bh, t, d, dtype, step):
    """dQ (with Delta) and dK/dV against the plain backward on the same
    inputs and the same LSE. The training shapes first (18 images x 4 heads,
    32x32 tokens, D 32 and 16), the 32x32 level of the 128² model (D 64),
    then ragged T, a wide head and a head dim that the wrapper zero-pads
    (8 -> 16), each entry within one bf16 `step` of the plain output's (see
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
    """cp.async and ldmatrix read 16-byte rows: a contiguous view that starts
    one element into its storage is refused by every wrapper, not copied."""
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
# up4 (64/8 = 8, which the wrappers zero-pad to 16).
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
    same weights on the plain attention (max |diff| <= 1e-3, the FMA
    kernel's f32 roundoff through ~20 layers), two forward launches (down2
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
