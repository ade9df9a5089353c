#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`ddpm_image_restoration_tpu_torch`) on one
NVIDIA card and checks it, phase by phase:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: every kernel of the serving and training paths, with nvcc, from
     the checkout, one nvcc per source, all started together; each kernel's
     registers, spills and shared memory (`ptxas -v`) and its tensor-core
     instructions (HMMA, counted in `cuobjdump -sass`);
  3. kernels: each kernel against its plain PyTorch version, with times
     (the kernels' and SDPA's as device time under torch.profiler, the
     plain versions' between CUDA events), and the autograd Function's
     gradients against autograd through the plain attention;
  4. reference: a half-width f32 restore on the card against the same
     restore on the CPU (the CPU path is the one the tests hold to the JAX
     package);
  5. serve: the WebP restore server core at full width (64², the release
     widths, bf16, flash attention at <= 32²) on three batches of 8 images
     under the production solver policy, counting the kernel's launches;
  6. train_reference: one half-width f32 train step on the card against the
     same step on the CPU (loss and every gradient);
  7. train: the WebP trainer (`cli/train.py main`) at full width, bf16,
     batch 18, EMA: one epoch, then a second resumed from the checkpoint the
     first wrote, counting each kernel's launches in the train steps; then
     the train step alone, timed and profiled.

    python3 chip_smoke.py

It prints each phase's seconds, then a JSON line of per-kernel numbers, the
card's `nvidia-smi` name and power limit, and last `{"ok": true, ...}`. It
exits non-zero, printing no result, when any phase fails, when no CUDA card
is visible, or when the port's package is not beside it. It needs torch,
numpy and nvcc; Pillow only for the exact final projection, which it skips,
saying why, when Pillow is missing.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ddpm_image_restoration_tpu_torch"
JAX_PACKAGE = PACKAGE.removesuffix("_torch")  # the reference; never imported here

# The forward kernel's shapes on the main paths, (path, BH, T, D, save_lse):
# 32x32 tokens at down2 (head dim 128/4) and up4 (64/4), for a serving batch
# of 8 images, a training batch of 18 (with the LSE the backward needs) and
# the trainer's validation batch of 4 (4 heads each).
FWD_PATH_SHAPES = [("serve", 32, 1024, 32, False), ("serve", 32, 1024, 16, False),
                   ("train step", 72, 1024, 32, True), ("train step", 72, 1024, 16, True),
                   ("validation", 16, 1024, 32, False), ("validation", 16, 1024, 16, False)]
# (BH, T, D): those shapes, then long, ragged and wide-head cases of the
# kernel's contract.
KERNEL_SHAPES = list(dict.fromkeys(s[1:4] for s in FWD_PATH_SHAPES)) + [
    (8, 4096, 16), (4, 300, 64), (2, 256, 128), (3, 17, 32)]
# Backward (BH, T, D): the training path's shapes first (down2 and up4 of a
# batch of 18 images x 4 heads, 32x32 tokens), then contract shapes: the
# 32x32 level of the 128² model (head dim 64, batch 18), and ragged, short
# and wide cases.
BWD_SHAPES = [(72, 1024, 32), (72, 1024, 16), (72, 1024, 64), (4, 300, 64), (4, 1300, 16),
              (2, 256, 128), (3, 17, 32)]
TRAIN_SHAPES = BWD_SHAPES[:2]
# Each kernel against its plain version, entry by entry:
#   |got - ref| <= BF16_STEP * |ref| (bf16 outputs only) + F32_REL * max|ref|.
# Both accumulate in f32 on the same inputs, so their f32 results differ by
# roundoff, which F32_REL of the largest entry covers; a bf16 output is then
# rounded once on each side, which moves the two apart by at most one bf16
# step of that entry (2^-7 of it). The LSE and Delta are f32 in either case.
BF16_STEP = 2 ** -7
F32_REL = 1e-4
# The Function's gradients against autograd through the plain attention,
# within this share of the largest entry: in bf16 the kernels take Delta
# from the rounded output where autograd keeps it in f32, which moved a
# gradient by up to 0.8 bf16 steps of the largest entry on the card; two
# steps are allowed.
FUNCTION_REL = {"bfloat16": 2 ** -6, "float32": F32_REL}
# Which design computes each kernel, per input dtype.
DESIGNS = {
    "flash_attention_fwd": {"bf16": "mma.sync m16n8k16, hi/lo P", "f32": "FMA"},
    "flash_attention_bwd_dq": {"bf16": "mma.sync m16n8k16, hi/lo dS", "f32": "FMA"},
    "flash_attention_bwd_dkv": {"bf16": "mma.sync m16n8k16, hi/lo P and dS", "f32": "FMA"},
}
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense
# tensor-core bf16 and f32 (non-tensor-core) FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}
SERVE_QUALITIES = (10, 30, 50)
SERVE_BATCH = 8
TRAIN_BATCH = 18        # the WebP preset's batch size
TRAIN_IMAGES = 135      # natural synthetic images: 108 train (6 steps an epoch), 13 val
SEED = 0
# The whole run takes well under a minute; past this, fail rather than hang.
TIME_LIMIT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Device time per call: the summed time of the CUDA kernels that
    `iters` calls launch (torch.profiler), over `iters`. Unlike events around
    the calls it leaves out the gaps while the host launches, which decide
    the time of a call made of several short kernels (an autograd
    backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / iters


def max_err(got, ref, rel_max: float | None = None) -> tuple[float, float]:
    """max |got - ref| and its largest share of the bound: by default the
    kernel rule above (BF16_STEP of each entry where ref is bf16, plus
    F32_REL of the largest), else `rel_max` of the largest entry alone."""
    import torch

    step = BF16_STEP if ref.dtype == torch.bfloat16 and rel_max is None else 0.0
    ref = ref.float()
    diff = (got.float() - ref).abs()
    bound = step * ref.abs() + (F32_REL if rel_max is None else rel_max) * ref.abs().max()
    return diff.max().item(), (diff / bound.clamp_min(1e-30)).max().item()


def attention_bound_ms(bh: int, t: int, d: int, dtype_name: str,
                       save_lse: bool = False) -> tuple[float, str]:
    """Least time for the work: q, k, v read once and o (and the f32 LSE)
    written once, over the memory rate; the two T x T x D products over the
    type's peak."""
    elt = 2 if dtype_name == "bfloat16" else 4
    t_bytes = (4 * bh * t * d * elt + (4 * bh * t if save_lse else 0)) / PEAK_BYTES_S
    t_ops = 4 * bh * t * t * d / PEAK_FLOPS_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def bwd_bound_ms(kind: str, bh: int, t: int, d: int, dtype_name: str) -> tuple[float, str]:
    """Least time for one backward kernel's work. Bytes: dQ reads q, k, v,
    o, dO and the LSE and writes dQ and Delta; dK/dV reads q, k, v, dO, the
    LSE and Delta and writes dK and dV: 6 [BH,T,D] tensors and 2 [BH,T] f32
    rows either way. Operations: the T x T x D products, 3 of them for dQ
    (S, dP, dQ) and 4 for dK/dV (S, dP, dV, dK), 2 flops per multiply-add."""
    elt = 2 if dtype_name == "bfloat16" else 4
    t_bytes = (6 * bh * t * d * elt + 8 * bh * t) / PEAK_BYTES_S
    t_ops = {"dq": 6, "dkv": 8}[kind] * bh * t * t * d / PEAK_FLOPS_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def synthetic_images(n: int, size: int, seed: int):
    """Smooth multi-frequency test images in [-1, 1], NHWC float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        for c in range(3):
            fx, fy, ph = rng.uniform(1, 6), rng.uniform(1, 6), rng.uniform(0, 6.28)
            imgs[i, :, :, c] = 0.6 * np.sin(2 * np.pi * fx * xx + ph) * np.cos(2 * np.pi * fy * yy)
    imgs += rng.normal(0, 0.05, imgs.shape).astype(np.float32)
    return np.clip(imgs, -1, 1)


def phase_environment(state: dict) -> None:
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    state["smi"] = nvidia_smi_line()
    log(state["smi"])
    state["pil"] = importlib.util.find_spec("PIL") is not None
    log(f"Pillow importable: {state['pil']}")


def phase_build(state: dict) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from ddpm_image_restoration_tpu_torch.ops import build
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    names = (fa.KERNEL, fa.BWD_KERNEL)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(build.build, names))
    hmma = {}
    for name, (path, seconds) in zip(names, built):
        log(f"built {path.name} with {build.find_nvcc()} in {seconds:.1f} s")
        log_file = path.with_suffix(".log")
        for line in build.ptxas_summary(log_file.read_text() if log_file.exists() else ""):
            log(f"  ptxas: {line}")
        for kernel, n in sass_mma_counts(path, build.find_nvcc()).items():
            hmma[kernel] = n
            log(f"  sass: {kernel}: {n} HMMA instructions")
        build.load(name)
    # the forward, dQ and dK/dV tensor-core kernels, at each of the 4 head dims
    mma = {k: n for k, n in hmma.items() if "_mma_kernel" in k}
    if hmma and (len(mma) != 12 or not all(mma.values())):
        raise AssertionError(f"tensor-core kernels without HMMA in their SASS: {mma}")


def sass_mma_counts(path, nvcc: str) -> dict:
    """Tensor-core (HMMA) instructions per kernel in the library's SASS, from
    `cuobjdump -sass` beside nvcc; {} (logged) where it cannot be run."""
    from ddpm_image_restoration_tpu_torch.ops.build import kernel_label

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"  sass: not measured ({tool}: {e})")
        return {}
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_label(m.group(1))
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def phase_kernels(state: dict) -> None:
    import torch
    import torch.nn.functional as F

    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    failures = []
    for bh, t, d in KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            q4, k4, v4 = (z[None] for z in (q, k, v))
            lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            for save_lse in (False, True):
                got = fa.flash_attention_fwd(q, k, v, save_lse=save_lse)
                ref = fa.flash_attention_plain(q, k, v, save_lse=save_lse)
                torch.cuda.synchronize()
                err = share = 0.0
                pairs = zip(("o", "lse"), got, ref) if save_lse else [("o", got, ref)]
                for part, a, b in pairs:
                    e, sh = max_err(a, b)
                    err, share = max(err, e), max(share, sh)
                    if not sh <= 1.0:
                        failures.append(f"(BH,T,D)=({bh},{t},{d}) {name} {part}: "
                                        f"max|err| {e:.3g}, {sh:.3g} of its bound")
                ms = device_time_ms(lambda: fa.flash_attention_fwd(q, k, v, save_lse))
                event_ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, save_lse))
                plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v, save_lse))
                bound, by = attention_bound_ms(bh, t, d, name, save_lse)
                rows[(bh, t, d, name, save_lse)] = dict(
                    max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound, bound_by=by)
                log(f"flash_attention_fwd (BH,T,D)=({bh},{t},{d}) {name} lse={save_lse}: "
                    f"max|err| {err:.3g} ({share:.3g} of its bound)  "
                    f"kernel {ms:.4f} ms device ({event_ms:.4f} ms between events)  "
                    f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms device  "
                    f"bound {bound:.4f} ms ({by})")
    state["kernel_rows"] = rows
    state["bwd_rows"] = check_backward(failures)
    check_function(failures)
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))


def check_backward(failures: list) -> dict:
    """The dQ kernel (with Delta) and the dK/dV kernel against their plain
    versions on the same inputs and LSE; their times, the plain versions',
    and scaled_dot_product_attention's backward at the same shape (it
    computes dQ, dK and dV in one call: the yardstick for both rows). Kernel
    and SDPA times are device time (`device_time_ms`), since a call's host
    overhead exceeds the tensor-core kernels' time; the kernels' times
    between CUDA events are kept beside them."""
    import torch
    import torch.nn.functional as F

    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {}
    for bh, t, d in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v, save_lse=True)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
            rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
            rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, rdelta)
            torch.cuda.synchronize()
            outs = {"dq": (("dq", dq, rdq), ("delta", delta, rdelta)),
                    "dkv": (("dk", dk, rdk), ("dv", dv, rdv))}
            errs = {}
            for kind, parts in outs.items():
                errs[kind] = 0.0
                for part, got, ref in parts:
                    e, sh = max_err(got, ref)
                    errs[kind] = max(errs[kind], e)
                    log(f"  {part} (BH,T,D)=({bh},{t},{d}) {name}: max|err| {e:.3g}, "
                        f"{sh:.3g} of its bound, max|ref| {ref.float().abs().max().item():.3g}")
                    if not sh <= 1.0:
                        failures.append(f"bwd {part} (BH,T,D)=({bh},{t},{d}) {name}: "
                                        f"max|err| {e:.3g}, {sh:.3g} of its bound")
            kernel_calls = {"dq": lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse),
                            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)}
            plain_calls = {
                "dq": lambda: fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse),
                "dkv": lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)}
            times = {kind: (device_time_ms(kernel_calls[kind]), cuda_time_ms(kernel_calls[kind]),
                            cuda_time_ms(plain_calls[kind])) for kind in kernel_calls}
            q4, k4, v4 = (z[None].detach().requires_grad_() for z in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4)

            def lib_backward():
                return torch.autograd.grad(out4, (q4, k4, v4), do[None], retain_graph=True)

            lib_ms = device_time_ms(lib_backward)
            lib_event_ms = cuda_time_ms(lib_backward)
            role = "train step" if (bh, t, d) in TRAIN_SHAPES else "contract"
            for kind in ("dq", "dkv"):
                err, (ms, event_ms, plain_ms) = errs[kind], times[kind]
                bound, by = bwd_bound_ms(kind, bh, t, d, name)
                rows[(kind, bh, t, d, name)] = dict(max_abs_err=err, ms=ms, event_ms=event_ms,
                                                    plain_ms=plain_ms, library_ms=lib_ms,
                                                    bound_ms=bound, bound_by=by)
                log(f"flash_attention_bwd_{kind} (BH,T,D)=({bh},{t},{d}) {name} [{role}]: "
                    f"max|err| {err:.3g}  kernel {ms:.4f} ms device ({event_ms:.4f} ms between "
                    f"events)  plain {plain_ms:.4f} ms  "
                    f"sdpa backward {lib_ms:.4f} ms device ({lib_event_ms:.4f} ms between "
                    f"events)  bound {bound:.4f} ms ({by})")
    return rows


def check_function(failures: list) -> None:
    """spatial_attention(impl='flash') under autograd (the Function: the
    forward kernel with LSE, then the dQ and dK/dV kernels) against autograd
    through the plain attention, at the training path's down2 (D = 32) and
    up4 (D = 16) shapes: the output and the gradients of q, k and v."""
    import torch

    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.ops.attention import spatial_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for (bh, t, d), dtype in ((s, dt) for s in TRAIN_SHAPES
                              for dt in (torch.bfloat16, torch.float32)):
        name = str(dtype).split(".")[-1]
        shape = (bh // 4, t, 4, d)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        counts = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
        results = []
        for impl in ("flash", "xla"):
            leaves = [z.clone().requires_grad_() for z in (q, k, v)]
            out = spatial_attention(*leaves, impl=impl)
            results.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
        torch.cuda.synchronize()
        ran = (fa.flash_attention_bwd_dq.launches - counts[0],
               fa.flash_attention_bwd_dkv.launches - counts[1])
        if ran != (1, 1):
            failures.append(f"Function {list(shape)} {name}: backward launches {ran}")
        for part, got, ref in zip(("o", "dq", "dk", "dv"), *results):
            e, sh = max_err(got, ref, None if part == "o" else FUNCTION_REL[name])
            log(f"FlashAttention {part} [B,T,H,D]={list(shape)} {name} vs autograd through "
                f"the plain attention: max|diff| {e:.3g}, {sh:.3g} of its bound, max|ref| "
                f"{ref.float().abs().max().item():.3g}; backward launches (dQ, dK/dV) {ran}")
            if not sh <= 1.0:
                failures.append(f"Function {part} {list(shape)} {name}: max|diff| {e:.3g}, "
                                f"{sh:.3g} of its bound")


def phase_reference(state: dict) -> None:
    """A small f32 restore (64², half widths, flash at <= 32², so down2 and
    up4 take the kernel at T = 1024, D = 16) on the card against the same
    restore on the CPU."""
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    cfg = ModelConfig(compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(2)
    torch.manual_seed(SEED)
    cpu_model = build_model("webp", cfg, device="cpu")
    gpu_model = build_model("webp", cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    x0 = torch.from_numpy(synthetic_images(2, cfg.image_size, SEED + 1))
    y = codec_surrogate(x0, 10, codec="webp")
    # f32 convolutions in full f32 on both sides (cuDNN would use TF32)
    torch.backends.cudnn.allow_tf32 = False
    try:
        out_cpu = restore_batch(cpu_model, y, 10, final_exact=False)
        before = fa.flash_attention_fwd.launches
        out_gpu = restore_batch(gpu_model, y.cuda(), 10, final_exact=False).cpu()
        launched = fa.flash_attention_fwd.launches - before
    finally:
        torch.backends.cudnn.allow_tf32 = True
    diff = (out_cpu - out_gpu).abs()
    log(f"card vs CPU restore (2x64x64, half width, f32, q10, {launched} kernel launches): "
        f"max|diff| {diff.max().item():.3g}  mean|diff| {diff.mean().item():.3g}")
    # The surrogate rounds DCT coefficients; a last-bit difference can move
    # one coefficient by a quantisation step, so the max is looser than the mean.
    if not (launched > 0 and np.isfinite(out_gpu.numpy()).all()
            and diff.mean().item() <= 1e-4 and diff.max().item() <= 2e-2):
        raise AssertionError("the card's restore disagrees with the CPU's")


def phase_serve(state: dict) -> None:
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch, solver_for
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import _solver_indices
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.train.checkpoint import load_release_params

    cfg = ModelConfig(attention_impl="flash", attn_max_resolution=32)  # webp, full width
    torch.manual_seed(SEED)
    model = build_model("webp", cfg, device="cuda")
    npz = os.path.join(ROOT, "artifacts_release", "webp_real_r5.npz")
    if os.path.exists(npz):
        model.load_state_dict(load_release_params(npz))
        log(f"weights: {npz}")
    else:
        log(f"weights: seeded random init (seed {SEED}); {npz} not in this copy")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: webp, {n_params / 1e6:.1f} M parameters, {cfg.compute_dtype}, "
        f"attention flash at <= {cfg.attn_max_resolution}^2")
    final_exact = state["pil"]
    if not final_exact:
        log("final_exact: skipped, Pillow cannot be imported here (the exact "
            "host codec needs it; the card path does not)")

    preset = get_preset("webp")
    batches, expected = [], 0
    for i, q in enumerate(SERVE_QUALITIES):
        x0 = torch.from_numpy(synthetic_images(SERVE_BATCH, cfg.image_size, SEED + 10 + i)).cuda()
        batches.append((q, codec_surrogate(x0, q, codec="webp")))
        init_t = init_timestep_for_quality(q, 100, preset)
        stride, reuse, _, _ = solver_for(init_t, q, "webp")
        n_evals = len(_solver_indices(init_t, stride))
        # one T=1024 level in the encoder (down2), one in the decoder (up4)
        expected += n_evals + math.ceil(n_evals / reuse)
        log(f"q{q}: init_t {init_t}, stride {stride}, {n_evals} evaluations, "
            f"encoder reuse {reuse}")

    torch.cuda.synchronize()
    _reset_counts()
    outs = [restore_batch(model, y, q, "webp", final_exact=final_exact) for q, y in batches]
    torch.cuda.synchronize()
    state["launches"] = counts = _counts()
    launches = counts[fa.KERNEL]
    log(f"launches on the serving path: {counts} (schedule implies {expected} forward, "
        f"no backward)")
    if launches != expected or counts["flash_attention_bwd_dq"] or \
            counts["flash_attention_bwd_dkv"]:
        raise AssertionError(f"kernels launched {counts}, schedule implies {expected} forward")
    for (q, y), out in zip(batches, outs):
        o = out.cpu().numpy()
        if o.shape != tuple(y.shape) or not np.isfinite(o).all() or np.abs(o).max() > 1.0:
            raise AssertionError(f"q{q}: bad output shape {o.shape}, finite "
                                 f"{np.isfinite(o).all()}, max |x| {np.abs(o).max()}")

    # steady-state timing: the same three batches again
    times = []
    for q, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_batch(model, y, q, "webp", final_exact=final_exact)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / len(times)
    log(f"serve: {ms:.1f} ms/batch of {SERVE_BATCH}, {SERVE_BATCH * len(times) / sum(times):.1f} "
        f"img/s on {state['smi']} (final_exact {final_exact})")
    profile_run(f"one batch of {SERVE_BATCH}, q30",
                lambda: restore_batch(model, batches[1][1], batches[1][0], "webp",
                                      final_exact=final_exact))


def profile_run(label: str, run) -> None:
    """Where one call's time goes: device-busy share of the wall time and
    the kernels with the most device time (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile ({label}): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}%), "
        f"{sum(e.count for e in events)} device kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matmuls in full f32 inside the block (cuDNN
    defaults its f32 convolutions to TF32)."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _reset_counts() -> None:
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        fn.launches = 0


def _counts() -> dict:
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    return {fn.__name__: fn.launches for fn in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)}


def phase_train_reference(state: dict) -> None:
    """One f32 train step of a half-width model (64², flash attention at
    <= 32², so down2 and up4 go through the Function at T = 1024, D = 16)
    on the card against the same step on the CPU: the loss within rtol
    1e-4; every gradient entry within 1e-4 of the model's largest; the
    attention projections of the two flash levels each within 1e-3 of their
    own largest entry (f32 sums in other orders through ~30 layers)."""
    import dataclasses

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    model_cfg = dataclasses.replace(ModelConfig(compute_dtype="float32", attention_impl="flash",
                                                attn_max_resolution=32), dropout=0.0).scaled(2)
    cfg = TrainConfig(codec="webp", model=model_cfg, ema_decay=0.999)
    torch.manual_seed(SEED)
    cpu_model = build_model("webp", model_cfg, device="cpu")
    gpu_model = build_model("webp", model_cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    x0 = torch.from_numpy(synthetic_images(4, 64, SEED + 3))
    batch = {"x0": x0, "xt": codec_surrogate(x0, 20, codec="webp"),
             "t": torch.tensor([10, 35, 60, 90], dtype=torch.int32)}
    with no_tf32():
        cpu_m = make_train_step(cpu_model, cfg)(create_train_state(cpu_model, cfg), batch, None)
        _reset_counts()
        gpu_m = make_train_step(gpu_model, cfg)(
            create_train_state(gpu_model, cfg), {k: v.cuda() for k, v in batch.items()}, None)
        torch.cuda.synchronize()
    counts = _counts()
    # the loss's angle term jumps by 2 pi at a real-valued FFT bin whose
    # imaginary part takes another sign: count such bins between the two
    flips = 0
    with torch.no_grad():
        xt = batch["xt"].cuda()
        pred_gpu = xt + gpu_model(xt, batch["t"].cuda() / 100.0)
        for z in (batch["x0"], pred_gpu.cpu()):
            a = torch.angle(torch.fft.rfft2(z.permute(0, 3, 1, 2) * 0.5 + 0.5))
            b = torch.angle(torch.fft.rfft2(z.cuda().permute(0, 3, 1, 2) * 0.5 + 0.5)).cpu()
            flips += int(((a - b).abs() > 1.0).sum())
    loss_rel = abs(gpu_m["loss"].item() - cpu_m["loss"].item()) / abs(cpu_m["loss"].item())
    cpu_g = {n: p.grad for n, p in cpu_model.named_parameters()}
    g_max = max(g.abs().max().item() for g in cpu_g.values())
    worst, worst_attn = (0.0, ""), (0.0, "")
    for n, p in gpu_model.named_parameters():
        diff = (p.grad.cpu() - cpu_g[n]).abs().max().item()
        worst = max(worst, (diff / g_max, n))
        if n.startswith(("down2.attn.", "up4.attn.")):
            worst_attn = max(worst_attn, (diff / cpu_g[n].abs().max().item(), n))
    log(f"card vs CPU train step (4x64x64, half width, f32): loss {gpu_m['loss'].item():.6f} vs "
        f"{cpu_m['loss'].item():.6f} (rel {loss_rel:.3g}); worst gradient |diff|/max|g| "
        f"{worst[0]:.3g} ({worst[1]}); worst flash-level attention gradient "
        f"|diff|/own max {worst_attn[0]:.3g} ({worst_attn[1]}); launches {counts}; "
        f"FFT angle flips between card and CPU {flips}")
    if counts != {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                  "flash_attention_bwd_dkv": 2}:
        raise AssertionError(f"the card's train step launched {counts}")
    if not (np.isfinite(gpu_m["loss"].item()) and loss_rel <= 1e-4 and worst[0] <= 1e-4
            and worst_attn[0] <= 1e-3):
        raise AssertionError("the card's train step disagrees with the CPU's")


def phase_train(state: dict) -> None:
    """The WebP trainer at full width through its entry point: one epoch,
    then a second resumed from the first's checkpoint. In each run the
    kernels must launch as the schedule implies: per train step the forward
    kernel with LSE at down2 and up4 and one dQ and one dK/dV launch each;
    per validation (3 qualities, init_t model evaluations each at stride 1)
    one forward launch at down2 (encode) and one at up4 (decode) per
    evaluation. Then the train step alone, timed and profiled."""
    import shutil

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.train import main as train_main
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig, get_preset
    from ddpm_image_restoration_tpu_torch.data.dataset import split_indices
    from ddpm_image_restoration_tpu_torch.train.steps import make_train_step

    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    preset = get_preset("webp")
    steps = len(split_indices(TRAIN_IMAGES)[0]) // TRAIN_BATCH
    val_evals = sum(init_timestep_for_quality(q, 100, preset) for q in preset.val_qualities)
    expected = {"flash_attention_fwd": 2 * steps + 2 * val_evals,
                "flash_attention_bwd_dq": 2 * steps, "flash_attention_bwd_dkv": 2 * steps}
    argv = ["--codec", "webp", "--attn", "flash", "--attn-max-res", "32", "--batch-size",
            str(TRAIN_BATCH), "--ema-decay", "0.999", "--synthetic", str(TRAIN_IMAGES),
            "--synthetic-kind", "natural", "--checkpoint-dir", ckpt_dir, "--seed", str(SEED),
            "--device", "cuda"]
    totals = dict.fromkeys(expected, 0)
    try:
        for epochs in (1, 2):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            train_state, hist = train_main(argv + ["--epochs", str(epochs)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] += v
            model = train_state.model
            qkv = {lvl: getattr(model, lvl).attn.qkv.weight.grad for lvl in ("down2", "up4")}
            log(f"train run to epoch {epochs}: {wall:.1f} s; epoch {epochs - 1}: loss "
                f"{hist['loss'][-1]:.4f}, val_psnr {hist['val_psnr'][-1]:.3f}, val_ssim "
                f"{hist['val_ssim'][-1]:.4f}, {hist['step_ms'][-1]:.1f} ms/step in the loop "
                f"(data pipeline included), epoch {hist['epoch_time'][-1]:.1f} s; optimizer step "
                f"{train_state.step}; launches {counts} (schedule implies {expected}); "
                f"|qkv grad| max down2 {qkv['down2'].abs().max().item():.3g}, "
                f"up4 {qkv['up4'].abs().max().item():.3g}")
            if counts != expected:
                raise AssertionError(f"kernel launches {counts}, schedule implies {expected}")
            if not (len(hist["loss"]) == 1 and train_state.step == epochs * steps):
                raise AssertionError(f"run to epoch {epochs} trained {len(hist['loss'])} "
                                     f"epochs, {train_state.step} steps: no resume")
            if not (np.isfinite(hist["loss"]).all() and np.isfinite(hist["val_psnr"]).all()):
                raise AssertionError(f"non-finite loss or val PSNR: {dict(hist)}")
            for lvl, g in qkv.items():
                if g is None or not torch.isfinite(g).all() or g.abs().max().item() == 0:
                    raise AssertionError(f"{lvl}.attn.qkv got no gradient")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    state["launches_train"] = totals

    # the train step alone, on one device batch (no data pipeline)
    cfg = TrainConfig(codec="webp", model=ModelConfig(attention_impl="flash",
                                                      attn_max_resolution=32),
                      batch_size=TRAIN_BATCH, ema_decay=0.999)
    x0 = torch.from_numpy(synthetic_images(TRAIN_BATCH, 64, SEED + 4)).cuda()
    t = torch.randint(1, 100, (TRAIN_BATCH,), generator=torch.Generator().manual_seed(SEED))
    batch = {"x0": x0, "xt": codec_surrogate(x0, 30, codec="webp"), "t": t.cuda()}
    step = make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    step(train_state, batch, gen)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step(train_state, batch, gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"train step alone (webp, full width, bf16, batch {TRAIN_BATCH}, EMA): {ms:.1f} ms/step, "
        f"{TRAIN_BATCH * 1e3 / ms:.1f} img/s on {state['smi']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_run(f"one train step, batch {TRAIN_BATCH}", lambda: step(train_state, batch, gen))


PHASES = [("environment", phase_environment), ("build", phase_build),
          ("kernels", phase_kernels), ("reference", phase_reference),
          ("serve", phase_serve), ("train_reference", phase_train_reference),
          ("train", phase_train)]


def kernels_json(state: dict) -> str:
    """One row per kernel. Its top-level numbers are at the first serving
    or training shape in bf16 (down2); `main_path_shapes` has each shape the
    main paths give it, with its own error and times. `launches` sums the
    main paths' runs (serve, then train), each counted from 0;
    `launches_by_path` splits it."""
    serve, train = state["launches"], state.get("launches_train", {})

    def row(name, source, replaces, rows, shapes, key):
        per_shape = [{"path": path, "shape_bh_t_d": [bh, t, d], "dtype": "bfloat16",
                      "save_lse": lse, **rows[key(bh, t, d, "bfloat16", lse)]}
                     for path, bh, t, d, lse in shapes]
        first = per_shape[0]
        by_path = {"serve": serve.get(name, 0), "train": train.get(name, 0)}
        return {
            "name": name, "route": "cuda", "source": f"{PACKAGE}/csrc/{source}",
            "design": DESIGNS[name],
            "replaces": f"{JAX_PACKAGE}/ops/pallas/flash_attention.py:{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "shape": "BH=%d,T=%d,D=%d bf16 (%s, down2)" % (*first["shape_bh_t_d"], first["path"]),
            "main_path_shapes": per_shape,
        }

    fwd_rows, bwd_rows = state["kernel_rows"], state.get("bwd_rows", {})
    kernels = [row("flash_attention_fwd", "flash_attention_fwd.cu", 51, fwd_rows,
                   FWD_PATH_SHAPES, lambda *k: k)]
    for kind, line in (("dq", 207), ("dkv", 247)):
        rows = {k: r for k, r in bwd_rows.items() if k[0] == kind}
        kernels.append(row(f"flash_attention_bwd_{kind}", "flash_attention_bwd.cu", line,
                           rows, [("train step", *s, True) for s in TRAIN_SHAPES],
                           lambda bh, t, d, n, lse, kind=kind: (kind, bh, t, d, n)))
    return json.dumps({"kernels": kernels})


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    def on_alarm(signum, frame):
        raise TimeoutError(f"chip_smoke exceeded {TIME_LIMIT_S} s")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(TIME_LIMIT_S)
    state: dict = {}
    t_all = time.perf_counter()
    for name, fn in PHASES:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn(state)
        except Exception:
            traceback.print_exc()
            log(f"== phase {name} FAILED after {time.perf_counter() - t0:.1f} s")
            return 1
        log(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s")
    log(f"all phases ok in {time.perf_counter() - t_all:.1f} s")
    log(kernels_json(state))
    log(state["smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
