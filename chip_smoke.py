#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`ddpm_image_restoration_tpu_torch`) on one
NVIDIA card and checks it, phase by phase:

  1. environment: torch and CUDA versions, the card's name and power limit,
     Pillow's version and whether it writes AVIF;
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
     package), a traced-budget, mixed-quality one with decoder reuse, and
     one of the AVIF-preset model;
  5. serve: the WebP restore server core at full width (64², the release
     widths, bf16, flash attention at <= 32²) on three batches of 8 images
     under the production solver policy, counting the kernel's launches;
  6. train_reference: one half-width f32 train step on the card against the
     same step on the CPU (loss and every gradient), WebP and AVIF presets;
  7. train: the WebP trainer (`cli/train.py main`) at full width, bf16,
     batch 18, EMA: one epoch, then a second resumed from the checkpoint the
     first wrote, counting each kernel's launches in the train steps; then
     the train step alone, timed and profiled;
  8. restore: the restore CLI (`cli/restore.py main`) at full width on
     WebP and JPEG files that Pillow writes (estimated qualities, decoder
     reuse at depth 1 and 2, a 2-way ensemble, tiles of a non-square
     image, and the EMA weights of the checkpoint phase `train` wrote), then
     the server (`cli/serve.py main`) on mixed codecs with the traced
     budget; each variant's kernel launches against its schedule, and its
     milliseconds per image;
  9. evaluate: the evaluator (`cli/evaluate.py main`) at full width on 20
     images, q10/30/50 under the production policy, static and traced:
     launches against the schedule, the metrics summary's fields, images
     per second per quality;
 10. avif: the AVIF model family at full width: `cli/train.py --codec
     avif` (one epoch, EMA, checkpoint), `cli/evaluate.py` and
     `cli/restore.py --model-codec avif` on that checkpoint (AVIF files
     Pillow writes), then two steps of `cli/train.py --codec all`; every
     kernel's launches against the schedule.

    python3 chip_smoke.py

It prints each phase's seconds, then a JSON line of per-kernel numbers, the
card's `nvidia-smi` name and power limit, and last `{"ok": true, ...}`. It
exits non-zero, printing no result, when any phase fails, when no CUDA card
is visible, or when the port's package is not beside it. It needs torch,
numpy, scipy (the Fréchet distance), nvcc and Pillow with AVIF (phases
`restore`, `evaluate` and `avif` read and write image files; the serving
phase skips the exact final projection, saying why, without Pillow).
"""

from __future__ import annotations

import argparse
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
# of 8 images (the evaluator's too), a training batch of 18 (with the LSE
# the backward needs), the trainer's validation batch of 4, the restore
# CLI's single files, its tile batches of 16 and the serve CLI's batches of
# 7 (4 heads each); then the AVIF model's (8 heads: head dim 128/8 = 16 at
# down2, 64/8 = 8 at up4, which the wrapper zero-pads to 16) for its
# training and evaluation batches of 8, its validation batch of 4 and the
# restore CLI's single files.
FWD_PATH_SHAPES = [("serve", 32, 1024, 32, False), ("serve", 32, 1024, 16, False),
                   ("train step", 72, 1024, 32, True), ("train step", 72, 1024, 16, True),
                   ("validation", 16, 1024, 32, False), ("validation", 16, 1024, 16, False),
                   ("restore", 4, 1024, 32, False), ("restore", 4, 1024, 16, False),
                   ("restore tiles", 64, 1024, 32, False), ("restore tiles", 64, 1024, 16, False),
                   ("serve CLI", 28, 1024, 32, False), ("serve CLI", 28, 1024, 16, False),
                   ("avif train step", 64, 1024, 16, True), ("avif train step", 64, 1024, 8, True),
                   ("avif evaluate", 64, 1024, 16, False), ("avif evaluate", 64, 1024, 8, False),
                   ("avif validation", 32, 1024, 16, False),
                   ("avif validation", 32, 1024, 8, False),
                   ("avif restore", 8, 1024, 16, False), ("avif restore", 8, 1024, 8, False)]
# (BH, T, D): those shapes, then long, ragged and wide-head cases of the
# kernel's contract.
KERNEL_SHAPES = list(dict.fromkeys(s[1:4] for s in FWD_PATH_SHAPES)) + [
    (8, 4096, 16), (4, 300, 64), (2, 256, 128), (3, 17, 32)]
# Backward (BH, T, D) -> heads: the training paths' shapes first (down2 and
# up4 of a WebP batch of 18 images x 4 heads and of an AVIF batch of 8 x 8
# heads, 32x32 tokens), then contract shapes: the 32x32 level of the 128²
# model (head dim 64, batch 18), and ragged, short and wide cases.
TRAIN_SHAPES = {(72, 1024, 32): 4, (72, 1024, 16): 4, (64, 1024, 16): 8, (64, 1024, 8): 8}
BWD_SHAPES = [*TRAIN_SHAPES, (72, 1024, 64), (4, 300, 64), (4, 1300, 16), (2, 256, 128),
              (3, 17, 32)]
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
# The restore phase's files: 2 WebPs 64² at each quality, 2 JPEGs, and one
# non-square WebP for tile mode; the CLIs' common flags (the release model,
# the production budget and encoder reuse).
RESTORE_QUALITIES = (10, 30, 50, 90)
RESTORE_FLAGS = ["--device", "cuda", "--attn", "flash", "--attn-max-res", "32",
                 "--max-evals", "14", "--encoder-reuse", "2"]
TILE_SIZE_HW = (136, 200)
# The evaluate phase: cli/evaluate.py on the webp preset, natural synthetic
# images in batches of 8 (20 = two full batches and one of 4 real images
# padded to 8), under the production policy; the flags it shares with the
# avif phase.
CARD_FLAGS = ["--device", "cuda", "--attn", "flash", "--attn-max-res", "32"]
# The diffusion steps of the evaluate and avif phases' CLIs (`--steps`, the
# CLIs' default), which set each quality's start step and so the schedules.
DIFFUSION_STEPS = 100
EVAL_IMAGES = 20
EVAL_BATCH = 8
EVAL_QUALITIES = (10, 30, 50)
# The avif phase: the AVIF trainer (batch 8, the preset's) on natural
# synthetic images (80% train: 6 steps of 8), the evaluator and the restore
# CLI on its checkpoint at the preset's validation qualities, then two steps
# of the unified trainer (batch 18: 36 training images of 45).
AVIF_TRAIN_IMAGES = 60
AVIF_EVAL_IMAGES = 8
AVIF_QUALITIES = (20, 50, 80)
ALL_TRAIN_IMAGES = 45
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


def device_time_ms(fn, iters: int = 10, warmup: int = 3, windows: int = 3) -> float:
    """Device time per call: the summed time of the CUDA kernels that
    `iters` calls launch (torch.profiler), over `iters`; the largest over
    `windows` profiler sessions, each around the `iters` calls alone.
    Unlike events around the calls it leaves out the gaps while the host
    launches, which decide the time of a call made of several short kernels
    (an autograd backward).

    The largest, because a session can miss kernels that ran and never
    adds any: sessions recorded none of SDPA's cuDNN backward (0.15 ms
    between events) or of the flash forward, or only the pad and slice
    kernels around it. (A session that also ran warm-up calls counted the
    measured kernels twice, so none does.) Sessions that disagree are
    logged; 0 means every session recorded nothing, and the callers fail on
    that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    readings = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        readings.append(sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type.name == "CUDA") / 1e3 / iters)
    ms = max(readings)
    if min(readings) < 0.5 * ms:
        log(f"  profiler sessions read {[round(r, 4) for r in readings]} ms: taking {ms:.4f}")
    return ms


def profiled_events(fn) -> str:
    """What torch.profiler records for one call of `fn`: each event with
    its device type, count and device time (to tell a call the profiler
    does not see from one that runs no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return "; ".join(f"{e.key[:60]} [{e.device_type.name}] x{e.count} "
                     f"{e.self_device_time_total:.1f}/{e.device_time_total:.1f} us"
                     for e in prof.key_averages())


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
    state["avif"] = False
    if state["pil"]:
        import PIL

        from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import avif_available

        state["avif"] = avif_available()
        log(f"Pillow {PIL.__version__}; avif_available() {state['avif']}")
    log("phase avif: " + ("the AVIF CLIs on AVIF bitstreams that Pillow writes and reads"
                          if state["avif"] else
                          "fails: Pillow here cannot write AVIF, which the AVIF trainer's "
                          "data, the exact final projection and the AVIF files need"))


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

            def sdpa():
                return F.scaled_dot_product_attention(q4, k4, v4)

            lib_ms = device_time_ms(sdpa)
            if not lib_ms > 0:
                failures.append(f"sdpa (BH,T,D)=({bh},{t},{d}) {name}: the profiler summed no "
                                f"device time; {profiled_events(sdpa)}")
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
                if not ms > 0:
                    failures.append(f"flash_attention_fwd (BH,T,D)=({bh},{t},{d}) {name}: the "
                                    f"profiler summed no device time")
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
            failures += [f"flash_attention_bwd_{kind} (BH,T,D)=({bh},{t},{d}) {name}: the "
                         f"profiler summed no device time" for kind, tm in times.items()
                         if not tm[0] > 0]
            q4, k4, v4 = (z[None].detach().requires_grad_() for z in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4)

            def lib_backward():
                return torch.autograd.grad(out4, (q4, k4, v4), do[None], retain_graph=True)

            lib_ms = device_time_ms(lib_backward)
            lib_event_ms = cuda_time_ms(lib_backward)
            if not lib_ms > 0:
                failures.append(f"sdpa backward (BH,T,D)=({bh},{t},{d}) {name}: the profiler "
                                f"summed no device time; {profiled_events(lib_backward)}")
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
    through the plain attention, at the training paths' down2 and up4
    shapes (WebP: D = 32, 16; AVIF: D = 16, 8): the output and the
    gradients of q, k and v."""
    import torch

    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.ops.attention import spatial_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for ((bh, t, d), heads), dtype in ((s, dt) for s in TRAIN_SHAPES.items()
                                       for dt in (torch.bfloat16, torch.float32)):
        name = str(dtype).split(".")[-1]
        shape = (bh // heads, t, heads, d)
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
    """Small f32 restores (64², half widths, flash at <= 32², so down2 and
    up4 take the kernel at T = 1024) on the card against the same restores
    on the CPU: a WebP q10 batch on the static schedule (D = 16); a q10 /
    q70 batch on the traced budget of the production policy (14 slots,
    encoder reuse 2) with decoder reuse at depth 1, whose 7 groups launch
    the kernel once at down2 and once at up4 each; and an AVIF-preset model
    (8 heads: D = 8 at down2, 4 at up4, both padded to 16) restoring a q20
    batch under the AVIF policy (phase consistency on)."""
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    cfg = ModelConfig(compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(2)
    models = {}
    for codec in ("webp", "avif"):
        torch.manual_seed(SEED)
        cpu_model = build_model(codec, cfg, device="cpu")
        gpu_model = build_model(codec, cfg, device="cuda")
        gpu_model.load_state_dict(cpu_model.state_dict())
        models[codec] = cpu_model, gpu_model
    x0 = torch.from_numpy(synthetic_images(2, cfg.image_size, SEED + 1))
    q_mix = [10.0, 70.0]
    n, g = static_schedule(20, "avif")
    cases = [("webp q10, static schedule", "webp", codec_surrogate(x0, 10, codec="webp"), 10,
              {}, None),
             ("webp q10/q70, traced budget 14, decoder reuse 1", "webp",
              codec_surrogate(x0, torch.tensor(q_mix), codec="webp"), q_mix,
              dict(bucket=30, traced=True, decoder_reuse_depth=1), 14),
             ("avif-preset model, avif q20, static schedule", "avif",
              codec_surrogate(x0, 20, codec="avif"), 20, {}, n + g)]
    for label, codec, y, quality, kw, want in cases:
        cpu_model, gpu_model = models[codec]
        # f32 convolutions in full f32 on both sides (cuDNN would use TF32)
        with no_tf32():
            out_cpu = restore_batch(cpu_model, y, quality, codec, final_exact=False, **kw)
            before = fa.flash_attention_fwd.launches
            out_gpu = restore_batch(gpu_model, y.cuda(), quality, codec, final_exact=False,
                                    **kw).cpu()
            launched = fa.flash_attention_fwd.launches - before
        diff = (out_cpu - out_gpu).abs()
        log(f"card vs CPU restore (2x64x64, half width, f32, {label}, {launched} kernel "
            f"launches{'' if want is None else f'; schedule implies {want}'}): "
            f"max|diff| {diff.max().item():.3g}  mean|diff| {diff.mean().item():.3g}")
        # The surrogate rounds DCT coefficients; a last-bit difference can move
        # one coefficient by a quantisation step, so the max is looser than the mean.
        if not (launched > 0 and (want is None or launched == want)
                and np.isfinite(out_gpu.numpy()).all()
                and diff.mean().item() <= 1e-4 and diff.max().item() <= 2e-2):
            raise AssertionError(f"the card's restore ({label}) disagrees with the CPU's")


def restore_budget() -> tuple[int, int]:
    """(max evals, encoder reuse) of RESTORE_FLAGS."""
    return tuple(int(RESTORE_FLAGS[RESTORE_FLAGS.index(f) + 1])
                 for f in ("--max-evals", "--encoder-reuse"))


def static_schedule(quality: float, codec: str, budget: int | None = None,
                    reuse: int | None = None, steps: int = 100) -> tuple[int, int]:
    """(n, g): the model evaluations of one restore on the static budgeted
    schedule at `quality` over `steps` diffusion steps (the production
    policy's budget and encoder reuse unless given) and its encoder-reuse
    groups. The forward kernel then runs
    once at down2 per group (encode) and once at up4 per evaluation
    (decode): n + g launches per batch."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import (
        init_timestep_for_quality,
        student_stride,
    )
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import _solver_indices
    from ddpm_image_restoration_tpu_torch.diffusion.policy import (
        PRODUCTION_ENCODER_REUSE,
        PRODUCTION_MAX_EVALS,
    )

    budget = budget or PRODUCTION_MAX_EVALS
    reuse = reuse or PRODUCTION_ENCODER_REUSE
    init_t = init_timestep_for_quality(quality, steps, get_preset(codec))
    n = len(_solver_indices(init_t, student_stride(init_t, budget)))
    return n, math.ceil(n / reuse)


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
    the kernels with the most device time (torch.profiler, CUPTI). One
    session around the call alone (see device_time_ms): it can miss
    kernels, so the busy share is a lower bound."""
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
    <= 32², so down2 and up4 go through the Function at T = 1024) on the
    card against the same step on the CPU, for the WebP preset (D = 16) and
    the AVIF preset (8 heads: D = 8 and 4, padded to 16; the AVIF loss): the
    loss within rtol 1e-4; every gradient entry within 1e-4 of the model's
    largest; the attention projections of the two flash levels each within
    1e-3 of their own largest entry (f32 sums in other orders through ~30
    layers)."""
    import dataclasses

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    model_cfg = dataclasses.replace(ModelConfig(compute_dtype="float32", attention_impl="flash",
                                                attn_max_resolution=32), dropout=0.0).scaled(2)
    x0 = torch.from_numpy(synthetic_images(4, 64, SEED + 3))
    failed = []
    for codec in ("webp", "avif"):
        cfg = TrainConfig(codec=codec, model=model_cfg, ema_decay=0.999)
        torch.manual_seed(SEED)
        cpu_model = build_model(codec, model_cfg, device="cpu")
        gpu_model = build_model(codec, model_cfg, device="cuda")
        gpu_model.load_state_dict(cpu_model.state_dict())
        batch = {"x0": x0, "xt": codec_surrogate(x0, 20, codec=codec),
                 "t": torch.tensor([10, 35, 60, 90], dtype=torch.int32)}
        with no_tf32():
            cpu_m = make_train_step(cpu_model, cfg)(create_train_state(cpu_model, cfg), batch,
                                                    None)
            _reset_counts()
            gpu_m = make_train_step(gpu_model, cfg)(
                create_train_state(gpu_model, cfg), {k: v.cuda() for k, v in batch.items()},
                None)
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
        log(f"card vs CPU train step ({codec}, 4x64x64, half width, f32): loss "
            f"{gpu_m['loss'].item():.6f} vs {cpu_m['loss'].item():.6f} (rel {loss_rel:.3g}); "
            f"worst gradient |diff|/max|g| {worst[0]:.3g} ({worst[1]}); worst flash-level "
            f"attention gradient |diff|/own max {worst_attn[0]:.3g} ({worst_attn[1]}); "
            f"launches {counts}; FFT angle flips between card and CPU {flips}")
        if counts != {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                      "flash_attention_bwd_dkv": 2}:
            failed.append(f"{codec}: the card's train step launched {counts}")
        if not (np.isfinite(gpu_m["loss"].item()) and loss_rel <= 1e-4 and worst[0] <= 1e-4
                and worst_attn[0] <= 1e-3):
            failed.append(f"{codec}: the card's train step disagrees with the CPU's")
    if failed:
        raise AssertionError("; ".join(failed))


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
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.data.dataset import split_indices

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
    try:  # the checkpoint stays for phase `restore`, which removes it
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
    except BaseException:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        raise
    state["train_ckpt"] = ckpt_dir
    state["launches_train"] = totals

    step_alone(state, "webp", model, train_state, TRAIN_BATCH)


def step_alone(state: dict, codec: str, model, train_state, batch: int) -> None:
    """The trainer's step alone on one device batch (no data pipeline),
    full width, bf16, EMA: wall time over 5 steps after a warm one, the
    steps' peak device memory (the model and its train state included),
    then one step profiled."""
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(codec=codec, model=model.cfg, batch_size=batch, ema_decay=0.999)
    dev = model.out_conv.weight.device
    x0 = torch.from_numpy(synthetic_images(batch, model.cfg.image_size, SEED + 4)).to(dev)
    t = torch.randint(1, 100, (batch,), generator=torch.Generator().manual_seed(SEED))
    device_batch = {"x0": x0, "xt": codec_surrogate(x0, 30, codec=codec), "t": t.to(dev)}
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    if dev.type == "cuda":  # the step's own peak, not the process's
        torch.cuda.reset_peak_memory_stats(dev)
    step(train_state, device_batch, gen)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step(train_state, device_batch, gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"train step alone ({codec}, full width, bf16, batch {batch}, EMA): {ms:.1f} ms/step, "
        f"{batch * 1e3 / ms:.1f} img/s on {state['smi']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_run(f"one {codec} train step, batch {batch}",
                lambda: step(train_state, device_batch, gen))


def phase_restore(state: dict) -> None:
    """The restore CLI at full width (64², bf16, flash at <= 32², random
    weights under torch.manual_seed(0)) on files Pillow writes, each
    variant counted from 0 against its schedule: the forward kernel once
    at down2 per encode and once at up4 per decode, so for a file of n
    evaluations in g = ceil(n/2) encoder-reuse groups n + g at decoder
    reuse depth 0 or 2 and 2g at depth 1 (up4 is then in the deep part,
    run once a group); an ensemble of 2 twice that; tiles that per batch
    of 16 tiles. Then the same WebPs from the EMA of phase `train`'s
    checkpoint, and the server on WebPs and JPEGs with --codec auto and the
    traced budget (n' + g' per batch, the budget padded to whole groups).
    RESTORE_QUALITIES and TILE_SIZE_HW size the workload.
    Logs the milliseconds per image of each CLI call (model build and file
    I/O included)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    from PIL import Image  # writing and reading the files needs Pillow

    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.cli.serve import main as serve_main
    from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality
    from ddpm_image_restoration_tpu_torch.diffusion.policy import (
        PRODUCTION_ENCODER_REUSE,
        PRODUCTION_MAX_EVALS,
    )
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.utils.tiling import plan_tiles

    ckpt_dir = state.pop("train_ckpt", None)
    work = os.path.join(ROOT, "build", "chip_smoke_restore")
    shutil.rmtree(work, ignore_errors=True)
    try:
        if ckpt_dir is None:
            raise AssertionError("phase train left no checkpoint to restore from")
        inputs = os.path.join(work, "in")
        os.makedirs(inputs)

        def write(name, x, **kw):
            path = os.path.join(inputs, name)
            Image.fromarray(np.round((x * 0.5 + 0.5) * 255).astype(np.uint8)).save(path, **kw)
            return path

        imgs = synthetic_images(2 * len(RESTORE_QUALITIES) + 2, 64, SEED + 20)
        webps = [write(f"w{i}_q{q}.webp", imgs[i], quality=int(q))
                 for i, q in enumerate(np.repeat(RESTORE_QUALITIES, 2))]
        jpegs = [write(f"a{i}.jpg", imgs[-2 + i], quality=30 + 40 * i) for i in range(2)]
        th, tw = TILE_SIZE_HW
        wide = write("wide.webp", synthetic_images(1, tw, SEED + 21)[0][:th], quality=30)

        def groups(q):
            """(n, g) of the static budgeted schedule at quality q."""
            return static_schedule(q, "webp", *restore_budget())

        qs = [estimate_quality(p) for p in webps]
        log(f"estimated qualities of the WebPs written at "
            f"{[int(q) for q in np.repeat(RESTORE_QUALITIES, 2)]}: {qs}")
        # one batch when every file shares its quality, else one file at a time
        per_batch = [groups(q) for q in ([qs[0]] if len(set(qs)) == 1 else qs)]
        n_tiles = len(plan_tiles(th, tw, 64, 32)[0])
        n_t, g_t = groups(estimate_quality(wide))
        tile_batches = math.ceil(n_tiles / 16)
        auto = ["--quality", "auto", "--codec", "webp"]
        variants = [
            ("quality auto", webps, ["--random-init"], sum(n + g for n, g in per_batch)),
            ("decoder reuse 1", webps, ["--random-init", "--decoder-reuse-depth", "1"],
             sum(2 * g for n, g in per_batch)),
            ("decoder reuse 2", webps, ["--random-init", "--decoder-reuse-depth", "2"],
             sum(n + g for n, g in per_batch)),
            ("ensemble 2", webps, ["--random-init", "--ensemble", "2"],
             sum(2 * (n + g) for n, g in per_batch)),
            (f"tile {th}x{tw}, {n_tiles} tiles", [wide], ["--random-init", "--size-mode", "tile"],
             tile_batches * (n_t + g_t)),
            ("checkpoint EMA", webps, ["--checkpoint-dir", ckpt_dir, "--use-ema"],
             sum(n + g for n, g in per_batch)),
        ]
        totals = dict.fromkeys(_counts(), 0)
        failures = []
        for i, (label, files, extra, want) in enumerate(variants):
            out_dir = os.path.join(work, f"out{i}")
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                restore_main([*files, *RESTORE_FLAGS, *auto, *extra, "--output-dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] += v
            log(f"restore [{label}]: {len(files)} file(s), {1e3 * wall / len(files):.1f} ms/image "
                f"on {state['smi']}; launches {counts} (schedule implies {want} forward); "
                f"{printed.getvalue().splitlines()[0]}")
            if counts != {fa.KERNEL: want, "flash_attention_bwd_dq": 0,
                          "flash_attention_bwd_dkv": 0}:
                failures.append(f"restore [{label}]: launches {counts}, schedule implies {want}")
            shape = (th, tw, 3) if files == [wide] else (64, 64, 3)
            for f in files:
                png = os.path.join(out_dir, os.path.splitext(os.path.basename(f))[0]
                                   + "_restored.png")
                got = np.asarray(Image.open(png)).shape if os.path.exists(png) else None
                if got != shape:
                    failures.append(f"restore [{label}]: {png} has shape {got}, not {shape}")

        # the server: WebPs and JPEGs in codec-pure batches of one less than
        # the WebPs (the largest group, WebPs, first; then the 2 JPEGs, the
        # larger group; then the last WebP), where a queue served in name
        # order (JPEGs first) would give two batches; each batch on the
        # traced budget (14 slots)
        watch, out_dir = os.path.join(work, "watch"), os.path.join(work, "served")
        os.makedirs(watch)
        for f in webps + jpegs:
            shutil.copy(f, watch)
        n_pad = -(-PRODUCTION_MAX_EVALS // PRODUCTION_ENCODER_REUSE) * PRODUCTION_ENCODER_REUSE
        want = 3 * (n_pad + n_pad // PRODUCTION_ENCODER_REUSE)
        batch = len(webps) - 1
        want_batches = [batch, len(jpegs), 1]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            serve_main(["--watch", watch, "--output-dir", out_dir, *RESTORE_FLAGS,
                        "--random-init", "--solver", "auto", "--traced", "--quality", "auto",
                        "--codec", "auto", "--model-codec", "all", "--batch-size", str(batch),
                        "--once"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        for k, v in counts.items():
            totals[k] += v
        served = [int(m) for m in re.findall(r"restored (\d+) images", printed.getvalue())]
        log(f"serve [--codec auto, --traced, --quality auto]: {len(webps + jpegs)} files in "
            f"batches of {served}, {1e3 * wall / len(webps + jpegs):.1f} ms/image on "
            f"{state['smi']}; launches {counts} (schedule implies {want} forward)")
        if served != want_batches:
            failures.append(f"serve: batches {served}, codec-pure batches give {want_batches}")
        if counts != {fa.KERNEL: want, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}:
            failures.append(f"serve: launches {counts}, schedule implies {want}")
        outs = sorted(os.listdir(out_dir))
        if len(outs) != len(webps + jpegs) or any(np.asarray(Image.open(os.path.join(out_dir, f))).shape
                                  != (64, 64, 3) for f in outs):
            failures.append(f"serve wrote {outs}")
        state["launches_restore"] = totals
        if failures:
            raise AssertionError("; ".join(failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _quiet(fn, argv):
    """fn(argv) with its standard output captured; returns (result, the
    printed text)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = fn(argv)
    return out, printed.getvalue()


def _check_summary(summary: dict, n_images: int, qualities, label: str) -> list:
    """What an evaluation's metrics summary must hold: every quality with
    n real images, every metric finite, finite paired CIs, the seeded
    proxy LPIPS and random-conv Fréchet features, and the partial flag
    cleared."""
    import numpy as np

    failures = []
    if list(summary["results"]) != [str(q) for q in qualities] or summary.get("partial"):
        failures.append(f"{label}: qualities {list(summary['results'])}, partial "
                        f"{summary.get('partial')}")
    if summary["lpips_kind"] != "lpips_proxy":
        failures.append(f"{label}: lpips_kind {summary['lpips_kind']}")
    for q, r in summary["results"].items():
        values = [r[f"{tag}_{m}"] for tag in ("compressed", "restored")
                  for m in ("psnr", "ssim", "l2", "lpips", "fid")]
        values += [r["delta_psnr_ci95"], r["delta_ssim_ci95"], r["images_per_sec"]]
        if r["n"] != n_images or r["fid_kind"] != "random_conv" or \
                not np.isfinite(values).all():
            failures.append(f"{label} q{q}: n {r['n']}, fid_kind {r['fid_kind']}, "
                            f"values {values}")
    return failures


def phase_evaluate(state: dict) -> None:
    """The evaluator (`cli/evaluate.py main`) at full width on the webp
    preset (random weights under torch.manual_seed(0)): EVAL_IMAGES natural
    synthetic images in batches of EVAL_BATCH (the last partial batch padded
    to EVAL_BATCH) at EVAL_QUALITIES under the production policy, on the
    static schedule (n + g forward launches per batch) and on the traced
    budget (14 slots, 7 groups: 21 per batch); no backward launch. Logs
    each quality's images per second and each run's wall time, then
    profiles the harness on one batch at q30."""
    import shutil

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.common import add_model_flags, model_config_from
    from ddpm_image_restoration_tpu_torch.cli.evaluate import main as evaluate_main
    from ddpm_image_restoration_tpu_torch.config import EvalConfig
    from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
    from ddpm_image_restoration_tpu_torch.diffusion.policy import (
        PRODUCTION_ENCODER_REUSE,
        PRODUCTION_MAX_EVALS,
    )
    from ddpm_image_restoration_tpu_torch.evaluation.harness import evaluate_restoration
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    out = os.path.join(ROOT, "build", "chip_smoke_evaluate")
    batches = math.ceil(EVAL_IMAGES / EVAL_BATCH)
    n_pad = -(-PRODUCTION_MAX_EVALS // PRODUCTION_ENCODER_REUSE) * PRODUCTION_ENCODER_REUSE
    runs = [("static", [], batches * sum(sum(static_schedule(q, "webp", steps=DIFFUSION_STEPS))
                                         for q in EVAL_QUALITIES)),
            ("traced", ["--traced"],
             batches * len(EVAL_QUALITIES) * (n_pad + n_pad // PRODUCTION_ENCODER_REUSE))]
    argv = ["--codec", "webp", *CARD_FLAGS, "--random-init", "--synthetic", str(EVAL_IMAGES),
            "--synthetic-kind", "natural", "--batch-size", str(EVAL_BATCH),
            "--qualities", *map(str, EVAL_QUALITIES), "--solver", "auto",
            "--steps", str(DIFFUSION_STEPS), "--output-dir", out]
    totals = dict.fromkeys(_counts(), 0)
    failures = []
    try:
        for label, extra, want in runs:
            shutil.rmtree(out, ignore_errors=True)
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            summary, printed = _quiet(evaluate_main, [*argv, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] += v
            rows = summary["results"]
            log(f"evaluate [webp, {label}]: {EVAL_IMAGES} images at batch {EVAL_BATCH}, "
                f"{wall:.1f} s on {state['smi']}; images/s "
                + ", ".join(f"q{q} {r['images_per_sec']:.2f}" for q, r in rows.items())
                + f"; launches {counts} (schedule implies {want} forward)")
            for line in printed.splitlines()[-2 - len(rows):]:
                log(f"  {line}")
            if counts != {fa.KERNEL: want, "flash_attention_bwd_dq": 0,
                          "flash_attention_bwd_dkv": 0}:
                failures.append(f"evaluate [{label}]: launches {counts}, schedule implies {want}")
            failures += _check_summary(summary, EVAL_IMAGES, EVAL_QUALITIES, f"evaluate [{label}]")
            if not os.path.exists(os.path.join(out, "metrics_summary.json")):
                failures.append(f"evaluate [{label}]: no metrics_summary.json")
        # where one quality's time goes: the harness on one batch, the
        # model already built (the CLI's runs above include building it)
        ap = argparse.ArgumentParser()
        add_model_flags(ap)
        args = ap.parse_args(CARD_FLAGS)
        cfg = EvalConfig(codec="webp", model=model_config_from(args), steps=DIFFUSION_STEPS,
                         output_dir=out, qualities_override=(30,))
        torch.manual_seed(SEED)
        model = build_model("webp", cfg.model, device=args.device)
        ds = SyntheticImageDataset(EVAL_BATCH, cfg.model.image_size, seed=99, kind="natural")
        images = np.stack([ds[i] for i in range(EVAL_BATCH)])

        def one_batch():
            evaluate_restoration(cfg, model, images, batch_size=EVAL_BATCH, verbose=False,
                                 solver="auto")

        one_batch()
        profile_run(f"evaluation of one batch of {EVAL_BATCH}, q30, static, with the metrics",
                    one_batch)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    state["launches_evaluate"] = totals
    if failures:
        raise AssertionError("; ".join(failures))


def phase_avif(state: dict) -> None:
    """The AVIF model family at full width (8 heads, the AVIF frequency
    blocks, bf16, flash attention at <= 32², seeded weights), each run
    counted from 0 against its schedule:
      1. `cli/train.py --codec avif`: one epoch of AVIF_TRAIN_IMAGES natural
         images at the preset's batch of 8 with EMA and a checkpoint (per
         step the forward with LSE and one dQ and one dK/dV at down2 and
         up4; validation at 20/50/80 from init_t 75/50/20 at stride 1);
      2. `cli/evaluate.py --codec avif` on that checkpoint's EMA,
         AVIF_EVAL_IMAGES images at AVIF_QUALITIES under the AVIF policy;
      3. `cli/restore.py --model-codec avif` on AVIF files Pillow writes
         (quality estimated from the bitstream), from the same EMA;
      4. `cli/train.py --codec all`: two steps on mixed-codec batches of 18,
         validated once per codec at its middle val quality.
    Needs Pillow with AVIF (phase environment prints whether it has it)."""
    import shutil

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.evaluate import main as evaluate_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.cli.train import main as train_main
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.data.dataset import split_indices

    if not state["avif"]:
        raise AssertionError("Pillow cannot write AVIF here (phase environment)")
    from PIL import Image

    from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality

    work = os.path.join(ROOT, "build", "chip_smoke_avif")
    shutil.rmtree(work, ignore_errors=True)
    ckpt = os.path.join(work, "ckpt")
    totals = dict.fromkeys(_counts(), 0)
    failures = []

    def run(label, fn, argv, want):
        """fn(argv) counted from 0: logs its wall time and launches, records
        a failure unless they are `want` (fwd, dq, dkv)."""
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out, printed = _quiet(fn, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        for k, v in counts.items():
            totals[k] += v
        want = dict(zip(counts, want))
        log(f"avif [{label}]: {wall:.1f} s on {state['smi']}; launches {counts} "
            f"(schedule implies {want})")
        if counts != want:
            failures.append(f"avif [{label}]: launches {counts}, schedule implies {want}")
        return out, printed, wall

    try:
        avif = get_preset("avif")
        steps = len(split_indices(AVIF_TRAIN_IMAGES)[0]) // avif.batch_size
        n_val = sum(init_timestep_for_quality(q, DIFFUSION_STEPS, avif)
                    for q in avif.val_qualities)
        (tstate, hist), _, _ = run(
            "train --codec avif, 1 epoch", train_main,
            ["--codec", "avif", *CARD_FLAGS, "--ema-decay", "0.999", "--synthetic",
             str(AVIF_TRAIN_IMAGES), "--synthetic-kind", "natural", "--checkpoint-dir", ckpt,
             "--seed", str(SEED), "--epochs", "1", "--steps", str(DIFFUSION_STEPS)],
            (2 * steps + 2 * n_val, 2 * steps, 2 * steps))
        m = tstate.model
        grads = {n: getattr(m, lvl).attn.qkv.weight.grad for n, lvl in
                 (("down2 qkv", "down2"), ("up4 qkv", "up4"))}
        grads["down2 transform"] = m.down2.freq_guide.adaptive_transform.transform_weights.grad
        log(f"  heads {m.down2.attn.num_heads}; loss {hist['loss'][-1]:.4f}, val_psnr "
            f"{hist['val_psnr'][-1]:.3f}, val_ssim {hist['val_ssim'][-1]:.4f}, "
            f"{hist['step_ms'][-1]:.1f} ms/step in the loop, epoch {hist['epoch_time'][-1]:.1f} s; "
            f"{steps} steps, {n_val} validation evaluations; |grad| max "
            + ", ".join(f"{k} {g.abs().max().item():.3g}" for k, g in grads.items()))
        if not (tstate.step == steps and np.isfinite(hist["loss"]).all()
                and np.isfinite(hist["val_psnr"]).all()):
            failures.append(f"avif train: step {tstate.step} of {steps}, history {dict(hist)}")
        if any(g is None or not torch.isfinite(g).all() or g.abs().max().item() == 0
               for g in grads.values()):
            failures.append("avif train: a flash level or the adaptive transform got no gradient")
        step_alone(state, "avif", m, tstate, avif.batch_size)

        evaluate_want = sum(sum(static_schedule(q, "avif", steps=DIFFUSION_STEPS))
                            for q in AVIF_QUALITIES)
        summary, _, wall = run(
            "evaluate --codec avif, checkpoint EMA", evaluate_main,
            ["--codec", "avif", *CARD_FLAGS, "--checkpoint-dir", ckpt, "--use-ema",
             "--solver", "auto", "--synthetic", str(AVIF_EVAL_IMAGES), "--synthetic-kind",
             "natural", "--batch-size", str(AVIF_EVAL_IMAGES),
             "--qualities", *map(str, AVIF_QUALITIES), "--steps", str(DIFFUSION_STEPS),
             "--output-dir", os.path.join(work, "eval")],
            (evaluate_want, 0, 0))
        log("  images/s " + ", ".join(f"q{q} {r['images_per_sec']:.2f} (PSNR "
                                      f"{r['compressed_psnr']:.2f}->{r['restored_psnr']:.2f})"
                                      for q, r in summary["results"].items()))
        failures += _check_summary(summary, AVIF_EVAL_IMAGES, AVIF_QUALITIES, "avif evaluate")

        inputs = os.path.join(work, "in")
        os.makedirs(inputs)
        imgs = synthetic_images(2 * len(AVIF_QUALITIES), 64, SEED + 30)
        files = []
        for i, q in enumerate(np.repeat(AVIF_QUALITIES, 2)):
            files.append(os.path.join(inputs, f"a{i}_q{q}.avif"))
            Image.fromarray(np.round((imgs[i] * 0.5 + 0.5) * 255).astype(np.uint8)).save(
                files[-1], quality=int(q))
        qs = [estimate_quality(f) for f in files]
        per_batch = [qs[0]] if len(set(qs)) == 1 else qs
        out_dir = os.path.join(work, "restored")
        _, printed, wall = run(
            "restore --model-codec avif, checkpoint EMA", restore_main,
            [*files, *RESTORE_FLAGS, "--codec", "avif", "--model-codec", "avif", "--quality",
             "auto", "--checkpoint-dir", ckpt, "--use-ema", "--steps", str(DIFFUSION_STEPS),
             "--output-dir", out_dir],
            (sum(sum(static_schedule(q, "avif", *restore_budget(), steps=DIFFUSION_STEPS))
                 for q in per_batch), 0, 0))
        written = [int(q) for q in np.repeat(AVIF_QUALITIES, 2)]
        log(f"  {len(files)} AVIF files written at {written}, estimated {qs}: "
            f"{1e3 * wall / len(files):.1f} ms/image")
        for f in files:
            png = os.path.join(out_dir, os.path.splitext(os.path.basename(f))[0] + "_restored.png")
            got = np.asarray(Image.open(png)).shape if os.path.exists(png) else None
            if got != (64, 64, 3):
                failures.append(f"avif restore: {png} has shape {got}")

        unified = get_preset("all")
        all_steps = len(split_indices(ALL_TRAIN_IMAGES)[0]) // unified.batch_size
        n_val = sum(init_timestep_for_quality(
            p.val_qualities[len(p.val_qualities) // 2], DIFFUSION_STEPS, p)
            for p in map(get_preset, ("jpeg", "webp", "avif")))
        (ustate, uhist), _, _ = run(
            "train --codec all, 2 steps", train_main,
            ["--codec", "all", *CARD_FLAGS, "--synthetic", str(ALL_TRAIN_IMAGES),
             "--synthetic-kind", "natural", "--checkpoint-dir", os.path.join(work, "all"),
             "--seed", str(SEED), "--epochs", "1", "--steps", str(DIFFUSION_STEPS)],
            (2 * all_steps + 2 * n_val, 2 * all_steps, 2 * all_steps))
        emb = ustate.model.codec_embed.weight.grad
        log(f"  loss {uhist['loss'][-1]:.4f}, val_psnr {uhist['val_psnr'][-1]:.3f} (mean of "
            f"jpeg q30, webp q30, avif q50), {all_steps} steps, {n_val} validation evaluations; "
            f"|codec_embed grad| max {emb.abs().max().item():.3g}")
        if not (ustate.step == all_steps and np.isfinite(uhist["loss"]).all()
                and np.isfinite(uhist["val_psnr"]).all() and emb.abs().max().item() > 0):
            failures.append(f"train --codec all: step {ustate.step}, history {dict(uhist)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    state["launches_avif"] = totals
    if failures:
        raise AssertionError("; ".join(failures))


PHASES = [("environment", phase_environment), ("build", phase_build),
          ("kernels", phase_kernels), ("reference", phase_reference),
          ("serve", phase_serve), ("train_reference", phase_train_reference),
          ("train", phase_train), ("restore", phase_restore), ("evaluate", phase_evaluate),
          ("avif", phase_avif)]


def kernels_json(state: dict) -> str:
    """One row per kernel. Its top-level numbers are at the first serving
    or training shape in bf16 (down2); `main_path_shapes` has each shape the
    main paths give it, with its own error and times. `launches` sums the
    main paths' runs (serve, train, the restore and serve CLIs, the
    evaluator, the AVIF family), each counted from 0; `launches_by_path`
    splits it."""
    paths = {"serve": state["launches"], "train": state.get("launches_train", {}),
             "restore": state.get("launches_restore", {}),
             "evaluate": state.get("launches_evaluate", {}),
             "avif": state.get("launches_avif", {})}

    def row(name, source, replaces, rows, shapes, key):
        per_shape = [{"path": path, "shape_bh_t_d": [bh, t, d], "dtype": "bfloat16",
                      "save_lse": lse, **rows[key(bh, t, d, "bfloat16", lse)]}
                     for path, bh, t, d, lse in shapes]
        first = per_shape[0]
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
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
                           rows, [("avif train step" if heads == 8 else "train step", *s, True)
                                  for s, heads in TRAIN_SHAPES.items()],
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
