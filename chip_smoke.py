#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`ddpm_image_restoration_tpu_torch`) on one
NVIDIA card and checks it, phase by phase:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: every kernel of the serving path, with nvcc, from the checkout;
  3. kernels: each kernel against its plain PyTorch version, with times;
  4. reference: a half-width f32 restore on the card against the same
     restore on the CPU (the CPU path is the one the tests hold to the JAX
     package);
  5. serve: the WebP restore server core at full width (64², the release
     widths, bf16, flash attention at <= 32²) on three batches of 8 images
     under the production solver policy, counting the kernel's launches.

    python3 chip_smoke.py

It prints each phase's seconds, then a JSON line of per-kernel numbers, the
card's `nvidia-smi` name and power limit, and last `{"ok": true, ...}`. It
exits non-zero, printing no result, when any phase fails, when no CUDA card
is visible, or when the port's package is not beside it. It needs torch,
numpy and nvcc; Pillow only for the exact final projection, which it skips,
saying why, when Pillow is missing.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ddpm_image_restoration_tpu_torch"
JAX_PACKAGE = PACKAGE.removesuffix("_torch")  # the reference; never imported here

# (BH, T, D): the two shapes of the serving path first (down2: 8 images x 4
# heads, 32x32 tokens, head dim 128/4; up4: head dim 64/4), then ragged and
# wide-head cases of the kernel's contract.
KERNEL_SHAPES = [(32, 1024, 32), (32, 1024, 16), (8, 4096, 16), (4, 300, 64), (2, 256, 128)]
MAIN_PATH_SHAPES = KERNEL_SHAPES[:2]
# max |kernel - plain|: both accumulate in f32; bf16 rounds the output once.
ATOL = {"bfloat16": 2e-2, "float32": 2e-3}
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense
# tensor-core bf16 and f32 (non-tensor-core) FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}
SERVE_QUALITIES = (10, 30, 50)
SERVE_BATCH = 8
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


def attention_bound_ms(bh: int, t: int, d: int, dtype_name: str) -> tuple[float, str]:
    """Least time for the work: q, k, v read once and o written once, over
    the memory rate; the two T x T x D products over the type's peak."""
    elt = 2 if dtype_name == "bfloat16" else 4
    t_bytes = 4 * bh * t * d * elt / PEAK_BYTES_S
    t_ops = 4 * bh * t * t * d / PEAK_FLOPS_S[dtype_name]
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
    from ddpm_image_restoration_tpu_torch.ops import build
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    path, seconds = build.build(fa.KERNEL)
    log(f"built {path.name} with {build.find_nvcc()} in {seconds:.1f} s")
    build.load(fa.KERNEL)


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
            err = 0.0
            for save_lse in (False, True):
                got = fa.flash_attention_fwd(q, k, v, save_lse=save_lse)
                ref = fa.flash_attention_plain(q, k, v, save_lse=save_lse)
                torch.cuda.synchronize()
                pairs = zip(got, ref) if save_lse else [(got, ref)]
                e = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
                err = max(err, e)
                if not e <= ATOL[name]:
                    failures.append(f"(BH,T,D)=({bh},{t},{d}) {name} lse={save_lse}: "
                                    f"max|err| {e:.3g} > {ATOL[name]}")
            ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v))
            plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v))
            q4, k4, v4 = (z[None] for z in (q, k, v))
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            bound, by = attention_bound_ms(bh, t, d, name)
            rows[(bh, t, d, name)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=lib_ms, bound_ms=bound, bound_by=by)
            log(f"flash_attention_fwd (BH,T,D)=({bh},{t},{d}) {name}: max|err| {err:.3g} "
                f"(atol {ATOL[name]})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"sdpa {lib_ms:.4f} ms  bound {bound:.4f} ms ({by})")
    state["kernel_rows"] = rows
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))


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
    fa.flash_attention_fwd.launches = 0
    outs = [restore_batch(model, y, q, "webp", final_exact=final_exact) for q, y in batches]
    torch.cuda.synchronize()
    launches = fa.flash_attention_fwd.launches
    state["launches"] = {fa.KERNEL: launches}
    log(f"flash_attention_fwd launches on the serving path: {launches} (schedule implies {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, schedule implies {expected}")
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
    profile_restore(lambda: restore_batch(model, batches[1][1], batches[1][0], "webp",
                                          final_exact=final_exact))


def profile_restore(run) -> None:
    """Where one restore's time goes: device-busy share of the wall time and
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
    log(f"profile (one batch of {SERVE_BATCH}, q30): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}%), "
        f"{sum(e.count for e in events)} device kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


PHASES = [("environment", phase_environment), ("build", phase_build),
          ("kernels", phase_kernels), ("reference", phase_reference),
          ("serve", phase_serve)]


def kernels_json(state: dict) -> str:
    rows = state["kernel_rows"]
    per_shape = []
    for bh, t, d in MAIN_PATH_SHAPES:
        r = rows[(bh, t, d, "bfloat16")]
        per_shape.append({"shape_bh_t_d": [bh, t, d], "dtype": "bfloat16", **r})
    first = per_shape[0]
    return json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/flash_attention_fwd.cu",
        "replaces": f"{JAX_PACKAGE}/ops/pallas/flash_attention.py:51",
        "launches": state["launches"]["flash_attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        "shape": "BH=32,T=1024,D=32 bf16 (down2)",
        "main_path_shapes": per_shape,
    }]})


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
