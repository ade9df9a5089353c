#!/usr/bin/env python3
"""Shows that the card's kernel bounds catch a numerics fault in the
tensor-core kernels: builds a copy of the port's CUDA sources, outside the
checkout, with the `lo` product of the hi/lo split dropped at the split
product of `csrc/flash_mma.cuh` (`wgmma_split`, which the bf16 forward, dQ
and dK/dV use: each then rounds P, and dS, to bf16 once) and the 3xTF32
products of `csrc/flash_tf32.cuh` cut to one (`wgmma_3xtf32_ss`/`_sr`/`_rs`,
which the f32 forward, dQ and dK/dV use: every product then in one TF32
rounding of its operands, 1xTF32), and holds the kernels of that copy and of the
checkout to their plain versions under chip_smoke.py's bounds: the bf16
forward, dQ and dK/dV at the D = 32 shapes of the main paths, D = 16 and
8 beside them, the restore CLI's (4, 1024, 32), which the forward splits
over a cluster, and D = 256 and 128 at the 1024² path's bottleneck (4,
1024, 256) and (4, 1024, 128), where the warp-specialised forward and dQ
split their keys and dK/dV its query tiles over a cluster of 2 (20 bf16
cases); the f32 forward, dQ and dK/dV at the f32 paths' shapes (the
full-width f32 distillation's (72, 1024, 32|16), the 1024² path's (4,
1024, 256|128)): 16 f32 cases.

    python3 chip_fault_check.py

Prints one line per kernel, shape, dtype and build (share of the bound:
<= 1 passes; the mean |err| beside the max) and exits 0 when every case
of the checkout passes and every case of the faulted copy fails in each
output the products feed (O; dQ; dK and dV). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
# (header, [(sound, faulted)]): the bf16 split point, wgmma_split, and the
# 3xTF32 products, cut to one.
SPLITS = [("flash_mma.cuh",
           [("  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);\n"
             "  wgmma_sm90::wgmma_rs<1>(d, a.lo, b, true);\n",
             "  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);\n")]),
          ("flash_tf32.cuh",
           [("  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_lo, accumulate);\n"
             "  wgmma_sm90::wgmma_tf32_ss(d, a_lo, b_hi, true);\n"
             "  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_hi, true);\n",
             "  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_hi, accumulate);\n"),
            ("  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_lo, accumulate);\n"
             "  wgmma_sm90::wgmma_tf32_rs(d, a_lo, b_hi, true);\n"
             "  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_hi, true);\n",
             "  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_hi, accumulate);\n"),
            ("  wgmma_sm90::wgmma_tf32_rs(d, a.hi, b_lo, true);\n"
             "  wgmma_sm90::wgmma_tf32_rs(d, a.lo, b_hi, true);\n"
             "  wgmma_sm90::wgmma_tf32_rs(d, a.hi, b_hi, true);\n",
             "  wgmma_sm90::wgmma_tf32_rs(d, a.hi, b_hi, true);\n")])]
# (kernel, BH, T, D, save_lse, dtype): bf16: the forward at its serving,
# train-step, validation and restore shapes; dQ and dK/dV at the train
# steps'; the three at the 1024² path's D = 256 and 128 (restore and train
# step). f32: the forward (without and with
# the LSE), dQ and dK/dV at the f32 distillation's and the 1024² path's
# shapes.
CASES = [("fwd", 32, 1024, 32, False), ("fwd", 72, 1024, 32, True), ("fwd", 16, 1024, 32, False),
         ("fwd", 4, 1024, 32, False),
         ("dq", 72, 1024, 32, True), ("dkv", 72, 1024, 32, True), ("fwd", 32, 1024, 16, False),
         ("dq", 72, 1024, 16, True), ("dkv", 72, 1024, 16, True), ("fwd", 64, 1024, 8, True),
         ("dq", 64, 1024, 8, True), ("dkv", 64, 1024, 8, True),
         ("fwd", 4, 1024, 256, False), ("fwd", 4, 1024, 256, True), ("dq", 4, 1024, 256, True),
         ("dkv", 4, 1024, 256, True), ("fwd", 4, 1024, 128, False), ("fwd", 4, 1024, 128, True),
         ("dq", 4, 1024, 128, True), ("dkv", 4, 1024, 128, True)]
CASES = [(*c, "bfloat16") for c in CASES] + [
    ("fwd", 72, 1024, 32, False, "float32"), ("fwd", 72, 1024, 32, True, "float32"),
    ("dq", 72, 1024, 32, True, "float32"), ("dkv", 72, 1024, 32, True, "float32"),
    ("fwd", 72, 1024, 16, False, "float32"), ("fwd", 72, 1024, 16, True, "float32"),
    ("dq", 72, 1024, 16, True, "float32"), ("dkv", 72, 1024, 16, True, "float32"),
    ("fwd", 4, 1024, 256, False, "float32"), ("fwd", 4, 1024, 256, True, "float32"),
    ("dq", 4, 1024, 256, True, "float32"), ("dkv", 4, 1024, 256, True, "float32"),
    ("fwd", 4, 1024, 128, False, "float32"), ("fwd", 4, 1024, 128, True, "float32"),
    ("dq", 4, 1024, 128, True, "float32"), ("dkv", 4, 1024, 128, True, "float32")]


# The outputs in which a faulted product must show, per kernel (the LSE and
# Delta are sums the products feed little or not at all).
FAULT_PARTS = {"fwd": ("o",), "dq": ("dq",), "dkv": ("dk", "dv")}


def shares(fa, max_err) -> list[tuple[float, float]]:
    """Each case's worst share of its bound with this build's kernels, over
    all its outputs and over the least failing of FAULT_PARTS."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for kind, bh, t, d, save_lse, dtype_name in CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        if kind == "fwd":
            got = fa.flash_attention_fwd(q, k, v, save_lse=save_lse)
            ref = fa.flash_attention_plain(q, k, v, save_lse=save_lse)
            pairs = list(zip(("o", "lse"), got, ref)) if save_lse else [("o", got, ref)]
        else:
            # the sound forward's O and LSE (and for dK/dV the plain Delta)
            # feed both builds
            o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
            if kind == "dq":
                got = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
                ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
                pairs = list(zip(("dq", "delta"), got, ref))
            else:
                delta = (do.float() * o.float()).sum(-1)
                got = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
                ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
                pairs = list(zip(("dk", "dv"), got, ref))
        torch.cuda.synchronize()
        worst, least = 0.0, float("inf")
        for part, a, b in pairs:
            e, sh = max_err(a, b)
            worst = max(worst, sh)
            if part in FAULT_PARTS[kind]:
                least = min(least, sh)
            mean = (a.float() - b.float()).abs().mean().item()
            print(f"  {kind} {part} (BH,T,D)=({bh},{t},{d}) {dtype_name}: max|err| {e:.3g}, "
                  f"{sh:.3g} of its bound, mean|err| {mean:.3g}, max|ref| "
                  f"{b.float().abs().max().item():.3g}", flush=True)
        out.append((worst, least))
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_fault_check: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from ddpm_image_restoration_tpu_torch.ops import build
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    print(chip_smoke.nvidia_smi_line(), flush=True)
    print("sound build (the checkout):", flush=True)
    sound = shares(fa, chip_smoke.max_err)

    work = Path(tempfile.mkdtemp(prefix="flash_dropped_lo_"))
    try:
        shutil.copytree(build.CSRC_DIR, work / "csrc")
        for name, splits in SPLITS:
            header = work / "csrc" / name
            text = header.read_text()
            for whole, dropped in splits:
                if text.count(whole) != 1:
                    raise RuntimeError(f"split products not found in {name}: {whole!r}")
                text = text.replace(whole, dropped)
            header.write_text(text)
        build.CSRC_DIR, build.BUILD_DIR = work / "csrc", work / "build"
        build._LOADED.clear()
        for name in (fa.KERNEL, fa.BWD_KERNEL):
            build.build(name)
        print(f"faulted build (lo products dropped, {work}):", flush=True)
        faulted = shares(fa, chip_smoke.max_err)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    ok = all(w <= 1.0 for w, _ in sound) and all(least > 1.0 for _, least in faulted)
    for case, (a, _), (_, b) in zip(CASES, sound, faulted):
        print(f"{case}: sound {a:.3g}, faulted {b:.3g} of the bound (its least failing "
              f"output of {'/'.join(FAULT_PARTS[case[0]])})")
    print(f"every sound case passes and every faulted case fails: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
