#!/usr/bin/env python3
"""Shows that the card's kernel bounds catch a numerics fault in the
tensor-core kernels: builds a copy of the port's CUDA sources, outside the
checkout, with the `lo` product of the hi/lo split dropped at the split
product of `csrc/flash_mma.cuh` (`wgmma_split`, which the forward, dQ and
dK/dV use: each then rounds P, and dS, to bf16 once), and holds the bf16
forward, dQ and dK/dV kernels of that copy and of the checkout to their
plain versions under chip_smoke.py's bounds, at the D = 32 shapes of the
main paths, D = 16 and 8 beside them, the restore CLI's (4, 1024, 32),
which the forward splits over a cluster, and D = 256 and 128 at the 1024²
path's bottleneck (4, 1024, 256) and (4, 1024, 128), where the
warp-specialised forward splits its keys and dK/dV its query tiles over
a cluster of 2.

    python3 chip_fault_check.py

Prints one line per kernel, shape and build (share of the bound: <= 1
passes) and exits 0 when every case of the checkout passes and every case
of the faulted copy fails. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
# (sound, faulted) at the split point, wgmma_split.
SPLITS = [("  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);\n"
           "  wgmma_sm90::wgmma_rs<1>(d, a.lo, b, true);\n",
           "  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);\n")]
# (kernel, BH, T, D, save_lse): the forward at its serving, train-step,
# validation and restore shapes; dQ and dK/dV at the train steps'; the
# three at the 1024² path's D = 256 (restore and train step), the forward
# and dK/dV at its D = 128.
CASES = [("fwd", 32, 1024, 32, False), ("fwd", 72, 1024, 32, True), ("fwd", 16, 1024, 32, False),
         ("fwd", 4, 1024, 32, False),
         ("dq", 72, 1024, 32, True), ("dkv", 72, 1024, 32, True), ("fwd", 32, 1024, 16, False),
         ("dq", 72, 1024, 16, True), ("dkv", 72, 1024, 16, True), ("fwd", 64, 1024, 8, True),
         ("dq", 64, 1024, 8, True), ("dkv", 64, 1024, 8, True),
         ("fwd", 4, 1024, 256, False), ("fwd", 4, 1024, 256, True), ("dq", 4, 1024, 256, True),
         ("dkv", 4, 1024, 256, True), ("fwd", 4, 1024, 128, False), ("fwd", 4, 1024, 128, True),
         ("dkv", 4, 1024, 128, True)]


def shares(fa, max_err) -> list[float]:
    """Each case's worst share of its bound, bf16, with this build's kernels."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for kind, bh, t, d, save_lse in CASES:
        q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen).to(torch.bfloat16)
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
        worst = 0.0
        for part, a, b in pairs:
            e, sh = max_err(a, b)
            worst = max(worst, sh)
            print(f"  {kind} {part} (BH,T,D)=({bh},{t},{d}) bf16: max|err| {e:.3g}, "
                  f"{sh:.3g} of its bound", flush=True)
        out.append(worst)
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
        header = work / "csrc" / "flash_mma.cuh"
        text = header.read_text()
        for whole, dropped in SPLITS:
            if text.count(whole) != 1:
                raise RuntimeError(f"split products not found in flash_mma.cuh: {whole!r}")
            text = text.replace(whole, dropped)
        header.write_text(text)
        build.CSRC_DIR, build.BUILD_DIR = work / "csrc", work / "build"
        build._LOADED.clear()
        for name in (fa.KERNEL, fa.BWD_KERNEL):
            build.build(name)
        print(f"faulted build (lo product dropped, {work}):", flush=True)
        faulted = shares(fa, chip_smoke.max_err)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    ok = all(s <= 1.0 for s in sound) and all(s > 1.0 for s in faulted)
    for case, a, b in zip(CASES, sound, faulted):
        print(f"{case}: sound {a:.3g}, faulted {b:.3g} of the bound")
    print(f"every sound case passes and every faulted case fails: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
