#!/usr/bin/env python3
"""Times the flash-attention forward, dQ and dK/dV kernels of several
builds of the port's CUDA sources on one card, in turns.

    python3 kernel_ab.py [--splits] [--dtype bfloat16|float32|both] NAME=CSRC_DIR [...]

Each CSRC_DIR is a copy of `ddpm_image_restoration_tpu_torch/csrc` (the
checkout's, a parent commit's from `git archive`, or an edited copy); each
is built with the port's nvcc flags into a temporary directory and loaded
side by side. Every build is first held to the plain versions at every
shape (within chip_smoke.py's bounds, or the script stops), then the card
is warmed for 10 s, then each shape is timed for every build in ROUNDS
rounds, the order reversed each round, as device time under
torch.profiler (chip_smoke.device_time_ms). The last lines are the
medians, a line per kernel and shape, a column per build. Timing builds
in turns within one process is what makes them comparable: the same
kernels can read much faster a minute into a call than at its start.

The forward is called through `flash_attention_fwd` (each build's own
split rule), dQ through `flash_attention_bwd_dq` and dK/dV through
`flash_attention_bwd_dkv`, on the plain version's O, LSE and Delta. A
build whose forward or dK/dV does not take D = 8 (before the wgmma
kernels) is timed at those D = 8 shapes as "-"; a dQ launcher that refuses
D = 8 (before the wgmma dQ) is timed as that build's wrapper ran it: the
five inputs zero-padded to 16, the launch at 16 and dQ sliced back, the
pad and slice kernels counted in its device time. With --splits, the
first build's forward is also timed with its keys split over clusters of
1, 2 and 4 blocks (`flash_attention_fwd_split`) at the small-BH shapes of
SPLIT_SHAPES, and its dQ with the key tiles and its dK/dV with the query
tiles split over clusters of 1 and 2 blocks (`flash_attention_bwd_dq_split`,
`flash_attention_bwd_dkv_split`, D >= 128) at WS_SPLIT_SHAPES. `--dtype
float32` times the f32 kernels instead (both: the two in turn) at
F32_FWD and F32_BWD, the f32 path shapes of
chip_smoke.py; with --splits also the first build's f32 forward and dQ
split over 1, 2 and 4 blocks (`flash_attention_fwd_split`,
`flash_attention_bwd_dq_split`, a build without the dQ one skipped) at
F32_SPLIT_SHAPES, and its f32 dK/dV with the query tiles split over 1 and
2 blocks (`flash_attention_bwd_dkv_split`) at F32_DKV_SPLIT_SHAPES (D =
256 ignores the split: its cluster splits the head dim). Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
ROUNDS = 3
# Every distinct path shape of chip_smoke.py: the forward's (BH, T, D,
# save_lse) on every path (serving, training, distillation, validation, the
# CLIs, AVIF, the model axis, the 1024² path), dQ's and dK/dV's (BH, T, D)
# on every training path
FWD = list(dict.fromkeys(s[1:] for s in chip_smoke.FWD_PATH_SHAPES))
BWD = list(chip_smoke.TRAIN_SHAPES)
# (BH, T, D): the restore CLI's, the AVIF restore's, the validation's and
# the 1024² path's bottleneck (D = 256 and 128)
SPLIT_SHAPES = [(4, 1024, 32), (8, 1024, 16), (8, 1024, 32), (16, 1024, 32), (4, 1024, 256),
                (4, 1024, 128)]
# (BH, T, D): the bf16 dQ's split over key tiles and dK/dV's over query
# tiles (D >= 128): the 1024² train step's bottleneck, and BH = 1 and 8
# beside it
WS_SPLIT_SHAPES = [(4, 1024, 256), (4, 1024, 128), (1, 1024, 256), (8, 1024, 256)]
# f32 (BH, T, D, save_lse) and (BH, T, D): chip_smoke.py's f32 path shapes
# (the full-width f32 distillation's, the 1024² path's, the half-width f32
# gates' at D = 16, where D = 8 runs padded to 16)
F32_FWD = list(dict.fromkeys(s[1:] for s in chip_smoke.F32_FWD_PATH_SHAPES))
F32_BWD = list(chip_smoke.F32_TRAIN_SHAPES)
F32_SPLIT_SHAPES = [(4, 1024, 256), (4, 1024, 128), (8, 1024, 16), (16, 1024, 16)]
# (BH, T, D): the f32 dK/dV's split over query tiles at the 1024² path's
# bottleneck
F32_DKV_SPLIT_SHAPES = [(4, 1024, 256), (4, 1024, 128)]


def build(name: str, csrc: Path, nvcc: str, flags) -> tuple[str, dict]:
    from ddpm_image_restoration_tpu_torch.ops.build import ptxas_summary

    out = Path(tempfile.mkdtemp(prefix=f"ab_{name}_"))
    libs, ptxas = {}, []
    for lib in ("flash_attention_fwd", "flash_attention_bwd"):
        so = out / f"lib{lib}.so"
        r = subprocess.run([nvcc, *flags, "-o", str(so), str(csrc / f"{lib}.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"{name}: nvcc failed on {lib}:\n{r.stderr[-3000:]}")
        libs[lib] = ctypes.CDLL(str(so))
        ptxas += ptxas_summary(r.stdout + r.stderr)
    fwd = libs["flash_attention_fwd"].flash_attention_fwd
    dq, dkv = (getattr(libs["flash_attention_bwd"], f"flash_attention_bwd_{kind}")
               for kind in ("dq", "dkv"))
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    for f in (dq, dkv):
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
    fwd.restype = dq.restype = dkv.restype = ctypes.c_int
    return name, {"fwd": fwd, "dq": dq, "dkv": dkv, "lib": libs["flash_attention_fwd"],
                  "lib_bwd": libs["flash_attention_bwd"], "ptxas": ptxas}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from ddpm_image_restoration_tpu_torch.ops import build as port_build
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    args = sys.argv[1:]
    splits = "--splits" in args
    dtype_arg = "bfloat16"
    if "--dtype" in args:
        dtype_arg = args[args.index("--dtype") + 1]
        args = [a for i, a in enumerate(args) if a != "--dtype" and
                (i == 0 or args[i - 1] != "--dtype")]
    dtypes = {"bfloat16": [torch.bfloat16], "float32": [torch.float32],
              "both": [torch.bfloat16, torch.float32]}[dtype_arg]
    specs = [arg.split("=", 1) for arg in args if arg != "--splits"]
    nvcc = port_build.find_nvcc()
    with ThreadPoolExecutor(len(specs)) as pool:
        builds = dict(pool.map(lambda s: build(s[0], Path(s[1]).resolve(), nvcc,
                                               port_build.NVCC_FLAGS), specs))
    print(chip_smoke.nvidia_smi_line(), flush=True)
    names_of = {torch.bfloat16: "bf16", torch.float32: "f32"}
    for name, b in builds.items():
        for line in b["ptxas"]:
            if any(line.split(":")[0].endswith(names_of[dt]) for dt in dtypes):
                print(f"{name} ptxas: {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    calls = {}  # (kind, shape, dtype) -> (name -> call or None), and the check
    for dtype in dtypes:
        code, tag = int(dtype == torch.bfloat16), names_of[dtype]

        def randn(bh, t, d, dtype=dtype):
            return torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)

        for shape in (FWD if dtype == torch.bfloat16 else F32_FWD):
            bh, t, d, lse = shape
            q, k, v = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
            o, l = torch.empty_like(q), torch.empty(bh, t, device="cuda")
            ref = fa.flash_attention_plain(q, k, v)

            def make(f, q=q, k=k, v=v, o=o, l=l, bh=bh, t=t, d=d, lse=lse, code=code):
                return lambda: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 l.data_ptr() if lse else None, bh, t, d, code, d ** -0.5, stream)
            calls[("fwd", shape, tag)] = ({n: make(b["fwd"]) for n, b in builds.items()},
                                          lambda o=o, ref=ref: [(o, ref)])
        bwd_shapes = BWD if dtype == torch.bfloat16 else F32_BWD
        for shape in bwd_shapes:
            bh, t, d = shape
            q, k, v, do = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
            o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
            dq, delta = torch.empty_like(q), torch.empty(bh, t, device="cuda")
            rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, lse)

            def make(f, q=q, k=k, v=v, o=o, do=do, lse=lse, dq=dq, delta=delta, bh=bh, t=t, d=d,
                     code=code):
                def launch(d_k, ins, out):
                    return f(*(z.data_ptr() for z in ins), lse.data_ptr(), out.data_ptr(),
                             delta.data_ptr(), bh, t, d_k, code, d ** -0.5, stream)

                if launch(d, (q, k, v, o, do), dq) == 0:
                    return lambda: launch(d, (q, k, v, o, do), dq)
                d_k = next(h for h in fa.HEAD_DIMS if h >= d)  # the build's wrapper pads

                def padded():
                    ins = [torch.nn.functional.pad(z, (0, d_k - d)) for z in (q, k, v, o, do)]
                    out = torch.empty_like(ins[0])
                    err = launch(d_k, ins, out)
                    dq.copy_(out[..., :d])
                    return err
                return padded
            calls[("dq", shape, tag)] = ({n: make(b["dq"]) for n, b in builds.items()},
                                         lambda dq=dq, delta=delta, rdq=rdq, rdelta=rdelta:
                                         [(dq, rdq), (delta, rdelta)])
        for shape in bwd_shapes:
            bh, t, d = shape
            q, k, v, do = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
            o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
            delta = (do.float() * o.float()).sum(-1)
            dk, dv = torch.empty_like(q), torch.empty_like(q)
            rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)

            def make(f, q=q, k=k, v=v, do=do, lse=lse, delta=delta, dk=dk, dv=dv, bh=bh, t=t,
                     d=d, code=code):
                return lambda: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 bh, t, d, code, d ** -0.5, stream)
            calls[("dkv", shape, tag)] = ({n: make(b["dkv"]) for n, b in builds.items()},
                                          lambda dk=dk, dv=dv, rdk=rdk, rdv=rdv:
                                          [(dk, rdk), (dv, rdv)])

    # each build's calls against the plain versions; a refused launch is "-"
    for key, (per_build, outputs) in calls.items():
        for name, call in per_build.items():
            if call() != 0:
                per_build[name] = None
                continue
            torch.cuda.synchronize()
            share = max(chip_smoke.max_err(a, b)[1] for a, b in outputs())
            if not share <= 1.0:
                raise AssertionError(f"{name} {key}: {share:.3g} of the bound")
    print("every build within the bounds", flush=True)
    t0 = time.time()
    while time.time() - t0 < 10:
        for per_build, _ in calls.values():
            for call in per_build.values():
                if call:
                    call()
    torch.cuda.synchronize()

    names = list(builds)
    times = {n: {key: [] for key in calls} for n in names}
    for rnd in range(ROUNDS):
        for name in names if rnd % 2 == 0 else names[::-1]:
            for key, (per_build, _) in calls.items():
                call = per_build[name]
                times[name][key].append(chip_smoke.device_time_ms(call) if call else None)
    print(f"device us, median of {ROUNDS} rounds, a line per kernel and shape: "
          + " ".join(f"{n:>8}" for n in names), flush=True)
    for key in calls:
        row = []
        for name in names:
            xs = [x for x in times[name][key] if x is not None]
            row.append(f"{sorted(xs)[len(xs) // 2] * 1e3:8.1f}" if xs else "       -")
        print(f"{key[0]:>4} {key[2]:>4} {str(key[1]):<22} " + " ".join(row), flush=True)
    if splits:
        name = names[0]
        lib, lib_bwd = builds[name]["lib"], builds[name]["lib_bwd"]
        fwd_split = lib.flash_attention_fwd_split
        fwd_split.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fwd_split.restype = ctypes.c_int
        for dtype in dtypes:
            code, tag = int(dtype == torch.bfloat16), names_of[dtype]

            def randn(bh, t, d, dtype=dtype):
                return torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)

            print(f"{name}: {tag} forward device us split over 1, 2, 4 blocks, median of "
                  f"{ROUNDS} rounds", flush=True)
            for bh, t, d in (SPLIT_SHAPES if dtype == torch.bfloat16 else F32_SPLIT_SHAPES):
                q, k, v = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
                o = torch.empty_like(q)
                row = []
                for split in (1, 2, 4):
                    def call(split=split):
                        return fwd_split(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         None, bh, t, d, code, d ** -0.5, split, stream)
                    xs = sorted(chip_smoke.device_time_ms(call) for _ in range(ROUNDS))
                    row.append(f"{xs[len(xs) // 2] * 1e3:7.1f}")
                print(f"  ({bh},{t},{d}) " + " ".join(row), flush=True)
            kernels = ([("dq", WS_SPLIT_SHAPES, (1, 2)), ("dkv", WS_SPLIT_SHAPES, (1, 2))]
                       if dtype == torch.bfloat16
                       else [("dq", F32_SPLIT_SHAPES, (1, 2, 4)),
                             ("dkv", F32_DKV_SPLIT_SHAPES, (1, 2))])
            for kind, split_shapes, counts in kernels:
                fn = getattr(lib_bwd, f"flash_attention_bwd_{kind}_split", None)
                if fn is None:
                    continue
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                print(f"{name}: {tag} {kind} device us split over {counts} blocks, median of "
                      f"{ROUNDS} rounds", flush=True)
                for bh, t, d in split_shapes:
                    q, k, v, do = (randn(bh, t, d), randn(bh, t, d), randn(bh, t, d),
                                   randn(bh, t, d))
                    o, lse = fa.flash_attention_plain(q, k, v, save_lse=True)
                    delta = (do.float() * o.float()).sum(-1)
                    a, b = torch.empty_like(q), torch.empty_like(q)
                    ptrs = ((q, k, v, do, lse, delta, a, b) if kind == "dkv"
                            else (q, k, v, o, do, lse, a, delta))
                    row = []
                    for split in counts:
                        def call(split=split):
                            return fn(*(z.data_ptr() for z in ptrs), bh, t, d, code, d ** -0.5,
                                      split, stream)
                        xs = sorted(chip_smoke.device_time_ms(call) for _ in range(ROUNDS))
                        row.append(f"{xs[len(xs) // 2] * 1e3:7.1f}")
                    print(f"  ({bh},{t},{d}) " + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
