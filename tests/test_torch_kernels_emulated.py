"""The port's CUDA kernel sources run on the CPU, lane by lane.

The sources in `ddpm_image_restoration_tpu_torch/csrc/` compile with g++
against `tests/cuda_emu/`, which emulates what they use of CUDA: threads,
blocks and clusters, `__syncthreads`, shuffles, and the sm_90a instructions
of `wgmma_sm90.cuh` that the three bf16 kernels and the three f32 ones
run (`wgmma` in bf16 from swizzled shared-memory descriptors, K-major and
MN-major, and from registers, and in TF32, K-major only, run at the wait
that needs it; `cvt.rna.tf32.f32`; `mbarrier` phases and transaction
counts, arrivals from another block of the cluster; TMA tile loads with
zero fill and swizzle; named barriers; the cluster barrier and distributed
shared memory; `setmaxnreg`, checked), and the tensor-map encoder's checks. The emulated launchers (forward with
LSE, dQ with Delta, dK/dV) then face the same checks as the card tests
(tests/test_torch_kernels_cuda.py): each output against its plain PyTorch
version entry by entry, within one bf16 step of the entry (bf16 outputs)
plus 1e-4 of the largest. This checks the kernels' indexing, fragment and
shared-memory layouts, tiling, the ring's protocol, masking and numerics; it
cannot check the PTX itself, the timing, or races the emulation does not
provoke, which only the card shows, and it reads the PTX ISA as the
kernels' author does (tests/cuda_emu/wgmma_sm90.cuh).
"""

import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu_torch.ops import build
from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
LAUNCH = re.compile(r"(\w+<[^<>]*>)<<<(.*?)>>>\(")
# The split product of all three bf16 kernels (wgmma_split), with its lo
# half and without it.
SPLITS = [("  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);\n"
           "  wgmma_sm90::wgmma_rs<1>(d, a.lo, b, true);\n",
           "  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);\n")]
# The 3xTF32 products of the f32 forward, dQ and dK/dV (flash_tf32.cuh),
# and the same with the lo products dropped: one TF32 product (1xTF32).
TF32_SPLITS = [("  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_lo, accumulate);\n"
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
                "  wgmma_sm90::wgmma_tf32_rs(d, a.hi, b_hi, true);\n")]
# Short and ragged T over the 64-row tiles (one partial tile, one full, a
# ragged third), every head dim of the build; at D = 256 ragged over the
# f32 kernels' 16-row tiles too.
SHAPES = [(2, 17, 32), (1, 130, 16), (2, 64, 16), (1, 150, 32), (1, 70, 64), (1, 40, 128),
          (1, 130, 8), (2, 70, 8), (1, 70, 256)]
STEPS = [(torch.bfloat16, 2 ** -7), (torch.float32, 0.0)]


def _compile(out: Path, faulted: bool = False) -> Path:
    """The emulation's `run_kernels` program linked with the kernel sources,
    in `out`; with `faulted`, the split products' `lo` half dropped (bf16)
    and the 3xTF32 products cut to one (f32)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    out.mkdir(parents=True, exist_ok=True)
    for f in EMU_DIR.iterdir():
        shutil.copy(f, out / f.name)
    for header, splits in (("flash_mma.cuh", SPLITS), ("flash_tf32.cuh", TF32_SPLITS)):
        tiles = (build.CSRC_DIR / header).read_text()
        for sound, dropped in splits:
            assert tiles.count(sound) == 1
            if faulted:
                tiles = tiles.replace(sound, dropped)
        (out / header).write_text(tiles)
    # the launchers' host code (tensor maps, the shared-memory limit) as it
    # stands, for the emulation's wgmma_sm90.cuh to include
    hopper = (build.CSRC_DIR / "wgmma_sm90.cuh").read_text()
    (out / "wgmma_sm90_host.inc").write_text(hopper[hopper.index("namespace wgmma_sm90_host"):])
    units = ["run_kernels.cpp"]
    for name in (fa.KERNEL, fa.BWD_KERNEL):
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        (out / f"{name}.cpp").write_text(
            LAUNCH.sub(r"emu_launch(std::make_tuple(\2), &\1, ", src))
        units.append(f"{name}.cpp")

    def compile_unit(unit):
        return subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-I", str(out), "-c", unit,
                               "-o", unit + ".o"], cwd=out, capture_output=True, text=True)

    with ThreadPoolExecutor(len(units)) as pool:
        for unit, r in zip(units, pool.map(compile_unit, units)):
            assert r.returncode == 0, f"{unit}:\n{r.stderr[-4000:]}"
    r = subprocess.run([gxx, "-o", "run_kernels", *(u + ".o" for u in units), "-lpthread"],
                       cwd=out, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return out / "run_kernels"


@pytest.fixture(scope="module")
def run_kernels(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("cuda_emu"))


def _run(run_kernels: Path, work: Path, bh, t, d, dtype, seed=0, split=1, dkv_split=1,
         dq_split=1):
    """q, k, v, dO from a seeded normal, rounded to `dtype`, through the
    emulated forward (LSE; its split over keys forced to `split`, 0 for
    the launcher's rule), dQ (Delta; the f32 kernel's split over keys at D
    <= 128 forced to `dq_split`) and dK/dV (its split over query tiles
    forced to `dkv_split`, 0 for the rule: the bf16 kernel's at D >= 128,
    the f32 kernel's at D <= 128; at f32 D = 256 the cluster splits the
    head dim and the split is ignored) launchers, each at the head dim its
    wrapper pads D to."""
    rng = np.random.default_rng(seed)
    ins = {n: torch.from_numpy(rng.normal(size=(bh, t, d)).astype(np.float32)).to(dtype)
           for n in ("q", "k", "v", "do")}
    work.mkdir()
    for n, x in ins.items():
        x.float().numpy().tofile(work / n)
    dims = [str(fa.kernel_head_dim(name, d, dtype)) for name in
            ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")]
    r = subprocess.run([str(run_kernels), str(work), str(bh), str(t), str(d),
                        str(int(dtype == torch.bfloat16)), str(split), *dims, str(dkv_split),
                        str(dq_split)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

    def out(n, shape):
        return torch.from_numpy(np.fromfile(work / n, np.float32).reshape(shape))

    outs = {n: out(n, (bh, t, d)).to(dtype) for n in ("o", "dq", "dk", "dv")}
    outs.update({n: out(n, (bh, t)) for n in ("lse", "delta")})
    return ins, outs


def _shares(ins, outs, step):
    """Each output's largest |got - ref| over its bound (step * |ref| +
    1e-4 * max|ref|), the references as in the card tests: the plain
    forward, and the plain backward from the kernel's O and LSE."""
    q, k, v, do = ins["q"], ins["k"], ins["v"], ins["do"]
    ro, rlse = fa.flash_attention_plain(q, k, v, save_lse=True)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, outs["o"], do, outs["lse"])
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, outs["lse"], rdelta)
    refs = {"o": ro, "lse": rlse, "dq": rdq, "delta": rdelta, "dk": rdk, "dv": rdv}
    shares = {}
    for n, ref in refs.items():
        s = step if ref.dtype == torch.bfloat16 else 0.0
        ref = ref.float()
        bound = s * ref.abs() + 1e-4 * ref.abs().max()
        shares[n] = ((outs[n].float() - ref).abs() / bound).max().item()
    return shares


@pytest.mark.parametrize("bh,t,d", SHAPES)
@pytest.mark.parametrize("dtype,step", STEPS)
def test_emulated_kernels_match_plain(run_kernels, tmp_path, bh, t, d, dtype, step):
    """bf16 takes the tensor-core forward, dQ and dK/dV kernels (the
    forward unsplit; all three at the head dim itself, D = 8 too), f32 the
    TF32 forward, dQ and dK/dV (3xTF32; D = 8 padded to 16); every output
    within its bound."""
    if dtype == torch.bfloat16:
        assert all(fa.kernel_head_dim(name, d, dtype) == d for name in fa.WGMMA_KERNELS)
    ins, outs = _run(run_kernels, tmp_path / "run", bh, t, d, dtype)
    shares = _shares(ins, outs, step)
    print(f"({bh},{t},{d}) {dtype}: shares of the bound {shares}")
    assert all(s <= 1.0 for s in shares.values()), shares


# (BH, T, D, split): the forward's keys over a cluster of 4 blocks (one
# with two key tiles, three with one, T ragged), over 2 at D = 8, and the
# launcher's own rule at a shape where it splits (3 row tiles, 5 key tiles:
# 4 ways); at D = 256, where the merge area overlays the ring, over 4
# blocks (5 key tiles of 32: one block with two) and by the rule, which
# splits it at most 2 ways there.
SPLIT_CASES = [(1, 300, 32, 4), (2, 150, 8, 2), (1, 300, 16, 0), (1, 150, 256, 4),
               (1, 70, 256, 0)]


@pytest.mark.parametrize("bh,t,d,split", SPLIT_CASES)
@pytest.mark.parametrize("dtype,step", STEPS)
def test_emulated_split_route_matches_plain(run_kernels, tmp_path, bh, t, d, split, dtype, step):
    """The forward (bf16, and f32 on TF32) with its keys split over a
    cluster and merged through distributed shared memory: every output
    within its bound."""
    ins, outs = _run(run_kernels, tmp_path / "run", bh, t, d, dtype, split=split)
    shares = _shares(ins, outs, step)
    print(f"({bh},{t},{d}) split {split} {dtype}: shares of the bound {shares}")
    assert all(s <= 1.0 for s in shares.values()), shares


# (BH, T, D, split, dkv_split): the warp-specialised bf16 forward and dK/dV
# at D = 128 and 256, over 64-row tiles: T ragged over three tiles (the
# forward's two consumer warpgroups taking tiles 0, 2 and 1; dK/dV's ring
# wrapping at D = 256's two stages), unsplit and split over a cluster of
# 2 (the forward over keys: one block's second warpgroup with no tile;
# dK/dV over query tiles, the partial sums added through distributed shared
# memory), the forward over 4 (a block with no tile), the launchers' own
# rules (which split both) and one tile (T <= 64: the rules leave both
# unsplit).
WS_CASES = [(1, 150, 128, 1, 1), (1, 150, 128, 2, 2), (1, 130, 256, 1, 1), (1, 150, 256, 2, 2),
            (2, 70, 128, 0, 0), (1, 150, 128, 4, 0), (1, 40, 256, 0, 0)]


@pytest.mark.parametrize("bh,t,d,split,dkv_split", WS_CASES)
def test_emulated_ws_routes_match_plain(run_kernels, tmp_path, bh, t, d, split, dkv_split):
    """The warp-specialised bf16 forward and dK/dV (a producer warpgroup
    handing its registers to two consumer warpgroups by setmaxnreg, 384
    threads a block) on their split and unsplit routes: every output within
    its bound."""
    ins, outs = _run(run_kernels, tmp_path / "run", bh, t, d, torch.bfloat16, split=split,
                     dkv_split=dkv_split)
    shares = _shares(ins, outs, 2 ** -7)
    print(f"({bh},{t},{d}) split {split}, dK/dV split {dkv_split}: shares of the bound {shares}")
    assert all(s <= 1.0 for s in shares.values()), shares


# (BH, T, D, dq_split): the warp-specialised bf16 dQ at D = 128 and 256
# (one 64-query tile a block; S and P in one consumer warpgroup, dP and dS
# in the other, each accumulating half of dQ's columns), its key tiles
# dealt over a cluster of 1 or 2 blocks and the partial dQ added through
# distributed shared memory: T ragged over three 64-row tiles unsplit and
# split 2 (block 0 takes key tiles 0 and 2, its last one ragged; block 1
# tile 1), D = 256 ragged over two full tiles, the launcher's rule (which
# splits (2, 70, 128) and (1, 200, 256): block 1 takes tiles 1 and 3, its
# last one ragged), and one tile (T <= 64: the rule leaves it unsplit;
# forced to 2, block 1 has no key tile).
DQ_WS_CASES = [(1, 150, 128, 1), (1, 150, 128, 2), (1, 130, 256, 1), (1, 150, 256, 2),
               (2, 70, 128, 0), (1, 200, 256, 0), (1, 40, 128, 0), (1, 40, 256, 2)]


@pytest.mark.parametrize("bh,t,d,dq_split", DQ_WS_CASES)
def test_emulated_dq_ws_routes_match_plain(run_kernels, tmp_path, bh, t, d, dq_split):
    """The warp-specialised bf16 dQ (a producer warpgroup summing Delta and
    handing its registers to two consumer warpgroups by setmaxnreg, P and
    dS passed between them through shared memory) on its split and unsplit
    routes: dQ and Delta (and the other outputs) within their bounds."""
    ins, outs = _run(run_kernels, tmp_path / "run", bh, t, d, torch.bfloat16, dq_split=dq_split)
    shares = _shares(ins, outs, 2 ** -7)
    print(f"({bh},{t},{d}) dQ split {dq_split}: shares of the bound {shares}")
    assert all(s <= 1.0 for s in shares.values()), shares


@pytest.mark.parametrize("bh,t,d", [(1, 150, 32), (1, 130, 16), (1, 130, 8), (1, 70, 256),
                                    (1, 130, 128)])
def test_emulated_dropped_lo_fails_the_bound(tmp_path, bh, t, d):
    """A copy of the sources with the `lo` half dropped at the split
    product (wgmma_split: P and dS rounded to bf16 once) fails the bound in
    the forward output, dQ, dK and dV, while the f32 statistics still pass:
    the bounds see the split in every kernel (at D = 128 and 256 the
    warp-specialised forward, dQ and dK/dV)."""
    faulted = _compile(tmp_path / "faulted", faulted=True)
    ins, outs = _run(faulted, tmp_path / "run", bh, t, d, torch.bfloat16)
    shares = _shares(ins, outs, 2 ** -7)
    print(f"dropped lo, ({bh},{t},{d}) bf16: shares of the bound {shares}")
    assert min(shares["o"], shares["dq"], shares["dk"], shares["dv"]) > 1.0, shares
    assert max(shares["lse"], shares["delta"]) <= 1.0, shares


# (BH, T, D, split, dq_split, dkv_split): the TF32 f32 forward, dQ and
# dK/dV at D = 16, 32, 64, 128 and 256 over ragged T (the forward's 64-,
# 32- and 16-key stages, its ring wrapping; D = 256's single stage; dK/dV's
# 64-, 32- and 16-query stages, its ring wrapping at D >= 32), unsplit and
# with the keys of the forward and dQ split over a cluster of 2 or 4
# blocks ((1, 70, 32) 4 ways: the forward's 2 key tiles and dQ's 3 leave
# blocks with none) and dK/dV's query tiles over 2 (D = 16, 32 and 128;
# (1, 70, 128): one block's last tile ragged), and the launchers' own
# rules (which split (1, 150, 64) 2 ways, and dK/dV's query tiles wherever
# one key tile has two query tiles); at D = 256 the forward's one stage
# with its raw landing area, and dQ's and dK/dV's head dim split over a
# cluster of 2 (their other splits ignored); one key tile (T <= 64) at D =
# 16, 32 and 128.
F32_CASES = [(2, 70, 16, 1, 1, 1), (1, 150, 32, 2, 2, 2), (1, 70, 32, 4, 4, 1),
             (1, 150, 64, 0, 0, 0), (1, 70, 128, 4, 4, 2), (3, 40, 128, 0, 0, 0),
             (1, 70, 256, 1, 1, 1), (1, 50, 256, 2, 0, 0), (1, 150, 128, 1, 1, 1),
             (1, 150, 128, 1, 1, 2), (1, 130, 256, 1, 1, 2), (1, 150, 16, 0, 0, 2),
             (2, 40, 16, 1, 1, 0), (3, 17, 32, 1, 1, 0)]


@pytest.mark.parametrize("bh,t,d,split,dq_split,dkv_split", F32_CASES)
def test_emulated_f32_tf32_kernels_match_plain(run_kernels, tmp_path, bh, t, d, split, dq_split,
                                               dkv_split):
    """The f32 forward, dQ and dK/dV on TF32 wgmma with the 3xTF32 split
    (V, K, Q^T and dO^T transposed by the producer warps, keys or queries
    permuted in groups of 8; dK/dV warp-specialised by product), split over
    a cluster and not: every output within the f32 bound (1e-4 of the
    largest entry)."""
    ins, outs = _run(run_kernels, tmp_path / "run", bh, t, d, torch.float32, split=split,
                     dq_split=dq_split, dkv_split=dkv_split)
    shares = _shares(ins, outs, 0.0)
    print(f"({bh},{t},{d}) split {split}, dQ split {dq_split}, dK/dV split {dkv_split}, f32: "
          f"shares of the bound {shares}")
    assert all(s <= 1.0 for s in shares.values()), shares


@pytest.mark.parametrize("bh,t,d", [(1, 150, 16), (1, 150, 32), (1, 70, 128), (1, 70, 256)])
def test_emulated_one_tf32_product_fails_the_f32_bound(tmp_path, bh, t, d):
    """A copy with the 3xTF32 products cut to one (A_hi * B_hi: the lo
    products dropped, every product rounded to TF32 once) fails the f32
    bound in the forward output, dQ, dK and dV, while Delta (f32 sums of
    rows in device memory) still passes: the bound sees the split in every
    f32 kernel."""
    faulted = _compile(tmp_path / "faulted", faulted=True)
    ins, outs = _run(faulted, tmp_path / "run", bh, t, d, torch.float32)
    shares = _shares(ins, outs, 0.0)
    print(f"one TF32 product, ({bh},{t},{d}) f32: shares of the bound {shares}")
    assert shares["o"] > 1.0, shares
    assert shares["dq"] > 1.0, shares
    assert min(shares["dk"], shares["dv"]) > 1.0, shares
    assert shares["delta"] <= 1.0, shares
