#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (`ddpm_image_restoration_tpu_torch`) on one
NVIDIA card and checks it, phase by phase:

  1. environment: torch and CUDA versions, the card's name and power limit,
     Pillow's version and whether it writes AVIF;
  2. build: every kernel of the serving and training paths, with nvcc, from
     the checkout, one nvcc per source, all started together; each kernel's
     registers, spills and shared memory (`ptxas -v`) and its tensor-core
     and TMA instructions (HGMMA with UTMALDG in every instantiation of
     the bf16 wgmma forward, dQ and dK/dV kernels, D = 8 to 256, and of
     the f32 forward, dQ and dK/dV (TF32 wgmma, D = 16 to 256), and HMMA
     in none; counted in `cuobjdump -sass`), and no spill in the
     warp-specialised bf16 forward, dQ and dK/dV (D = 128 and 256) and f32
     dK/dV (every D);
  3. kernels: each kernel against its plain PyTorch version, with times
     (the kernels' and SDPA's as device time under torch.profiler, the
     plain versions' between CUDA events), and the autograd Function's
     gradients against autograd through the plain attention, at every path
     shape (D = 256 and 128 of the 1024² path too) and contract shape, in
     bf16 and f32; at the f32 path shapes SDPA in f32 under each backend
     that takes f32 (efficient, math), the faster one the yardstick;
  3b. path1024: the WebP preset's full-width UNet at 1024² (flash attention
     at <= 32²: only the bottleneck attends, at T = 1024 with D = 256, 256
     and 128; random weights, batch 1): `cli/restore.py` on a 1024² WebP
     under the production policy, one train step with block remat, each
     kernel's launches per head dim against what the model's structure
     predicts, and one UNet evaluation with flash attention against the
     same weights with the plain attention (bf16); then the restore, the
     train step and the evaluation in f32 (`--compute-dtype float32`:
     the TF32 f32 forward, dQ and dK/dV at D = 256 and 128);
  4. reference: a half-width f32 restore on the card against the same
     restore on the CPU (the CPU path is the one the tests hold to the JAX
     package), a traced-budget, mixed-quality one with decoder reuse, and
     one of the AVIF-preset model;
  4b. release: the release weights (`artifacts_release/webp_real_r5.npz`,
     or `--release`'s, loaded once, strict, its sha256 against the
     fixture's) at full width: the JAX package's inputs from
     `tests/torch_release/<release>_jax.npz` restored on the card through
     the serve core under the production policy of each case's codec,
     twice (the signature's first call runs the solver eager, the second
     captures it as a CUDA graph and replays it; the two compared bit for
     bit), each in
     f32 held to the JAX package's own f32 restores (mean|diff| <= 1e-4,
     max <= 2e-2, an image at a reference edge by PSNR, n + g forward
     launches), in bf16 by PSNR (within 0.1 dB of the JAX f32 restore's,
     or of the span to JAX's own bf16 restore's where the fixture has it);
     then the README's CLIs with `--params-npz` on those weights, each output's
     PSNR against its clean image: for the WebP release `cli/restore.py`
     (tiles; `--quality auto`; `--solver gaussian_mixture`), `cli/serve.py
     --once` and `cli/evaluate.py`; for the unified one `cli/restore.py`
     on a JPEG, a WebP and an AVIF, `cli/serve.py --once` on a directory
     of the three (codec-pure batches, counted) and `cli/evaluate.py
     --codec jpeg`, all with `--model-codec all --codec auto`;
  5. serve: the restore server core at full width (64², the release
     weights that phase `release` loaded, bf16, flash attention at <= 32²)
     on three batches of 8 images under the production solver policy (WebP;
     for the unified model one JPEG, one WebP and one AVIF batch) in four
     passes: the signatures' first calls (eager), their captures, timed
     replays, and timed eager calls again, each pass's launches held to
     the schedule, one batch profiled each way;
  6. train_reference: one half-width f32 train step on the card against the
     same step on the CPU (loss and every gradient), WebP and AVIF presets,
     and one half-width f32 distill step (2 student evaluations through the
     rematerialised solver) likewise;
  7. train: the WebP trainer (`cli/train.py main`) at full width, bf16,
     batch 18, EMA: two epochs in one run (the step's graph replayed
     across validation), then a third resumed from the checkpoint the
     first run wrote, counting each kernel's launches in the train steps,
     validation and the epoch's restoration grid; the data pipeline alone;
     then the train step alone, timed and profiled;
  8. distill: solver distillation (`cli/distill.py main`) at full width
     from phase `train`'s checkpoint: 2 student evaluations at q10/q50
     against the full-solver teacher, in bf16 and then in f32 as the
     README tells users to distill (`--compute-dtype float32`), then the
     progressive chain (budgets 4, 2), then `cli/restore.py --max-evals
     2` from the student; every
     kernel's launches against the schedule; then the distill step alone,
     timed, profiled, and its peak memory with and without the solver's
     rematerialisation;
  9. parallel: the parallel layer (parallel/mesh.py). In this process
     under a world-1 NCCL process group: `cli/restore.py` and
     `cli/serve.py` with `--dp -1` against the same calls without it at full
     width, then the full-width bf16 WebP train step (batch 18, EMA) plain,
     under the data mesh and under FSDP: ms/step and peak memory. Then two
     processes of this script sharing the card over gloo: a half-width f32
     step under the data mesh, under FSDP and on a (1, 2) ('data', 'model')
     mesh (tensor parallelism), a data-parallel and a spatial-parallel
     restore at eta 0.85, each against the one-process card run, the dry
     run, `cli/restore.py --dp -1` and `--sp -1` against the one-rank call,
     and each rank's state, resident and peak memory and ms/step at full
     width under the data mesh, FSDP and the model axis (batch 18); every
     rank's launches against the schedule;
 10. restore: the restore CLI (`cli/restore.py main`) at full width on
     WebP and JPEG files that Pillow writes (estimated qualities, decoder
     reuse at depth 1 and 2, a 2-way ensemble, tiles of a non-square
     image, and the EMA weights of the checkpoint phase `train` wrote), then
     the server (`cli/serve.py main`) on mixed codecs with the traced
     budget; each variant's kernel launches against its schedule, and its
     milliseconds per image; then that checkpoint through `cli/export.py`
     (EMA, and `--raw-params`) into release npz files that hold its weights
     rounded to fp16 in the JAX package's layout, and the restore CLI on
     the EMA npz (`--params-npz`);
 11. evaluate: the evaluator (`cli/evaluate.py main`) at full width on 20
     images, q10/30/50 under the production policy, static and traced:
     launches against the schedule, the metrics summary's fields, images
     per second per quality;
 12. avif: the AVIF model family at full width: `cli/train.py --codec
     avif` (one epoch, EMA, checkpoint), `cli/evaluate.py` and
     `cli/restore.py --model-codec avif` on that checkpoint (AVIF files
     Pillow writes), then two steps of `cli/train.py --codec all`; every
     kernel's launches against the schedule;
 13. gaussian_mixture: `cli/restore.py --solver gaussian_mixture` at full
     width on 8 WebPs at q30 (cold and warm) and a non-square WebP in
     tiles, the forward kernel's launches against init_t x 2 a batch, ms
     per image; the sampler's per-step threefry draws (host) and batched
     SVD (card), a profile of one sampler batch; a half-width f32 sampler
     run on the card against the CPU;
 14. modules: DDIM and the DDPM chain over the experimental models at
     their default widths, card against CPU in f32; the native codec
     engine built from `native/codec_engine.cpp` into build/, its loader
     batches against the surrogate on the card and its ms/batch against
     Pillow's; `utils/profiling.trace` around a serve batch; the serve
     batch with the upsample and block DCT swapped for the JAX package's
     other formulations (shift/adds, block-diagonal matmuls, defined
     here), in turns: ms/batch, output against the default, and each op's
     time on its own between CUDA events.

    python3 chip_smoke.py [--release NAME]

`--release all_teacher_r3` runs phases `release` and `serve` on the unified
multi-codec release (`--model-codec all`: JPEG, WebP and AVIF restores held
to the JAX package's own in `tests/torch_release/all_teacher_r3_jax.npz`,
and the restore, serve and evaluate CLIs with `--codec auto`) instead of
`webp_real_r5`; every other phase runs as without it. Given explicitly, the
copy must hold that npz and its fixture and no other release npz (a copy
sent to the card holds one); the script refuses otherwise, as it does an
unknown name.

On a host with several cards, `torchrun --standalone --nproc-per-node N
chip_smoke.py --parallel-child-nccl OUTDIR` runs phase `parallel`'s ranks
alone over NCCL, a card a rank, with the preset's 18 images a rank (N even:
the model axis runs on an (N/2, 2) mesh, `--sp` over all N).

It prints each phase's seconds, then a JSON line of per-kernel numbers, the
card's `nvidia-smi` name and power limit, and last `{"ok": true, ...}`. It
exits non-zero, printing no result, when any phase fails, when no CUDA card
is visible, or when the port's package is not beside it. It needs torch,
numpy, scipy (the Fréchet distance), nvcc, a C++ compiler (the native
codec engine), Pillow with AVIF (phases `release`, `restore`, `evaluate`,
`avif` and `gaussian_mixture` read and write image files; the serving
phase skips the exact final projection, saying why, without Pillow), and
the release npz and its fixture (phases `release` and `serve` fail
without them).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
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
# 7 (4 heads each), and the distillation teacher's batch of 18 (without the
# LSE: it runs under no_grad; the student's shapes are the train step's); then the
# AVIF model's (8 heads: head dim 128/8 = 16 at down2, 64/8 = 8 at up4,
# which the bf16 forward and dK/dV take natively and dQ's wrapper
# zero-pads to 16) for its
# training and evaluation batches of 8, its validation batch of 4 and the
# restore CLI's single files; then the Gaussian-mixture restore's batch of 8
# files and its tile batches (the serve and restore-tile shapes again); last
# the train step on a (2, 2) ('data', 'model') mesh, 9 images a data rank
# (`--parallel-child-nccl` on four cards; the script's own (1, 2) mesh and
# `--sp` restores give the train-step and serve shapes: a model rank
# attends over its data rank's whole batch, an `--sp` rank over the
# gathered tokens of every image); then phase `path1024`'s bottleneck at
# 1024² (4 heads of 1024 and 512 channels at 32² tokens, batch 1: D = 256
# and 128), restored and trained; last phase `release`'s bf16 restores of the
# JAX package's inputs (2 images x 4 heads).
FWD_PATH_SHAPES = [("serve", 32, 1024, 32, False), ("serve", 32, 1024, 16, False),
                   ("train step", 72, 1024, 32, True), ("train step", 72, 1024, 16, True),
                   ("distill teacher", 72, 1024, 32, False),
                   ("distill teacher", 72, 1024, 16, False),
                   ("validation", 16, 1024, 32, False), ("validation", 16, 1024, 16, False),
                   ("restore", 4, 1024, 32, False), ("restore", 4, 1024, 16, False),
                   ("restore tiles", 64, 1024, 32, False), ("restore tiles", 64, 1024, 16, False),
                   ("serve CLI", 28, 1024, 32, False), ("serve CLI", 28, 1024, 16, False),
                   ("avif train step", 64, 1024, 16, True), ("avif train step", 64, 1024, 8, True),
                   ("avif evaluate", 64, 1024, 16, False), ("avif evaluate", 64, 1024, 8, False),
                   ("avif validation", 32, 1024, 16, False),
                   ("avif validation", 32, 1024, 8, False),
                   ("avif restore", 8, 1024, 16, False), ("avif restore", 8, 1024, 8, False),
                   ("gaussian_mixture", 32, 1024, 32, False),
                   ("gaussian_mixture", 32, 1024, 16, False),
                   ("gaussian_mixture tiles", 64, 1024, 32, False),
                   ("gaussian_mixture tiles", 64, 1024, 16, False),
                   ("model axis (2, 2)", 36, 1024, 32, True),
                   ("model axis (2, 2)", 36, 1024, 16, True),
                   ("restore 1024²", 4, 1024, 256, False), ("restore 1024²", 4, 1024, 128, False),
                   ("train step 1024²", 4, 1024, 256, True),
                   ("train step 1024²", 4, 1024, 128, True),
                   ("release", 8, 1024, 32, False), ("release", 8, 1024, 16, False)]
# The f32 kernels' shapes on the main paths, (path, BH, T, D, save_lse):
# the README's f32 distillation at full width (phase `distill`,
# `--compute-dtype float32`: the teacher's batch of 18 x 4 heads under
# no_grad, the student's with the LSE: D = 32 at down2, 16 at up4), the
# 1024² path's f32 legs (phase `path1024`: the restore and the remat train
# step, D = 256 and 128), and the half-width f32 gates at D = 16 (the
# restore's 2 images x 4 heads at down2, the train step's 4 x 4; their D =
# 8 at up4 runs padded to 16), and phase `release`'s full-width f32 restores
# of the JAX package's inputs (2 images x 4 heads: D = 32 and 16).
F32_FWD_PATH_SHAPES = [("distill teacher f32", 72, 1024, 32, False),
                       ("distill teacher f32", 72, 1024, 16, False),
                       ("distill student f32", 72, 1024, 32, True),
                       ("distill student f32", 72, 1024, 16, True),
                       ("restore 1024² f32", 4, 1024, 256, False),
                       ("restore 1024² f32", 4, 1024, 128, False),
                       ("train step 1024² f32", 4, 1024, 256, True),
                       ("train step 1024² f32", 4, 1024, 128, True),
                       ("f32 restore gate", 8, 1024, 16, False),
                       ("f32 train gate", 16, 1024, 16, True),
                       ("release f32", 8, 1024, 32, False),
                       ("release f32", 8, 1024, 16, False)]
# (BH, T, D) -> path of the f32 dQ and dK/dV on the main paths.
F32_TRAIN_SHAPES = {(72, 1024, 32): "distill student f32", (72, 1024, 16): "distill student f32",
                    (4, 1024, 256): "train step 1024² f32", (4, 1024, 128): "train step 1024² f32",
                    (16, 1024, 16): "f32 train gate"}
# (BH, T, D): those shapes, then long, ragged and wide-head cases of the
# kernel's contract.
KERNEL_SHAPES = list(dict.fromkeys(s[1:4] for s in FWD_PATH_SHAPES)) + [
    (8, 4096, 16), (4, 300, 64), (2, 256, 128), (3, 17, 32), (32, 1024, 256), (3, 300, 256),
    (2, 300, 192)]
# Backward (BH, T, D) -> heads: the training paths' shapes first (down2 and
# up4 of a WebP batch of 18 images x 4 heads and of an AVIF batch of 8 x 8
# heads, 32x32 tokens, and of 9 images x 4 heads a data rank of the (2, 2)
# model-axis step; the 1024² train step's bottleneck, one image x 4 heads
# at D = 256 and 128), then contract shapes: the 32x32 level of the 128²
# model (head dim 64, batch 18), ragged, short and wide cases, and D = 256
# at a batch of 8 images, ragged, and at D = 192 (padded to 256); last the
# half-width f32 train gate's down2 and up4 (4 images x 4 heads, D = 16 and
# 8), for the f32 kernels' times beside SDPA's in f32.
TRAIN_SHAPES = {(72, 1024, 32): 4, (72, 1024, 16): 4, (64, 1024, 16): 8, (64, 1024, 8): 8,
                (36, 1024, 32): 4, (36, 1024, 16): 4, (4, 1024, 256): 4, (4, 1024, 128): 4}
TRAIN_PATHS = {(64, 1024, 16): "avif train step", (64, 1024, 8): "avif train step",
               (36, 1024, 32): "model axis (2, 2)", (36, 1024, 16): "model axis (2, 2)",
               (4, 1024, 256): "train step 1024²", (4, 1024, 128): "train step 1024²"}
BWD_SHAPES = [*TRAIN_SHAPES, (72, 1024, 64), (4, 300, 64), (4, 1300, 16), (2, 256, 128),
              (3, 17, 32), (32, 1024, 256), (3, 300, 256), (2, 300, 192), (16, 1024, 16),
              (16, 1024, 8)]
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
    "flash_attention_fwd": {"bf16": "wgmma m64nNk16, TMA/mbarrier ring, hi/lo P, cluster split "
                                    "over keys; D <= 64: two warpgroups of 64 rows; D = 128 "
                                    "and 256: warp-specialised 64-row blocks (producer "
                                    "warpgroup, setmaxnreg, two consumer warpgroups taking "
                                    "the key tiles in turn, 64-key stages)",
                            "f32": "TF32 wgmma m64nNk8, 3xTF32 split (hi/lo by cvt.rna), "
                                   "TMA/mbarrier ring, a producer warpgroup writing K hi/lo "
                                   "and V^T hi/lo (keys permuted in groups of 8), cluster split "
                                   "over keys; D = 16-64: two consumer warpgroups of 64 rows, "
                                   "D = 128 and 256: one (D = 256: one 16-key stage and a raw "
                                   "landing area)"},
    "flash_attention_bwd_dq": {"bf16": "wgmma m64nNk16, TMA/mbarrier ring, hi/lo dS; D <= 64: "
                                       "two warpgroups of 64 rows; D = 128 and 256: "
                                       "warp-specialised 64-row blocks (producer warpgroup "
                                       "streaming 64-key stages, setmaxnreg; one consumer "
                                       "warpgroup S and P, the other Delta, dP and dS, each "
                                       "half of dQ's columns), key tiles over a cluster of 2",
                               "f32": "TF32 wgmma m64nNk8, 3xTF32 split, TMA/mbarrier ring, "
                                      "a producer warpgroup writing K, V and K^T hi/lo; two "
                                      "consumer warpgroups at D <= 64, one at 128 and 256; "
                                      "D <= 128: cluster split over keys; D = 256: the head "
                                      "dim split over a cluster of 2, partial S and dP "
                                      "exchanged through distributed shared memory, Q's lo "
                                      "part in registers, two 16-key stages"},
    "flash_attention_bwd_dkv": {"bf16": "wgmma m64nNk16, TMA/mbarrier ring, hi/lo P and dS; "
                                        "D = 128 and 256: warp-specialised (producer "
                                        "warpgroup, setmaxnreg; one consumer warpgroup S^T, "
                                        "P^T and dV, the other dP^T, dS^T and dK), query "
                                        "tiles over a cluster of 2",
                                "f32": "TF32 wgmma m64nNk8, 3xTF32 split, TMA/mbarrier ring, "
                                       "a producer warpgroup writing Q, dO, Q^T and dO^T "
                                       "hi/lo (queries permuted in groups of 8), setmaxnreg "
                                       "56/224, K lo and V lo in registers; D <= 32: two "
                                       "consumer warpgroups of 64 keys each running all four "
                                       "products; D >= 64: one 64-key tile a block, one "
                                       "consumer warpgroup S^T, P^T and dV, the other dP^T, "
                                       "dS^T and dK; D <= 128: query tiles over a cluster of "
                                       "2 by the rule; D = 256: the head dim split over a "
                                       "cluster of 2, partial S^T and dP^T exchanged through "
                                       "distributed shared memory"},
}
# The bf16 instantiations (kernel, head dims) that run wgmma: all three
# bf16 kernels at every head dim they are built for (one name each, the
# design chosen by D at compile time).
WGMMA_DESIGN_DIMS = {"flash_fwd_wgmma_kernel": (8, 16, 32, 64, 128, 256),
                     "flash_bwd_dq_wgmma_kernel": (8, 16, 32, 64, 128, 256),
                     "flash_bwd_dkv_wgmma_kernel": (8, 16, 32, 64, 128, 256)}
# The f32 instantiations (kernel, head dims) that run TF32 wgmma: all three
# f32 kernels at every head dim they are built for.
TF32_DESIGN_DIMS = {"flash_fwd_kernel": (16, 32, 64, 128, 256),
                    "flash_bwd_dq_kernel": (16, 32, 64, 128, 256),
                    "flash_bwd_dkv_kernel": (16, 32, 64, 128, 256)}
# The f32 path shapes' (kernel, SDPA in f32) device ms of the FMA forward
# and dQ that the TF32 designs replaced, as chip_smoke measured them on
# `NVIDIA H100 80GB HBM3, 700.00 W` (PR 17 run 1; PERF.md §6, the f32 rows'
# "was"): forward (BH, T, D); dQ against SDPA's whole backward. Shapes that
# no earlier run recorded are logged as such.
FMA_F32_FWD_MS = {(4, 1024, 256): (0.4412, 0.1496), (4, 1024, 128): (0.2319, 0.0962),
                  (8, 1024, 16): (0.0874, 0.0980), (16, 1024, 16): (0.0879, 0.1306)}
FMA_F32_DQ_MS = {(4, 1024, 256): (0.6033, 0.5871), (4, 1024, 128): (0.3376, 0.3085),
                 (16, 1024, 16): (0.1126, 0.2933)}
# The same for the FMA dK/dV that the TF32 design replaced: (kernel, SDPA's
# whole f32 backward, its faster backend) device ms at the f32 path shapes,
# as chip_smoke measured them on `NVIDIA H100 80GB HBM3, 700.00 W` (PERF.md
# §6, the f32 dK/dV rows' "was").
FMA_F32_DKV_MS = {(4, 1024, 256): (0.5372, 0.2606), (4, 1024, 128): (0.3448, 0.1845),
                  (72, 1024, 32): (0.9805, 1.3463), (72, 1024, 16): (0.4792, 1.2627),
                  (16, 1024, 16): (0.1364, 0.2914)}
# The 1024² path's (kernel, SDPA) device ms of the D = 128 and 256 designs
# that the warp-specialised forward and dK/dV replaced (the forward's
# 128-row blocks with 32-key stages at D = 256; dK/dV's 288-thread blocks,
# two a key tile at D = 256), as chip_smoke measured them on `NVIDIA H100
# 80GB HBM3, 700.00 W` (PERF.md §6, the kernel table's "was"): forward (BH,
# T, D, save_lse); dK/dV (BH, T, D) against SDPA's whole backward.
WIDE_FWD_BEFORE_MS = {(4, 1024, 256, False): (0.0485, 0.0275), (4, 1024, 256, True): (0.0518, 0.0275),
               (4, 1024, 128, False): (0.0253, 0.0163), (4, 1024, 128, True): (0.0274, 0.0163)}
WIDE_DKV_BEFORE_MS = {(4, 1024, 256): (0.1608, 0.0627), (4, 1024, 128): (0.0983, 0.0451)}
# The same for the bf16 dQ design that the warp-specialised one replaced
# at D = 128 and 256 (128-row blocks, thread 0 loading, 32-key stages at
# D = 256), as chip_smoke measured it on the same card beside the
# warp-specialised dK/dV (PERF.md §6, the dQ rows' "was"): (dQ, SDPA's
# whole backward, dK/dV) at (BH, T, D), so that each run logs dQ/SDPA and
# the pair's (dQ + dK/dV)/SDPA beside the earlier design's.
WIDE_DQ_BEFORE_MS = {(4, 1024, 256): (0.0663, 0.0653, 0.0288), (4, 1024, 128): (0.0297, 0.0452, 0.0173)}
# The bf16 path shapes' (kernel, SDPA) device ms of the mma.sync forward and
# dK/dV kernels that the wgmma ones replaced, as chip_smoke measured them on
# `NVIDIA H100 80GB HBM3, 700.00 W` (PERF.md §6, the kernel table's "was"):
# the ratio each run logs its own beside. Forward: (BH, T, D, save_lse);
# dK/dV: (BH, T, D) against SDPA's whole backward.
MMA_SYNC_FWD_MS = {
    (32, 1024, 32, False): (0.0382, 0.0242), (32, 1024, 16, False): (0.0309, 0.0241),
    (72, 1024, 32, True): (0.0811, 0.0544), (72, 1024, 16, True): (0.0642, 0.0539),
    (72, 1024, 32, False): (0.0806, 0.0544), (4, 1024, 32, False): (0.0196, 0.0129),
    (64, 1024, 16, True): (0.0576, 0.0440), (64, 1024, 8, True): (0.0733, 0.0447),
    (36, 1024, 32, True): (0.0462, 0.0352), (36, 1024, 16, True): (0.0376, 0.0337)}
MMA_SYNC_DKV_MS = {
    (72, 1024, 32): (0.1322, 0.1411), (72, 1024, 16): (0.0999, 0.1297),
    (64, 1024, 16): (0.0889, 0.1066), (64, 1024, 8): (0.1123, 0.1101),
    (36, 1024, 32): (0.0762, 0.0825), (36, 1024, 16): (0.0600, 0.0796)}
# The same for the mma.sync dQ kernel that the wgmma one replaced (PERF.md
# §6, the dQ rows' "was", from one run): (dQ, SDPA's whole backward, the
# wgmma dK/dV beside it) device ms, so that each run logs dQ/SDPA and the
# pair's (dQ + dK/dV)/SDPA beside the mma.sync dQ's.
MMA_SYNC_DQ_MS = {
    (72, 1024, 32): (0.0879, 0.1424, 0.0991), (72, 1024, 16): (0.0651, 0.1303, 0.0830),
    (64, 1024, 16): (0.0566, 0.1051, 0.0671), (64, 1024, 8): (0.0812, 0.1100, 0.0679),
    (36, 1024, 32): (0.0535, 0.0827, 0.0583), (36, 1024, 16): (0.0416, 0.0803, 0.0501)}


def ratio_note(ms: float, lib_ms: float, was, design: str = "mma.sync kernel") -> str:
    """'kernel/SDPA r (<design>: r0)' for a path shape's log line."""
    then = f"{was[0] / was[1]:.3f}" if was else "not recorded"
    return f"kernel/SDPA {ms / lib_ms if lib_ms > 0 else float('nan'):.3f} ({design}: {then})"


def earlier_design(table_mma_sync: dict, table_wide: dict, key) -> tuple:
    """(earlier times, what they were) for a path shape's log line: the
    earlier D = 128 / 256 design's where it has the shape, else the mma.sync
    kernel's."""
    if key in table_wide:
        return table_wide[key], "earlier D = 128/256 design"
    return table_mma_sync.get(key), "mma.sync kernel"


# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense
# tensor-core bf16 FLOP/s; dense TF32 on the tensor cores; f32 outside the
# tensor cores (FMA: only the "was" bound of the f32 kernels' FMA designs).
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS_S = 989e12
PEAK_TF32_FLOPS_S = 495e12
PEAK_FMA_F32_FLOPS_S = 67e12
SERVE_QUALITIES = (10, 30, 50)
SERVE_BATCH = 8
TRAIN_BATCH = 18        # the WebP preset's batch size
# natural synthetic images: 432 train (24 steps an epoch, the loop timed over
# 22: far more than the loader's 4 workers + 2 prefetched batches), 54 val
TRAIN_IMAGES = 540
SEED = 0
# The restore phase's files: 2 WebPs 64² at each quality, 2 JPEGs, and one
# non-square WebP for tile mode; the CLIs' common flags (the release model,
# the production budget and encoder reuse).
RESTORE_QUALITIES = (10, 30, 50, 90)
RESTORE_FLAGS = ["--device", "cuda", "--attn", "flash", "--attn-max-res", "32",
                 "--max-evals", "14", "--encoder-reuse", "2"]
# `cli/export.py`'s flags for phase `train`'s checkpoint (that run's model).
EXPORT_FLAGS = ["--device", "cuda", "--codec", "webp", "--attn-max-res", "32"]
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
# synthetic images (80% train: 24 steps of 8), the evaluator and the restore
# CLI on its checkpoint at the preset's validation qualities, then two steps
# of the unified trainer (batch 18: 36 training images of 45).
AVIF_TRAIN_IMAGES = 240
AVIF_EVAL_IMAGES = 8
AVIF_QUALITIES = (20, 50, 80)
ALL_TRAIN_IMAGES = 45
# Flash-attention calls per UNet evaluation at 64² with attention at <= 32²:
# the two 32² levels, down2 (encode) and up4 (decode).
FLASH_PER_EVAL = 2
# The distill phase: the student's budget and qualities against the
# full-solver teacher on DISTILL_IMAGES natural images (36 training images:
# 2 steps of 18), the step alone timed over DISTILL_TIMED_EAGER warm eager
# calls and DISTILL_TIMED_REPLAYS replays; then the progressive chain from a
# stride-10 teacher on DISTILL_PROGRESSIVE_IMAGES (18 training images: 1 step
# a stage), whose budgets must be these.
DISTILL_N_EVAL = 2
DISTILL_QUALITIES = (10, 50)
DISTILL_TEACHER_STRIDE = 1   # the full solver
DISTILL_IMAGES = 45
DISTILL_TIMED_EAGER = 3
DISTILL_TIMED_REPLAYS = 3
# The step alone's gates run a shorter teacher (3 evaluations at q50, not
# 50) over 2 steps a run: 3 + 3 runs in torch's default setting and 3 + 1
# under deterministic algorithms, remat on and off, in bf16 and f32.
DISTILL_GATE_TEACHER_STRIDE = 25
DISTILL_GATE_STEPS = 2
# The distiller's shared memory pool (`distill_pool`): each bucket's steps of
# one `cli/distill.py` run, with the gates' shorter teacher.
DISTILL_POOL_STEPS = 3
DISTILL_PROGRESSIVE_IMAGES = 23
DISTILL_PROGRESSIVE_STRIDE = 10
DISTILL_PROGRESSIVE_BUDGETS = [4, 2]
# A restore held to another implementation's on the same input and weights
# (phases `reference` and `release`): mean and max |diff|. The surrogate
# rounds DCT coefficients; a last-bit difference can move one coefficient by
# a quantisation step, so the max is looser than the mean.
RESTORE_MEAN_DIFF = 1e-4
RESTORE_MAX_DIFF = 2e-2
# The release phase: release weights (`--release NAME`, DEFAULT_RELEASE
# without it: `artifacts_release/NAME.npz`, the one npz that the copy of the
# tree sent to the card holds, `.chiprunignore`) and the JAX package's own
# f32 restores on them (`tests/torch_release/NAME_jax.npz`, written by
# `tests/_torch_release.py`); RELEASES gives each name's model preset. The
# bf16 restore's PSNR must be within RELEASE_PSNR_DB of the JAX f32
# restore's (or of the span from it to JAX's own bf16 restore's, where the
# fixture records that), and an f32 image that the fixture names a
# reference edge (JAX's own restore moves past RESTORE_MAX_DIFF for a 1e-6
# input move) within RELEASE_PSNR_DB of the JAX f32 image's; a restore
# must gain over its input wherever the JAX restore gained RELEASE_GAIN_DB
# or more in that case. The WebP release's CLI files: the fixture's two
# images as WebPs at RELEASE_CLI_QUALITIES, and a TILE_SIZE_HW natural image
# at q30 for tiles; the evaluator on RELEASE_EVAL_IMAGES natural images; the
# Gaussian-mixture restore on image 0 as a WebP at GM_QUALITY. The unified
# release's (`--model-codec all --codec auto`): UNIFIED_RESTORE_FILES for
# the restore CLI, UNIFIED_SERVE_FILES (both images in each codec, one codec
# a batch) for the server, the evaluator on JPEG.
RELEASES = {"webp_real_r5": "webp", "all_teacher_r3": "all"}
DEFAULT_RELEASE = "webp_real_r5"


def release_files(name: str) -> tuple[str, str]:
    """(npz, fixture) of release `name`, relative to the checkout."""
    return (os.path.join("artifacts_release", f"{name}.npz"),
            os.path.join("tests", "torch_release", f"{name}_jax.npz"))


RELEASE_NPZ, RELEASE_FIXTURE = release_files(DEFAULT_RELEASE)
RELEASE_PSNR_DB = 0.1
RELEASE_GAIN_DB = 0.3
RELEASE_CLI_QUALITIES = (10, 50)
RELEASE_TILE_QUALITY = 30
RELEASE_EVAL_IMAGES = 16
UNIFIED_RESTORE_FILES = (("jpeg", 0, 10), ("webp", 1, 50), ("avif", 0, 30))  # codec, image, q
UNIFIED_SERVE_FILES = {"jpeg": 10, "webp": 30, "avif": 50}
UNIFIED_FLAGS = ["--model-codec", "all", "--codec", "auto", "--quality", "auto"]
RELEASE_SCALE = 1  # widths divided by this (the CPU rehearsal's narrow model)
# The whole run takes 6-11 minutes on an H100; past this, fail rather than hang.
TIME_LIMIT_S = 900


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
    measured kernels twice, so none does.) While every session so far has
    recorded nothing, it takes more, up to 3 x `windows` (all 3 of a run's
    sessions once read 0 at one shape). Sessions that disagree are logged;
    0 means every session recorded nothing, and the callers fail on that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    readings = []
    while len(readings) < windows or (max(readings) == 0 and len(readings) < 3 * windows):
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


def products_s(products: int, bh: int, t: int, d: int, dtype_name: str) -> float:
    """Seconds for `products` T x T x D products (2 flops a multiply-add) at
    the peak of the tensor-core work the kernels do for the dtype: bf16 at
    the bf16 peak; f32 as the 3xTF32 split (three TF32 products for each f32
    one) at the TF32 peak."""
    flops = 2 * products * bh * t * t * d
    if dtype_name == "float32":
        return 3 * flops / PEAK_TF32_FLOPS_S
    return flops / PEAK_BF16_FLOPS_S


def attention_bound_ms(bh: int, t: int, d: int, dtype_name: str,
                       save_lse: bool = False) -> tuple[float, str]:
    """Least time for the work: q, k, v read once and o (and the f32 LSE)
    written once, over the memory rate; the two T x T x D products (S, P*V)
    at `products_s`'s peak."""
    elt = 2 if dtype_name == "bfloat16" else 4
    t_bytes = (4 * bh * t * d * elt + (4 * bh * t if save_lse else 0)) / PEAK_BYTES_S
    t_ops = products_s(2, bh, t, d, dtype_name)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


BWD_PRODUCTS = {"dq": 3, "dkv": 4}  # dQ: S, dP, dS*K; dK/dV: S^T, dP^T, dV, dK
FWD_PRODUCTS = 2


def fma_bound_ms(products: int, bh: int, t: int, d: int) -> float:
    """The operations bound of f32 products on FMA at the f32 peak outside
    the tensor cores: the bound of the FMA designs that the f32 kernels'
    TF32 ones replaced, logged beside their "was" times."""
    return 1e3 * 2 * products * bh * t * t * d / PEAK_FMA_F32_FLOPS_S


def sdpa_backends_ms(make_call) -> tuple[float, str, dict]:
    """SDPA's device time under each backend that takes f32 inputs
    (EFFICIENT_ATTENTION, MATH), each alone under
    torch.nn.attention.sdpa_kernel: (the faster's ms, its name, every
    backend's ms). `make_call()` is run under the backend and returns the
    call to time (for a backward, the graph is built there)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel([backend]):
            times[backend.name] = device_time_ms(make_call())
    best = min(times, key=times.get)
    return times[best], best, times


def bwd_bound_ms(kind: str, bh: int, t: int, d: int, dtype_name: str) -> tuple[float, str]:
    """Least time for one backward kernel's work. Bytes: dQ reads q, k, v,
    o, dO and the LSE and writes dQ and Delta; dK/dV reads q, k, v, dO, the
    LSE and Delta and writes dK and dV: 6 [BH,T,D] tensors and 2 [BH,T] f32
    rows either way. Operations: the T x T x D products (BWD_PRODUCTS) at
    `products_s`'s peak."""
    elt = 2 if dtype_name == "bfloat16" else 4
    t_bytes = (6 * bh * t * d * elt + 8 * bh * t) / PEAK_BYTES_S
    t_ops = products_s(BWD_PRODUCTS[kind], bh, t, d, dtype_name)
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
    for label, ignore in (("as it stands", None), ("as copied to the card", ".chiprunignore")):
        files = list(copy_files(ROOT, ignore))
        n_bytes = sum(b for _, b in files)
        log(f"the tree beside this script, {label}: {n_bytes} bytes "
            f"({n_bytes / 2 ** 20:.1f} MiB), {len(files)} files")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    log(f"SM clock (max, now): {clocks}")
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
    sass, spilled = {}, []
    for name, (path, seconds) in zip(names, built):
        log(f"built {path.name} with {build.find_nvcc()} in {seconds:.1f} s")
        log_file = path.with_suffix(".log")
        text = log_file.read_text() if log_file.exists() else ""
        for line in build.ptxas_summary(text):
            log(f"  ptxas: {line}")
            # the warp-specialised kernels (the bf16 forward, dQ and dK/dV
            # at D = 128 and 256, the f32 dK/dV) keep every accumulator in
            # registers: no spill
            if re.match(r"flash_(fwd|bwd_dq|bwd_dkv)_wgmma_kernel D=(128|256) bf16|"
                        r"flash_bwd_dkv_kernel D=\d+ f32", line) and \
                    "spills 0/0 B" not in line:
                spilled.append(line)
        for line in text.splitlines():  # e.g. wgmma serialized by ptxas
            if "wgmma" in line.lower() or "warning" in line.lower():
                log(f"  nvcc: {line.strip()}")
        for kernel, ops in sass_op_counts(path, build.find_nvcc()).items():
            sass[kernel] = ops
            log(f"  sass: {kernel}: " + ", ".join(f"{n} {op}" for op, n in ops.items()))
        build.load(name)
    if spilled:
        raise AssertionError(f"a warp-specialised kernel spills: {spilled}")
    if not sass:
        return
    # every instantiation of the bf16 forward, dQ and dK/dV wgmma kernels
    # (WGMMA_DESIGN_DIMS: 18, 6 of them dQ) and of the f32 forward, dQ and
    # dK/dV (TF32_DESIGN_DIMS) is built, runs HGMMA and loads by TMA
    # (UTMALDG), and no other wgmma kernel is built; no kernel runs HMMA
    # (mma.sync)
    want = [f"{kernel} D={d} bf16" for kernel, dims in WGMMA_DESIGN_DIMS.items() for d in dims]
    want += [f"{kernel} D={d} f32" for kernel, dims in TF32_DESIGN_DIMS.items() for d in dims]
    bad = [k for k in want if not (k in sass and sass[k]["HGMMA"] and sass[k]["UTMALDG"])]
    bad += [k for k in sass if "_wgmma_kernel" in k and k not in want]
    bad += [k for k, ops in sass.items() if ops["HMMA"]]
    if bad:
        raise AssertionError(f"wgmma kernels missing, unexpected or without HGMMA/UTMALDG, or "
                             f"kernels with HMMA, in the SASS: {bad}")


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")


def sass_op_counts(path, nvcc: str) -> dict:
    """Tensor-core (HGMMA: wgmma; HMMA: mma.sync) and TMA-load (UTMALDG)
    instructions per kernel in the library's SASS, from `cuobjdump -sass`
    beside nvcc; {} (logged) where it cannot be run."""
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
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def phase_kernels(state: dict) -> None:
    import torch
    import torch.nn.functional as F

    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    failures = []
    f32_path = {s[1:4] for s in F32_FWD_PATH_SHAPES}
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
            backend = "default"
            if dtype == torch.float32 and (bh, t, d) in f32_path:
                # the library time of an f32 path shape: the faster backend
                default_ms = lib_ms
                lib_ms, backend, each = sdpa_backends_ms(lambda: sdpa)
                log(f"sdpa (BH,T,D)=({bh},{t},{d}) f32 by backend: "
                    + ", ".join(f"{b} {ms:.4f} ms" for b, ms in each.items())
                    + f"; the default dispatch {default_ms:.4f} ms; taking {backend}")
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
                    library_ms=lib_ms, library=f"sdpa ({backend})", bound_ms=bound,
                    bound_by=by)
                log(f"flash_attention_fwd (BH,T,D)=({bh},{t},{d}) {name} lse={save_lse}: "
                    f"max|err| {err:.3g} ({share:.3g} of its bound)  "
                    f"kernel {ms:.4f} ms device ({event_ms:.4f} ms between events)  "
                    f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms device  "
                    f"bound {bound:.4f} ms ({by})")
    state["kernel_rows"] = rows
    for path, bh, t, d, lse in FWD_PATH_SHAPES:
        r = rows[(bh, t, d, "bfloat16", lse)]
        log(f"flash_attention_fwd [{path}] (BH,T,D)=({bh},{t},{d}) bf16 lse={lse}: "
            + ratio_note(r["ms"], r["library_ms"],
                         *earlier_design(MMA_SYNC_FWD_MS, WIDE_FWD_BEFORE_MS, (bh, t, d, lse))))
    for path, bh, t, d, lse in F32_FWD_PATH_SHAPES:
        r = rows[(bh, t, d, "float32", lse)]
        log(f"flash_attention_fwd [{path}] (BH,T,D)=({bh},{t},{d}) f32 lse={lse}: kernel "
            f"{r['ms']:.4f} ms, " + ratio_note(r["ms"], r["library_ms"],
                                               FMA_F32_FWD_MS.get((bh, t, d)), "FMA kernel")
            + f" against {r['library']}; bound {r['bound_ms']:.4f} ms (3xTF32 at 495 TFLOP/s, "
            f"{r['bound_by']}), FMA bound {fma_bound_ms(FWD_PRODUCTS, bh, t, d):.4f} ms "
            f"(f32 at 67)")
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
            backend = "default"
            if dtype == torch.float32 and (bh, t, d) in F32_TRAIN_SHAPES:
                def backward_under_backend():
                    out = F.scaled_dot_product_attention(q4, k4, v4)
                    return lambda: torch.autograd.grad(out, (q4, k4, v4), do[None],
                                                       retain_graph=True)

                default_ms = lib_ms
                lib_ms, backend, each = sdpa_backends_ms(backward_under_backend)
                log(f"sdpa backward (BH,T,D)=({bh},{t},{d}) f32 by backend: "
                    + ", ".join(f"{b} {ms:.4f} ms" for b, ms in each.items())
                    + f"; the default dispatch {default_ms:.4f} ms; taking {backend}")
            role = "train step" if (bh, t, d) in TRAIN_SHAPES else "contract"
            for kind in ("dq", "dkv"):
                err, (ms, event_ms, plain_ms) = errs[kind], times[kind]
                bound, by = bwd_bound_ms(kind, bh, t, d, name)
                rows[(kind, bh, t, d, name)] = dict(max_abs_err=err, ms=ms, event_ms=event_ms,
                                                    plain_ms=plain_ms, library_ms=lib_ms,
                                                    library=f"sdpa backward ({backend})",
                                                    bound_ms=bound, bound_by=by)
                log(f"flash_attention_bwd_{kind} (BH,T,D)=({bh},{t},{d}) {name} [{role}]: "
                    f"max|err| {err:.3g}  kernel {ms:.4f} ms device ({event_ms:.4f} ms between "
                    f"events)  plain {plain_ms:.4f} ms  "
                    f"sdpa backward {lib_ms:.4f} ms device ({lib_event_ms:.4f} ms between "
                    f"events)  bound {bound:.4f} ms ({by})")
            if name == "float32" and (bh, t, d) in F32_TRAIN_SHAPES:
                path = F32_TRAIN_SHAPES[(bh, t, d)]
                dkv_ms, dq_ms = times["dkv"][0], times["dq"][0]
                was = FMA_F32_DQ_MS.get((bh, t, d))
                log(f"flash_attention_bwd_dq [{path}] (BH,T,D)=({bh},{t},{d}) f32: kernel "
                    f"{dq_ms:.4f} ms (FMA kernel: {was[0] if was else 'not recorded'}), "
                    + ratio_note(dq_ms, lib_ms, was, "FMA kernel")
                    + f" against sdpa backward ({backend}); pair dQ + dK/dV "
                    f"{dq_ms + dkv_ms:.4f} ms, pair/SDPA "
                    f"{(dq_ms + dkv_ms) / lib_ms if lib_ms > 0 else float('nan'):.3f}; bound "
                    f"{rows[('dq', bh, t, d, name)]['bound_ms']:.4f} ms (3xTF32 at 495 "
                    f"TFLOP/s, {rows[('dq', bh, t, d, name)]['bound_by']}), FMA bound "
                    f"{fma_bound_ms(BWD_PRODUCTS['dq'], bh, t, d):.4f} ms (f32 at 67)")
                was = FMA_F32_DKV_MS.get((bh, t, d))
                log(f"flash_attention_bwd_dkv [{path}] (BH,T,D)=({bh},{t},{d}) f32: kernel "
                    f"{dkv_ms:.4f} ms (FMA kernel: {was[0] if was else 'not recorded'}), "
                    + ratio_note(dkv_ms, lib_ms, was, "FMA kernel")
                    + f" against sdpa backward ({backend}); bound "
                    f"{rows[('dkv', bh, t, d, name)]['bound_ms']:.4f} ms (3xTF32 at 495 "
                    f"TFLOP/s, {rows[('dkv', bh, t, d, name)]['bound_by']}), FMA bound "
                    f"{fma_bound_ms(BWD_PRODUCTS['dkv'], bh, t, d):.4f} ms (f32 at 67)")
            if name == "bfloat16" and (bh, t, d) in TRAIN_SHAPES:
                path = TRAIN_PATHS.get((bh, t, d), "train step")
                dkv_ms, dq_ms = times["dkv"][0], times["dq"][0]
                log(f"flash_attention_bwd_dkv [{path}] (BH,T,D)=({bh},{t},{d}) bf16: "
                    + ratio_note(dkv_ms, lib_ms,
                                 *earlier_design(MMA_SYNC_DKV_MS, WIDE_DKV_BEFORE_MS, (bh, t, d))))
                was, design = earlier_design(MMA_SYNC_DQ_MS, WIDE_DQ_BEFORE_MS, (bh, t, d))
                pair_was = f"{(was[0] + was[2]) / was[1]:.3f}" if was else "not recorded"
                pair_label = ("the earlier pair" if design.startswith("earlier")
                              else "with the mma.sync dQ")
                log(f"flash_attention_bwd_dq [{path}] (BH,T,D)=({bh},{t},{d}) bf16: "
                    + ratio_note(dq_ms, lib_ms, was, design)
                    + f"; pair dQ + dK/dV {dq_ms + dkv_ms:.4f} ms, pair/SDPA "
                    f"{(dq_ms + dkv_ms) / lib_ms if lib_ms > 0 else float('nan'):.3f} "
                    f"({pair_label}: {pair_was})")
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


# Phase `path1024`: the WebP preset's full-width UNet at --image-size 1024
# with flash attention at <= 32², where only the bottleneck attends (1024,
# 1024 and 512 channels over 4 heads at 32² = 1024 tokens: D = 256, 256 and
# 128); seeded random weights, batch 1. The restore CLI at q30 under the
# production budget (RESTORE_FLAGS), then one train step with block remat.
PATH1024_SIZE = 1024
PATH1024_QUALITY = 30
PATH1024_SCALE = 1  # widths divided by this (the CPU rehearsal's narrow model)
PATH1024_F32_MAX_DIFF = 1e-3
PATH1024_GATE_STEPS = 2  # steps a run of the remat train step's gates


def flash_head_dims(model, size: int) -> tuple:
    """From the model's structure: the head dims of its attention blocks
    that take the flash kernel on size² images (flash impl, and at least
    the kernel's threshold of tokens at the block's level), as (encode,
    decode) lists; `encode` holds the encoder's and the bottleneck's."""
    from ddpm_image_restoration_tpu_torch.ops.attention import MIN_TOKENS_FOR_KERNEL

    n_enc = len(model.cfg.enc_widths) + len(model.cfg.bottleneck_widths)
    dims = ([], [])
    for i, (level, block) in enumerate(model._blocks()):
        attn = block.attn
        if (attn is not None and attn.impl == "flash"
                and (size >> level) ** 2 >= MIN_TOKENS_FOR_KERNEL):
            dims[i >= n_enc].append(attn.qkv.in_features // attn.num_heads)
    return dims


@contextlib.contextmanager
def launches_by_head_dim(key=lambda name, bh, t, d_kernel, dtype: (name, d_kernel)):
    """Records each kernel launch as key(wrapper name, BH, T, head dim the
    kernel ran at, dtype), by default (wrapper name, head dim), from the one
    helper every wrapper launches through (`ops.flash_attention._launch`);
    the wrappers' counts are untouched."""
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    real, seen = fa._launch, []

    def recording(name, pointers, bh, t, d_kernel, dtype, d, device):
        real(name, pointers, bh, t, d_kernel, dtype, d, device)
        seen.append(key(name, bh, t, d_kernel, dtype))

    fa._launch = recording
    try:
        yield seen
    finally:
        fa._launch = real


def phase_path1024(state: dict) -> None:
    """The 1024² path at full width (`PATH1024_SIZE`), each run counted from
    0, its launches per kernel and head dim against what the model's
    structure predicts (`flash_head_dims`):
      * `cli/restore.py` on a 1024² WebP at q30 under the production policy
        (DDRMSampler, surrogate steps, final_exact): the forward once per
        bottleneck block per encode, so 3g launches for g encoder groups,
        2g of them at D = 256;
      * the train step (`train/steps.py make_train_step`, bf16, block remat,
        dropout, EMA) three times: its first call (eager), its capture and
        a replay, each with its peak device memory (a replay allocates
        nothing; the capture counts the graph's pool), and each per
        attention block the forward with the LSE twice
        (the recompute), dQ and dK/dV once, at (4, 1024, 256) for two
        blocks; the loss and every gradient finite. The replay runs under
        the profiler, and its kernels are counted in the device's trace by
        name and template head dim (`flash_traced`): a replay runs no
        Python, so nothing else sees its launches. One eager step is
        profiled too, its device count held to the same prediction. Then
        its gates
        (`graph_gates`, PATH1024_GATE_STEPS steps a run): the graph in
        torch's default setting, and one captured under deterministic
        algorithms, against eager;
      * one UNet evaluation with flash attention against the same weights
        with the plain attention, both bf16 (a whole restore is chaotic on
        random weights: ROADMAP "Random-weight restores"), within the plain
        model's own bf16 error against its f32 evaluation, mean and max;
      * the same restore and train step (and its gates) with
        `--compute-dtype float32` (the f32 forward and dQ at D = 256 and
        128, counted as above), and one
        f32 evaluation flash against plain under `no_tf32`, max |diff| <=
        PATH1024_F32_MAX_DIFF (the bound of tests/test_torch_kernels_cuda.py
        on the full-width f32 flash route against the plain route)."""
    import collections
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from ddpm_image_restoration_tpu_torch.cli.common import load_image
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    size, q = PATH1024_SIZE, PATH1024_QUALITY
    work = os.path.join(ROOT, "build", "chip_smoke_path1024")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    failures, totals = [], dict.fromkeys(_counts(), 0)
    cfg = ModelConfig(image_size=size, attention_impl="flash", attn_max_resolution=32)
    narrow = ["--width-scale", str(PATH1024_SCALE)] if PATH1024_SCALE > 1 else []
    if narrow:
        cfg = cfg.scaled(PATH1024_SCALE)
    torch.manual_seed(SEED)
    model = build_model("webp", cfg, device=CARD).eval()
    enc, dec = flash_head_dims(model, size)
    log(f"1024² path: flash attention head dims per encode {enc}, per decode {dec}")
    if not narrow and sorted(enc + dec) != [128, 256, 256]:
        failures.append(f"the 1024² model's flash blocks have head dims {enc + dec}, "
                        f"not the bottleneck's 256, 256 and 128")

    def check(label, seen, want, wall, on_device=False):
        """`seen`, the launches by (kernel, head dim), against `want`: the
        calls that reached `_launch`, or with `on_device` the kernels in
        the device's trace (a replay runs no Python). They go into the
        totals; the wrappers' counts (for a replay, what its capture
        counted, added again) must agree with them."""
        got, counts = collections.Counter(seen), _counts()
        by_kernel = {n: sum(v for (k, _), v in got.items() if k == n) for n in counts}
        for k, v in by_kernel.items():
            totals[k] += v
        source = "in the device's trace" if on_device else "launched"
        log(f"{label}: {wall:.2f} s on {state['smi']}; kernels {source} by (kernel, head dim) "
            f"{dict(sorted(got.items()))}, the structure predicts {dict(sorted(want.items()))}; "
            f"wrapper counts {counts}")
        if got != want or by_kernel != counts:
            failures.append(f"{label}: launches {dict(got)} (wrappers {counts}), the "
                            f"structure predicts {dict(want)}")

    try:
        x = synthetic_images(1, size, SEED + 3)[0]
        src = os.path.join(work, "in.webp")
        Image.fromarray(np.round((x * 0.5 + 0.5) * 255).astype(np.uint8)).save(src, quality=q)

        # the restore CLI: encoder blocks once per group, decoder blocks per
        # evaluation; bf16, then f32
        def at(name, d, dtype):  # (kernel, the head dim it runs at in `dtype`)
            return name, fa.kernel_head_dim(name, d, getattr(torch, dtype))

        n, g = static_schedule(q, "webp", *restore_budget())
        for dtype in ("bfloat16", "float32"):
            want = collections.Counter()
            for d in enc:
                want[at(fa.KERNEL, d, dtype)] += g
            for d in dec:
                want[at(fa.KERNEL, d, dtype)] += n
            out_dir = os.path.join(work, f"out_{dtype}")
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with launches_by_head_dim() as seen, \
                    contextlib.redirect_stdout(io.StringIO()) as printed:
                restore_main([src, *RESTORE_FLAGS, *narrow, "--image-size", str(size),
                              "--random-init", "--quality", str(q), "--codec", "webp",
                              "--compute-dtype", dtype, "--output-dir", out_dir])
            torch.cuda.synchronize()
            check(f"restore 1024² {dtype} (n {n}, g {g}; {printed.getvalue().splitlines()[0]})",
                  seen, want, time.perf_counter() - t0)
            png = os.path.join(out_dir, "in_restored.png")
            shape = np.asarray(Image.open(png)).shape if os.path.exists(png) else None
            if shape != (size, size, 3):
                failures.append(f"restore 1024² {dtype} wrote {png} of shape {shape}")

        # one train step with block remat: each block's forward again in the
        # backward; bf16, then f32
        xt = torch.from_numpy(load_image(src, None)[None]).to(CARD)
        batch = {"x0": torch.from_numpy(x[None]).to(CARD), "xt": xt,
                 "t": torch.tensor([50], device=CARD), "quality": torch.tensor([q], device=CARD)}
        for dtype in ("bfloat16", "float32"):
            want = collections.Counter()
            for d in enc + dec:
                want[at(fa.KERNEL, d, dtype)] += 2
                want[at("flash_attention_bwd_dq", d, dtype)] += 1
                want[at("flash_attention_bwd_dkv", d, dtype)] += 1
            tcfg = TrainConfig(codec="webp", model=dataclasses.replace(
                cfg, remat=True, compute_dtype=dtype), batch_size=1, ema_decay=0.999)
            torch.manual_seed(SEED)
            train_model = build_model("webp", tcfg.model, device=CARD)
            train_state = create_train_state(train_model, tcfg)
            step = make_train_step(train_model, tcfg)
            gen = torch.Generator(device=CARD).manual_seed(SEED)
            card = train_model.out_conv.weight.device.type == "cuda"
            t_dtype = time.perf_counter()
            for call in ("eager", "capture", "replay"):
                torch.cuda.synchronize()
                if card:
                    torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                t0 = time.perf_counter()
                on_device = call == "replay" and card
                if on_device:  # a replay runs no Python: the device's trace counts its kernels
                    out = []
                    seen, sessions = flash_traced(
                        f"one 1024² train step ({dtype}, remat), graph replayed",
                        lambda: out.append(step(train_state, batch, gen)), want)
                    metrics = out[-1]
                else:
                    with launches_by_head_dim() as seen:
                        metrics = step(train_state, batch, gen)
                        torch.cuda.synchronize()
                peak = _gib(torch.cuda.max_memory_allocated()) if card else "-"
                check(f"train step 1024² ({dtype}, remat, dropout {tcfg.model.dropout}, {call}"
                      f"{', under the profiler' if on_device else ''}; loss "
                      f"{metrics['loss'].item():.4f}, grad norm "
                      f"{metrics['grad_norm'].item():.4g}; peak device memory {peak})", seen,
                      want, time.perf_counter() - t0, on_device)
            graphs = list(step.cache.graphs.values())
            if card and (len(graphs) != 1 or graphs[0].replays != 1 + sessions):
                failures.append(f"train step 1024² {dtype}: {len(graphs)} graphs, replays "
                                f"{[g.replays for g in graphs]}")
            eager_flash, _ = flash_traced(f"one 1024² train step ({dtype}, remat), eager",
                                          lambda: step.eager(train_state, batch, gen), want)
            if card and eager_flash != want:
                failures.append(f"train step 1024² {dtype}, eager: kernels in the device's "
                                f"trace {dict(eager_flash)}, the structure predicts {dict(want)}")
            bad = [k for k, p in train_model.named_parameters()
                   if p.grad is None or not torch.isfinite(p.grad).all()]
            qkv = [getattr(train_model, f"bottleneck{i}").attn.qkv.weight.grad.abs().max().item()
                   for i in (1, 2, 3)]
            log(f"  |bottleneck qkv grad| max {qkv}; parameters without a finite gradient: {bad}")
            if bad or not all(v > 0 for v in qkv) or not all(
                    math.isfinite(metrics[k].item()) for k in ("loss", "grad_norm")):
                failures.append(f"train step 1024² {dtype}: loss {metrics['loss'].item()}, grad "
                                f"norm {metrics['grad_norm'].item()}, non-finite or missing "
                                f"gradients {bad[:5]}, bottleneck qkv grads {qkv}")
            runner = StepRuns(train_state, batch, gen, PATH1024_GATE_STEPS)
            failures += graph_gates(f"train step 1024² {dtype}, remat", runner,
                                    lambda: make_train_step(train_model, tcfg), step)
            log(f"  (train step 1024² {dtype}: {time.perf_counter() - t_dtype:.1f} s with its "
                "gates)")
            del train_state, train_model, step, metrics, runner, graphs
            torch.cuda.empty_cache()

        # one evaluation: flash against plain attention on the same weights (bf16), and
        # the plain model's own bf16 error against f32 as the yardstick
        weights = model.state_dict()
        plain = build_model("webp", dataclasses.replace(cfg, attention_impl="xla"),
                            device=CARD).eval()
        plain.load_state_dict(weights)
        exact = build_model("webp", dataclasses.replace(cfg, attention_impl="xla",
                                                        compute_dtype="float32"),
                            device=CARD).eval()
        exact.load_state_dict(weights)
        t = torch.tensor([0.5], device=CARD)
        want = collections.Counter()
        for d in enc + dec:
            want[(fa.KERNEL, d)] += 1
        with torch.no_grad(), no_tf32():
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with launches_by_head_dim() as seen:
                out = model(xt, t).float()
                torch.cuda.synchronize()
            check("UNet evaluation 1024² (bf16, flash)", seen, want, time.perf_counter() - t0)
            ref = plain(xt, t).float()
            ref32 = exact(xt, t).float()
        err, floor = (out - ref).abs(), (ref - ref32).abs()
        log(f"  flash against plain attention: max|diff| {err.max().item():.4g}, mean "
            f"{err.mean().item():.4g}; plain bf16 against f32: max {floor.max().item():.4g}, "
            f"mean {floor.mean().item():.4g}; max|out| {ref.abs().max().item():.4g}")
        if not (torch.isfinite(out).all() and err.mean() <= floor.mean()
                and err.max() <= floor.max()):
            failures.append(f"UNet 1024²: flash against plain attention max {err.max().item()}"
                            f", mean {err.mean().item()}, beyond the bf16 model's own error "
                            f"(max {floor.max().item()}, mean {floor.mean().item()})")
        # the f32 evaluation: flash against the plain f32 model (`exact`)
        del model, plain
        flash32 = build_model("webp", dataclasses.replace(cfg, compute_dtype="float32"),
                              device=CARD).eval()
        flash32.load_state_dict(weights)
        want = collections.Counter(at(fa.KERNEL, d, "float32") for d in enc + dec)
        with torch.no_grad(), no_tf32():
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with launches_by_head_dim() as seen:
                out32 = flash32(xt, t).float()
                torch.cuda.synchronize()
            check("UNet evaluation 1024² (f32, flash)", seen, want, time.perf_counter() - t0)
        err32 = (out32 - ref32).abs()
        log(f"  f32 flash against plain attention (no TF32): max|diff| {err32.max().item():.4g}"
            f", mean {err32.mean().item():.4g}, max|out| {ref32.abs().max().item():.4g} (bound "
            f"max|diff| <= {PATH1024_F32_MAX_DIFF})")
        if not (torch.isfinite(out32).all() and err32.max() <= PATH1024_F32_MAX_DIFF):
            failures.append(f"UNet 1024² f32: flash against plain attention max "
                            f"{err32.max().item()} > {PATH1024_F32_MAX_DIFF}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _reset_counts()
    state["launches_path1024"] = totals
    if failures:
        raise AssertionError("; ".join(failures))


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
        if not (launched > 0 and (want is None or launched == want)
                and np.isfinite(out_gpu.numpy()).all()
                and diff.mean().item() <= RESTORE_MEAN_DIFF
                and diff.max().item() <= RESTORE_MAX_DIFF):
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


def file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def copy_files(root: str, ignore_file: str | None = ".chiprunignore"):
    """(path relative to `root`, bytes) of each file that the copy of
    `root` sent to the card holds: all but `.git/`, `chiprun_out/` and what
    `ignore_file` lists (None: nothing more). A pattern with an inner or
    leading slash matches the path from the root, one without a name at any
    depth (gitignore's rule; the copy was seen to drop such names at the
    root), '#' starts a comment, and a pattern ending in '/' matches
    nothing: the copy kept `results/` for the pattern `results/` (and was
    then refused as over 256 MiB) and left it out for `results`."""
    import fnmatch

    patterns = []
    if ignore_file and os.path.exists(os.path.join(root, ignore_file)):
        with open(os.path.join(root, ignore_file)) as f:
            patterns = [p.strip() for p in f if p.strip() and not p.startswith("#")]

    def ignored(rel: str) -> bool:
        for p in patterns:
            if p.endswith("/"):
                continue
            if fnmatch.fnmatch(rel, p.lstrip("/")) if "/" in p else \
                    fnmatch.fnmatch(os.path.basename(rel), p):
                return True
        return False

    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        rel_dir = "" if rel_dir == "." else rel_dir
        dirnames[:] = [d for d in dirnames
                       if os.path.join(rel_dir, d) not in (".git", "chiprun_out")
                       and not ignored(os.path.join(rel_dir, d))]
        for name in filenames:
            rel = os.path.join(rel_dir, name)
            if not ignored(rel):
                yield rel, os.lstat(os.path.join(dirpath, name)).st_size


def release_name(state: dict) -> str:
    """The release this run restores with (`--release`, else the default)."""
    return state.get("release", DEFAULT_RELEASE)


def release_refusal(name: str, root: str) -> str | None:
    """Why `--release name`, given explicitly, cannot run from the copy at
    `root` (None when it can): its npz or its fixture is absent, or another
    release npz lies beside it (a copy for the card holds one npz: two pass
    its 256 MiB). No phase then falls back to other weights."""
    for path in release_files(name):
        if not os.path.exists(os.path.join(root, path)):
            return f"{path} is not in this copy: --release {name} runs on those weights only"
    folder = os.path.join(root, "artifacts_release")
    others = sorted(f for f in os.listdir(folder) if f.endswith(".npz") and f != f"{name}.npz")
    if others:
        return (f"this copy holds {', '.join(others)} beside {name}.npz: a copy for the card "
                f"holds one release npz")
    return None


def parse_args(argv: list) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Runs the port on one CUDA card, phase by phase.")
    ap.add_argument("--release", choices=sorted(RELEASES), default=None,
                    help=f"the release weights of phases release and serve (default "
                         f"{DEFAULT_RELEASE}); given explicitly, the copy must hold that npz "
                         f"and its fixture and no other release npz")
    return ap.parse_args(argv)


def load_release(state: dict) -> dict:
    """The release npz and the JAX package's restores on it (the fixture),
    both read from the checkout: the state dict, strict against the full
    model's parameters, in state["release_params"], the fixture in
    state["release_fixture"]. Raises if either file is absent or the npz's
    sha256 is not the fixture's."""
    import numpy as np

    from ddpm_image_restoration_tpu_torch.train.checkpoint import load_release_params

    npz_rel, fixture_rel = release_files(release_name(state))
    npz, fixture_path = (os.path.join(ROOT, p) for p in (npz_rel, fixture_rel))
    for path in (npz, fixture_path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} is not in this copy: phases release and serve run "
                                    f"on the release weights only")
    with np.load(fixture_path) as data:
        fixture = {k: data[k] for k in data.files}
    t0 = time.perf_counter()
    params = load_release_params(npz)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sha = file_sha256(npz)
    log(f"weights: {npz_rel}, {os.path.getsize(npz)} bytes, {len(params)} tensors, loaded in "
        f"{load_s:.2f} s; sha256 {sha} ({time.perf_counter() - t0:.2f} s); the fixture's "
        f"{fixture['weights_sha256']} (JAX {fixture['jax_version']})")
    if sha != str(fixture["weights_sha256"]):
        raise AssertionError(f"{npz_rel} is not the file the fixture was made from")
    state["release_params"], state["release_fixture"] = params, fixture
    return params


def release_model(state: dict, compute_dtype: str, device: str):
    """The release's model (its preset, widths / RELEASE_SCALE, flash at
    <= 32²) in `compute_dtype` on `device`, holding state["release_params"]
    (strict)."""
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    cfg = ModelConfig(compute_dtype=compute_dtype, attention_impl="flash",
                      attn_max_resolution=32).scaled(RELEASE_SCALE)
    model = build_model(RELEASES[release_name(state)], cfg, device=device)
    model.load_state_dict(state["release_params"], strict=True)
    return model


def fixture_tag(fixture: dict, codec: str, q) -> str:
    """The key suffix of the (codec, quality) case in a release fixture: the
    quality in a one-codec fixture, "<codec>_<quality>" where it lists
    `codecs` (tests/_torch_release.py)."""
    return f"{codec}_{int(q)}" if "codecs" in fixture else str(int(q))


def fixture_cases(fixture: dict) -> list:
    """[(codec, quality, tag)] of the fixture's restores, in its order."""
    codecs = fixture["codecs"] if "codecs" in fixture else ["webp"] * len(fixture["qualities"])
    return [(str(c), int(q), fixture_tag(fixture, str(c), q))
            for c, q in zip(codecs, fixture["qualities"])]


def fixture_gain(fixture: dict, tag) -> float:
    """The JAX restore's PSNR gain over its input in case `tag`, dB."""
    return float(fixture[f"psnr_restored_{tag}"]) - float(fixture[f"psnr_y_{tag}"])


def release_compare(q, got, want, launched: int, n: int, g: int, codec: str = "",
                    by_psnr=()) -> tuple[str, list]:
    """(log line, failures) of an f32 restore `got` at quality q (of
    `codec`, named in the line when given) held to the JAX package's `want`:
    the RESTORE_*_DIFF bounds over every image but those in `by_psnr`
    (reference edges, which the caller holds by PSNR), every value finite,
    and n + g forward launches."""
    import numpy as np

    keep = [i for i in range(len(want)) if i not in by_psnr]
    diff = np.abs(np.asarray(got, np.float64)[keep] - np.asarray(want, np.float64)[keep])
    case = f"{codec} q{q}" if codec else f"q{q}"
    line = (f"{case}: f32 restore against the JAX package's: mean|diff| {diff.mean():.3g} "
            f"(bound {RESTORE_MEAN_DIFF:g}), max|diff| {diff.max():.3g} "
            f"(bound {RESTORE_MAX_DIFF:g})"
            + (f" over images {keep} (images {list(by_psnr)} by PSNR)" if by_psnr else "")
            + f"; {launched} forward launches, schedule implies {n} + {g}")
    failures = []
    if not (np.isfinite(got).all() and diff.mean() <= RESTORE_MEAN_DIFF
            and diff.max() <= RESTORE_MAX_DIFF):
        failures.append(f"{case}: the f32 restore disagrees with the JAX package's (mean "
                        f"{diff.mean():.3g}, max {diff.max():.3g}, finite "
                        f"{bool(np.isfinite(got).all())})")
    if launched != n + g:
        failures.append(f"{case}: {launched} forward launches, schedule implies {n + g}")
    return line, failures


SOLVER_MODES = ("eager", "graph")  # a signature's first call, then its captured loop


def release_restores(model, fixture: dict, device: str, totals: dict,
                     modes: tuple = ("eager",)) -> tuple[dict, list]:
    """Each fixture input restored by `model` through `sample_batch` (the
    production policy of its codec at its quality, final_exact=False), f32
    convolutions in full f32, once per mode in `modes`: the signature's
    first call runs the solver eager, a second call ("graph", SOLVER_MODES
    on the card) captures the solver loop as a CUDA graph and replays it.
    Each restore is held alike: an f32 model's to the fixture's restore
    (`release_compare`), an image the fixture names a reference edge by its
    PSNR within RELEASE_PSNR_DB of the JAX restore's; a bf16 model's PSNR
    by `release_psnr_failures`; its forward launches, counted from 0 per
    restore into `totals`, to the schedule's n + g. A graph's restore is
    also compared with the eager one: bit for bit, or its max|diff| logged
    (the fixture's bounds stay the gate). Returns ({tag: the last mode's
    restore's PSNR against x0, dB}, failures)."""
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.serve import sample_batch
    from ddpm_image_restoration_tpu_torch.evaluation.metrics import psnr
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    f32 = model.cfg.compute_dtype == "float32"
    x0 = torch.tensor(fixture["x0"])
    edges = {str(e) for e in fixture.get("reference_edges", [])}
    named = "codecs" in fixture
    psnrs, failures = {}, []
    for codec, q, tag in fixture_cases(fixture):
        case = f"{codec} q{q}" if named else f"q{q}"
        y = torch.tensor(fixture[f"y_{tag}"], device=device)
        n, g = static_schedule(q, codec)
        if n != int(fixture[f"evals_{tag}"]):
            failures.append(f"{case}: {n} evaluations, the JAX package ran "
                            f"{int(fixture[f'evals_{tag}'])}")
        outs = {}
        for mode in modes:
            how = f" [{mode}]" if len(modes) > 1 else ""
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with no_tf32():
                out = outs[mode] = sample_batch(model, y, q, codec, final_exact=False).cpu()
            wall = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] += v
            psnrs[tag] = psnr(out, x0).item()
            bf16_ref = (f", its bf16 restore {float(fixture[f'psnr_restored_bf16_{tag}']):.4f}"
                        if f"psnr_restored_bf16_{tag}" in fixture else "")
            log(f"{case}{how} {model.cfg.compute_dtype}: {y.shape[0]} images in "
                f"{1e3 * wall:.1f} ms; PSNR {psnrs[tag]:.4f} dB (input "
                f"{float(fixture[f'psnr_y_{tag}']):.4f}, the JAX f32 restore "
                f"{float(fixture[f'psnr_restored_{tag}']):.4f}{bf16_ref}); launches {counts}")
            if counts["flash_attention_bwd_dq"] or counts["flash_attention_bwd_dkv"]:
                failures.append(f"{case}{how}: backward launches {counts}")
            if not f32:
                failures += release_psnr_failures(f"bf16 restore{how}", fixture, tag,
                                                  psnrs[tag], float(fixture[f"psnr_y_{tag}"]),
                                                  near_db=RELEASE_PSNR_DB)
                if counts[fa.KERNEL] != n + g:
                    failures.append(f"{case}{how} {model.cfg.compute_dtype}: "
                                    f"{counts[fa.KERNEL]} forward launches, schedule implies "
                                    f"{n + g}")
                continue
            want = fixture[f"restored_{tag}"]
            held = [i for i in range(len(want)) if f"{tag}/{i}" in edges]
            line, bad = release_compare(q, out.numpy(), want, counts[fa.KERNEL], n, g,
                                        codec if named else "", held)
            log(line + how)
            failures += [b + how for b in bad]
            for i in held:
                got_db = psnr(out[i:i + 1], x0[i:i + 1]).item()
                ref_db = psnr(torch.tensor(want[i:i + 1]), x0[i:i + 1]).item()
                log(f"{case} image {i}: a reference edge (the JAX package's own restore moves "
                    f"{float(fixture[f'self_move_{tag}'][i]):.3g} for a 1e-6 input move, past "
                    f"{RESTORE_MAX_DIFF:g}): held by PSNR, {got_db:.4f} dB against the JAX "
                    f"restore's {ref_db:.4f} (within {RELEASE_PSNR_DB}); its max|diff| "
                    f"{float(np.abs(out[i].numpy() - want[i]).max()):.3g}{how}")
                if not abs(got_db - ref_db) <= RELEASE_PSNR_DB:
                    failures.append(f"{case} image {i}{how}: PSNR {got_db:.4f} dB, the JAX "
                                    f"restore's {ref_db:.4f}: more than {RELEASE_PSNR_DB} dB "
                                    f"apart")
        if "graph" in outs:
            same = torch.equal(outs["graph"], outs["eager"])
            log(f"{case} {model.cfg.compute_dtype}: the graph's restore against the eager one: "
                + ("bit for bit" if same else "NOT bit for bit, max|diff| "
                   f"{(outs['graph'] - outs['eager']).abs().max().item():.3g} (held to the "
                   f"fixture's bounds)"))
    return psnrs, failures


def release_psnr_failures(label: str, fixture: dict, tag, got_db: float, input_db: float,
                          near_db: float | None = None) -> list:
    """The release PSNR rules for one restore in the fixture's case `tag`:
    its gain over its input positive wherever the fixture's is
    RELEASE_GAIN_DB or more; with `near_db` (a bf16 restore), its PSNR
    within that of the JAX package's own restores: its f32 one, or, where
    the fixture records its bf16 one too, the span between the two (JAX's
    own bf16 restore of the unified release lies up to 0.23 dB from its
    f32 one)."""
    failures = []
    want_gain = fixture_gain(fixture, tag) >= RELEASE_GAIN_DB
    if want_gain and not got_db > input_db:
        failures.append(f"{label} [{tag}]: PSNR {got_db:.4f} dB does not exceed the input's "
                        f"{input_db:.4f} (the JAX restore gained {fixture_gain(fixture, tag):.4f})")
    refs = [float(fixture[f"psnr_restored_{tag}"])]
    if f"psnr_restored_bf16_{tag}" in fixture:
        refs.append(float(fixture[f"psnr_restored_bf16_{tag}"]))
    if near_db is not None and not min(refs) - near_db <= got_db <= max(refs) + near_db:
        failures.append(f"{label} [{tag}]: PSNR {got_db:.4f} dB, the JAX restores' "
                        f"{' and '.join(f'{r:.4f}' for r in refs)} (f32, bf16): more than "
                        f"{near_db} dB apart")
    return failures


def psnr_u8(a, b) -> float:
    """PSNR of two 8-bit images, dB."""
    import numpy as np

    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def write_release_file(folder: str, name: str, x, q: int) -> tuple:
    """The [-1, 1] image `x` written by Pillow at quality q into `folder`, in
    the format of `name`'s extension. Returns (path, the clean 8-bit
    image)."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    clean = np.round((np.asarray(x) * 0.5 + 0.5) * 255).astype(np.uint8)
    path = os.path.join(folder, name)
    Image.fromarray(clean).save(path, quality=q)
    return path, clean


def webp_release_runs(state: dict, work: str) -> list:
    """The README's card commands on the WebP release (`--params-npz`), as
    `run_release_clis` takes them: `cli/restore.py` with `--quality auto`
    on the fixture's images as 64² WebPs at RELEASE_CLI_QUALITIES and in
    tile mode on a TILE_SIZE_HW natural image, `cli/serve.py --once` on the
    64² ones (one batch of 8 at the bucket nearest their median quality),
    `cli/evaluate.py` on RELEASE_EVAL_IMAGES natural images at the
    fixture's qualities, and `cli/restore.py --solver gaussian_mixture` on
    image 0 as a WebP at GM_QUALITY (the README's command)."""
    import shutil

    import numpy as np

    from ddpm_image_restoration_tpu_torch.cli.evaluate import main as evaluate_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.cli.serve import _BUCKETS
    from ddpm_image_restoration_tpu_torch.cli.serve import main as serve_main
    from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality
    from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
    from ddpm_image_restoration_tpu_torch.utils.tiling import plan_tiles

    fixture = state["release_fixture"]
    npz = ["--params-npz", os.path.join(ROOT, release_files(release_name(state))[0])]
    inputs, watch = os.path.join(work, "in"), os.path.join(work, "watch")
    squares = [(*write_release_file(inputs, f"r{i}_q{q}.webp", fixture["x0"][i], q), str(q))
               for i, q in enumerate(RELEASE_CLI_QUALITIES)]
    th, tw = TILE_SIZE_HW
    wide_x = SyntheticImageDataset(1, tw, seed=int(fixture["seed"]) + 1, kind="natural")[0][:th]
    wide = (*write_release_file(inputs, f"wide_q{RELEASE_TILE_QUALITY}.webp", wide_x,
                                RELEASE_TILE_QUALITY), str(RELEASE_TILE_QUALITY))
    gm = (*write_release_file(os.path.join(work, "gm"), f"gm_q{GM_QUALITY}.webp",
                              fixture["x0"][0], GM_QUALITY), str(GM_QUALITY))
    os.makedirs(watch)
    for path, _, _ in squares:
        shutil.copy(path, watch)
    qs = [estimate_quality(p) for p, _, _ in squares]

    def groups(q):
        return static_schedule(q, "webp", *restore_budget())

    per_batch = [groups(q) for q in ([qs[0]] if len(set(qs)) == 1 else qs)]
    n_t, g_t = groups(RELEASE_TILE_QUALITY)
    tile_batches = math.ceil(len(plan_tiles(th, tw, 64, 32)[0]) / 16)
    bucket = min(_BUCKETS, key=lambda b: abs(b - float(np.median(qs))))
    return [
        dict(label="restore --quality auto", main=restore_main,
             argv=[*(p for p, _, _ in squares), *RESTORE_FLAGS, *npz, "--codec", "webp",
                   "--quality", "auto"], inputs=squares, want=sum(n + g for n, g in per_batch)),
        dict(label=f"restore --size-mode tile, {th}x{tw}", main=restore_main,
             argv=[wide[0], *RESTORE_FLAGS, *npz, "--codec", "webp", "--quality",
                   str(RELEASE_TILE_QUALITY), "--size-mode", "tile"], inputs=[wide],
             want=tile_batches * (n_t + g_t)),
        dict(label="serve --once", main=serve_main,
             argv=["--watch", watch, *CARD_FLAGS, *npz, "--codec", "webp", "--quality", "auto",
                   "--solver", "auto", "--batch-size", str(SERVE_BATCH), "--once"],
             inputs=squares, want=sum(static_schedule(bucket, "webp")), batches=1),
        dict(label="evaluate", main=evaluate_main, codec="webp",
             argv=["--codec", "webp", *CARD_FLAGS, *npz, "--synthetic", str(RELEASE_EVAL_IMAGES),
                   "--synthetic-kind", "natural", "--batch-size", str(EVAL_BATCH),
                   "--qualities", *map(str, fixture["qualities"]), "--solver", "auto"],
             inputs=None, want=math.ceil(RELEASE_EVAL_IMAGES / EVAL_BATCH)
             * sum(sum(static_schedule(int(q), "webp")) for q in fixture["qualities"])),
        dict(label=f"restore --solver gaussian_mixture --quality {GM_QUALITY}", main=restore_main,
             argv=[gm[0], *CARD_FLAGS, *npz, "--solver", "gaussian_mixture", "--quality",
                   str(GM_QUALITY)], inputs=[gm], want=gm_launches()),
    ]


def unified_release_runs(state: dict, work: str) -> list:
    """The README's unified deployment on the unified release
    (`--params-npz ... --model-codec all --codec auto --quality auto`), as
    `run_release_clis` takes them: `cli/restore.py` on one JPEG, one WebP
    and one AVIF (UNIFIED_RESTORE_FILES: each file restored alone, at its
    detected codec and estimated quality), `cli/serve.py --once` on a
    directory of both fixture images in each codec (UNIFIED_SERVE_FILES:
    three codec-pure batches of SERVE_BATCH, each at the bucket nearest its
    median quality), and `cli/evaluate.py --codec jpeg --model-codec all`
    on RELEASE_EVAL_IMAGES natural images at the fixture's JPEG
    qualities."""
    import shutil

    import numpy as np

    from ddpm_image_restoration_tpu_torch.cli.evaluate import main as evaluate_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.cli.serve import _BUCKETS
    from ddpm_image_restoration_tpu_torch.cli.serve import main as serve_main
    from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality

    fixture = state["release_fixture"]
    npz = ["--params-npz", os.path.join(ROOT, release_files(release_name(state))[0])]
    ext = {"jpeg": "jpg", "webp": "webp", "avif": "avif"}
    inputs, watch = os.path.join(work, "in"), os.path.join(work, "watch")
    singles = [(*write_release_file(inputs, f"r{i}_{c}_q{q}.{ext[c]}", fixture["x0"][i], q),
                fixture_tag(fixture, c, q)) for c, i, q in UNIFIED_RESTORE_FILES]
    served = [(*write_release_file(inputs, f"s{i}_{c}_q{q}.{ext[c]}", x, q),
               fixture_tag(fixture, c, q))
              for c, q in UNIFIED_SERVE_FILES.items() for i, x in enumerate(fixture["x0"])]
    os.makedirs(watch)
    for path, _, _ in served:  # the server moves what it restored out of `watch`
        shutil.copy(path, watch)
    restore_want = sum(sum(static_schedule(estimate_quality(p), c, *restore_budget()))
                       for (p, _, _), (c, _, _) in zip(singles, UNIFIED_RESTORE_FILES))
    serve_want = 0
    for c in UNIFIED_SERVE_FILES:
        qs = [estimate_quality(p) for p, _, _ in served if f"_{c}_" in os.path.basename(p)]
        serve_want += sum(static_schedule(
            min(_BUCKETS, key=lambda b: abs(b - float(np.median(qs)))), c))
    jpeg_qs = [q for c, q, _ in fixture_cases(fixture) if c == "jpeg"]
    return [
        dict(label="restore --codec auto --model-codec all", main=restore_main,
             argv=[*(p for p, _, _ in singles), *RESTORE_FLAGS, *npz, *UNIFIED_FLAGS],
             inputs=singles, want=restore_want),
        dict(label="serve --once --codec auto --model-codec all", main=serve_main,
             argv=["--watch", watch, *CARD_FLAGS, *npz, *UNIFIED_FLAGS, "--solver", "auto",
                   "--batch-size", str(SERVE_BATCH), "--once"],
             inputs=served, want=serve_want, batches=len(UNIFIED_SERVE_FILES)),
        dict(label="evaluate --codec jpeg --model-codec all", main=evaluate_main, codec="jpeg",
             argv=["--codec", "jpeg", "--model-codec", "all", *CARD_FLAGS, *npz, "--synthetic",
                   str(RELEASE_EVAL_IMAGES), "--synthetic-kind", "natural", "--batch-size",
                   str(EVAL_BATCH), "--qualities", *map(str, jpeg_qs), "--solver", "auto"],
             inputs=None, want=math.ceil(RELEASE_EVAL_IMAGES / EVAL_BATCH)
             * sum(sum(static_schedule(q, "jpeg")) for q in jpeg_qs)),
    ]


def run_release_clis(state: dict, runs: list, work: str, totals: dict) -> list:
    """Each run (`webp_release_runs`, `unified_release_runs`: label, main,
    argv, inputs as [(path, clean 8-bit image, fixture tag)] or None for the
    evaluator, want: its forward launches, batches: the server's batches)
    counted from 0 against its schedule, its output directory under `work`.
    Each output PNG's PSNR against its clean image, and the evaluator's mean
    per quality, under `release_psnr_failures`. Returns the failures."""
    import numpy as np
    import torch
    from PIL import Image

    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    fixture = state["release_fixture"]
    npz_rel = release_files(release_name(state))[0]
    failures = []
    for i, run in enumerate(runs):
        label, want = run["label"], run["want"]
        out_dir = os.path.join(work, f"out{i}")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        _, printed = _quiet(run["main"], [*run["argv"], "--output-dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        for k, v in counts.items():
            totals[k] += v
        if counts != {fa.KERNEL: want, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}:
            failures.append(f"{label}: launches {counts}, schedule implies {want} forward")
        per = []
        if run.get("batches") is not None:
            batches = sum(line.startswith("restored ") for line in printed.splitlines())
            per.append(f"{batches} batches")
            if batches != run["batches"]:
                failures.append(f"{label}: {batches} batches, {run['batches']} codec-pure "
                                f"ones expected")
        if run["inputs"] is None:
            with open(os.path.join(out_dir, "metrics_summary.json")) as f:
                rows = json.load(f)["results"]
            for q, r in rows.items():
                per.append(f"q{q} {r['restored_psnr']:.4f} dB (compressed "
                           f"{r['compressed_psnr']:.4f}, gain "
                           f"{r['restored_psnr'] - r['compressed_psnr']:+.4f})")
                if not np.isfinite([r["restored_psnr"], r["compressed_psnr"]]).all():
                    failures.append(f"{label} q{q}: PSNRs not finite: {r}")
                failures += release_psnr_failures(label, fixture,
                                                  fixture_tag(fixture, run["codec"], q),
                                                  r["restored_psnr"], r["compressed_psnr"])
            n_images = RELEASE_EVAL_IMAGES
        else:
            for path, clean, tag in run["inputs"]:
                stem = os.path.splitext(os.path.basename(path))[0]
                png = os.path.join(out_dir, stem + "_restored.png")
                if not os.path.exists(png):
                    failures.append(f"{label}: wrote no {png}")
                    continue
                got = np.asarray(Image.open(png).convert("RGB"))
                seen = np.asarray(Image.open(path).convert("RGB"))
                if got.shape != clean.shape:
                    failures.append(f"{label}: {png} has shape {got.shape}, not {clean.shape}")
                    continue
                out_db, in_db = psnr_u8(got, clean), psnr_u8(seen, clean)
                per.append(f"{stem} {out_db:.4f} dB (input {in_db:.4f}, gain "
                           f"{out_db - in_db:+.4f})")
                failures += release_psnr_failures(f"{label} {stem}", fixture, tag, out_db, in_db)
            n_images = len(run["inputs"])
        log(f"{label} [--params-npz {npz_rel}]: {n_images} image(s), "
            f"{1e3 * wall / n_images:.1f} ms/image on {state['smi']}; launches {counts} "
            f"(schedule implies {want} forward); " + "; ".join(per))
    return failures


def phase_release(state: dict) -> None:
    """The release weights (`--release`, default `webp_real_r5.npz`) at
    full width: loaded once (strict), their sha256 against the fixture's;
    each fixture case (codec, quality) restored on the card in f32 (no TF32
    in the convolutions; the f32 forward kernel) through the serve core,
    eager and then as a replayed CUDA graph (`release_restores`), each held
    to the JAX package's own restore (RESTORE_*_DIFF, the fixture's
    reference edges by PSNR, n + g forward launches) and the graph to the
    eager restore, then in bf16, the production dtype, whose PSNR must be
    within RELEASE_PSNR_DB of the JAX restores' (`release_psnr_failures`)
    in either mode; the launch shapes logged; then
    the README's CLIs on those weights (`webp_release_runs` or, for the
    unified model, `unified_release_runs`)."""
    import collections
    import shutil

    import torch

    t_phase = time.perf_counter()
    load_release(state)
    fixture = state["release_fixture"]
    totals = dict.fromkeys(_counts(), 0)
    failures = []
    def shape(name, bh, t, d, dtype):
        return name, bh, t, d, str(dtype).split(".")[-1]

    with launches_by_head_dim(shape) as shapes:
        for dtype in ("float32", "bfloat16"):
            model = release_model(state, dtype, CARD)
            # on the CPU there is no graph: a second call would run eager again
            modes = SOLVER_MODES if torch.device(CARD).type == "cuda" else ("eager",)
            failures += release_restores(model, fixture, CARD, totals, modes)[1]
            del model
    log("launch shapes of the serve core's restores (kernel, BH, T, D, dtype): "
        f"{dict(collections.Counter(shapes))}")
    for _, _, tag in fixture_cases(fixture):
        log(f"[{tag}]: the JAX restore's gain {fixture_gain(fixture, tag):+.4f} dB: the gain "
            "rule " + ("applies" if fixture_gain(fixture, tag) >= RELEASE_GAIN_DB else
                       f"does not apply (under {RELEASE_GAIN_DB} dB)"))
    work = os.path.join(ROOT, "build", "chip_smoke_release")
    shutil.rmtree(work, ignore_errors=True)
    try:
        runs = (webp_release_runs if RELEASES[release_name(state)] == "webp"
                else unified_release_runs)(state, work)
        failures += run_release_clis(state, runs, work, totals)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    state["launches_release"] = totals
    log(f"phase release: launches {totals}, {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))


def phase_serve(state: dict) -> None:
    """The restore server core at full width on the release weights that
    phase `release` loaded (bf16, flash at <= 32²): three batches of 8 at
    SERVE_QUALITIES, all WebP for the WebP release, one JPEG, one WebP and
    one AVIF batch for the unified model (what `--codec auto --model-codec
    all` serves: codec-pure batches, the model conditioned on each batch's
    codec), four passes, each timed and its forward launches held to the
    schedule: the signatures' first calls (eager), their captures (the
    solver loop as a CUDA graph) and replays, replays, and eager again
    (fresh samplers); one batch profiled in each mode, the replayed one's
    flash kernels counted in the device's trace (`flash_traced`) and held
    to the schedule."""
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch, solver_for
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import _solver_indices
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa

    npz_rel = release_files(release_name(state))[0]
    if "release_params" not in state:
        raise AssertionError(f"no release weights: phase release loads {npz_rel}, and "
                             f"phase serve runs on those weights only")
    preset_name = RELEASES[release_name(state)]
    codecs = ["webp"] * len(SERVE_QUALITIES) if preset_name == "webp" else ["jpeg", "webp", "avif"]
    cfg = ModelConfig(attention_impl="flash", attn_max_resolution=32)  # full width
    model = build_model(preset_name, cfg, device="cuda")
    model.load_state_dict(state["release_params"], strict=True)
    log(f"weights: {npz_rel}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {preset_name}, {n_params / 1e6:.1f} M parameters, {cfg.compute_dtype}, "
        f"attention flash at <= {cfg.attn_max_resolution}^2")
    final_exact = state["pil"]
    if not final_exact:
        log("final_exact: skipped, Pillow cannot be imported here (the exact "
            "host codec needs it; the card path does not)")

    batches, expected, per_batch = [], 0, []
    for i, (q, codec) in enumerate(zip(SERVE_QUALITIES, codecs)):
        x0 = torch.from_numpy(synthetic_images(SERVE_BATCH, cfg.image_size, SEED + 10 + i)).cuda()
        batches.append((q, codec, codec_surrogate(x0, q, codec=codec)))
        init_t = init_timestep_for_quality(q, 100, get_preset(codec))
        stride, reuse, _, _ = solver_for(init_t, q, codec)
        n_evals = len(_solver_indices(init_t, stride))
        # one T=1024 level in the encoder (down2), one in the decoder (up4)
        per_batch.append(n_evals + math.ceil(n_evals / reuse))
        expected += per_batch[-1]
        log(f"{codec} q{q}: init_t {init_t}, stride {stride}, {n_evals} evaluations, "
            f"encoder reuse {reuse}")

    def serve_pass(label: str, eager: bool = False) -> list:
        """The batches once, in turn, each timed to a synchronise; the
        launches counted from 0 over the pass and held to the schedule.
        `eager` drops the model's samplers before each batch (the serve
        core keeps one per codec on the model), so that each runs as a
        signature's first call: eager."""
        outs, times = [], []
        torch.cuda.synchronize()
        _reset_counts()
        for q, codec, y in batches:
            if eager:
                model.__dict__.pop("_serve_samplers", None)
            t0 = time.perf_counter()
            outs.append(restore_batch(model, y, q, codec, final_exact=final_exact))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = _counts()
        for k, v in counts.items():
            totals[k] += v
        ms = 1e3 * sum(times) / len(times)
        log(f"serve {label}: {ms:.1f} ms/batch of {SERVE_BATCH} "
            f"({', '.join(f'{1e3 * t:.1f}' for t in times)}), "
            f"{SERVE_BATCH * len(times) / sum(times):.1f} img/s on {state['smi']} (final_exact "
            f"{final_exact}); launches {counts} (schedule implies {expected} forward, no "
            f"backward)")
        if counts[fa.KERNEL] != expected or counts["flash_attention_bwd_dq"] or \
                counts["flash_attention_bwd_dkv"]:
            raise AssertionError(f"serve {label}: kernels launched {counts}, schedule implies "
                                 f"{expected} forward")
        for (q, codec, y), out in zip(batches, outs):
            o = out.cpu().numpy()
            if o.shape != tuple(y.shape) or not np.isfinite(o).all() or np.abs(o).max() > 1.0:
                raise AssertionError(f"serve {label} {codec} q{q}: bad output shape {o.shape}, "
                                     f"finite {np.isfinite(o).all()}, max |x| {np.abs(o).max()}")
        return outs

    totals = dict.fromkeys(_counts(), 0)
    first = serve_pass("eager, the signatures' first calls")
    serve_pass("graph, captured and replayed")
    graph = serve_pass("graph, replayed (timed)")
    q, codec, y = batches[1]
    flash, _ = flash_traced(f"one batch of {SERVE_BATCH}, {codec} q{q}, graph replayed",
                            lambda: restore_batch(model, y, q, codec, final_exact=final_exact),
                            (per_batch[1], 0, 0))
    if by_wrapper(flash) != (per_batch[1], 0, 0):  # a replay runs no Python: the trace counts
        raise AssertionError(f"serve {codec} q{q}, one batch replayed: flash kernels in the "
                             f"device's trace {dict(flash)}, the schedule implies "
                             f"{per_batch[1]} forward")
    eager = serve_pass("eager (timed)", eager=True)
    model.__dict__.pop("_serve_samplers", None)
    profile_run(f"one batch of {SERVE_BATCH}, {codec} q{q}, eager",
                lambda: restore_batch(model, y, q, codec, final_exact=final_exact))
    state["launches"] = totals
    for (q, codec, _), a, b, c in zip(batches, first, graph, eager):
        log(f"serve {codec} q{q}: graph against eager max|diff| {(b - a).abs().max().item():.3g}, "
            f"eager against eager {(c - a).abs().max().item():.3g}")


def profile_run(label: str, run) -> collections.Counter:
    """Where one call's time goes: device-busy share of the wall time and
    the kernels with the most device time (torch.profiler, CUPTI). One
    session around the call alone (see device_time_ms): it can miss
    kernels, so the busy share is a lower bound. It records the device's
    activity only and sums the profiler's raw events, never building its
    per-op tables: for a call of ~80,000 launches (a distill step) those
    took 24-50 s on the H100's host, and nothing here reads them. (On the
    CPU, where there is no device activity, it records the host's.)
    Returns the flash kernels that the device ran in the call
    (`flash_on_device`), a replayed graph's included, and logs them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_kernel = collections.defaultdict(lambda: [0, 0.0])   # name -> [count, device us]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name()][0] += 1
            per_kernel[e.name()][1] += e.duration_ns() / 1e3
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3
    flash = flash_on_device(per_kernel)
    log(f"profile ({label}): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}%), "
        f"{sum(n for n, _ in per_kernel.values())} device kernel launches; flash kernels on "
        f"the device by (wrapper, head dim) {dict(sorted(flash.items()))}")
    for name, (n, us) in sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {us / 1e3:8.2f} ms  x{n:<5d} {name[:90]}")
    return flash


# A flash kernel's device name (csrc/flash_attention_*.cu): the wrapper it
# belongs to and its template head dim.
FLASH_DEVICE_NAME = re.compile(r"\bflash_(fwd|bwd_dq|bwd_dkv)(?:_wgmma)?_kernel<(\d+)>")


def flash_on_device(per_kernel: dict) -> collections.Counter:
    """The flash kernels of a profile (kernel name -> [count, device us]) by
    (wrapper name, head dim), read from each kernel's name and template:
    the launches that the device ran, whether Python launched them or a
    graph replayed them."""
    got = collections.Counter()
    for name, (n, _) in per_kernel.items():
        m = FLASH_DEVICE_NAME.search(name)
        if m:
            got[(f"flash_attention_{m.group(1)}", int(m.group(2)))] += n
    return got


def flash_traced(label: str, run, want, sessions: int = 3) -> tuple:
    """The flash kernels that `run` launches on the device, from up to
    `sessions` profiled calls (`profile_run`): per (wrapper, head dim) the
    largest count over them, since a session can miss a kernel's record but
    never adds one (one session of an eager distill step read 2 of its 8
    backward launches short). Stops once the count is `want` (a Counter by
    (wrapper, head dim), or a (forward, dQ, dK/dV) tuple). Returns (the
    count, the sessions run). On the CPU, which has no device trace, one
    session."""
    import torch

    best = collections.Counter()
    for n in range(1, sessions + 1):
        best |= profile_run(label if n == 1 else f"{label}, session {n}", run)
        if not torch.cuda.is_available() or (
                by_wrapper(best) if isinstance(want, tuple) else best) == want:
            break
    return best, n


def by_wrapper(by_dim: collections.Counter) -> tuple:
    """(forward, dQ, dK/dV) launches of a count by (wrapper, head dim)."""
    return tuple(sum(n for (name, _), n in by_dim.items() if name == w)
                 for w in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"))


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
    failed += distill_reference(model_cfg, x0[:2])
    if failed:
        raise AssertionError("; ".join(failed))


def distill_reference(model_cfg, x0) -> list:
    """One f32 distill step of the half-width WebP model (EMA on) on the card
    against the same step on the CPU: the teacher at stride 10 from q50's
    start step 50 (6 evaluations), the student at 2 evaluations through the
    rematerialised solver. Gates as the train step's: the loss within rtol
    1e-4, every gradient entry within 1e-4 of the largest; the card
    launches the forward FLASH_PER_EVAL x (6 + 2 x 2) times (each student
    evaluation once more in the backward) and dQ and dK/dV FLASH_PER_EVAL x
    2 times each. Returns the failures.

    The weights are seeded with SEED: on them two CPU runs of this step that
    differ only in their thread count (so in their f32 reduction orders)
    agree to 4e-6 of the largest gradient. The unrolled solver can amplify
    last-bit differences (leaky-ReLU kinks, the surrogate's rounding): at
    seed 5 such CPU runs differed by 1.2e-4 and at seed 1 by 4.9e-3, which
    no implementation could meet. So every run makes the CPU step a second
    time at half the threads and logs that spread beside the card's
    difference: the gate's margin on these weights."""
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.distill import DistillConfig, make_distill_step
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state

    cfg = TrainConfig(codec="webp", model=model_cfg, ema_decay=0.999)
    dcfg = DistillConfig(n_eval=DISTILL_N_EVAL, teacher_stride=10)
    torch.manual_seed(SEED)
    weights = build_model("webp", model_cfg, device="cpu").state_dict()
    batch = {"x0": x0, "xt": codec_surrogate(x0, 50, codec="webp")}
    runs = []
    threads = torch.get_num_threads()
    for dev, n_threads in (("cpu", threads), ("cpu", max(1, threads // 2)), ("cuda", threads)):
        torch.set_num_threads(n_threads)
        teacher, student = (build_model("webp", model_cfg, device=dev) for _ in range(2))
        teacher.load_state_dict(weights)
        student.load_state_dict(weights)
        step, _, s_stride, t_stride = make_distill_step(student, teacher, cfg, dcfg, 50)
        with no_tf32():
            _reset_counts()
            m = step(create_train_state(student, cfg), {k: v.to(dev) for k, v in batch.items()})
            if dev == "cuda":
                torch.cuda.synchronize()
        runs.append((m["loss"].item(), {n: p.grad.cpu() for n, p in student.named_parameters()},
                     _counts()))
    torch.set_num_threads(threads)
    (cpu_loss, cpu_g, _), (_, cpu_half_g, _), (gpu_loss, gpu_g, counts) = runs
    g_max = max(g.abs().max().item() for g in cpu_g.values())
    worst = max(((gpu_g[n] - g).abs().max().item() / g_max, n) for n, g in cpu_g.items())
    spread = max(((cpu_half_g[n] - g).abs().max().item() / g_max, n)
                 for n, g in cpu_g.items())
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    want = {"flash_attention_fwd": FLASH_PER_EVAL * (6 + 2 * DISTILL_N_EVAL),
            "flash_attention_bwd_dq": FLASH_PER_EVAL * DISTILL_N_EVAL,
            "flash_attention_bwd_dkv": FLASH_PER_EVAL * DISTILL_N_EVAL}
    log(f"card vs CPU distill step (webp q50, 2x64x64, half width, f32, teacher stride "
        f"{t_stride}, student stride {s_stride}, remat): loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
        f"(rel {loss_rel:.3g}); worst gradient |diff|/max|g| {worst[0]:.3g} ({worst[1]}) "
        f"against the gate 1e-4, where the CPU against itself at {threads} and "
        f"{max(1, threads // 2)} threads reads {spread[0]:.3g} ({spread[1]}); "
        f"launches {counts} (schedule implies {want})")
    failed = []
    if counts != want:
        failed.append(f"distill: the card's step launched {counts}, schedule implies {want}")
    if not (np.isfinite(gpu_loss) and loss_rel <= 1e-4 and worst[0] <= 1e-4):
        failed.append("distill: the card's step disagrees with the CPU's")
    return failed


def phase_train(state: dict) -> None:
    """The WebP trainer at full width through its entry point: two epochs
    in one run, then a third resumed from its checkpoint. In each run the
    kernels must launch as the schedule implies: per train step the forward
    kernel with LSE at down2 and up4 and one dQ and one dK/dV launch each;
    per validation (3 qualities, init_t model evaluations each at stride 1)
    one forward launch at down2 (encode) and one at up4 (decode) per
    evaluation, and as many for epoch 0's restoration grid (q10, 80
    evaluations). Each run's first step runs eager, its second captures the
    step's CUDA graph, and every later one replays it, validation (on the
    EMA sampler's own graphs) between epochs included: one capture and
    E·steps − 1 replays a run of E epochs (`counting_step_graphs`). Then
    the data pipeline alone (`loader_alone`) and the train step alone,
    eager and as a graph (`step_alone`)."""
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
    # epoch 0 (in the first run only) also restores the restoration grid
    grid_evals = grid_restore_evals(preset, 100)
    argv = ["--codec", "webp", "--attn", "flash", "--attn-max-res", "32", "--batch-size",
            str(TRAIN_BATCH), "--ema-decay", "0.999", "--synthetic", str(TRAIN_IMAGES),
            "--synthetic-kind", "natural", "--checkpoint-dir", ckpt_dir, "--seed", str(SEED),
            "--device", "cuda"]
    totals = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0}
    step_ms = []
    try:  # the checkpoint stays for phase `restore`, which removes it
        for first, last in ((0, 2), (2, 3)):
            n_epochs = last - first
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with counting_step_graphs() as graphs:
                train_state, hist = train_main(argv + ["--epochs", str(last)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] += v
            want = {"flash_attention_fwd": n_epochs * (2 * steps + 2 * val_evals)
                    + (2 * grid_evals if first == 0 else 0),
                    "flash_attention_bwd_dq": 2 * n_epochs * steps,
                    "flash_attention_bwd_dkv": 2 * n_epochs * steps}
            model = train_state.model
            qkv = {lvl: getattr(model, lvl).attn.qkv.weight.grad for lvl in ("down2", "up4")}
            step_ms += hist["step_ms"]
            log(f"train run to epoch {last} ({n_epochs} epoch(s) from epoch {first}): "
                f"{wall:.1f} s; per epoch: loss "
                f"{[round(v, 4) for v in hist['loss']]}, val_psnr "
                f"{[round(v, 3) for v in hist['val_psnr']]}, val_ssim "
                f"{[round(v, 4) for v in hist['val_ssim']]}, "
                f"{[round(v, 1) for v in hist['step_ms']]} ms/step in the loop (data "
                f"pipeline included, over the {steps - 2} steps after 2 warm-up steps), "
                f"epoch {[round(v, 1) for v in hist['epoch_time']]} s; optimizer step "
                f"{train_state.step}; step graphs {graphs}; launches {counts} (schedule "
                f"implies {want}); |qkv grad| max down2 {qkv['down2'].abs().max().item():.3g}, "
                f"up4 {qkv['up4'].abs().max().item():.3g}")
            if counts != want:
                raise AssertionError(f"kernel launches {counts}, schedule implies {want}")
            if graphs != {"captures": 1, "replays": n_epochs * steps - 1}:
                raise AssertionError(f"the loop's {n_epochs}x{steps} steps ran {graphs}: the "
                                     "first eager, then one capture and a replay a step")
            if not (len(hist["loss"]) == len(hist["val_psnr"]) == n_epochs
                    and train_state.step == last * steps):
                raise AssertionError(f"run to epoch {last} trained and validated "
                                     f"{len(hist['loss'])} and {len(hist['val_psnr'])} "
                                     f"epochs, {train_state.step} steps")
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

    loader_alone(state, "webp", TRAIN_IMAGES, TRAIN_BATCH, step_ms)
    step_alone(state, "webp", model, train_state, TRAIN_BATCH)


@contextlib.contextmanager
def counting_step_graphs():
    """Counts the captures and replays of the train steps that
    `train/loop.py train_model` makes inside the block (its
    `make_train_step`, wrapped): the yielded dict is filled as the block
    ends."""
    from ddpm_image_restoration_tpu_torch.train import loop

    made, make = [], loop.make_train_step

    def recording(*a, **k):
        made.append(make(*a, **k))
        return made[-1]

    counts = {}
    loop.make_train_step = recording
    try:
        yield counts
    finally:
        loop.make_train_step = make
        counts["captures"] = sum(step.cache.captures for step in made)
        counts["replays"] = sum(g.replays for step in made for g in step.graphs.values())


def loader_alone(state: dict, codec: str, images: int, batch: int, loop_ms: list) -> None:
    """The trainer's data pipeline without the card: one epoch of the
    DegradationLoader that `train_model` builds for `cli/train.py
    --synthetic {images} --synthetic-kind natural` (the same images,
    split, workers and prefetch), ms per batch on the card's host, logged
    beside the loop's `step_ms` (`loop_ms`, one per epoch trained)."""
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset, split_indices
    from ddpm_image_restoration_tpu_torch.data.pipeline import DegradationLoader

    cfg = TrainConfig(codec=codec, batch_size=batch, seed=SEED)
    ds = SyntheticImageDataset(images, cfg.model.image_size, kind="natural")
    loader = DegradationLoader(ds, split_indices(images, cfg.split_fracs, cfg.split_seed)[0],
                               cfg.preset, batch, cfg.steps, seed=cfg.seed,
                               num_workers=cfg.data_workers, augment=cfg.augment)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader.epoch(0))
    ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"{codec} data pipeline alone (DegradationLoader, {cfg.data_workers} workers, batch "
        f"{batch} of {ds.image_size}² natural images made in the loop, {n} batches): "
        f"{ms:.1f} ms/batch on the card's host ({os.cpu_count()} cores); the loop's step_ms "
        f"{[round(v, 1) for v in loop_ms]} (step alone: below)")
    state.setdefault("loader_ms", {})[codec] = ms


def grid_restore_evals(preset, steps: int) -> int:
    """Model evaluations of the trainer's restoration grid (epochs that are
    multiples of viz_every): one full-solver restore at the preset's lowest
    val quality."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality

    return init_timestep_for_quality(preset.val_qualities[0], steps, preset)


STEP_ALONE_STEPS = 5
GATE_RUNS = 3  # runs of each kind whose spread bounds a graph's difference from eager
STATE_PARTS = ("params", "mu", "nu", "ema")  # the train state's f32 dicts
GATE_PARTS = ("loss", "grad_norm", *STATE_PARTS)


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms inside the block, warn only (an op
    without a deterministic CUDA kernel still runs, and warns); yields the
    names of the ops that warned."""
    import warnings

    import torch

    ops = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield ops
        finally:
            torch.use_deterministic_algorithms(False)
            ops.update(str(w.message).split(" does not have a deterministic")[0][:80]
                       for w in caught if "does not have a deterministic" in str(w.message))


class StepRuns:
    """Runs of a step function (`fn(train_state, batch, generator)`: a
    train step, a distill step, or either's `.eager`) of `n_steps` steps
    each, from copies of one train state on one device batch: before each
    run the masters, moments, EMA and step count are put back in place and
    the generator reseeded. The copies and each run's results stay on the
    state's device (a full-width state is 1.8 GB: a trip through the host
    took ~0.6 s each way). After the runs, `put_back()` leaves the state as
    it was."""

    def __init__(self, train_state, batch: dict, generator, n_steps: int):
        import torch

        self.state, self.batch, self.gen, self.n_steps = train_state, batch, generator, n_steps
        self.dev = train_state.model.out_conv.weight.device
        self.card = self.dev.type == "cuda"
        # what a run's peak counts besides its own growth: the model, the
        # state and what else the phase holds, not these copies or results
        self.resident = torch.cuda.memory_allocated(self.dev) if self.card else 0
        self.saved = self._copy()
        self.count = train_state.step
        self.torch = torch

    def _copy(self) -> dict:
        return {p: {k: v.clone() for k, v in getattr(self.state, p).items()} for p in STATE_PARTS}

    def put_back(self) -> None:
        with self.torch.no_grad():
            for p in STATE_PARTS:
                for k, v in getattr(self.state, p).items():
                    v.copy_(self.saved[p][k])
        self.state.step = self.count
        self.state.write_back()
        self.gen.manual_seed(SEED + 1)

    def run(self, fn, warm_up=()) -> dict:
        """`n_steps` calls of fn from the state put back, the calls of
        `warm_up` first, each from the state put back (their memory
        counted, not their time): ms/step, peak device memory (the
        resident memory and the run's own growth above it), the flash
        launches of the timed steps, their losses and grad norms and the
        state after them."""
        torch, dev = self.torch, self.dev
        torch.cuda.synchronize()
        if self.card:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        for warm in warm_up:
            self.put_back()
            warm(self.state, self.batch, self.gen)
        self.put_back()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = [fn(self.state, self.batch, self.gen) for _ in range(self.n_steps)]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / self.n_steps
        peak = self.resident + torch.cuda.max_memory_allocated(dev) - base if self.card else 0
        return {"ms": ms, "peak": peak, "counts": _counts(),
                "loss": torch.stack([m["loss"] for m in out]),
                "grad_norm": torch.stack([m["grad_norm"] for m in out]), **self._copy()}

    def graph_run(self, step, label: str) -> dict:
        """A run of `step` after its first call (eager) and its second
        (capture): on a card it must hold one graph (on the CPU none)."""
        out = self.run(step, warm_up=(step, step) if self.card else ())
        if len(step.cache.graphs) != int(self.card):
            raise AssertionError(f"{label}: {len(step.cache.graphs)} graphs captured")
        return out


def _diff(a, b) -> float:
    import torch

    if isinstance(a, dict):
        return torch.stack([(a[k] - b[k]).abs().max() for k in a]).max().item()
    return (a - b).abs().max().item()


def _spread(runs: list, part: str) -> float:
    return max(_diff(a[part], b[part]) for i, a in enumerate(runs) for b in runs[i + 1:])


def default_setting_gate(eagers: list, graphs: list) -> tuple[str, list]:
    """The graph captured in torch's default setting (the one the trainer
    and the distiller replay) against eager: per quantity (GATE_PARTS), the
    first graph run against the first eager run within twice the larger of
    the eager runs' and the graph runs' spreads (their largest pairwise
    differences; bit for bit where both are 0). Returns (the log's
    verdicts, failures)."""
    verdicts, failures = [], []
    for part in GATE_PARTS:
        bound = 2 * max(_spread(eagers, part), _spread(graphs, part))
        err = _diff(graphs[0][part], eagers[0][part])
        verdicts.append(f"{part} {err:.3g} (eager {_spread(eagers, part):.3g}, graph "
                        f"{_spread(graphs, part):.3g})")
        if not (err == 0 if bound == 0 else err <= bound):
            failures.append(f"default setting {part}: graph against eager {err:.3g} > {bound:.3g}")
    return "; ".join(verdicts), failures


def deterministic_gate(eagers: list, graph: dict) -> tuple[str, list]:
    """Under deterministic algorithms: per quantity the graph must equal the
    first eager run bit for bit where the eager runs agree bit for bit,
    else lie within twice their spread; the graph's launches must be the
    eager runs' and its losses finite and distinct. Returns (the log's
    verdicts, failures)."""
    import torch

    verdicts, failures = [], []
    for part in GATE_PARTS:
        spread, err = _spread(eagers, part), _diff(graph[part], eagers[0][part])
        verdicts.append(f"{part} {err:.3g} (eager spread {spread:.3g})")
        if not (err == 0 if spread == 0 else err <= 2 * spread):
            failures.append(f"{part}: graph against eager {err:.3g}, eager spread {spread:.3g}")
    if not all(r["counts"] == graph["counts"] for r in eagers):
        failures.append(f"launches: graph {graph['counts']}, eager {eagers[0]['counts']}")
    if not (torch.isfinite(graph["loss"]).all()
            and len(set(graph["loss"].tolist())) == len(graph["loss"])):
        failures.append(f"graph losses {graph['loss'].tolist()}")
    return "; ".join(verdicts), failures


def graph_gates(label: str, runner: StepRuns, make_step, step=None, eagers: list = (),
                graphs: list = (), default_setting: bool = True) -> list:
    """Both gates of a captured step against its eager body, from copies of
    one state (`runner`): in torch's default setting (unless
    `default_setting` is False), GATE_RUNS eager runs (`step.eager`) and
    GATE_RUNS runs of one step function's graph (`step`, else
    `make_step()`; `eagers` and `graphs` are its runs made already, topped
    up to GATE_RUNS: `default_setting_gate`), then under deterministic
    algorithms GATE_RUNS eager runs and a second step function's graph
    captured under that setting (`deterministic_gate`). Logs both; returns
    the failures."""
    failures, t0 = [], time.perf_counter()
    if default_setting:
        step = make_step() if step is None else step
        eagers, graphs = list(eagers), list(graphs)
        while len(eagers) < GATE_RUNS or len(graphs) < GATE_RUNS:
            if len(eagers) < GATE_RUNS:
                eagers.append(runner.run(step.eager))
            if len(graphs) < GATE_RUNS:
                graphs.append(runner.graph_run(step, label))
        verdicts, failures = default_setting_gate(eagers, graphs)
        log(f"  {label}, torch's default setting: eager {[round(r['ms'], 1) for r in eagers]} "
            f"ms/step, graph {[round(r['ms'], 1) for r in graphs]} (replays), peak device "
            f"memory eager {_gib(eagers[0]['peak'])}, graph {_gib(graphs[0]['peak'])} (a "
            f"replay allocates nothing: the pool counts at the capture); max "
            f"|diff| over {runner.n_steps} steps, graph against eager (eager against eager, "
            f"graph against graph, {GATE_RUNS} runs each; bound twice the larger): {verdicts} "
            f"[{time.perf_counter() - t0:.1f} s]")
    del step
    t0 = time.perf_counter()  # its graph's memory, unless the caller keeps the step
    det_step = make_step()
    with deterministic_algorithms() as nondeterministic:
        det_eagers = [runner.run(det_step.eager) for _ in range(GATE_RUNS)]
        det_graph = runner.graph_run(det_step, label)
    verdicts, det_failures = deterministic_gate(det_eagers, det_graph)
    log(f"  {label}, under deterministic algorithms, graph against {GATE_RUNS} eager runs, max "
        f"|diff| over {runner.n_steps} steps: {verdicts}; ops without a deterministic CUDA "
        f"kernel: {sorted(nondeterministic) or 'none'}; eager "
        f"{[round(r['ms'], 1) for r in det_eagers]} ms/step, graph {det_graph['ms']:.1f} "
        f"[{time.perf_counter() - t0:.1f} s]")
    runner.put_back()
    return failures + det_failures


def step_alone(state: dict, codec: str, model, train_state, batch: int) -> None:
    """The trainer's step alone on one device batch (no data pipeline), full
    width, bf16, the model's dropout, EMA, eager and as its captured graph,
    each run from copies of one state (`StepRuns`: the trainer's, put back
    in place; the dropout generator reseeded): STEP_ALONE_STEPS eager steps
    after a warm one (`train_step.eager`, the body a signature's first call
    runs), then `train_step`'s first call (eager) and second (capture and
    replay) and STEP_ALONE_STEPS replays. Logs ms/step, each run's peak
    device memory (the model and its train state included; the graph's
    pool and its capture counted) and one step of each profiled, its flash
    kernels in the device's trace (`flash_traced`) held to the eager
    steps' launches a step; then the
    gates (`graph_gates`): the graph in torch's default setting against
    eager, and a graph captured under deterministic algorithms against
    eager, bit for bit where the eager runs agree bit for bit."""
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(codec=codec, model=model.cfg, batch_size=batch, ema_decay=0.999)
    dev = model.out_conv.weight.device
    x0 = torch.from_numpy(synthetic_images(batch, model.cfg.image_size, SEED + 4)).to(dev)
    t = torch.randint(1, 100, (batch,), generator=torch.Generator().manual_seed(SEED))
    device_batch = {"x0": x0, "xt": codec_surrogate(x0, 30, codec=codec), "t": t.to(dev)}
    runner = StepRuns(train_state, device_batch, torch.Generator(device=dev),
                      STEP_ALONE_STEPS)
    label = f"{codec} step alone"

    step = make_train_step(model, cfg)
    eager = runner.run(step.eager, warm_up=(step.eager,))
    graph = runner.graph_run(step, label)
    log(f"train step alone ({codec}, full width, bf16, batch {batch}, dropout "
        f"{model.cfg.dropout}, EMA) on {state['smi']}: eager {eager['ms']:.1f} ms/step "
        f"({batch * 1e3 / eager['ms']:.1f} img/s), graph {graph['ms']:.1f} ms/step "
        f"({batch * 1e3 / graph['ms']:.1f} img/s, {eager['ms'] / graph['ms']:.2f}x); peak "
        f"device memory eager {_gib(eager['peak'])}, graph {_gib(graph['peak'])} (its capture "
        f"and pool included); launches over {STEP_ALONE_STEPS} steps eager {eager['counts']}, "
        f"graph {graph['counts']}")
    per_step = tuple(n // STEP_ALONE_STEPS for n in eager["counts"].values())
    on_device = {"eager": flash_traced(
        f"one {codec} train step, batch {batch}, eager",
        lambda: step.eager(train_state, device_batch, runner.gen), per_step)[0],
                 "graph replayed": flash_traced(
        f"one {codec} train step, batch {batch}, graph replayed",
        lambda: step(train_state, device_batch, runner.gen), per_step)[0]}
    failures = graph_gates(label, runner, lambda: make_train_step(model, cfg), step, [eager],
                           [graph])
    for call, flash in on_device.items() if runner.card else ():
        if by_wrapper(flash) != per_step:
            failures.append(f"one step {call}: flash kernels in the device's trace "
                            f"{dict(flash)}, the eager steps launched {per_step} a step")
    if graph["counts"] != eager["counts"]:
        failures.append(f"launches: graph {graph['counts']}, eager {eager['counts']}")
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))


def _counted(state: dict, label: str, fn, argv, want, totals: dict, failures: list):
    """fn(argv) counted from 0, its standard output captured: logs its wall
    time and launches, adds them to `totals`, records a failure unless they
    are `want` (fwd, dq, dkv). Returns (fn's result, the printed text, the
    wall seconds)."""
    import torch

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
    log(f"{label}: {wall:.1f} s on {state['smi']}; launches {counts} (schedule implies {want})")
    if counts != want:
        failures.append(f"{label}: launches {counts}, schedule implies {want}")
    return out, printed, wall


def _evals(init_t: int, n_eval: int = 0, stride: int = 1) -> int:
    """Model evaluations of the static schedule from `init_t` at `stride`, or
    at the budget `n_eval` (the stride derived by student_stride)."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import student_stride
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import _solver_indices

    return len(_solver_indices(init_t, student_stride(init_t, n_eval) if n_eval else stride))


def distill_launches(n_steps: int, n_eval: int, teacher_stride: int = 1,
                     teacher_n_eval: int = 0, recompute: int = 1) -> tuple:
    """(forward, dQ, dK/dV) launches of a distill run of `n_steps` steps
    (DISTILL_QUALITIES round-robin from the first) and its validation. A
    step at quality q launches the forward FLASH_PER_EVAL·(E_t + (1 + r)·E_s)
    times, E_t and E_s the teacher's and the student's evaluations from
    init_t(q) and r = `recompute` the times the backward recomputes a
    student evaluation, and dQ and dK/dV FLASH_PER_EVAL·E_s times each;
    validation restores at the webp val qualities at the student's budget
    (forward only)."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.config import get_preset

    preset = get_preset("webp")
    fwd = bwd = 0
    for b in range(n_steps):
        init_t = init_timestep_for_quality(DISTILL_QUALITIES[b % len(DISTILL_QUALITIES)],
                                           DIFFUSION_STEPS, preset)
        f, b_, _ = distill_step_launches(init_t, n_eval, teacher_stride, teacher_n_eval,
                                         recompute)
        fwd, bwd = fwd + f, bwd + b_
    fwd += FLASH_PER_EVAL * sum(
        _evals(init_timestep_for_quality(q, DIFFUSION_STEPS, preset), n_eval)
        for q in preset.val_qualities)
    return fwd, bwd, bwd


def distill_step_launches(init_t: int, n_eval: int, teacher_stride: int = 1,
                          teacher_n_eval: int = 0, recompute: int = 1) -> tuple:
    """(forward, dQ, dK/dV) launches of one distill step from `init_t`
    (`distill_launches`' term of a step)."""
    e_t, e_s = _evals(init_t, teacher_n_eval, teacher_stride), _evals(init_t, n_eval)
    return (FLASH_PER_EVAL * (e_t + (1 + recompute) * e_s), FLASH_PER_EVAL * e_s,
            FLASH_PER_EVAL * e_s)


def phase_distill(state: dict) -> None:
    """Solver distillation at full width (WebP preset, release widths, bf16,
    batch 18, EMA, flash attention at <= 32², seeded weights), the teacher
    being phase `train`'s checkpoint (its EMA), each run counted from 0:
      1. `cli/distill.py main`: the student at DISTILL_N_EVAL evaluations at
         q10 and q50 (round-robin) against the full-solver teacher
         (DISTILL_TEACHER_STRIDE 1), one epoch on DISTILL_IMAGES natural
         images (2 steps); then the same with `--compute-dtype float32`, as
         the README tells users to distill, its launches counted per kernel
         and head dim, the loss and every gradient finite, its step time
         beside the bf16 run's;
      2. `--progressive` from a stride-10 teacher on fewer images: the
         budget chain must be DISTILL_PROGRESSIVE_BUDGETS (stage0, then the
         root directory);
      3. `cli/restore.py --max-evals 2` from the student's EMA on the
         restore phase's WebPs;
      4. `cli/distill.py main` again, DISTILL_POOL_STEPS steps a bucket,
         its graphs in one memory pool, held to the same run through
         `step.eager` (`distill_pool`);
      5. the distill step alone (q50), bf16 and f32 (`distill_alone`):
         eager and as its captured graph, timed, profiled, its peak device
         memory with the solver's rematerialisation on and off, and the
         graph against eager (`graph_gates`).
    Launches per step follow `distill_launches` with r = 1: the student's
    solver runs each step under activation checkpointing (`DDRMSampler.run`,
    remat=True) and its blocks without (no `--remat`), so the backward
    recomputes each student evaluation once, and the recompute, under grad,
    launches the forward with the LSE again. (With `--remat` the blocks'
    checkpoints nest inside the step's and r = 2; without the step's, r = 0.)
    The student's evaluations launch the forward with the LSE, the
    teacher's (under no_grad) without it."""
    import collections
    import shutil

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.distill import main as distill_main
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality
    from ddpm_image_restoration_tpu_torch.data.dataset import split_indices
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.train.distill import DistillConfig, teacher_weights

    ckpt_dir = state.get("train_ckpt")
    if ckpt_dir is None:
        raise AssertionError("phase train left no checkpoint to distill from")
    t_phase = time.perf_counter()

    def elapsed(what):
        log(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into the phase)")

    work = os.path.join(ROOT, "build", "chip_smoke_distill")
    shutil.rmtree(work, ignore_errors=True)
    student_dir = os.path.join(work, "student")
    totals = dict.fromkeys(_counts(), 0)
    failures = []
    common = ["--codec", "webp", *CARD_FLAGS, "--batch-size", str(TRAIN_BATCH), "--ema-decay",
              "0.999", "--synthetic-kind", "natural", "--steps", str(DIFFUSION_STEPS), "--seed",
              str(SEED), "--epochs", "1", "--qualities", *map(str, DISTILL_QUALITIES),
              "--teacher-dir", ckpt_dir]
    try:
        steps = len(split_indices(DISTILL_IMAGES)[0]) // TRAIN_BATCH
        (dstate, hist), _, wall = _counted(
            state, f"distill [n_eval {DISTILL_N_EVAL}, teacher stride {DISTILL_TEACHER_STRIDE}, "
            f"{steps} steps]", distill_main,
            [*common, "--synthetic", str(DISTILL_IMAGES), "--checkpoint-dir", student_dir,
             "--n-eval", str(DISTILL_N_EVAL), "--teacher-stride", str(DISTILL_TEACHER_STRIDE)],
            distill_launches(steps, DISTILL_N_EVAL, DISTILL_TEACHER_STRIDE), totals, failures)
        student = dstate.model
        qkv = {lvl: getattr(student, lvl).attn.qkv.weight.grad for lvl in ("down2", "up4")}
        log(f"  loss {hist['loss'][-1]:.4f}, val_psnr {hist['val_psnr'][-1]:.3f} (student at "
            f"{DISTILL_N_EVAL} evaluations), {hist['step_ms'][-1]:.1f} ms/distill step in the "
            f"loop (data pipeline included), epoch {hist['epoch_time'][-1]:.1f} s; optimizer "
            f"step {dstate.step}; |qkv grad| max down2 {qkv['down2'].abs().max().item():.3g}, "
            f"up4 {qkv['up4'].abs().max().item():.3g}")
        if not (dstate.step == steps and np.isfinite(hist["loss"]).all()
                and np.isfinite(hist["val_psnr"]).all()):
            failures.append(f"distill: step {dstate.step} of {steps}, history {dict(hist)}")
        if any(g is None or not torch.isfinite(g).all() or g.abs().max().item() == 0
               for g in qkv.values()):
            failures.append("distill: a flash level of the student got no gradient")
        elapsed("distill CLI")

        # the same run in f32, as the README tells users to distill (bf16
        # distillation diverges there): the f32 forward with and without
        # the LSE, dQ and dK/dV at the flash levels' head dims
        want32 = distill_launches(steps, DISTILL_N_EVAL, DISTILL_TEACHER_STRIDE)
        with launches_by_head_dim() as seen:
            (dstate32, hist32), _, _ = _counted(
                state, f"distill f32 [--compute-dtype float32, n_eval {DISTILL_N_EVAL}, teacher "
                f"stride {DISTILL_TEACHER_STRIDE}, {steps} steps]", distill_main,
                [*common, "--synthetic", str(DISTILL_IMAGES), "--checkpoint-dir",
                 os.path.join(work, "student_f32"), "--n-eval", str(DISTILL_N_EVAL),
                 "--teacher-stride", str(DISTILL_TEACHER_STRIDE), "--compute-dtype", "float32"],
                want32, totals, failures)
        student32 = dstate32.model
        dims = [fa.kernel_head_dim(fa.KERNEL, d, torch.float32)
                for d in sum(flash_head_dims(student32, student32.cfg.image_size), [])]
        by_dim = collections.Counter(seen)
        want_dim = collections.Counter()
        for name, n in zip((fa.KERNEL, "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                           want32):
            for d in dims:
                want_dim[(name, d)] += n // len(dims)
        grads = {n: p.grad for n, p in student32.named_parameters()}
        bad = [n for n, g in grads.items() if g is not None and not torch.isfinite(g).all()]
        missing = [n for n, g in grads.items() if g is None]
        qkv32 = [getattr(student32, lvl).attn.qkv.weight.grad for lvl in ("down2", "up4")]
        log(f"  f32: launches by (kernel, head dim) {dict(sorted(by_dim.items()))}, the schedule "
            f"implies {dict(sorted(want_dim.items()))}; loss {hist32['loss'][-1]:.4f}, val_psnr "
            f"{hist32['val_psnr'][-1]:.3f}, {hist32['step_ms'][-1]:.1f} ms/distill step in the "
            f"loop (bf16: {hist['step_ms'][-1]:.1f}), epoch {hist32['epoch_time'][-1]:.1f} s "
            f"(bf16: {hist['epoch_time'][-1]:.1f}) on {state['smi']}; parameters with a "
            f"non-finite gradient {bad}, without one {missing}; |qkv grad| max "
            f"{[g.abs().max().item() if g is not None else None for g in qkv32]}")
        if by_dim != want_dim:
            failures.append(f"distill f32: launches {dict(by_dim)}, the schedule implies "
                            f"{dict(want_dim)}")
        if not (dstate32.step == steps and np.isfinite(hist32["loss"]).all()
                and np.isfinite(hist32["val_psnr"]).all()) or bad or any(
                    g is None or g.abs().max().item() == 0 for g in qkv32):
            failures.append(f"distill f32: step {dstate32.step} of {steps}, history "
                            f"{dict(hist32)}, non-finite gradients {bad[:5]}, flash-level qkv "
                            f"gradients {[g is not None for g in qkv32]}")
        del grads
        elapsed("distill CLI f32")

        p_steps = len(split_indices(DISTILL_PROGRESSIVE_IMAGES)[0]) // TRAIN_BATCH
        budgets = DISTILL_PROGRESSIVE_BUDGETS
        want = np.zeros(3, int)
        teacher = (DISTILL_PROGRESSIVE_STRIDE, 0)
        for budget in budgets:
            want += distill_launches(p_steps, budget, *teacher)
            teacher = (1, budget)
        prog_dir = os.path.join(work, "progressive")
        _, printed, _ = _counted(
            state, f"distill --progressive [teacher stride {DISTILL_PROGRESSIVE_STRIDE}, "
            f"{p_steps} steps a stage]", distill_main,
            [*common, "--synthetic", str(DISTILL_PROGRESSIVE_IMAGES), "--checkpoint-dir",
             prog_dir, "--n-eval", str(DISTILL_N_EVAL), "--teacher-stride",
             str(DISTILL_PROGRESSIVE_STRIDE), "--progressive"],
            tuple(int(w) for w in want), totals, failures)
        chain = [int(b) for b in re.findall(r"\] eval budget (\d+)", printed)]
        stages = sorted(d for d in os.listdir(prog_dir) if d.startswith("stage"))
        log(f"  progressive budgets {chain} (JAX's chain for this teacher: {budgets}); stage "
            f"directories {stages}")
        if chain != budgets or stages != [f"stage{k}" for k in range(len(budgets) - 1)] \
                or not any(f.startswith("ckpt_") for f in os.listdir(prog_dir)):
            failures.append(f"distill --progressive: budgets {chain}, stages {stages}")
        elapsed("progressive")

        distill_pool(state, common, work, failures)
        elapsed("shared pool")

        webps, _, _ = write_restore_inputs(os.path.join(work, "in"))
        qs = [estimate_quality(p) for p in webps]
        per_batch = [qs[0]] if len(set(qs)) == 1 else qs
        out_dir = os.path.join(work, "restored")
        _, _, wall = _counted(
            state, f"restore --max-evals {DISTILL_N_EVAL} from the student's EMA", restore_main,
            [*webps, *CARD_FLAGS, "--codec", "webp", "--quality", "auto", "--max-evals",
             str(DISTILL_N_EVAL), "--checkpoint-dir", student_dir, "--use-ema", "--steps",
             str(DIFFUSION_STEPS), "--output-dir", out_dir],
            (sum(sum(static_schedule(q, "webp", DISTILL_N_EVAL, 1, DIFFUSION_STEPS))
                 for q in per_batch), 0, 0), totals, failures)
        log(f"  {len(webps)} WebPs (estimated qualities {qs}): {1e3 * wall / len(webps):.1f} "
            f"ms/image")
        for f in webps:
            png = os.path.join(out_dir, os.path.splitext(os.path.basename(f))[0] + "_restored.png")
            if not os.path.exists(png):
                failures.append(f"distill restore: no {png}")
        state["launches_distill"] = totals
        elapsed("student restore")

        # the distill step alone, on one device batch (no data pipeline): bf16,
        # then f32
        weights = teacher_weights(DistillConfig(teacher_dir=ckpt_dir), verbose=False)
        for dtype, st in (("bfloat16", dstate), ("float32", dstate32)):
            dev = st.model.out_conv.weight.device
            teacher_model = build_model("webp", st.model.cfg, device=dev)
            teacher_model.load_state_dict(weights)
            distill_alone(state, st, teacher_model, failures)
            del teacher_model
            elapsed(f"step alone {dtype}")
        del dstate32, student32
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))


def distill_pool(state: dict, common: list, work: str, failures: list) -> None:
    """The production distiller's graphs (`train/distill.py distill_model`
    through `cli/distill.py main`, bf16): DISTILL_POOL_STEPS steps for each
    of the two DISTILL_QUALITIES buckets (round-robin), the teacher at
    DISTILL_GATE_TEACHER_STRIDE, every bucket's graphs in one cache and
    memory pool. Under deterministic algorithms, twice: the steps as
    `distill_model` makes them (a bucket's first step eager, its second
    captured and replayed, later ones replayed) and each step through
    `step.eager`. The first must capture once per bucket and replay
    DISTILL_POOL_STEPS − 1 times per bucket; both runs' launches must be
    the schedule's (`distill_launches`; the graph run's replays counted as
    their captures' launches) and their losses and grad norms per step,
    masters, moments, EMA and validation PSNR bit for bit equal. Logs each
    run's wall time and peak device memory above what the phase held
    before it. Its launches stay out of the phase's totals."""
    import torch

    from ddpm_image_restoration_tpu_torch.cli.distill import main as distill_main
    from ddpm_image_restoration_tpu_torch.data.dataset import split_indices
    from ddpm_image_restoration_tpu_torch.train import distill as distill_mod

    steps = len(DISTILL_QUALITIES) * DISTILL_POOL_STEPS
    images = steps * TRAIN_BATCH
    while len(split_indices(images)[0]) < steps * TRAIN_BATCH:
        images += 1
    want = distill_launches(steps, DISTILL_N_EVAL, DISTILL_GATE_TEACHER_STRIDE)
    card = torch.cuda.is_available() and "cuda" in common
    runs = {}
    for mode in ("graph", "eager"):
        made, per_step, real = [], [], distill_mod.make_distill_step

        def making(*a, mode=mode, made=made, per_step=per_step, real=real, **k):
            step, *rest = real(*a, **k)
            made.append(step)
            fn = step.eager if mode == "eager" else step

            def recorded(train_state, batch, generator=None):
                out = fn(train_state, batch, generator)
                per_step.append(out)
                return out

            return (recorded, *rest)

        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        distill_mod.make_distill_step = making
        try:
            with deterministic_algorithms() as nondeterministic:
                (dstate, hist), _, wall = _counted(
                    state, f"distill shared pool, {mode} [{DISTILL_POOL_STEPS} steps a bucket, "
                    f"teacher stride {DISTILL_GATE_TEACHER_STRIDE}, deterministic algorithms]",
                    distill_main,
                    [*common, "--synthetic", str(images), "--checkpoint-dir",
                     os.path.join(work, f"pool_{mode}"), "--n-eval", str(DISTILL_N_EVAL),
                     "--teacher-stride", str(DISTILL_GATE_TEACHER_STRIDE)],
                    want, dict.fromkeys(_counts(), 0), failures)
        finally:
            distill_mod.make_distill_step = real
        peak = (f"{_gib(torch.cuda.max_memory_allocated() - base)} above the "
                f"{_gib(base)} allocated before" if card else "not measured (no card)")
        caches = {id(s.cache): s.cache for s in made}
        graphs = [g for c in caches.values() for g in c.graphs.values()]
        runs[mode] = {"loss": torch.stack([m["loss"] for m in per_step]),
                      "grad_norm": torch.stack([m["grad_norm"] for m in per_step]),
                      **{p: {k: v.clone() for k, v in getattr(dstate, p).items()}
                         for p in STATE_PARTS},
                      "val_psnr": hist["val_psnr"]}
        log(f"  {mode}: {len(per_step)} steps in {wall:.1f} s with the teacher's and "
            f"students' setup and one validation; peak device memory {peak}; "
            f"{len(made)} step functions, {len(caches)} cache(s), "
            f"{sum(c.captures for c in caches.values())} captures, replays "
            f"{[g.replays for g in graphs]}; ops without a deterministic CUDA kernel: "
            f"{sorted(nondeterministic) or 'none'}")
        # on the CPU nothing is captured
        replays = [DISTILL_POOL_STEPS - 1] * len(DISTILL_QUALITIES) if card else []
        if mode == "graph" and (len(made) != len(DISTILL_QUALITIES) or len(caches) != 1
                                or [g.replays for g in graphs] != replays):
            failures.append(f"distill shared pool: {len(made)} step functions, {len(caches)} "
                            f"caches, replays {[g.replays for g in graphs]}")
        if len(per_step) != steps:
            failures.append(f"distill shared pool, {mode}: {len(per_step)} steps of {steps}")
        del dstate, hist, made, caches, graphs, per_step
        if card:
            torch.cuda.empty_cache()
    diffs = {p: _diff(runs["graph"][p], runs["eager"][p]) for p in GATE_PARTS}
    log(f"  distill shared pool, graph against eager, max |diff| (bit for bit): {diffs}; "
        f"val_psnr {runs['graph']['val_psnr']} and {runs['eager']['val_psnr']}")
    if any(diffs.values()) or runs["graph"]["val_psnr"] != runs["eager"]["val_psnr"]:
        failures.append(f"distill shared pool: graph against eager {diffs}, val_psnr "
                        f"{runs['graph']['val_psnr']}, {runs['eager']['val_psnr']}")


def distill_alone(state: dict, train_state, teacher, failures: list) -> None:
    """The distill step alone (webp q50, full width, batch TRAIN_BATCH, EMA,
    the student's and the teacher's compute dtype) on one device batch:
      1. per solver remat on and off, one eager call (remat on: the step's
         first call, which runs eager; off: `step.eager`), timed: its
         launches against the schedule's (`distill_step_launches`), peak
         device memory, and the student's run and backward alone
         (`student_run_peak`);
      2. remat on: DISTILL_TIMED_EAGER warm eager calls (`step.eager`)
         timed, one more profiled, the step's second call (capture and
         replay), then DISTILL_TIMED_REPLAYS replays timed; peak device
         memory of the capture and replays (the graph's pool included)
         and one more replay profiled (device time, busy share). The
         flash kernels of the profiled eager call and of the profiled
         replay are counted in the device's trace (`flash_traced`: a
         replay runs no Python) and held to the schedule's; the
         wrappers' counts of the timed replays (the capture's count added
         per replay) are held to it too;
      3. the gates (`graph_gates`) from copies of the state, with the
         teacher at DISTILL_GATE_TEACHER_STRIDE over DISTILL_GATE_STEPS
         steps (depth cut for time): the graph in torch's default setting
         (remat on) and, under deterministic algorithms, remat on and off.
    The state is left as the timed steps leave it."""
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import TrainConfig
    from ddpm_image_restoration_tpu_torch.train.distill import DistillConfig, make_distill_step

    student = train_state.model
    dtype, dev = student.cfg.compute_dtype, student.out_conv.weight.device
    card = dev.type == "cuda"
    cfg = TrainConfig(codec="webp", model=student.cfg, batch_size=TRAIN_BATCH,
                      ema_decay=0.999, steps=DIFFUSION_STEPS)
    x0 = torch.from_numpy(synthetic_images(TRAIN_BATCH, student.cfg.image_size,
                                           SEED + 4)).to(dev)
    batch = {"x0": x0, "xt": codec_surrogate(x0, 50, codec="webp")}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dcfg = DistillConfig(n_eval=DISTILL_N_EVAL, teacher_stride=DISTILL_TEACHER_STRIDE)
    label = f"distill step alone ({dtype})"

    def counted(fn):
        torch.cuda.synchronize()
        _reset_counts()
        fn(train_state, batch, gen)
        torch.cuda.synchronize()
        return tuple(_counts().values())

    def peak() -> str:
        return _gib(torch.cuda.max_memory_allocated(dev)) if card else "not measured (no card)"

    for remat in (True, False):
        step, init_t, _, _ = make_distill_step(student, teacher, cfg, dcfg, 50, remat=remat)
        want = distill_step_launches(init_t, DISTILL_N_EVAL, DISTILL_TEACHER_STRIDE,
                                     recompute=int(remat))
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        counts = counted(step if remat else step.eager)  # a signature's first call: eager
        first_ms, eager_peak = 1e3 * (time.perf_counter() - t0), peak()
        log(f"{label} (webp q50: teacher {_evals(init_t, 0, DISTILL_TEACHER_STRIDE)} "
            f"evaluations, student {_evals(init_t, DISTILL_N_EVAL)}; full width, batch "
            f"{TRAIN_BATCH}, EMA), solver remat {remat}, eager: peak device memory "
            f"{eager_peak}; launches {counts} (schedule implies {want}); the student's "
            f"differentiated run and its backward alone: "
            f"{student_run_peak(student, batch['xt'], init_t, remat)}")
        if counts != want:
            failures.append(f"{label} (remat {remat}): launches {counts}, schedule implies "
                            f"{want}")
        if not remat:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISTILL_TIMED_EAGER):
            step.eager(train_state, batch, gen)
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t0) / DISTILL_TIMED_EAGER
        on_device = {"eager": flash_traced(
            f"one distill step, webp q50, batch {TRAIN_BATCH}, {dtype}, eager",
            lambda: step.eager(train_state, batch, gen), want)}
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        capture = counted(step)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        for _ in range(DISTILL_TIMED_REPLAYS):
            step(train_state, batch, gen)
        torch.cuda.synchronize()
        graph_ms = 1e3 * (time.perf_counter() - t0) / DISTILL_TIMED_REPLAYS
        replayed = tuple(_counts().values())
        graphs = list(step.cache.graphs.values())
        replays = graphs[0].replays if graphs else 0
        log(f"{label}: eager {eager_ms:.1f} ms/step ({TRAIN_BATCH * 1e3 / eager_ms:.1f} img/s) "
            f"over {DISTILL_TIMED_EAGER} warm calls (the first call {first_ms:.1f}), graph "
            f"{graph_ms:.1f} ms/step ({TRAIN_BATCH * 1e3 / graph_ms:.1f} img/s, "
            f"{eager_ms / graph_ms:.2f}x) over {DISTILL_TIMED_REPLAYS} replays; peak device "
            f"memory eager {eager_peak}, graph {peak()} (its capture and pool included); "
            f"{len(graphs)} graph(s), {replays} replays; launches of the capture {capture}, "
            f"wrapper counts of the {DISTILL_TIMED_REPLAYS} replays {replayed} (the capture's, "
            f"added per replay; the schedule implies {want} a step) on {state['smi']}")
        if capture != want or replayed != tuple(DISTILL_TIMED_REPLAYS * n for n in want):
            failures.append(f"{label}: launches {capture}, replays {replayed}, the schedule "
                            f"implies {want} a step")
        on_device["graph replayed"] = flash_traced(
            f"one distill step, webp q50, batch {TRAIN_BATCH}, {dtype}, graph replayed",
            lambda: step(train_state, batch, gen), want)
        if card:
            replays = graphs[0].replays if graphs else 0
            sessions = on_device["graph replayed"][1]
            if len(graphs) != 1 or replays != 1 + DISTILL_TIMED_REPLAYS + sessions:
                failures.append(f"{label}: {len(graphs)} graphs, {replays} replays")
            for call, (flash, sessions) in on_device.items():
                log(f"  {label}, one step {call}: flash kernels in the device's trace "
                    f"{by_wrapper(flash)} over {sessions} profiled call(s) (the schedule "
                    f"implies {want})")
                if by_wrapper(flash) != want:
                    failures.append(f"{label}, one step {call}: flash kernels in the device's "
                                    f"trace {dict(flash)}, the schedule implies {want}")
        del step, graphs

    gate_dcfg = DistillConfig(n_eval=DISTILL_N_EVAL, teacher_stride=DISTILL_GATE_TEACHER_STRIDE)
    runner = StepRuns(train_state, batch, gen, DISTILL_GATE_STEPS)
    for remat in (True, False):
        gate = f"{label}, remat {'on' if remat else 'off'}, teacher stride " \
               f"{DISTILL_GATE_TEACHER_STRIDE}"
        failures += [f"{gate}: {f}" for f in graph_gates(
            gate, runner, lambda remat=remat: make_distill_step(
                student, teacher, cfg, gate_dcfg, 50, remat=remat)[0], default_setting=remat)]


def student_run_peak(student, y, init_t: int, remat: bool) -> str:
    """Peak device memory above what was allocated before, of the student's
    solver run at DISTILL_N_EVAL evaluations under grad and the backward of
    a scalar of its output: the activations that the solver's
    rematerialisation trades for a recompute (the optimizer's temporaries,
    which set the whole step's peak, left out)."""
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.quality import student_stride
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler

    dev = y.device
    if dev.type != "cuda":
        return "not measured (no card)"
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = DDRMSampler(student, student.preset).run(
        y, 50, init_t, student_stride(init_t, DISTILL_N_EVAL), eta=0.0, remat=remat)[0]
    out.square().mean().backward()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    for p in student.parameters():
        p.grad = None
    return f"{peak / 2**30:.2f} GiB above the resident {base / 2**30:.2f} GiB"


def write_restore_inputs(inputs: str) -> tuple:
    """The restore phase's files, written by Pillow into `inputs`: 2 WebPs
    64² at each of RESTORE_QUALITIES, 2 JPEGs (q30, q70) and one
    TILE_SIZE_HW WebP at q30. Returns (webps, jpegs, wide)."""
    import numpy as np
    from PIL import Image

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
    return webps, jpegs, wide


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
        webps, jpegs, wide = write_restore_inputs(os.path.join(work, "in"))
        th, tw = TILE_SIZE_HW

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
        export_round_trip(state, ckpt_dir, webps, work, [*auto, *RESTORE_FLAGS],
                          sum(n + g for n, g in per_batch), totals, failures)
        state["launches_restore"] = totals
        if failures:
            raise AssertionError("; ".join(failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def export_round_trip(state: dict, ckpt_dir: str, webps: list, work: str, flags: list,
                      want_fwd: int, totals: dict, failures: list) -> None:
    """Phase `train`'s checkpoint through `cli/export.py` on the card: the
    EMA npz (the default) and the `--raw-params` one each hold that
    checkpoint's weights rounded once to fp16, as the port's
    `load_release_params` reads them and as the JAX package's reads them
    (its '/'-joined Flax names, f32: the checkpoint's weights in the JAX
    layout, `params_to_jax`); then `cli/restore.py --params-npz` restores
    the WebPs from the EMA npz with `want_fwd` forward launches."""
    import numpy as np
    import torch
    from PIL import Image

    from ddpm_image_restoration_tpu_torch.cli import export
    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_release_params,
        params_to_jax,
    )

    mgr = CheckpointManager(ckpt_dir)
    template = export.release_template(export.parse_args([ckpt_dir, "--out", "-",
                                                           *EXPORT_FLAGS]))
    npz = {}
    for which, extra in (("ema", []), ("raw", ["--raw-params"])):
        out = os.path.join(work, f"release_{which}.npz")
        t0 = time.perf_counter()
        _, printed = _quiet(export.main, [ckpt_dir, "--out", out, *EXPORT_FLAGS, *extra])
        wall = time.perf_counter() - t0
        weights, _ = mgr.restore_params(ema=which == "ema")
        rounded = {k: v.half().float() for k, v in weights.items()}
        got = load_release_params(out)
        port_ok = got.keys() == rounded.keys() and all(torch.equal(got[k], v)
                                                       for k, v in rounded.items())
        template.load_state_dict(rounded)
        want = params_to_jax(template)
        with np.load(out) as data:
            as_jax = {k: data[k].astype(np.float32) for k in data.files if not k.startswith("__")}
            npz[which] = as_jax
        jax_ok = as_jax.keys() == want.keys() and all(np.array_equal(as_jax[k], v)
                                                      for k, v in want.items())
        log(f"export [{which}]: {wall:.1f} s; {printed.strip().splitlines()[-1][:160]}; "
            f"the port's reader gives the checkpoint's {which} weights in fp16: {port_ok}; "
            f"in the JAX package's layout: {jax_ok}")
        if not (port_ok and jax_ok):
            failures.append(f"export [{which}]: the npz does not hold the checkpoint's weights "
                            f"(port reader {port_ok}, JAX layout {jax_ok})")
    if all(np.array_equal(npz["ema"][k], v) for k, v in npz["raw"].items()):
        failures.append("export: the EMA npz equals the raw one")
    out_dir = os.path.join(work, "out_npz")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    _, printed = _quiet(restore_main, [*webps, *flags, "--params-npz",
                                       os.path.join(work, "release_ema.npz"),
                                       "--output-dir", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for k, v in counts.items():
        totals[k] += v
    log(f"restore [exported EMA npz]: {len(webps)} file(s), {1e3 * wall / len(webps):.1f} "
        f"ms/image on {state['smi']}; launches {counts} (schedule implies {want_fwd} forward)")
    if counts != {fa.KERNEL: want_fwd, "flash_attention_bwd_dq": 0,
                  "flash_attention_bwd_dkv": 0}:
        failures.append(f"restore [exported EMA npz]: launches {counts}, schedule implies "
                        f"{want_fwd}")
    for f in webps:
        png = os.path.join(out_dir, os.path.splitext(os.path.basename(f))[0] + "_restored.png")
        shape = np.asarray(Image.open(png)).shape if os.path.exists(png) else None
        if shape != (64, 64, 3):
            failures.append(f"restore [exported EMA npz]: {png} has shape {shape}")


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
         up4; validation at 20/50/80 from init_t 75/50/20 at stride 1, and
         the restoration grid at q20); then its data pipeline alone
         (`loader_alone`) and its step alone (`step_alone`);
      2. `cli/evaluate.py --codec avif` on that checkpoint's EMA,
         AVIF_EVAL_IMAGES images at AVIF_QUALITIES under the AVIF policy;
      3. `cli/restore.py --model-codec avif` on AVIF files Pillow writes
         (quality estimated from the bitstream), from the same EMA;
      4. `cli/train.py --codec all`: two steps on mixed-codec batches of 18,
         validated once per codec at its middle val quality, and the
         restoration grid of the WebP sampler at q10.
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
        return _counted(state, f"avif [{label}]", fn, argv, want, totals, failures)

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
            (2 * steps + 2 * n_val + 2 * grid_restore_evals(avif, DIFFUSION_STEPS), 2 * steps,
             2 * steps))
        m = tstate.model
        grads = {n: getattr(m, lvl).attn.qkv.weight.grad for n, lvl in
                 (("down2 qkv", "down2"), ("up4 qkv", "up4"))}
        grads["down2 transform"] = m.down2.freq_guide.adaptive_transform.transform_weights.grad
        log(f"  heads {m.down2.attn.num_heads}; loss {hist['loss'][-1]:.4f}, val_psnr "
            f"{hist['val_psnr'][-1]:.3f}, val_ssim {hist['val_ssim'][-1]:.4f}, "
            f"{hist['step_ms'][-1]:.1f} ms/step in the loop (over the {steps - 2} steps after 2 "
            f"warm-up steps), epoch {hist['epoch_time'][-1]:.1f} s; "
            f"{steps} steps, {n_val} validation evaluations; |grad| max "
            + ", ".join(f"{k} {g.abs().max().item():.3g}" for k, g in grads.items()))
        if not (tstate.step == steps and np.isfinite(hist["loss"]).all()
                and np.isfinite(hist["val_psnr"]).all()):
            failures.append(f"avif train: step {tstate.step} of {steps}, history {dict(hist)}")
        if any(g is None or not torch.isfinite(g).all() or g.abs().max().item() == 0
               for g in grads.values()):
            failures.append("avif train: a flash level or the adaptive transform got no gradient")
        loader_alone(state, "avif", AVIF_TRAIN_IMAGES, avif.batch_size, hist["step_ms"])
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
            (2 * all_steps + 2 * n_val
             + 2 * grid_restore_evals(get_preset("webp"), DIFFUSION_STEPS),
             2 * all_steps, 2 * all_steps))
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


# The parallel phase: (a) the data mesh at world size 1 under NCCL in this
# process, (b) PARALLEL_WORLD processes sharing the card over gloo (NCCL
# refuses two ranks on one device). PARALLEL_SCALE divides the widths of
# (b)'s half-width f32 checks; PARALLEL_MEMORY_SCALE those of the
# full-width bf16 models of (a)'s train steps and (b)'s memory readings.
PARALLEL_WORLD = 2
PARALLEL_BACKEND = "nccl"
PARALLEL_SCALE = 2
PARALLEL_MEMORY_SCALE = 1
PARALLEL_PER_RANK = 2          # (b)'s full-width steps: images per rank
PARALLEL_TIMED_STEPS = 2
PARALLEL_CHILD_TIMEOUT_S = 300


def _gib(n_bytes: float) -> str:
    return f"{n_bytes / 2**30:.3f} GiB"


def _peak_since(dev, base: int) -> int | None:
    """Peak device bytes allocated above `base` since the last reset (None
    off the card)."""
    import torch

    return torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else None


def diff_stats(got: dict, want: dict, atol: float) -> tuple:
    """(largest |got - want| over the tensors of `want`, the share of
    entries within `atol`)."""
    diffs = [(got[k].float().cpu() - v.float().cpu()).abs() for k, v in want.items()]
    return (max(d.max().item() for d in diffs),
            sum(int((d <= atol).sum()) for d in diffs) / sum(d.numel() for d in diffs))


def parallel_world1(state: dict, work: str, failures: list) -> None:
    """Part (a), in this process under a world-1 process group: the restore
    and serve CLIs with `--dp -1` against the same calls without it, in
    turns (plain, --dp, --dp, plain): the same PNGs and the same launches,
    and each call's ms/image; then the train steps
    (`parallel_train_world1`)."""
    import shutil

    import numpy as np
    from PIL import Image

    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.cli.serve import main as serve_main

    webps, _, _ = write_restore_inputs(os.path.join(work, "in"))
    n, g = static_schedule(30, "webp", *restore_budget())
    n_s, g_s = static_schedule(30, "webp")
    batches = -(-len(webps) // SERVE_BATCH)
    totals = dict.fromkeys(_counts(), 0)
    turns = [[], ["--dp", "-1"], ["--dp", "-1"], []]
    for cli, fn, want, what in (
            ("restore", restore_main, n + g, "one batch"),
            ("serve", serve_main, batches * (n_s + g_s),
             f"batches of {SERVE_BATCH}, production policy")):
        outs = []
        for i, dp in enumerate(turns):
            out_dir = os.path.join(work, f"{cli}_{i}")
            if cli == "restore":
                argv = [*webps, *RESTORE_FLAGS, "--quality", "30"]
            else:
                watch = out_dir + "_in"
                os.makedirs(watch)
                for f in webps:
                    shutil.copy(f, watch)
                argv = ["--watch", watch, *CARD_FLAGS, "--quality", "30", "--solver", "auto",
                        "--batch-size", str(SERVE_BATCH), "--once"]
            _, _, wall = _counted(state, f"{cli}{' --dp -1' if dp else ''} ({len(webps)} "
                                  f"WebPs, q30, {what})", fn,
                                  [*argv, "--random-init", "--output-dir", out_dir, *dp],
                                  (want, 0, 0), totals, failures)
            log(f"  {1e3 * wall / len(webps):.1f} ms/image")
            outs.append(out_dir)
        for f in webps:
            name = os.path.splitext(os.path.basename(f))[0] + "_restored.png"
            imgs = [np.asarray(Image.open(os.path.join(d, name)), np.int16) for d in outs]
            if not all(np.array_equal(imgs[0], b) for b in imgs[1:]):
                failures.append(f"{cli}: the --dp -1 calls' {name} differs from the plain "
                                "calls'")
    log(f"--dp -1 at world 1 wrote the same {len(webps)} PNGs as the plain CLIs: "
        f"{not any('differs' in f for f in failures)}")
    parallel_train_world1(state, failures, totals)
    state["launches_parallel"] = totals


def parallel_train_world1(state: dict, failures: list, totals: dict) -> None:
    """(a)'s train steps: the full-width bf16 WebP step (batch 18, EMA) plain
    (twice), under the data mesh and under FSDP (which splits nothing at
    world 1: the JAX rule needs 2 ranks), each from the same weights on the
    same batch with the same dropout generator. Each state's peak memory
    while it is built and takes its first step, above what the process held
    before; then ms/step over PARALLEL_TIMED_STEPS steps each, in turns,
    the plain step eager (`train_step.eager`, as the meshes run: its
    captured graph is timed by `step_alone`).

    Bound: at world 1 the mean over the mesh is the step's own gradient, so
    the loss must agree to rel 1e-6 (the forward is the same), and the
    masters after one step within 2·lr·1.01 of the first plain step's
    everywhere and within 1e-6 on at least 90% of entries: the bf16
    backward (atomic adds in the upsample backward) is not bitwise
    repeatable, and Adam's first step moves an entry by ~lr·sign(g), so a
    near-zero gradient that rounds to the other sign moves it by 2·lr (the
    bound of the bf16 step against the JAX package, tests/
    test_torch_trainer.py). The second plain step shows that spread."""
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.parallel.mesh import make_mesh, put_state
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    model_cfg = ModelConfig(attention_impl="flash", attn_max_resolution=32).scaled(
        PARALLEL_MEMORY_SCALE)
    cfg = TrainConfig(codec="webp", model=model_cfg, batch_size=TRAIN_BATCH, ema_decay=0.999)
    dev = torch.device("cuda") if PARALLEL_BACKEND == "nccl" else torch.device("cpu")
    x0 = torch.from_numpy(synthetic_images(TRAIN_BATCH, 64, SEED + 4))
    t = torch.randint(1, 100, (TRAIN_BATCH,), generator=torch.Generator().manual_seed(SEED))
    batch = {"x0": x0.to(dev), "xt": codec_surrogate(x0, 30, codec="webp").to(dev),
             "t": t.to(dev)}
    mesh = make_mesh((-1,), ("data",))
    lr = cfg.preset.lr
    want = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    runs = {}
    for mode in ("plain", "plain again", "data mesh", "fsdp"):
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            model = build_model("webp", model_cfg, device="cpu").to(dev)
        st = create_train_state(model, cfg)
        if mode in ("data mesh", "fsdp"):
            st = put_state(st, mesh, fsdp=mode == "fsdp")
        step = make_train_step(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        _reset_counts()
        loss = step(st, batch, gen)["loss"].item()
        sync()
        counts = _counts()
        for k, v in counts.items():
            totals[k] += v
        if counts != want:
            failures.append(f"train step ({mode}): launches {counts}, schedule implies {want}")
        runs[mode] = {"loss": loss, "step": step, "state": st, "gen": gen, "ms": [],
                      "masters": {k: v.detach().cpu().clone() for k, v in st.params.items()},
                      "peak": _peak_since(dev, base), "counts": counts,
                      "split": 0 if st.layout is None else len(st.layout.sharded)}
    order = ["plain", "data mesh", "fsdp", "fsdp", "data mesh", "plain"]
    for mode in order:
        r = runs[mode]
        sync()
        t0 = time.perf_counter()
        timed = r["step"].eager if mode == "plain" else r["step"]
        for _ in range(PARALLEL_TIMED_STEPS):
            timed(r["state"], batch, r["gen"])
        sync()
        r["ms"].append(1e3 * (time.perf_counter() - t0) / PARALLEL_TIMED_STEPS)
    for mode in ("plain", "data mesh", "fsdp"):
        r = runs[mode]
        peak = "not measured" if r["peak"] is None else _gib(r["peak"])
        log(f"train step ({mode}, world 1, full width/{PARALLEL_MEMORY_SCALE}, bf16, batch "
            f"{TRAIN_BATCH}, EMA): {' and '.join(f'{ms:.1f}' for ms in r['ms'])} ms/step over "
            f"{PARALLEL_TIMED_STEPS} steps in turns {order}; peak memory {peak} while built "
            f"and stepped once, on {state['smi']}; first-step launches {r['counts']}; "
            f"parameters split {r['split']}")
    p_loss, p_masters = runs["plain"]["loss"], runs["plain"]["masters"]
    for mode in ("plain again", "data mesh", "fsdp"):
        r = runs[mode]
        rel = abs(r["loss"] - p_loss) / abs(p_loss)
        worst, close = diff_stats(r["masters"], p_masters, 1e-6)
        log(f"train step ({mode}) against the plain step: loss rel {rel:.3g} (bound 1e-6); "
            f"masters max |diff| {worst:.3g} (bound {2 * lr * 1.01:.3g}), "
            f"{100 * close:.2f}% within 1e-6 (bound 90%)")
        if not (rel <= 1e-6 and worst <= 2 * lr * 1.01 and close >= 0.9):
            failures.append(f"train step ({mode}) at world 1 disagrees with the plain step")
    runs.clear()


def parallel_child(rank: int, world: int, work: str, store: str | None = None,
                   device: str = "cuda", scale: int = PARALLEL_SCALE,
                   memory_scale: int = PARALLEL_MEMORY_SCALE, backend: str = "gloo",
                   per_rank: int = PARALLEL_PER_RANK) -> dict:
    """Part (b), one rank of `world` (even; sharing the card over gloo on the
    FileStore `store`, or under `torchrun` with its own card, `store` None,
    over NCCL), its files under `work`: the half-width (widths/`scale`) f32
    WebP step with dropout and EMA under the data mesh, under FSDP and on a
    (world/2, 2) ('data', 'model') mesh, each against the one-process step
    on the card on the whole batch of 4; a data-parallel and a
    spatial-parallel (`shard_inference_spatial` over every rank) restore at
    eta 0.85 of an odd batch against the one-process restore; the dry run;
    `cli/restore.py --dp -1` and `--sp -1` against the call on one rank
    (`parallel_restore_cli`); then the bf16 step at widths/`memory_scale`,
    `per_rank` images a rank, on this rank's card alone, under the data
    mesh and FSDP, and on the ('data', 'model') mesh at the preset's batch
    (TRAIN_BATCH): its state, resident and peak memory, ms/step and
    first-step launches. Returns what it measured and its failures.

    The model axis is held to the train gates (loss and grad norm rtol
    1e-4, the gradient averaged over the data axis within 1e-4 of the
    largest one-process entry), its masters logged; the spatial restore to
    phase `reference`'s gate (mean |diff| <= 1e-4), its max logged, and its
    launches to the one-process schedule (the attention runs on the
    gathered tokens, replicated).

    Gates of the f32 steps: loss and grad norm rel 1e-5, and the gradient
    averaged over the ranks within 1e-5 of the largest one-process entry
    (sums in another order); the masters and the EMA after the step within
    2·lr·1.01 everywhere and within 1e-5 on at least 99.9% of entries. Not
    1e-5 everywhere, as on the CPU (tests/test_torch_parallel.py): the
    card's f32 backward is not bitwise repeatable (atomic adds), and Adam's
    first step divides each gradient by its own magnitude plus 1e-8, so an
    entry whose gradient is near 1e-8 moves further for a last-bit change
    (one master entry read 1.07e-5 in a run whose gradients agreed to
    rounding). The one-process step made twice shows the card's own spread
    beside them. The restore as the card-against-CPU restore of phase
    `reference` (mean |diff| <= 1e-4, max <= 2e-2): the batch sizes differ,
    so cuDNN may sum in other orders, and the surrogate can move one
    coefficient by a quantisation step for a last-bit difference."""
    import gc

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig, get_preset
    from ddpm_image_restoration_tpu_torch.device import resolve_device
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler, _solver_indices
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.parallel.dryrun import dryrun
    from ddpm_image_restoration_tpu_torch.parallel.mesh import (
        gather_batch,
        init_distributed,
        make_mesh,
        put_state,
        shard_batch,
        shard_inference,
        shard_inference_spatial,
    )
    from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

    if store is None:  # torchrun's environment
        init_distributed(device, backend=backend)
    else:
        init_distributed(device, backend=backend, init_method=f"file://{store}",
                         world_size=world, rank=rank)
    dev = resolve_device(device)
    mesh = make_mesh((-1,), ("data",))
    tp_shape = (world // 2, 2)
    tp_mesh = make_mesh(tp_shape, ("data", "model"))
    sp_mesh = make_mesh((-1,), ("spatial",))
    failures, out = [], {"rank": rank}

    def say(msg):
        log(f"[rank {rank}] {msg}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model_cfg = ModelConfig(compute_dtype="float32", attention_impl="flash",
                            attn_max_resolution=32).scaled(scale)
    cfg = TrainConfig(codec="webp", model=model_cfg, batch_size=4, ema_decay=0.999)
    lr = cfg.preset.lr
    x0 = torch.from_numpy(synthetic_images(4, 64, SEED + 3))
    batch = {"x0": x0, "xt": codec_surrogate(x0, 20, codec="webp"),
             "t": torch.tensor([10, 35, 60, 90], dtype=torch.int32)}

    def model_on_card():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            return build_model("webp", model_cfg, device="cpu").to(dev)

    def train(mode):
        model = model_on_card()
        st = create_train_state(model, cfg)
        m_mesh = tp_mesh if mode == "model axis" else mesh
        if mode in ("data mesh", "fsdp", "model axis"):
            st = put_state(st, m_mesh, fsdp=mode == "fsdp")
        mine = batch if st.layout is None else {k: shard_batch(v, m_mesh)
                                                for k, v in batch.items()}
        _reset_counts()
        m = make_train_step(model, cfg)(st, {k: v.to(dev) for k, v in mine.items()},
                                        torch.Generator(device=dev).manual_seed(SEED + 1))
        sync()
        counts = _counts()
        held, split_ok = {}, True
        if st.layout is not None:
            for k in st.layout.sharded:
                held[k] = [getattr(st, d)[k].numel() for d in ("params", "mu", "nu", "ema")]
                s = st.layout.splits[k]
                parts = (st.layout.m if s.model is not None else 1) * (
                    st.layout.n if s.data is not None else 1)
                split_ok = split_ok and held[k] == [st.layout.shapes[k].numel() // parts] * 4
            # the gradient averaged over the data axis, in the one-process layout
            grads = st.layout.full(st.layout.reduce_grads(model))
        else:
            grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()}
        return (m["loss"].item(), m["grad_norm"].item(), st.state_dict(), grads, counts, held,
                split_ok)

    with no_tf32():
        one = train("one process")
        full = {k: v.numel() for k, v in one[2]["params"].items()}
        g_max = max(g.abs().max().item() for g in one[3].values())
        for mode in ("one process again", "data mesh", "fsdp", "model axis"):
            loss, norm, sd, grads, counts, held, split_ok = train(mode)
            rel = abs(loss - one[0]) / abs(one[0])
            rel_n = abs(norm - one[1]) / abs(one[1])
            g_rel = diff_stats(grads, one[3], 0.0)[0] / g_max
            worst, close = diff_stats(sd["params"], one[2]["params"], 1e-5)
            e_worst, e_close = diff_stats(sd["ema"], one[2]["ema"], 1e-5)
            # the 'model' axis is held to the train gates (loss rtol 1e-4,
            # gradients within 1e-4 of the largest); its masters are logged
            bound = 1e-4 if mode == "model axis" else 1e-5
            images = 4 if mode.startswith("one") else 4 // (
                tp_shape[0] if mode == "model axis" else world)
            say(f"{mode} step (widths/{scale}, f32, dropout 0.1, EMA, "
                f"{images} of 4 images{f', mesh {tp_shape}' if mode == 'model axis' else ''})"
                f" against the one-process card step: loss rel {rel:.3g}, grad norm rel "
                f"{rel_n:.3g} (bound {bound:g}); gradient |diff|/max|g| {g_rel:.3g} (bound "
                f"{bound:g}); masters max |diff| {worst:.3g} (bound {2 * lr * 1.01:.3g}), "
                f"{100 * close:.3f}% within 1e-5 (bound 99.9%); EMA {e_worst:.3g}, "
                f"{100 * e_close:.3f}%; parameters split {len(held)}, each rank its blocks: "
                f"{split_ok}; launches {counts}")
            out[f"{mode} step"] = {"loss_rel": rel, "grad_norm_rel": rel_n, "grad_rel": g_rel,
                                   "masters_max_diff": worst, "masters_within_1e-5": close,
                                   "launches": counts, "split": len(held)}
            if mode.startswith("one"):
                continue
            if mode == "model axis":
                if not (rel <= 1e-4 and rel_n <= 1e-4 and g_rel <= 1e-4 and split_ok):
                    failures.append(f"{mode} step disagrees with the one-process step")
                if not held:
                    failures.append("the model axis split no parameter")
            elif not (rel <= 1e-5 and rel_n <= 1e-5 and g_rel <= 1e-5
                      and max(worst, e_worst) <= 2 * lr * 1.01
                      and min(close, e_close) >= 0.999 and split_ok):
                failures.append(f"{mode} step disagrees with the one-process step")
            if mode == "fsdp" and not held:
                failures.append("fsdp split no parameter")
            if counts != {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                          "flash_attention_bwd_dkv": 2}:
                failures.append(f"{mode} step launched {counts}")

        model = model_on_card()
        preset = get_preset("webp")
        init_t = init_timestep_for_quality(30, 100, preset)
        evals = len(_solver_indices(init_t, 10))
        y5 = torch.from_numpy(synthetic_images(5, 64, SEED + 5))
        y5 = codec_surrogate(y5, 30, codec="webp").to(dev)
        sampler = DDRMSampler(model, preset)

        def restore(rows):
            return sampler.sample(y5, 30, init_t, stride=10, eta=0.85, rows=rows,
                                  final_exact=False,
                                  generator=torch.Generator(device=dev).manual_seed(SEED))

        want = restore(None)
        rows = shard_inference(model, len(y5), mesh)
        _reset_counts()
        got = gather_batch(restore(rows), mesh, len(y5))
        sync()
        counts = _counts()
        diff = (got - want).abs()
        say(f"data-parallel restore (eta 0.85, 5 images, rows {rows}, {evals} evaluations) "
            f"against the one-process card restore: max |diff| {diff.max().item():.3g} "
            f"(bound 2e-2), mean {diff.mean().item():.3g} (bound 1e-4); launches {counts} "
            f"(schedule implies {FLASH_PER_EVAL * evals} forward)")
        out["restore"] = {"max_diff": diff.max().item(), "mean_diff": diff.mean().item(),
                          "launches": counts}
        if not (torch.isfinite(got).all() and diff.mean().item() <= 1e-4
                and diff.max().item() <= 2e-2):
            failures.append("the data-parallel restore disagrees with the one-process one")
        if counts != {"flash_attention_fwd": FLASH_PER_EVAL * evals,
                      "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}:
            failures.append(f"the data-parallel restore launched {counts}")

        # the same restore with each image's height split over every rank
        sp_model = shard_inference_spatial(model_on_card(), sp_mesh)
        sp_sampler = DDRMSampler(sp_model, preset)
        _reset_counts()
        got = sp_sampler.sample(y5, 30, init_t, stride=10, eta=0.85, final_exact=False,
                                generator=torch.Generator(device=dev).manual_seed(SEED))
        sync()
        counts = _counts()
        diff = (got - want).abs()
        plan = [lvl is not None for lvl in sp_model.spatial_levels(y5.shape[1])]
        say(f"spatial-parallel restore (--sp over {world} ranks, eta 0.85, 5 images, "
            f"{evals} evaluations, levels split {plan}) against the one-process card "
            f"restore: mean |diff| {diff.mean().item():.3g} (bound 1e-4), max "
            f"{diff.max().item():.3g}; launches {counts} (schedule implies "
            f"{FLASH_PER_EVAL * evals} forward, the attention on the gathered tokens)")
        out["sp restore"] = {"max_diff": diff.max().item(), "mean_diff": diff.mean().item(),
                             "launches": counts}
        if not (torch.isfinite(got).all() and diff.mean().item() <= 1e-4 and any(plan)):
            failures.append("the spatial-parallel restore disagrees with the one-process one")
        if counts != {"flash_attention_fwd": FLASH_PER_EVAL * evals,
                      "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}:
            failures.append(f"the spatial-parallel restore launched {counts}")
        del model, sampler, sp_model, sp_sampler

    dr = dryrun(device)
    say(f"dryrun: FSDP step over {dr['world']} ranks (mesh {dr['mesh']}), loss "
        f"{dr['loss']:.6f}; restore {dr['restored_shape']}, spatial restore "
        f"{dr['sp_restored_shape']}")
    out["dryrun"] = dr
    out["restore cli"] = parallel_restore_cli(rank, world, work, dev, failures)

    mem_cfg = ModelConfig(attention_impl="flash", attn_max_resolution=32).scaled(memory_scale)
    n_mem = per_rank * world
    mcfg = TrainConfig(codec="webp", model=mem_cfg, batch_size=n_mem, ema_decay=0.999)
    xm = torch.from_numpy(synthetic_images(n_mem, 64, SEED + 6))
    mbatch = {"x0": xm, "xt": codec_surrogate(xm, 30, codec="webp"),
              "t": torch.randint(1, 100, (n_mem,), generator=torch.Generator().manual_seed(SEED))}
    mine = {k: shard_batch(v, mesh).to(dev) for k, v in mbatch.items()}
    # the 'model' axis at the preset's batch: every model rank of a data rank
    # takes that data rank's images
    tcfg = TrainConfig(codec="webp", model=mem_cfg, batch_size=TRAIN_BATCH, ema_decay=0.999)
    xt = torch.from_numpy(synthetic_images(TRAIN_BATCH, 64, SEED + 6))
    tbatch = {"x0": xt, "xt": codec_surrogate(xt, 30, codec="webp"),
              "t": torch.randint(1, 100, (TRAIN_BATCH,),
                                 generator=torch.Generator().manual_seed(SEED))}
    tmine = {k: shard_batch(v, tp_mesh).to(dev) for k, v in tbatch.items()}
    link = ("gloo through host memory (not a measure of NCCL)" if backend == "gloo"
            else backend)
    for mode in ("one card", "data mesh", "fsdp", "model axis"):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            model = build_model("webp", mem_cfg, device="cpu").to(dev)
        tp = mode == "model axis"
        st = create_train_state(model, tcfg if tp else mcfg)
        if mode != "one card":
            st = put_state(st, tp_mesh if tp else mesh, fsdp=mode == "fsdp")
        step = make_train_step(model, tcfg if tp else mcfg)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        _reset_counts()
        loss = step(st, tmine if tp else mine, gen)["loss"].item()
        sync()
        counts = _counts()
        peak = _peak_since(dev, base)
        resident = (torch.cuda.memory_allocated(dev) - base) if dev.type == "cuda" else None
        t0 = time.perf_counter()
        for _ in range(PARALLEL_TIMED_STEPS):
            step(st, tmine if tp else mine, gen)
        sync()
        ms = 1e3 * (time.perf_counter() - t0) / PARALLEL_TIMED_STEPS
        state_bytes = 4 * sum(v.numel() for d in (st.params, st.mu, st.nu, st.ema)
                              for v in d.values())
        what = (f"mesh {tp_shape}, batch {TRAIN_BATCH}, {TRAIN_BATCH // tp_shape[0]} images per "
                "data rank" if tp else f"{per_rank} images per rank")
        say(f"{mode} (full width/{memory_scale}, bf16, EMA, {what}): f32 state "
            f"{_gib(state_bytes)} held by this rank; resident after a step "
            f"{'not measured' if resident is None else _gib(resident)}, peak "
            f"{'not measured' if peak is None else _gib(peak)}; {ms:.1f} ms/step over "
            f"{PARALLEL_TIMED_STEPS} steps" + ("" if mode == "one card" else f" with {link}")
            + f"; loss {loss:.5f}; first-step launches {counts}")
        out[f"{mode} memory"] = {"state_bytes": state_bytes, "resident_bytes": resident,
                                 "peak_bytes": peak, "ms_per_step": ms, "launches": counts}
        if not np.isfinite(loss):
            failures.append(f"memory run ({mode}): non-finite loss")
        if counts != {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                      "flash_attention_bwd_dkv": 2}:
            failures.append(f"memory run ({mode}) launched {counts}, the one-process step 2 "
                            "of each")
        del model, st, step
    dm, fs, ma = out["data mesh memory"], out["fsdp memory"], out["model axis memory"]
    if not fs["state_bytes"] < 0.75 * dm["state_bytes"]:
        failures.append(f"fsdp holds {fs['state_bytes']} bytes of state, the data mesh "
                        f"{dm['state_bytes']}")
    if not ma["state_bytes"] < 0.75 * out["one card memory"]["state_bytes"]:
        failures.append(f"the model axis holds {ma['state_bytes']} bytes of state, one card "
                        f"{out['one card memory']['state_bytes']}")
    out["failures"] = failures
    for f in failures:
        say(f"FAILED: {f}")
    return out


def parallel_restore_cli(rank: int, world: int, work: str, dev, failures: list) -> dict:
    """`cli/restore.py` at full width on the restore phase's WebPs (q30,
    one batch), in turns: on one rank (plain), with `--dp -1` over every
    rank (twice), with `--sp -1` over every rank (twice: each image's
    height split), on one rank again; every rank calls each, rank 0 reads
    and writes the files. Each rank must launch the forward as one batch's
    schedule implies (each rank runs every evaluation on its rows, or under
    `--sp` on the gathered tokens of all rows; ranks past 0 launch nothing
    in the one-rank calls). The `--sp -1` PNGs are logged against the plain
    ones (bf16 convolutions on row blocks sum in other orders, and the exact
    projection turns last bits into visible changes on random weights).

    Rank 0 then restores the same batch on its own card through the
    sampler as the CLI calls it, whole and in the ranks' row blocks: the
    whole batch must give the plain calls' PNGs and the row blocks the
    `--dp -1` calls' PNGs, bit for bit. The `--dp -1` PNGs are held to the
    row blocks and not to the whole batch: a block of fewer images runs
    cuDNN's bf16 convolutions with other algorithms, and on random weights
    the solver and the exact WebP projection turn those last bits into
    visible changes (on four cards, 2 images a rank against 8: ~8 of 255
    on average); the log gives that difference."""
    import numpy as np

    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.parallel.mesh import barrier, make_mesh

    inputs = os.path.join(work, "restore_in")
    if rank == 0:
        webps = write_restore_inputs(inputs)[0]
    else:  # the same names; only rank 0 reads them
        webps = [os.path.join(inputs, f"w{i}_q{int(q)}.webp")
                 for i, q in enumerate(np.repeat(RESTORE_QUALITIES, 2))]
    n, g = static_schedule(30, "webp", *restore_budget())
    name = torch_device_name(dev)
    totals = dict.fromkeys(_counts(), 0)
    outs = []
    turns = [[], ["--dp", "-1"], ["--dp", "-1"], ["--sp", "-1"], ["--sp", "-1"], []]
    for i, dp in enumerate(turns):
        out_dir = os.path.join(work, f"restore_cli_{i}")
        label = (f"[rank {rank}] restore{' ' + ' '.join(dp) if dp else ''} ({len(webps)} "
                 f"WebPs, q30, one batch{f' over {world} ranks' if dp else ''})")
        _, _, wall = _counted({"smi": name}, label, restore_main,
                              [*webps, *RESTORE_FLAGS, "--quality", "30", "--random-init",
                               "--output-dir", out_dir, *dp],
                              (n + g if dp or rank == 0 else 0, 0, 0), totals, failures)
        log(f"[rank {rank}]   {1e3 * wall / len(webps):.1f} ms/image")
        outs.append(out_dir)
    barrier(make_mesh())
    if rank != 0:
        return {"launches": totals}
    from PIL import Image

    pngs = [np.stack([np.asarray(Image.open(os.path.join(d, os.path.splitext(
        os.path.basename(f))[0] + "_restored.png")), np.int16) for f in webps]) for d in outs]
    plain, dp = restore_cli_on_one_card(webps, dev, world)
    ok = {"plain calls = whole batch": all(np.array_equal(plain, pngs[i]) for i in (0, 5)),
          "--dp -1 calls = row blocks": all(np.array_equal(dp, pngs[i]) for i in (1, 2))}
    diff, sp_diff = np.abs(pngs[1] - pngs[0]), np.abs(pngs[3] - pngs[0])
    log(f"[rank 0] restore on one card through the sampler, PNGs bit for bit: {ok}; the "
        f"--dp -1 PNGs against the plain ones: max {diff.max()}, mean {diff.mean():.3f} of "
        f"255, {100 * np.mean(diff > 0):.2f}% of pixels differ; the --sp -1 PNGs: max "
        f"{sp_diff.max()}, mean {sp_diff.mean():.3f}, {100 * np.mean(sp_diff > 0):.2f}%; the "
        f"two --sp -1 calls alike: {np.array_equal(pngs[3], pngs[4])}")
    if not all(ok.values()):
        failures.append(f"restore --dp -1: the PNGs are not what one card computes: {ok}")
    return {"launches": totals, **ok, "dp_vs_plain_mean_diff": float(diff.mean()),
            "sp_vs_plain_mean_diff": float(sp_diff.mean())}


def restore_cli_on_one_card(webps: list, dev, world: int) -> tuple:
    """What `cli/restore.py` with RESTORE_FLAGS, `--quality 30
    --random-init` computes for `webps` as one batch (uint8 HWC PNG pixels),
    whole and as the `world` ranks' row blocks (`--dp -1`), on `dev`."""
    import argparse

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.common import (
        add_model_flags,
        load_image,
        model_config_from,
    )
    from ddpm_image_restoration_tpu_torch.codecs.quality import (
        init_timestep_for_quality,
        student_stride,
    )
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
    from ddpm_image_restoration_tpu_torch.diffusion.ensemble import sample_ensemble
    from ddpm_image_restoration_tpu_torch.models import build_model

    ap = argparse.ArgumentParser()
    add_model_flags(ap)
    flags, _ = ap.parse_known_args(RESTORE_FLAGS)
    max_evals, reuse = restore_budget()
    cfg = model_config_from(flags)
    torch.manual_seed(0)  # --random-init
    model = build_model("webp", cfg, device=dev)
    sampler = DDRMSampler(model, get_preset("webp"))
    init_t = init_timestep_for_quality(30, 100, sampler.preset)
    y = torch.as_tensor(np.stack([load_image(p, cfg.image_size) for p in webps]), device=dev)
    per = -(-len(webps) // world)

    def restore(rows):
        return sample_ensemble(sampler, y, 30, init_t, n_transforms=1,
                               stride=student_stride(init_t, max_evals), encoder_reuse=reuse,
                               generator=torch.Generator(device=dev).manual_seed(0),
                               rows=rows).cpu().numpy()

    blocks = np.concatenate([restore((k * per, (k + 1) * per)) for k in range(world)])
    return tuple(np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8).astype(np.int16)
                 for x in (restore(None), blocks[:len(webps)]))


def torch_device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"


def run_parallel_children(state: dict, work: str) -> list:
    """Start PARALLEL_WORLD processes of this script (`--parallel-child`),
    wait for them, and return their results; a child that fails, hangs past
    PARALLEL_CHILD_TIMEOUT_S or writes no result fails the phase (each child
    is stopped before this returns)."""
    outs = [os.path.join(work, f"child_{r}.json") for r in range(PARALLEL_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-child",
                               str(r), str(PARALLEL_WORLD), work, outs[r]])
             for r in range(PARALLEL_WORLD)]
    deadline = time.monotonic() + PARALLEL_CHILD_TIMEOUT_S
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"parallel children exited with {codes}")
    if any(c != 0 for c in codes):
        raise AssertionError(f"a parallel child failed: exit codes {codes}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def child_main(argv: list) -> int:
    """One rank of part (b); writes its results as JSON; exit 1 on a failure.

        chip_smoke.py --parallel-child RANK WORLD WORK OUT  (gloo, one card)
        torchrun --nproc-per-node N chip_smoke.py --parallel-child-nccl OUTDIR

    The second runs part (b) over NCCL, one card a rank, with 18 images a
    rank in the full-width steps (the preset's batch on each card); OUTDIR
    gets child_<rank>.json."""
    import torch

    if argv[0] == "--parallel-child-nccl":
        rank, world, work = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), argv[1]
        os.makedirs(work, exist_ok=True)
        out_path = os.path.join(work, f"child_{rank}.json")
        kw = dict(backend="nccl", per_rank=TRAIN_BATCH)
    else:
        rank, world, work, out_path = int(argv[1]), int(argv[2]), argv[3], argv[4]
        kw = dict(store=os.path.join(work, "store"))
    try:
        out = parallel_child(rank, world, work, **kw)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 1 if out["failures"] else 0


def phase_parallel(state: dict) -> None:
    """The parallel layer (parallel/mesh.py): part (a) in this process under
    a world-1 PARALLEL_BACKEND process group on a FileStore
    (`parallel_world1`), then part (b) in PARALLEL_WORLD processes sharing
    the card over gloo (`parallel_child`); every rank's launches against the
    schedule. A failing child fails the phase."""
    import shutil

    import torch

    from ddpm_image_restoration_tpu_torch.parallel.mesh import init_distributed

    work = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    failures = []
    try:
        init_distributed("cuda" if PARALLEL_BACKEND == "nccl" else "cpu",
                         backend=PARALLEL_BACKEND, init_method=f"file://{work}/store1",
                         world_size=1, rank=0)
        t0 = time.perf_counter()
        try:
            parallel_world1(state, work, failures)
        finally:
            torch.distributed.destroy_process_group()
        log(f"  (part (a): {time.perf_counter() - t0:.1f} s)")
        children = run_parallel_children(state, work)
        log(f"  (parts (a) and (b): {time.perf_counter() - t0:.1f} s)")
        for r, res in enumerate(children):
            for label in ("data mesh step", "fsdp step", "model axis step", "restore",
                          "sp restore", "restore cli", "model axis memory"):
                for k, v in res[label]["launches"].items():
                    state["launches_parallel"][k] += v
        dm = [res["data mesh memory"] for res in children]
        fs = [res["fsdp memory"] for res in children]
        for r, (a, b) in enumerate(zip(dm, fs)):
            saved = (None if a["peak_bytes"] is None
                     else (a["peak_bytes"] - b["peak_bytes"], a["resident_bytes"] - b["resident_bytes"]))
            log(f"rank {r}: FSDP against the data mesh at world {PARALLEL_WORLD}: state "
                f"{_gib(b['state_bytes'])} against {_gib(a['state_bytes'])}"
                + ("" if saved is None else f"; peak saved {_gib(saved[0])}, resident saved "
                   f"{_gib(saved[1])}"))
            one, tp = children[r]["one card memory"], children[r]["model axis memory"]
            log(f"rank {r}: the model axis at batch {TRAIN_BATCH} against one card at "
                f"{PARALLEL_PER_RANK}: state {_gib(tp['state_bytes'])} against "
                f"{_gib(one['state_bytes'])}; {tp['ms_per_step']:.1f} ms/step (one process at "
                f"batch {TRAIN_BATCH}: part (a)'s plain step)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))


# The gaussian_mixture phase: the restore CLI with --solver gaussian_mixture
# at full width on GM_FILES WebPs at GM_QUALITY (one batch, restored twice:
# cold, then warm) and one GM_TILE_HW WebP in tiles, GM_TILE_BATCH a batch
# (the CLI pads the last batch to it). Each
# batch runs init_t model evaluations, each launching the forward kernel
# FLASH_PER_EVAL times. Its card-against-CPU case: the sampler at half
# width, f32, GM_REFERENCE_STEPS steps (the SVD guidance at i = 10..6, the
# phase projection at i = 10 and 5) on two 64² images at GM_QUALITY, from
# key 0.
GM_FLAGS = ["--device", "cuda", "--attn", "flash", "--attn-max-res", "32", "--random-init"]
GM_QUALITY = 30
GM_FILES = 8
GM_TILE_HW = (72, 100)
GM_TILE_BATCH = 16
GM_REFERENCE_STEPS = 11
# Steps of the profiled sampler batch: the SVD guidance on the first half,
# as at init_t; the profiler's own processing of a 70-step batch's 184,402
# kernels took ~100 s on the H100's host.
GM_PROFILE_STEPS = 10
# The modules phase: DDIM (T = 70 on a grid of MODULES_DDIM_STEPS) and the
# DDPM chain (T = MODULES_DDPM_T) over the experimental models at their
# default widths, card against CPU in f32, each within MODULES_MEAN on
# average (absolute: ~5x the 9e-6 that SelectiveFreqUNet's DDIM measured
# on the H100) and MODULES_REL·max(1, max|ref|) at most; the native engine's
# DegradationLoader batches (MODULES_LOADER_IMAGES natural 64² images in
# batches of 18, WebP) against the surrogate on the card; the serve batch
# (8 images at q30) under each of FORMULATIONS in turns, the model's
# output on it within one bf16 step (2^-7) of the default's on average. (The restored batch itself is logged, not gated: on random
# weights the surrogate's per-step rounding turns a last-bit change of the
# model's output into a mean change of ~0.15, as a CPU rehearsal at
# width/16 showed for every formulation.)
# MODULES_SCALE divides every model width of the phase and of
# `full_width_model` (1: the defaults); CARD is the device the new phases
# hold against the CPU.
CARD = "cuda"
MODULES_SCALE = 1
MODULES_DDIM_STEPS = 10
MODULES_DDPM_T = 70
MODULES_MEAN = 5e-5
MODULES_REL = 1e-3
MODULES_LOADER_IMAGES = 54
MODULES_TIMED = 3  # timed serve batches per formulation


# The JAX package's other formulations of the 2x upsample and the block DCT
# (its DDPM_IR_RESIZE_IMPL=shifts and DDPM_IR_DCT_IMPL=shifts|blockdiag),
# which the port's ops leave out: measured here by swapping them into the
# models for the serve batch, and held to the JAX package's in
# tests/test_torch_modules_phase.py.
def _upsample_axis_shifts(x, axis: int):
    """Exact 2x linear upsample (half-pixel centres) along one axis by
    fixed-weight shift/adds in x's dtype: out[2i] = 0.25·in[i-1] +
    0.75·in[i], out[2i+1] = 0.75·in[i] + 0.25·in[i+1], edges clamped."""
    import torch

    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    stacked = torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return stacked.reshape(shape)


def upsample_2x_shifts(x):
    """`ops.resize.upsample_2x_bilinear` as separable shift/adds, H then W."""
    return _upsample_axis_shifts(_upsample_axis_shifts(x, 2), 3)


def _block_padded(form):
    """`form(x, bs)` on NCHW x zero-padded to block multiples, cropped
    back, as `ops.dct.spatial_block_dct` pads."""
    import functools

    @functools.wraps(form)
    def padded(x, bs: int):
        import torch.nn.functional as F

        h, w = x.shape[-2:]
        return form(F.pad(x, (0, (-w) % bs, 0, (-h) % bs)), bs)[:, :, :h, :w]
    return padded


def _axis_dct_shifts(t, axis: int, bs: int):
    """The blockwise 1-D DCT along `axis` as strided slices and scalar
    multiply-adds in f32: within a block, output row i is the bs-term sum
    of d[i, j]·(input row j), summed left to right as the JAX package
    does."""
    import functools

    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import dct_matrix

    d = dct_matrix(bs).astype("float64")
    shape = list(t.shape)
    blocks = t.reshape(*shape[:axis], shape[axis] // bs, bs, *shape[axis + 1:])
    slices = [blocks.select(axis + 1, j).float() for j in range(bs)]
    outs = [functools.reduce(torch.add, (float(d[i, j]) * slices[j] for j in range(bs)))
            for i in range(bs)]
    return torch.stack(outs, dim=axis + 1).reshape(shape)


@_block_padded
def block_dct_shifts(x, bs: int):
    """`ops.dct.spatial_block_dct` as strided slices and scalar
    multiply-adds accumulated in f32, cast back once."""
    return _axis_dct_shifts(_axis_dct_shifts(x, 2, bs), 3, bs).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _block_diag_dct(n: int, bs: int):
    """kron(I_{n/bs}, D_bs) [n, n] in f32, the blockwise 1-D DCT of a
    length-n axis as one matrix (cached, as the JAX package caches it)."""
    import numpy as np

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import dct_matrix

    return np.kron(np.eye(n // bs), dct_matrix(bs).astype(np.float64)).astype(np.float32)


@_block_padded
def block_dct_blockdiag(x, bs: int):
    """`ops.dct.spatial_block_dct` as contractions of H and W against
    kron(I, D) block-diagonal matrices (rounded to x's dtype) in f32, cast
    back once (f32 matmuls use no TF32 unless
    `torch.backends.cuda.matmul.allow_tf32` is set)."""
    import torch

    d_h, d_w = (torch.from_numpy(_block_diag_dct(n, bs)).to(x.device, x.dtype).float()
                for n in x.shape[-2:])
    return torch.einsum("Hh,bchw,Ww->bcHW", d_h, x.float(), d_w).to(x.dtype)


FORMULATIONS = [("default", {}), ("resize=shifts", {"upsample_2x_bilinear": upsample_2x_shifts}),
                ("dct=shifts", {"spatial_block_dct": block_dct_shifts}),
                ("dct=blockdiag", {"spatial_block_dct": block_dct_blockdiag}), ("default", {})]


def full_width_model():
    """The WebP model at the release widths (divided by MODULES_SCALE),
    bf16, flash attention at <= 32², on CARD, under the current seed."""
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.models import build_model

    cfg = ModelConfig(attention_impl="flash", attn_max_resolution=32)
    return build_model("webp", cfg.scaled(MODULES_SCALE) if MODULES_SCALE > 1 else cfg,
                       device=CARD)


def gm_reference_case():
    """(cfg, y): the gaussian_mixture phase's card-against-CPU case. The
    model is the half-width f32 WebP model (flash at <= 32²) under
    torch.manual_seed(SEED); y two 64² images through the WebP surrogate at
    GM_QUALITY (NHWC numpy). On these inputs the JAX package's own sampler
    moves by far less than the gate for a 1e-6 input change
    (tests/test_torch_gaussian_mixture_phase.py)."""
    import torch

    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import ModelConfig

    cfg = ModelConfig(compute_dtype="float32", attention_impl="flash",
                      attn_max_resolution=32).scaled(2)
    x0 = torch.from_numpy(synthetic_images(2, cfg.image_size, SEED + 30))
    return cfg, codec_surrogate(x0, GM_QUALITY, codec="webp").numpy()


def write_gm_inputs(inputs: str) -> tuple:
    """GM_FILES WebPs 64² and one GM_TILE_HW WebP, all at GM_QUALITY,
    written by Pillow into `inputs`: (webps, wide)."""
    import numpy as np
    from PIL import Image

    os.makedirs(inputs)

    def write(name, x):
        path = os.path.join(inputs, name)
        Image.fromarray(np.round((x * 0.5 + 0.5) * 255).astype(np.uint8)).save(
            path, quality=GM_QUALITY)
        return path

    imgs = synthetic_images(GM_FILES, 64, SEED + 31)
    th, tw = GM_TILE_HW
    wide = write("wide.webp", synthetic_images(1, tw, SEED + 32)[0][:th])
    return [write(f"g{i}.webp", imgs[i]) for i in range(GM_FILES)], wide


def gm_launches(n_tiles: int = 0) -> int:
    """Forward launches of one gaussian_mixture CLI call: init_t
    evaluations a batch (FLASH_PER_EVAL each), one batch, or one per
    GM_TILE_BATCH tiles."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import init_timestep_for_quality
    from ddpm_image_restoration_tpu_torch.config import get_preset

    init_t = init_timestep_for_quality(GM_QUALITY, DIFFUSION_STEPS, get_preset("webp"))
    return (math.ceil(n_tiles / GM_TILE_BATCH) if n_tiles else 1) * init_t * FLASH_PER_EVAL


def phase_gaussian_mixture(state: dict) -> None:
    """`cli/restore.py --solver gaussian_mixture` at full width (64², bf16,
    flash at <= 32², random weights under torch.manual_seed(0)) on files
    Pillow writes, each call counted from 0 against init_t x FLASH_PER_EVAL
    a batch; its ms/image; the sampler's per-step host cost (the threefry
    draws: the key split, the mixture uniform and the batch's normals) and
    card cost (the batched SVD of the guidance); a profile of one sampler
    batch (device busy share, the kernels with the most device time); then
    the half-width f32 sampler on the card against the CPU (mean |diff| <=
    1e-4)."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image  # writing and reading the files needs Pillow

    from ddpm_image_restoration_tpu_torch.cli.restore import main as restore_main
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.diffusion.gaussian_mixture import (
        GaussianMixtureSampler,
        svd_structure_preservation,
    )
    from ddpm_image_restoration_tpu_torch.evaluation import prng
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from ddpm_image_restoration_tpu_torch.utils.tiling import plan_tiles

    failures = []
    work = os.path.join(ROOT, "build", "chip_smoke_gaussian_mixture")
    shutil.rmtree(work, ignore_errors=True)
    try:
        webps, wide = write_gm_inputs(os.path.join(work, "in"))
        th, tw = GM_TILE_HW
        n_tiles = len(plan_tiles(th, tw, 64, 32)[0])
        flags = [*GM_FLAGS, "--solver", "gaussian_mixture", "--codec", "webp",
                 "--quality", str(GM_QUALITY), "--steps", str(DIFFUSION_STEPS)]
        variants = [("cold", webps, [], gm_launches()), ("warm", webps, [], gm_launches()),
                    (f"tile {th}x{tw}, {n_tiles} tiles", [wide],
                     ["--size-mode", "tile", "--tile-batch", str(GM_TILE_BATCH)],
                     gm_launches(n_tiles))]
        totals = dict.fromkeys(_counts(), 0)
        for i, (label, files, extra, want) in enumerate(variants):
            out_dir = os.path.join(work, f"out{i}")
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            _quiet(restore_main, [*files, *flags, *extra, "--output-dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
            for k, v in counts.items():
                totals[k] += v
            log(f"restore --solver gaussian_mixture [{label}]: {len(files)} file(s), "
                f"{1e3 * wall / len(files):.1f} ms/image ({wall:.2f} s) on {state['smi']}; "
                f"launches {counts} (init_t x {FLASH_PER_EVAL} a batch implies {want} forward)")
            if counts != {fa.KERNEL: want, "flash_attention_bwd_dq": 0,
                          "flash_attention_bwd_dkv": 0}:
                failures.append(f"gaussian_mixture [{label}]: launches {counts}, "
                                f"the schedule implies {want}")
            shape = (th, tw, 3) if files == [wide] else (64, 64, 3)
            for f in files:
                png = os.path.join(out_dir, os.path.splitext(os.path.basename(f))[0]
                                   + "_restored.png")
                got = np.asarray(Image.open(png)).shape if os.path.exists(png) else None
                if got != shape:
                    failures.append(f"gaussian_mixture [{label}]: {png} has shape {got}")
        state["launches_gaussian_mixture"] = totals
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # per-step costs at the CLI batch's shape: the draws on the host, the
    # guidance's SVD of the [8·3, 64, 64] planes on the card
    shape, reps = (GM_FILES, 64, 64, 3), 10
    key = prng.prng_key(0)
    t0 = time.perf_counter()
    for _ in range(reps):
        key, k_noise, k_choice = prng.split(key, 3)
        prng.uniform(k_choice, ())
        prng.normal(k_noise, shape)
    draw_ms = 1e3 * (time.perf_counter() - t0) / reps
    x = torch.from_numpy(synthetic_images(GM_FILES, 64, SEED + 33)).to(CARD)
    for _ in range(2):
        svd_structure_preservation(x, 0.9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        svd_structure_preservation(x, 0.9)
    torch.cuda.synchronize()
    svd_ms = 1e3 * (time.perf_counter() - t0) / reps
    n_steps = gm_launches() // FLASH_PER_EVAL
    log(f"gaussian_mixture per step at {list(shape)}: threefry draws {draw_ms:.2f} ms on the "
        f"host (x{n_steps} steps = {draw_ms * n_steps / 1e3:.2f} s a batch); batched SVD "
        f"{svd_ms:.2f} ms (host wall, synchronised; on {n_steps // 2} of the {n_steps} steps) "
        f"on {state['smi']}")
    state["gm_step_ms"] = {"draws_host": draw_ms, "svd": svd_ms}
    torch.manual_seed(0)
    smp = GaussianMixtureSampler(full_width_model(), get_preset("webp"))
    profile_run(f"one gaussian_mixture batch of {GM_FILES}, {GM_PROFILE_STEPS} steps",
                lambda: smp.sample(x, steps=GM_PROFILE_STEPS))

    cfg, y = gm_reference_case()
    torch.manual_seed(SEED)
    cpu_model = build_model("webp", cfg, device="cpu")
    card_model = build_model("webp", cfg, device=CARD)  # initialised by the card's RNG
    card_model.load_state_dict(cpu_model.state_dict())
    outs = []
    for dev, model in (("cpu", cpu_model), (CARD, card_model)):
        smp = GaussianMixtureSampler(model, get_preset("webp"))
        with no_tf32():
            before = fa.flash_attention_fwd.launches
            outs.append(smp.sample(torch.from_numpy(y).to(dev),
                                   steps=GM_REFERENCE_STEPS).cpu())
            launched = fa.flash_attention_fwd.launches - before
    diff = (outs[0] - outs[1]).abs()
    log(f"card vs CPU gaussian_mixture (2x64x64, half width, f32, webp q{GM_QUALITY}, "
        f"{GM_REFERENCE_STEPS} steps, key 0; {launched} kernel launches on the card, "
        f"{GM_REFERENCE_STEPS * FLASH_PER_EVAL} implied): max|diff| {diff.max().item():.3g}  "
        f"mean|diff| {diff.mean().item():.3g}  max|x| {outs[0].abs().max().item():.3g}")
    if not (launched == GM_REFERENCE_STEPS * FLASH_PER_EVAL
            and np.isfinite(outs[1].numpy()).all() and diff.mean().item() <= 1e-4):
        failures.append("the card's gaussian_mixture restore disagrees with the CPU's")
    if failures:
        raise AssertionError("; ".join(failures))


@contextlib.contextmanager
def swapped(forms: dict):
    """The WebP model's ops swapped inside the block: each name in `forms`
    (`upsample_2x_bilinear`, `spatial_block_dct`) rebound to its form in
    every model module that calls it."""
    from ddpm_image_restoration_tpu_torch.models import freq_blocks, unet
    from ddpm_image_restoration_tpu_torch.parallel import spatial

    sites = [(mod, name) for name in forms for mod in (unet, freq_blocks, spatial)
             if hasattr(mod, name)]
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]
    for mod, name in sites:
        setattr(mod, name, forms[name])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def modules_experimental(failures: list) -> None:
    """DDIM at eta 0 and 0.5 over SelectiveFreqUNet and SimpleConvUNet, and
    the DDPM chain over MLPDenoiser, at their default widths, f32, on the
    card against the CPU from the same key."""
    import torch

    from ddpm_image_restoration_tpu_torch.diffusion.ddpm_schedule import (
        ddim_inference,
        ddpm_inference,
    )
    from ddpm_image_restoration_tpu_torch.evaluation import prng
    from ddpm_image_restoration_tpu_torch.models import experimental as exp

    def widths(ws):
        return tuple(w // MODULES_SCALE for w in ws)

    cases = [("SelectiveFreqUNet", lambda: exp.SelectiveFreqUNet(
                  widths((64, 128, 256, 512, 512)), widths((1024, 1024, 512)),
                  256 // MODULES_SCALE), 64, "ddim"),
             ("SimpleConvUNet", lambda: exp.SimpleConvUNet(widths((64, 128, 256))), 64, "ddim"),
             ("MLPDenoiser", lambda: exp.MLPDenoiser(32, widths((1024, 2048, 1024))), 32,
              "ddpm")]
    for name, make, size, chain in cases:
        torch.manual_seed(SEED)
        cpu_model = make().eval()
        gpu_model = make().to(CARD).eval()
        gpu_model.load_state_dict(cpu_model.state_dict())
        y = torch.from_numpy(synthetic_images(2, size, SEED + 40)).permute(0, 3, 1, 2)
        runs = ([(f"ddim eta {eta}", lambda m, x, eta=eta: ddim_inference(
                    m, x, T=70, n_steps=MODULES_DDIM_STEPS, eta=eta, key=prng.prng_key(SEED)))
                 for eta in (0.0, 0.5)] if chain == "ddim" else
                [(f"ddpm T {MODULES_DDPM_T}",
                  lambda m, x: ddpm_inference(m, x, T=MODULES_DDPM_T))])
        n_params = sum(p.numel() for p in cpu_model.parameters())
        for label, run in runs:
            with no_tf32():
                ref = run(cpu_model, y)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = run(gpu_model, y.to(CARD)).cpu()
                wall = time.perf_counter() - t0
            diff = (got - ref).abs()
            scale = max(1.0, ref.abs().max().item())
            log(f"{name} ({n_params / 1e6:.2f} M parameters, 2x{size}x{size}) {label}: card vs "
                f"CPU max|diff| {diff.max().item():.3g}  mean|diff| {diff.mean().item():.3g}  "
                f"max|ref| {ref.abs().max().item():.3g}; card {1e3 * wall:.1f} ms")
            if not (torch.isfinite(got).all() and diff.mean().item() <= MODULES_MEAN
                    and diff.max().item() <= MODULES_REL * scale):
                failures.append(f"{name} {label}: the card disagrees with the CPU")


def modules_native(state: dict, failures: list) -> None:
    """The native engine built from native/codec_engine.cpp into build/;
    its DegradationLoader batches against the surrogate on the card within
    tests/test_native.py's bounds; ms/batch against the 'pil' backend, in
    turns."""
    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.codecs import native
    from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.config import get_preset
    from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
    from ddpm_image_restoration_tpu_torch.data.pipeline import DegradationLoader

    t0 = time.perf_counter()
    available = native.native_available()
    log(f"native engine: available {available}, {native.library_path()} "
        f"({time.perf_counter() - t0:.1f} s to build and load)")
    if not available:
        failures.append("the native codec engine did not build from native/codec_engine.cpp")
        return
    ds = SyntheticImageDataset(MODULES_LOADER_IMAGES, 64, seed=SEED, kind="natural")
    ms = {"native_surrogate": [], "pil": []}
    for backend in ("native_surrogate", "pil", "native_surrogate", "pil"):
        loader = DegradationLoader(ds, np.arange(len(ds)), get_preset("webp"), TRAIN_BATCH,
                                   seed=SEED, degradation_backend=backend)
        t0 = time.perf_counter()
        batches = list(loader.epoch(0))
        ms[backend].append(1e3 * (time.perf_counter() - t0) / len(batches))
        if backend == "native_surrogate":
            b = batches[0]
            ref = codec_surrogate(torch.from_numpy(b["x0"]).to(CARD),
                                  torch.from_numpy(np.maximum(b["quality"], 1)).float().to(CARD),
                                  codec="webp").cpu().numpy()
            diff = np.abs(b["xt"] - ref)
    log(f"native_surrogate batch of {TRAIN_BATCH} (64², webp, qualities "
        f"{b['quality'].min()}-{b['quality'].max()}) vs codec_surrogate on the card: "
        f"mean|diff| {diff.mean():.3g}  max|diff| {diff.max():.3g}  "
        f"share > 1e-3 {(diff > 1e-3).mean():.3g}")
    if not (diff.mean() < 5e-3 and diff.max() < 8e-2):
        failures.append(f"native batch vs surrogate: mean {diff.mean():.3g}, max {diff.max():.3g}")
    # the degradation alone, on that batch's clean images and qualities
    alone = {"native_surrogate": [], "pil": []}
    for backend in ("native_surrogate", "pil", "native_surrogate", "pil"):
        t0 = time.perf_counter()
        if backend == "pil":
            compress_batch(b["x0"], "webp", b["quality"])
        else:
            native.codec_surrogate_native(b["x0"], np.maximum(b["quality"], 1), "webp")
        alone[backend].append(1e3 * (time.perf_counter() - t0))
    log(f"DegradationLoader ms/batch of {TRAIN_BATCH} natural images in turns (native, pil, "
        f"native, pil; images made in the loop): native "
        f"{[round(v, 1) for v in ms['native_surrogate']]}, pil {[round(v, 1) for v in ms['pil']]}"
        f"; the degradation alone: native {[round(v, 2) for v in alone['native_surrogate']]}, "
        f"pil {[round(v, 2) for v in alone['pil']]} ms on the card's host ({os.cpu_count()} "
        f"cores)")
    state["native_ms_per_batch"] = {"loader": ms, "degradation": alone}


def modules_formulations(state: dict, failures: list) -> None:
    """utils/profiling.trace around one serve batch (8 images, q30, full
    width, bf16): its Chrome trace must hold the card's kernels. Then the
    serve batch under each FORMULATIONS entry in turns: ms/batch; one model
    evaluation on the batch (t = 0.5) against the first default's, gated,
    and the restored batch against the first default's, logged; and the
    time per batch of the upsample and block-DCT calls: each call's shape
    recorded in one batch, each shape's op timed alone between CUDA events
    (20 back-to-back calls: device time where the kernels outlast their
    launches, else the launches' host time) times its calls. (torch.profiler
    read 0 in most sessions around these 3-350 us ops on the H100.)"""
    import shutil

    import collections

    import numpy as np
    import torch

    from ddpm_image_restoration_tpu_torch.cli.serve import restore_batch
    from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
    from ddpm_image_restoration_tpu_torch.models import freq_blocks, unet
    from ddpm_image_restoration_tpu_torch.parallel import spatial
    from ddpm_image_restoration_tpu_torch.utils import profiling

    torch.manual_seed(SEED)
    model = full_width_model()
    x0 = torch.from_numpy(synthetic_images(SERVE_BATCH, 64, SEED + 11)).to(CARD)
    y = codec_surrogate(x0, 30, codec="webp")

    def run():
        return restore_batch(model, y, 30, "webp", final_exact=False)

    t_half = torch.full((SERVE_BATCH,), 0.5, device=CARD)

    def evaluate():
        with torch.no_grad():
            return model(y, t_half, t_half)

    run()
    tdir = os.path.join(ROOT, "build", "chip_smoke_trace")
    shutil.rmtree(tdir, ignore_errors=True)
    try:
        with profiling.trace(tdir):
            with profiling.annotate("serve_batch"):
                run()
        with open(os.path.join(tdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    annotated = any(e.get("name") == "serve_batch" for e in events)
    log(f"profiling.trace of one serve batch: {len(events)} events, {len(kernels)} kernel "
        f"events, region 'serve_batch' {'found' if annotated else 'missing'}")
    if not kernels or not annotated:
        failures.append("profiling.trace wrote no kernel events or lost the annotation")

    originals = {(spatial, "upsample_2x_bilinear"): spatial.upsample_2x_bilinear,
                 (unet, "spatial_block_dct"): unet.spatial_block_dct,
                 (freq_blocks, "spatial_block_dct"): freq_blocks.spatial_block_dct}
    calls = collections.Counter()  # (op, shape, dtype, args) -> calls in one batch

    def recording(fn):
        def wrapped(x, *a):
            calls[(fn.__name__, tuple(x.shape), x.dtype, a)] += 1
            return fn(x, *a)
        return wrapped

    for (mod, name), fn in originals.items():
        setattr(mod, name, recording(fn))
    try:
        run()
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    per_op = collections.Counter(k[0] for k in calls.elements())
    log(f"upsample and DCT calls in one serve batch: {dict(per_op)} over {len(calls)} shapes")

    def op_ms() -> dict:
        """ms per batch of the upsample and DCT calls, each timed alone, in
        the form the models call now."""
        total = dict.fromkeys(per_op, 0.0)
        for (name, shape, dtype, args), n in calls.items():
            x = torch.randn(shape, device=CARD).to(dtype)
            fn = next(getattr(m, name) for m in (unet, spatial) if hasattr(m, name))
            total[name] += n * cuda_time_ms(lambda: fn(x, *args))
        return total

    ref = ref_eval = None
    rows = []
    for label, forms in FORMULATIONS:
        with swapped(forms):
            out, out_eval = run(), evaluate()
            times = []
            for _ in range(MODULES_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            ops = op_ms()
        if ref is None:
            ref, ref_eval = out, out_eval
        diff, diff_eval = (out - ref).abs(), (out_eval - ref_eval).abs()
        rows.append({"formulation": label, "ms_per_batch": times, "op_event_ms": ops,
                     "eval_mean_abs_diff": diff_eval.mean().item(),
                     "eval_max_abs_diff": diff_eval.max().item(),
                     "restore_mean_abs_diff": diff.mean().item()})
        log(f"serve batch [{label}]: {[round(t, 1) for t in times]} ms/batch of {SERVE_BATCH}; "
            f"ops alone (events) {({k: round(v, 3) for k, v in ops.items()})} ms; vs the default: one "
            f"evaluation mean|diff| {diff_eval.mean().item():.3g} max "
            f"{diff_eval.max().item():.3g}, the restore mean|diff| {diff.mean().item():.3g} "
            f"max {diff.max().item():.3g} on {state['smi']}")
        if not (np.isfinite(out.cpu().numpy()).all()
                and diff_eval.mean().item() <= 2 ** -7):
            failures.append(f"serve batch [{label}]: one evaluation mean|diff| "
                            f"{diff_eval.mean().item():.3g} from the default")
    state["formulations"] = rows


def phase_modules(state: dict) -> None:
    """The modules of the experimental family, the native engine, the
    profiling helpers and the resize/DCT formulations on the card."""
    failures = []
    modules_experimental(failures)
    modules_native(state, failures)
    modules_formulations(state, failures)
    if failures:
        raise AssertionError("; ".join(failures))


PHASES = [("environment", phase_environment), ("build", phase_build),
          ("kernels", phase_kernels), ("path1024", phase_path1024),
          ("reference", phase_reference), ("release", phase_release),
          ("serve", phase_serve), ("train_reference", phase_train_reference),
          ("train", phase_train), ("distill", phase_distill), ("parallel", phase_parallel),
          ("restore", phase_restore),
          ("evaluate", phase_evaluate), ("avif", phase_avif),
          ("gaussian_mixture", phase_gaussian_mixture), ("modules", phase_modules)]


# How `launches` counts a CUDA graph's replays, which run no Python.
REPLAY_LAUNCHES = (
    "each wrapper call that launches its kernel counts one; a captured graph's replay adds "
    "the launches its capture recorded (utils/graphs.py CapturedGraph.replay), except the "
    "1024² train step's replay, counted in the device's trace; the device's trace of one "
    "replay each of the serve solver, the train step and the distill step is held to the "
    "schedule (flash_traced)")


def kernels_json(state: dict) -> str:
    """One row per kernel. Its top-level numbers are at the first serving
    or training shape in bf16 (down2); `main_path_shapes` has each shape the
    main paths give it in bf16, `f32_path_shapes` each f32 one, with its own
    error and times (an f32 path shape's library time is SDPA's faster
    backend in f32, named). `launches` sums the
    main paths' runs (serve, the 1024² path, train, distillation, the
    parallel phase's ranks, the restore and serve CLIs, the evaluator, the
    AVIF family, the Gaussian-mixture restore, the release weights' restores
    and CLIs), each counted from 0;
    `launches_by_path` splits it; `launches_counted` says how a replayed
    graph's launches enter it (`REPLAY_LAUNCHES`)."""
    paths = {"serve": state["launches"], "path1024": state.get("launches_path1024", {}),
             "train": state.get("launches_train", {}),
             "distill": state.get("launches_distill", {}),
             "parallel": state.get("launches_parallel", {}),
             "restore": state.get("launches_restore", {}),
             "evaluate": state.get("launches_evaluate", {}),
             "avif": state.get("launches_avif", {}),
             "gaussian_mixture": state.get("launches_gaussian_mixture", {}),
             "release": state.get("launches_release", {})}

    def row(name, source, replaces, rows, shapes, key, f32_shapes):
        per_shape = [{"path": path, "shape_bh_t_d": [bh, t, d], "dtype": "bfloat16",
                      "save_lse": lse, **rows[key(bh, t, d, "bfloat16", lse)]}
                     for path, bh, t, d, lse in shapes]
        f32 = [{"path": path, "shape_bh_t_d": [bh, t, d], "dtype": "float32", "save_lse": lse,
                **rows[key(bh, t, d, "float32", lse)]}
               for path, bh, t, d, lse in f32_shapes if key(bh, t, d, "float32", lse) in rows]
        first = per_shape[0]
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        return {
            "name": name, "route": "cuda", "source": f"{PACKAGE}/csrc/{source}",
            "design": DESIGNS[name],
            "replaces": f"{JAX_PACKAGE}/ops/pallas/flash_attention.py:{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_counted": REPLAY_LAUNCHES,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "shape": "BH=%d,T=%d,D=%d bf16 (%s, down2)" % (*first["shape_bh_t_d"], first["path"]),
            "main_path_shapes": per_shape, "f32_path_shapes": f32,
        }

    fwd_rows, bwd_rows = state["kernel_rows"], state.get("bwd_rows", {})
    kernels = [row("flash_attention_fwd", "flash_attention_fwd.cu", 51, fwd_rows,
                   FWD_PATH_SHAPES, lambda *k: k, F32_FWD_PATH_SHAPES)]
    for kind, line in (("dq", 207), ("dkv", 247)):
        rows = {k: r for k, r in bwd_rows.items() if k[0] == kind}
        kernels.append(row(f"flash_attention_bwd_{kind}", "flash_attention_bwd.cu", line,
                           rows, [(TRAIN_PATHS.get(s, "train step"), *s, True)
                                  for s in TRAIN_SHAPES],
                           lambda bh, t, d, n, lse, kind=kind: (kind, bh, t, d, n),
                           [(path, *s, True) for s, path in F32_TRAIN_SHAPES.items()]))
    return json.dumps({"kernels": kernels})


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    child = sys.argv[1:2] in (["--parallel-child"], ["--parallel-child-nccl"])
    release = None if child else parse_args(sys.argv[1:]).release
    if release is not None and (why := release_refusal(release, ROOT)):
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if child:
        return child_main(sys.argv[1:])

    def on_alarm(signum, frame):
        raise TimeoutError(f"chip_smoke exceeded {TIME_LIMIT_S} s")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(TIME_LIMIT_S)
    state: dict = {"release": release or DEFAULT_RELEASE}
    log(f"release weights: {state['release']} ({release_files(state['release'])[0]})")
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
