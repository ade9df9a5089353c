"""Batch restoration service on the card: `python -m
ddpm_image_restoration_tpu_torch.cli.serve` (port of cli/serve.py).

Watches a directory for images, restores them in batches with the DDRM
sampler and writes `<name>_restored.png` to the output directory, moving
each served input to `--processed-dir` (default `<watch>/done`; undecodable
ones to `<watch>/rejected`).

    python -m ddpm_image_restoration_tpu_torch.cli.serve --watch ./in \
        --output-dir ./out --codec auto --model-codec all --quality auto \
        --params-npz w.npz --solver auto --traced --attn flash \
        --attn-max-res 32 --once

`--quality auto` estimates each file's quality from its bitstream and
restores each image at its own quality; the batch's start step snaps to the
bucket (10, 30, 50, 70, 90) nearest the batch median, unless `--traced`
gives every file its own start step. `--codec auto` serves codec-pure
batches, the largest group first. `--dp N` serves each batch data-parallel
over N ranks (-1: all) of a `torchrun` world, in fixed-size mode with
`--batch-size` a multiple of N: rank 0 watches the directory, reads the
files and writes the PNGs, every rank restores a block of the batch's rows,
and the output is the one-process output.

`restore_batch` is the server core for callers that hold tensors. Pillow is
needed only to read and write the image files, to estimate qualities, and
for the exact final projection; the core runs without it when
`final_exact=False`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.cli.common import (
    DataParallel,
    add_codec_flags,
    add_model_flags,
    add_weights_flags,
    build_restore_model,
    load_image,
    resolve_codecs,
    sampler_codec_id,
    save_image,
)
from ddpm_image_restoration_tpu_torch.codecs.quality import (
    init_timestep_for_quality,
    student_stride,
)
from ddpm_image_restoration_tpu_torch.config import get_preset
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
from ddpm_image_restoration_tpu_torch.diffusion.policy import production_solver_config
from ddpm_image_restoration_tpu_torch.parallel.mesh import replicated

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".avif")
# init_t buckets of --quality auto without --traced (around the batch median)
_BUCKETS = (10, 30, 50, 70, 90)


def solver_for(init_t: int, quality: float, codec: str, solver: str = "auto",
               stride: int = 1, max_evals: int = 0, encoder_reuse: int = 1,
               protect: tuple | None = None) -> tuple:
    """(stride, encoder_reuse, eta, protect) for one batch. 'auto' is the
    production policy (diffusion/policy.py) at the batch's quality, with its
    per-codec protection blend; otherwise `max_evals` derives the stride when
    set, else `stride` as given. An explicit `protect` always wins. eta None
    = the preset's."""
    if solver == "auto":
        pc = production_solver_config(quality, codec)
        return (student_stride(init_t, pc["max_evals"]), pc["encoder_reuse"],
                pc.get("eta"), protect or pc.get("protect"))
    if max_evals:
        return student_stride(init_t, max_evals), encoder_reuse, None, protect
    return stride, encoder_reuse, None, protect


def sample_batch(model, y: torch.Tensor, quality, codec: str = "webp", steps: int = 100,
                 solver: str = "auto", stride: int = 1, max_evals: int = 0,
                 encoder_reuse: int = 1, final_exact: bool = True,
                 generator: torch.Generator | None = None, bucket: float | None = None,
                 decoder_reuse_depth: int = 0, protect: tuple | None = None,
                 protect_adaptive: float | None = None, traced: bool = False,
                 rows: tuple | None = None) -> torch.Tensor:
    """Restore the NHWC batch `y` in [-1,1], compressed by `codec`, with
    `model` (which holds its weights, on y's device); the restoration as the
    sampler returns it.

    `quality` is a scalar or a per-sample [B] vector: each image restores
    at its own quality. `bucket` is the quality that sets the batch's
    init_t and its solver policy (default: `quality`, then a scalar).
    `traced` runs the traced-budget solver instead, each image at its own
    init_t, with the policy's budget (`solver` 'auto') or `max_evals`.
    `rows` = (start, stop) restores only those rows of the batch (a
    data-parallel rank's share; `DDRMSampler.sample`)."""
    preset = get_preset(codec)
    bucket = quality if bucket is None else bucket
    init_t = init_timestep_for_quality(int(bucket), steps, preset)
    b_stride, b_enc, b_eta, b_protect = solver_for(
        init_t, float(bucket), codec, solver, stride, max_evals, encoder_reuse, protect)
    steps_arg, budget = init_t, 0
    if traced:
        budget = production_solver_config(bucket)["max_evals"] if solver == "auto" else max_evals
        if not budget:
            raise ValueError("traced needs solver 'auto' or max_evals")
        q_b = np.broadcast_to(np.asarray(quality, np.float64).reshape(-1), (y.shape[0],))
        steps_arg = [init_timestep_for_quality(int(round(q)), steps, preset) for q in q_b]
    return DDRMSampler(model, preset, codec_id=sampler_codec_id(model, codec)).sample(
        y, quality, steps_arg, stride=b_stride, protect=b_protect,
        protect_adaptive=protect_adaptive, encoder_reuse=b_enc, eta=b_eta,
        decoder_reuse_depth=decoder_reuse_depth, traced_budget=budget,
        final_exact=final_exact, generator=generator, rows=rows)


def restore_batch(model, y: torch.Tensor, quality, codec: str = "webp", steps: int = 100,
                  solver: str = "auto", stride: int = 1, max_evals: int = 0,
                  encoder_reuse: int = 1, final_exact: bool = True,
                  generator: torch.Generator | None = None, **kw) -> torch.Tensor:
    """`sample_batch` (same arguments) clipped to [-1,1]: what the server
    writes."""
    return sample_batch(model, y, quality, codec, steps, solver, stride, max_evals,
                        encoder_reuse, final_exact, generator, **kw).clamp(-1.0, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Directory-watching restoration service")
    ap.add_argument("--watch", required=True, help="input directory to watch")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--processed-dir", default=None,
                    help="move processed inputs here (default <watch>/done)")
    add_codec_flags(ap)
    add_model_flags(ap)
    add_weights_flags(ap)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the sampler's noise generator")
    ap.add_argument("--quality", default="30",
                    help="quality the inputs were compressed at, or 'auto': "
                         "estimate each file's quality from its bitstream and "
                         "restore each image at its own quality; the batch's "
                         "init_t snaps to the bucket in {10,30,50,70,90} nearest "
                         "the batch median (per file with --traced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max-evals", type=int, default=0,
                    help="cap model evaluations per restore (overrides --stride)")
    ap.add_argument("--solver", default="manual", choices=["manual", "auto"],
                    help="'auto' = the production policy (diffusion/policy.py): "
                         "overrides --stride/--max-evals/--encoder-reuse")
    ap.add_argument("--traced", action="store_true",
                    help="fixed-budget solver (needs --solver auto or "
                         "--max-evals): each file restores at its own init_t")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel serving over N ranks of a torchrun world "
                         "(-1 = all); fixed-size mode, --batch-size a multiple of N")
    ap.add_argument("--encoder-reuse", type=int, default=1)
    ap.add_argument("--decoder-reuse-depth", type=int, default=0,
                    help="with encoder reuse > 1: run the deep decoder stages "
                         "once per reuse group, recomputing only the last N")
    ap.add_argument("--protect-adaptive", type=float, default=None, metavar="BETA",
                    help="cap local rewrite at BETA x the calibrated codec damage")
    ap.add_argument("--protect", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                    help="quality-gated blend protecting near-lossless inputs")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--poll-seconds", type=float, default=1.0)
    ap.add_argument("--once", action="store_true", help="drain the directory and exit")
    ap.add_argument("--size-mode", default="resize", choices=["resize", "tile"],
                    help="resize = squash inputs to the model's size; tile = serve "
                         "at native resolution via 16-aligned overlap tiles")
    ap.add_argument("--tile-overlap", type=int, default=32)
    ap.add_argument("--remat", action="store_true",
                    help="training only: serving runs no backward, so this "
                         "changes nothing (kept with the JAX CLI's flags)")
    args = ap.parse_args(argv)
    if args.traced and args.solver != "auto" and not args.max_evals:
        # at startup, not when the first batch arrives
        ap.error("--traced needs --solver auto or --max-evals")
    codec, model_codec = resolve_codecs(args)
    if args.dp and args.size_mode == "tile":
        raise SystemExit("--dp requires fixed-size mode: tile batches "
                         "are variable-sized and cannot be sharded "
                         "(drop --dp or --size-mode tile)")
    dp = DataParallel(args.dp, args.device)
    if args.batch_size % dp.n:
        raise SystemExit(f"--batch-size {args.batch_size} must be a "
                         f"multiple of --dp {dp.n}")
    if not dp.active:
        return
    if args.dp and dp.main:
        print(f"data-parallel serving over {dp.n} device(s)", flush=True)

    model = build_restore_model(model_codec, args)
    replicated(model, dp.mesh)
    dev = model.out_conv.weight.device
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    fallback = model_codec if model_codec != "all" else "jpeg"

    def select_batch(files):
        """The next codec-pure batch: head of the queue for a fixed --codec;
        for --codec auto the largest group of one detected codec."""
        if codec != "auto":
            return files[: args.batch_size], codec
        from ddpm_image_restoration_tpu_torch.codecs.estimate import detect_codec

        groups = {}
        for f in files:
            groups.setdefault(detect_codec(os.path.join(args.watch, f)) or fallback,
                              []).append(f)
        c = max(groups, key=lambda k: len(groups[k]))
        return groups[c][: args.batch_size], c

    def quality_for(paths):
        """(per-file qualities, the batch's bucket quality)."""
        if args.quality != "auto":
            q = float(int(args.quality))
            return [q] * len(paths), int(q)
        from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality

        ests = [estimate_quality(p) for p in paths]
        qualities = [float(e) if e is not None else 30.0 for e in ests]
        med = float(np.median(qualities))
        bucket = min(_BUCKETS, key=lambda b: abs(b - med))
        print(f"auto quality: per-file {qualities} -> init_t bucket {bucket}", flush=True)
        return qualities, bucket

    done_dir = args.processed_dir or os.path.join(args.watch, "done")
    reject_dir = os.path.join(args.watch, "rejected")
    if dp.main:
        os.makedirs(args.output_dir, exist_ok=True)
        os.makedirs(done_dir, exist_ok=True)
    solver_kw = dict(steps=args.steps, solver=args.solver, stride=args.stride,
                     max_evals=args.max_evals, encoder_reuse=args.encoder_reuse,
                     generator=generator, decoder_reuse_depth=args.decoder_reuse_depth,
                     protect=tuple(args.protect) if args.protect else None,
                     protect_adaptive=args.protect_adaptive)
    size = None if args.size_mode == "tile" else args.image_size

    def next_batch():
        """On data rank 0: the next batch to serve, read and decoded, as
        (files, codec, images, qualities, bucket quality); None to look
        again at once (every file of the batch was rejected), 'idle' when
        the directory is empty, 'stop' when it is empty under --once."""
        files = sorted(
            f for f in os.listdir(args.watch)
            if f.lower().endswith(_EXTS) and os.path.isfile(os.path.join(args.watch, f))
        )
        if not files:
            return "stop" if args.once else "idle"
        take, batch_codec = select_batch(files)
        batch, imgs = [], []
        for f in take:
            try:
                imgs.append(load_image(os.path.join(args.watch, f), size))
                batch.append(f)
            except Exception as e:  # a corrupt upload must not stop the server
                os.makedirs(reject_dir, exist_ok=True)
                os.replace(os.path.join(args.watch, f), os.path.join(reject_dir, f))
                print(f"rejected undecodable input {f}: {e}", flush=True)
        if not batch:
            return None
        qualities, bucket = quality_for([os.path.join(args.watch, f) for f in batch])
        return batch, batch_codec, imgs, qualities, bucket

    served = 0
    while True:
        plan = dp.share(next_batch() if dp.main else None)
        if plan == "stop":
            break
        if plan == "idle":
            if dp.main:
                time.sleep(args.poll_seconds)
            continue
        if plan is None:
            continue
        batch, batch_codec, imgs, qualities, bucket = plan
        if args.size_mode == "tile":
            from ddpm_image_restoration_tpu_torch.utils.tiling import restore_tiled

            def restore_fixed(tiles: np.ndarray, q: float) -> np.ndarray:
                return sample_batch(model, torch.as_tensor(tiles, device=dev), q, batch_codec,
                                    bucket=bucket, **solver_kw).cpu().numpy()

            # every tile of one image shares that image's own quality
            out = [restore_tiled(lambda t, q=q: restore_fixed(t, q), img, args.image_size,
                                 overlap=args.tile_overlap, batch_size=args.batch_size)
                   for img, q in zip(imgs, qualities)]
        else:
            n = len(batch)
            pad = args.batch_size - n  # one batch shape for every request
            y = np.concatenate([np.stack(imgs), np.zeros((pad, *imgs[0].shape), np.float32)])
            q = qualities[0] if len(set(qualities)) == 1 else qualities + [float(bucket)] * pad

            def restore_rows(yb: np.ndarray, rows) -> np.ndarray:
                return restore_batch(model, torch.as_tensor(yb, device=dev), q, batch_codec,
                                     bucket=bucket, traced=args.traced, rows=rows,
                                     **solver_kw).cpu().numpy()

            out = dp.run(restore_rows, y)[:n]
        served += len(batch)
        if not dp.main:
            continue
        for f, img in zip(batch, out):
            save_image(os.path.join(args.output_dir, os.path.splitext(f)[0] + "_restored.png"),
                       img)
            os.replace(os.path.join(args.watch, f), os.path.join(done_dir, f))
        print(f"restored {len(batch)} images (total {served})", flush=True)
    if dp.main:
        print(f"done; served {served} images", flush=True)


if __name__ == "__main__":
    main()
