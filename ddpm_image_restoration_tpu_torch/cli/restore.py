"""Restore codec-compressed image files: `python -m
ddpm_image_restoration_tpu_torch.cli.restore` (port of cli/restore.py).

Loads the weights (a release npz, or the port's own training checkpoint),
restores the files with the DDRM sampler and writes
`<output-dir>/<name>_restored.png`:

    python -m ddpm_image_restoration_tpu_torch.cli.restore in/*.webp \
        --codec webp --quality auto --params-npz w.npz --max-evals 14 \
        --encoder-reuse 2 --attn flash --attn-max-res 32 --output-dir out

It runs on the card unless `--device cpu` is passed. Files that share one
(codec, quality) go through the sampler as one batch; otherwise each file is
restored on its own, at its own detected codec and quality. `--size-mode
tile` restores each file at its native size through overlapping tiles.
`--consistency callback|host_loop` projects through the exact host codec
each step. `--solver gaussian_mixture` and `--sp` are parsed and refused
(not ported yet).

`--dp N` restores each batch data-parallel over N ranks (-1: all) of a
`torchrun` world, each rank taking a block of the batch's rows (padded to a
multiple of N); rank 0 reads the files and writes the PNGs, and the output
is the one-process output:

    torchrun --nproc-per-node 8 -m ddpm_image_restoration_tpu_torch.cli.restore \
        in/*.webp --dp -1 --params-npz w.npz --output-dir out
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.cli.common import (
    DataParallel,
    add_codec_flags,
    add_model_flags,
    add_weights_flags,
    build_restore_model,
    load_image,
    model_config_from,
    refuse_not_ported,
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
from ddpm_image_restoration_tpu_torch.diffusion.ensemble import sample_ensemble
from ddpm_image_restoration_tpu_torch.parallel.mesh import replicated


def main(argv=None):
    ap = argparse.ArgumentParser(description="Restore codec-compressed images")
    add_codec_flags(ap)
    add_model_flags(ap)
    add_weights_flags(ap)
    ap.add_argument("inputs", nargs="+", help="image files (treated as already compressed)")
    ap.add_argument("--output-dir", default="./restored")
    ap.add_argument("--quality", default="30",
                    help="quality the inputs were compressed at, or 'auto' "
                         "(recovered from the bitstream: exact for JPEG "
                         "quantization tables and AVIF base_q_idx, approximate "
                         "for lossy WebP via the VP8 quantizer index)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--consistency", default="surrogate",
                    choices=["surrogate", "callback", "host_loop"])
    ap.add_argument("--solver", default="ddrm", choices=["ddrm", "gaussian_mixture"])
    ap.add_argument("--stride", type=int, default=1, help=">1 = reduced-step solver")
    ap.add_argument("--max-evals", type=int, default=0,
                    help="cap model evaluations per restore (derives the stride "
                         "from each image's init_t); overrides --stride")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel restore over N ranks of a torchrun world "
                         "(-1 = all): each rank restores a block of the batch's rows "
                         "(batches are padded to a multiple of N)")
    ap.add_argument("--sp", type=int, default=0,
                    help="spatial-parallel restore (not ported; refused)")
    ap.add_argument("--encoder-reuse", type=int, default=1,
                    help="run the UNet encoder only every k-th model evaluation")
    ap.add_argument("--decoder-reuse-depth", type=int, default=0,
                    help="with --encoder-reuse > 1: also run the deep decoder "
                         "stages once per reuse group, recomputing only the "
                         "last N stages and the head")
    ap.add_argument("--protect", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                    help="quality-gated blend protecting near-lossless inputs")
    ap.add_argument("--protect-adaptive", type=float, default=None, metavar="BETA",
                    help="cap the restoration residual's local RMS at BETA x the "
                         "calibrated codec damage D(quality)")
    ap.add_argument("--ensemble", type=int, default=1, choices=[1, 2, 4, 8],
                    help="dihedral self-ensemble over N flip/rotation variants "
                         "(8 needs square inputs; ~N x restore time)")
    ap.add_argument("--size-mode", default="resize", choices=["resize", "tile"],
                    help="resize = squash inputs to the model's size; tile = "
                         "restore at native resolution via 16-aligned overlap tiles")
    ap.add_argument("--tile-overlap", type=int, default=32)
    ap.add_argument("--tile-batch", type=int, default=16, help="tiles per sampler batch")
    ap.add_argument("--remat", action="store_true",
                    help="training only: restoring runs no backward, so this "
                         "changes nothing (kept with the JAX CLI's flags)")
    args = ap.parse_args(argv)
    if args.dp and args.sp:
        raise SystemExit("--dp and --sp are mutually exclusive (a combined "
                         "data x spatial mesh adds nothing at this model's "
                         "sizes; pick the axis that matches your batch)")
    refuse_not_ported(args)
    codec, model_codec = resolve_codecs(args)

    dp = DataParallel(args.dp, args.device)
    if not dp.active:
        return
    if args.dp and dp.main:
        print(f"data-parallel restore over {dp.n} device(s)")
    mcfg = model_config_from(args)
    model = build_restore_model(model_codec, args)
    replicated(model, dp.mesh)
    dev = model.out_conv.weight.device

    samplers = {}

    def get_sampler(c: str) -> DDRMSampler:
        if c not in samplers:
            samplers[c] = DDRMSampler(model, get_preset(c), codec_id=sampler_codec_id(model, c),
                                      consistency_mode=args.consistency)
        return samplers[c]

    def read_inputs() -> tuple:
        """(codecs, qualities, images) of the input files (data rank 0)."""
        if codec == "auto":
            from ddpm_image_restoration_tpu_torch.codecs.estimate import detect_codec

            fallback = model_codec if model_codec != "all" else "jpeg"
            codecs = []
            for p in args.inputs:
                c = detect_codec(p)
                if c is None:
                    c = fallback
                    print(f"{p}: codec not identifiable from the bitstream "
                          f"(JPEG/WebP/AVIF magic); assuming {c}")
                elif model_codec not in ("all", c):
                    print(f"{p}: detected {c} but the checkpoint was trained "
                          f"for {model_codec}; restoring as {c} with the "
                          f"{model_codec} model")
                codecs.append(c)
        else:
            codecs = [codec] * len(args.inputs)

        if args.quality == "auto":
            from ddpm_image_restoration_tpu_torch.codecs.estimate import estimate_quality

            qualities = []
            for p in args.inputs:
                q = estimate_quality(p)
                if q is None:
                    q = 30
                    print(f"{p}: quality not recoverable from bitstream "
                          f"(JPEG, lossy WebP, AVIF only); assuming {q}")
                else:
                    print(f"{p}: estimated quality {q}")
                qualities.append(q)
        else:
            qualities = [int(args.quality)] * len(args.inputs)
        size = None if args.size_mode == "tile" else mcfg.image_size
        return codecs, qualities, [load_image(p, size) for p in args.inputs]

    codecs, qualities, images = dp.share(read_inputs() if dp.main else None)

    def make_restore_batch(file_codec: str, quality: int):
        smp = get_sampler(file_codec)
        init_t = init_timestep_for_quality(quality, args.steps, smp.preset)
        stride = student_stride(init_t, args.max_evals) if args.max_evals else args.stride

        def restore_batch(batch: np.ndarray, rows=None) -> np.ndarray:
            out = sample_ensemble(
                smp, torch.as_tensor(batch, device=dev), quality, init_t,
                n_transforms=args.ensemble, stride=stride, encoder_reuse=args.encoder_reuse,
                decoder_reuse_depth=args.decoder_reuse_depth,
                protect=tuple(args.protect) if args.protect else None,
                protect_adaptive=args.protect_adaptive,
                generator=torch.Generator(device=dev).manual_seed(0), rows=rows)
            return out.cpu().numpy()

        return lambda batch: dp.run(restore_batch, batch)

    if args.size_mode == "tile":
        from ddpm_image_restoration_tpu_torch.utils.tiling import restore_tiled

        out = [restore_tiled(make_restore_batch(c, q), img, mcfg.image_size,
                             overlap=args.tile_overlap, batch_size=args.tile_batch)
               for img, c, q in zip(images, codecs, qualities)]
    elif len(set(zip(codecs, qualities))) == 1:
        out = make_restore_batch(codecs[0], qualities[0])(np.stack(images))
    else:  # per-file detected codec/quality: restore one at a time
        out = [make_restore_batch(c, q)(img[None])[0]
               for img, c, q in zip(images, codecs, qualities)]

    if not dp.main:
        return
    os.makedirs(args.output_dir, exist_ok=True)
    for path, restored in zip(args.inputs, out):
        base = os.path.splitext(os.path.basename(path))[0]
        dst = os.path.join(args.output_dir, f"{base}_restored.png")
        save_image(dst, restored)
        print(f"wrote {dst}")


if __name__ == "__main__":
    main()
