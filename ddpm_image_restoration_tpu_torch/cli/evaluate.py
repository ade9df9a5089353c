"""Evaluation entry point: `python -m ddpm_image_restoration_tpu_torch.cli.evaluate`
(port of cli/evaluate.py, the JAX package's `ddpm-ir-evaluate`).

Compresses the test images at each quality, restores them and writes
`metrics_summary.json` (PSNR, SSIM, LPIPS, L2 and the Fréchet distance per
quality, with paired 95% CIs), a comparative table and example grids to
`--output-dir`:

    python -m ddpm_image_restoration_tpu_torch.cli.evaluate --codec webp \
        --params-npz w.npz --synthetic 256 --synthetic-kind natural \
        --solver auto --attn flash --attn-max-res 32 --output-dir eval

It runs on the card unless `--device cpu` is passed. The weights come from
a release npz (`--params-npz`), the port's own checkpoints
(`--checkpoint-dir`, the best by val PSNR, else the latest; `--use-ema`) or
`--random-init`. `--real N` evaluates on N bundled photographic patches
(the 'eval' split of data/real_patches.py, beside any `--synthetic`
images); `--consistency callback|host_loop` projects through the exact
host codec each step.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ddpm_image_restoration_tpu_torch.cli.common import (
    add_codec_flags,
    add_model_flags,
    add_weights_flags,
    build_restore_model,
    eval_config_from,
    refuse_not_ported,
    resolve_codecs,
)


def _parse_protect_adaptive(v):
    """--protect-adaptive BETA: a float trust multiplier, or 'auto' = the
    calibrated quality-tapered real-photo schedule (policy.REAL_PHOTO_TRUST)."""
    if v is None:
        return None
    if isinstance(v, str) and v.lower() == "auto":
        from ddpm_image_restoration_tpu_torch.diffusion.policy import REAL_PHOTO_TRUST

        return REAL_PHOTO_TRUST
    return float(v)


def main(argv=None):
    """Parse flags and evaluate; returns the metrics summary."""
    ap = argparse.ArgumentParser(description="Evaluate restoration quality across quality levels")
    add_codec_flags(ap)
    add_model_flags(ap)
    add_weights_flags(ap)
    ap.add_argument("--remat", action="store_true",
                    help="training only: evaluation runs no backward, so this "
                         "changes nothing (kept with the JAX CLI's flags)")
    ap.add_argument("--data-dir", default="./ILSVRC2012_img_val")
    ap.add_argument("--output-dir", default="./eval_results")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--max-images", type=int, default=0, help="0 = all (AVIF ref caps at 500)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--consistency", default="surrogate",
                    choices=["surrogate", "callback", "host_loop"])
    ap.add_argument("--no-fid", action="store_true")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N")
    ap.add_argument("--synthetic-seed", type=int, default=99,
                    help="synthetic eval images use a held-out seed by default")
    ap.add_argument("--synthetic-kind", default="waves",
                    choices=["waves", "dead_leaves", "natural", "mixed"],
                    help="synthetic generator (dead_leaves = natural-image-"
                         "statistics proxy: occluding power-law disks)")
    ap.add_argument("--real", type=int, default=0, metavar="N",
                    help="evaluate on N real photographic patches harvested from "
                         "package-bundled photographs (-1 = all; the 'eval' split, "
                         "disjoint from train --real patches)")
    ap.add_argument("--prediction", default="direct", choices=["direct", "residual"])
    ap.add_argument("--stride", type=int, default=1, help=">1 = reduced-step accelerated solver")
    ap.add_argument("--max-evals", type=int, default=0,
                    help="cap model evaluations per restore (stride derived "
                         "from each quality's init_t). Overrides --stride.")
    ap.add_argument("--encoder-reuse", type=int, default=1,
                    help="run the UNet encoder only every k-th model evaluation")
    ap.add_argument("--decoder-reuse-depth", type=int, default=0,
                    help="with --encoder-reuse > 1: also run the deep decoder "
                         "stages once per reuse group, recomputing only the "
                         "last N stages and the head")
    ap.add_argument("--solver", default="manual", choices=["manual", "auto"],
                    help="'auto' = the per-quality production policy "
                         "(diffusion/policy.py): overrides --stride/--max-evals/"
                         "--encoder-reuse per quality")
    ap.add_argument("--traced", action="store_true",
                    help="traced-budget solver: every image its own schedule in "
                         "a fixed number of slots (needs --max-evals or "
                         "--solver auto)")
    ap.add_argument("--ensemble", type=int, default=1, choices=[1, 2, 4, 8],
                    help="dihedral test-time self-ensemble over N flip/rotation variants")
    ap.add_argument("--qualities", type=int, nargs="*", default=None,
                    help="override the preset's eval quality list")
    ap.add_argument("--no-final-exact", action="store_true",
                    help="skip the bit-exact host-codec recomputation of the "
                         "final consistency projection")
    ap.add_argument("--protect-adaptive", default=None, metavar="BETA",
                    help="cap the restoration residual's local RMS at BETA x the "
                         "calibrated codec damage D(quality); 'auto' = the "
                         "real-photo schedule")
    ap.add_argument("--protect", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                    help="quality-gated blend: full restoration at q<=LO, "
                         "untouched input at q>=HI")
    ap.add_argument("--eta", type=float, default=None,
                    help="override the sampler's noise weight eta (0 = no noise)")
    ap.add_argument("--eta-b", type=float, default=None,
                    help="override the consistency blend eta_b")
    ap.add_argument("--init-t", type=int, default=0,
                    help="pin the solver start step for every quality (0 = "
                         "per-quality clamp((100-q)/100*steps, lo, hi))")
    ap.add_argument("--phase-threshold", type=int, default=None,
                    help="override the phase-consistency quality gate (0 disables it)")
    args = ap.parse_args(argv)
    refuse_not_ported(args)
    codec, model_codec = resolve_codecs(args, allow_auto=False)
    args.codec = codec

    from ddpm_image_restoration_tpu_torch.data.dataset import (
        ImageFolderDataset,
        SyntheticImageDataset,
        split_indices,
    )
    from ddpm_image_restoration_tpu_torch.evaluation.harness import evaluate_restoration

    cfg = eval_config_from(args)
    if args.qualities:
        cfg = dataclasses.replace(cfg, qualities_override=tuple(args.qualities))
    model = build_restore_model(model_codec, args)

    parts = []
    if args.synthetic:
        parts.append(SyntheticImageDataset(args.synthetic, cfg.model.image_size,
                                           seed=args.synthetic_seed, kind=args.synthetic_kind))
    if args.real:
        from ddpm_image_restoration_tpu_torch.data.real_patches import RealPatchDataset

        # the split's permutation keeps RealPatchDataset's default seed, the
        # one the trainer's --real split uses, so the two never overlap
        parts.append(RealPatchDataset(0 if args.real < 0 else args.real, cfg.model.image_size,
                                      split="eval"))
    if parts:
        from ddpm_image_restoration_tpu_torch.data.real_patches import ConcatDataset

        ds = parts[0] if len(parts) == 1 else ConcatDataset(*parts)
        test_idx = np.arange(len(ds))
    else:
        ds = ImageFolderDataset(args.data_dir, cfg.model.image_size)
        _, _, test_idx = split_indices(len(ds))  # seeded test split
    images = np.stack([ds[int(i)] for i in test_idx])

    return evaluate_restoration(
        cfg, model, images, batch_size=args.batch_size, prediction=args.prediction,
        stride=args.stride, encoder_reuse=args.encoder_reuse,
        decoder_reuse_depth=args.decoder_reuse_depth, ensemble=args.ensemble,
        max_evals=args.max_evals, final_exact=False if args.no_final_exact else None,
        protect=tuple(args.protect) if args.protect else None,
        protect_adaptive=_parse_protect_adaptive(args.protect_adaptive),
        eta=args.eta, eta_b=args.eta_b, init_t_override=args.init_t,
        phase_threshold=args.phase_threshold, solver=args.solver, traced=args.traced)


if __name__ == "__main__":
    main()
