"""Distillation entry point (port of cli/distill.py, the JAX package's
`ddpm-ir-distill`): compresses a trained teacher's multi-step DDRM
restoration into a few-evaluation student (train/distill.py). The output is
an ordinary checkpoint directory of the port; restore, serve or evaluate it
with `--max-evals N` to run the student at its distilled budget:

    python -m ddpm_image_restoration_tpu_torch.cli.train --codec webp \
        --synthetic 256 --epochs 60 --checkpoint-dir ckpt_teacher
    python -m ddpm_image_restoration_tpu_torch.cli.distill --codec webp \
        --synthetic 256 --epochs 30 --teacher-dir ckpt_teacher \
        --checkpoint-dir ckpt_student --n-eval 2
    python -m ddpm_image_restoration_tpu_torch.cli.restore in.webp \
        --codec webp --checkpoint-dir ckpt_student --max-evals 2

It runs on `--device` (default cuda; `--device cpu` on the CPU).
`--codec auto|all` is refused: distillation trains through one codec's
consistency projection.
"""

from __future__ import annotations

import argparse

from ddpm_image_restoration_tpu_torch.cli.common import add_model_flags, train_config_from


def main(argv=None):
    """Parse flags and distill; returns distill_model's (state, history)."""
    ap = argparse.ArgumentParser(
        description="Distill a trained DDRM restorer into a few-eval student")
    ap.add_argument("--codec", default="webp", choices=["webp", "jpeg", "avif", "all", "auto"],
                    help="the codec to distill for (auto and all are refused)")
    ap.add_argument("--model-codec", default="",
                    help="kept with the JAX CLI's flags; distillation reads the "
                         "teacher as --codec")
    add_model_flags(ap)
    ap.add_argument("--remat", action="store_true",
                    help="also rematerialise each UNet block of the student in the "
                         "backward (each solver step is rematerialised anyway)")
    ap.add_argument("--teacher-dir", default="",
                    help="checkpoint directory of the trained teacher (its best "
                         "checkpoint, EMA weights when present)")
    ap.add_argument("--teacher-npz", default="",
                    help="release-npz teacher weights instead (overrides --teacher-dir)")
    ap.add_argument("--n-eval", type=int, default=1,
                    help="student model evaluations per restore")
    ap.add_argument("--teacher-stride", type=int, default=1,
                    help="teacher solver stride (1 = full solver)")
    ap.add_argument("--qualities", type=int, nargs="+", default=[],
                    help="quality buckets to distill (default: the codec preset's "
                         "whole eval quality grid)")
    ap.add_argument("--gt-weight", type=float, default=0.3,
                    help="weight of the clean-image term of the distillation loss")
    ap.add_argument("--progressive", action="store_true",
                    help="halve the eval budget stage by stage down to --n-eval "
                         "(each stage's student teaches the next)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--steps", type=int, default=100, help="diffusion timesteps")
    ap.add_argument("--batch-size", type=int, default=0, help="0 = codec preset default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir", default="./ILSVRC2012_img_val")
    ap.add_argument("--data-workers", type=int, default=4)
    ap.add_argument("--no-cache-decoded", action="store_true")
    ap.add_argument("--checkpoint-dir", default="./checkpoints_distilled")
    ap.add_argument("--consistency", default="surrogate",
                    choices=["surrogate", "callback", "host_loop"],
                    help="consistency mode of the VALIDATION restores (the student "
                         "always trains through the differentiable surrogate)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="distill on N synthetic images instead of --data-dir")
    ap.add_argument("--synthetic-kind", default="waves",
                    choices=["waves", "dead_leaves", "natural", "mixed"])
    ap.add_argument("--ema-decay", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=0.0,
                    help="learning rate (0 = the codec preset's training value)")
    ap.add_argument("--ckpt-interval", type=int, default=1,
                    help="minimum epochs between checkpoint saves (the last epoch "
                         "always saves)")
    ap.add_argument("--augment", action="store_true",
                    help="dihedral-8 augmentation of the clean image before degradation")
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)
    if args.codec in ("auto", "all"):
        raise SystemExit("distillation is per-codec: --codec jpeg|webp|avif")
    if not args.teacher_dir and not args.teacher_npz:
        ap.error("one of --teacher-dir / --teacher-npz is required")

    from ddpm_image_restoration_tpu_torch.train.distill import DistillConfig, distill_model

    cfg = train_config_from(args)
    dcfg = DistillConfig(teacher_dir=args.teacher_dir, teacher_npz=args.teacher_npz,
                         n_eval=args.n_eval, teacher_stride=args.teacher_stride,
                         qualities=tuple(args.qualities), gt_weight=args.gt_weight,
                         progressive=args.progressive)
    dataset = None
    if args.synthetic:
        from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset

        dataset = SyntheticImageDataset(args.synthetic, cfg.model.image_size,
                                        kind=args.synthetic_kind)
    return distill_model(cfg, dcfg, dataset=dataset, resume=not args.no_resume,
                         device=args.device)


if __name__ == "__main__":
    main()
