"""Shared CLI plumbing: model and training configs from flags (port of
cli/common.py; the JAX-only `--platform` and compile-cache setup have no
counterpart, and `--device` picks the card or the CPU)."""

from __future__ import annotations

import argparse

from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """Flags of the model's shape, dtype, attention and device."""
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--width-scale", type=int, default=1,
                    help="divide all channel widths by this (quick experiments)")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--attn", default="xla", choices=["xla", "flash"])
    ap.add_argument("--attn-max-res", type=int, default=1024,
                    help="apply self-attention only at spatial sizes <= this")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (the default) raises when no card is visible")


def model_config_from(args) -> ModelConfig:
    cfg = ModelConfig(
        image_size=args.image_size,
        compute_dtype=args.compute_dtype,
        attention_impl=args.attn,
        attn_max_resolution=args.attn_max_res,
        remat=getattr(args, "remat", False),
    )
    if args.width_scale > 1:
        cfg = cfg.scaled(args.width_scale)
    return cfg


def train_config_from(args) -> TrainConfig:
    return TrainConfig(
        codec=args.codec,
        model=model_config_from(args),
        epochs=args.epochs,
        steps=args.steps,
        batch_size=args.batch_size,
        seed=args.seed,
        data_dir=args.data_dir,
        checkpoint_dir=args.checkpoint_dir,
        consistency_mode=args.consistency,
        ema_decay=args.ema_decay,
        fsdp=args.fsdp,
        data_workers=args.data_workers,
        cache_decoded=not args.no_cache_decoded,
        lr_override=args.lr,
        ckpt_min_interval=args.ckpt_interval,
        augment=args.augment,
    )
