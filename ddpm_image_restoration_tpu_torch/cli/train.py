"""Training entry point (port of cli/train.py, the JAX package's
`ddpm-ir-train`):

    python -m ddpm_image_restoration_tpu_torch.cli.train --codec webp \
        --attn flash --attn-max-res 32 --ema-decay 0.999 \
        --synthetic 400 --synthetic-kind natural --epochs 10 \
        --checkpoint-dir ./ckpt

Runs on `--device` (default cuda; there is no fallback to the CPU). The
flags of what the port has not implemented yet raise with a message:
`--real`, `--fsdp`, `--remat`, `--consistency callback|host_loop` and
`--auto-restart`. Every codec trains: `--codec all` is the unified model on
mixed-codec batches.
"""

from __future__ import annotations

import argparse

from ddpm_image_restoration_tpu_torch.cli.common import add_model_flags, train_config_from

# Flags that select no config field; the trainer refuses the config values
# it has not ported (train/loop.py check_supported).
_NOT_PORTED = {
    "real": "--real (bundled photographic patches: data/real_patches.py is not ported)",
    "auto_restart": "--auto-restart (the crash-resume guard)",
}


def main(argv=None):
    """Parse flags and train; returns train_model's (state, history)."""
    ap = argparse.ArgumentParser(description="Train a codec-restoration diffusion model")
    ap.add_argument("--codec", default="webp", choices=["webp", "jpeg", "avif", "all"])
    add_model_flags(ap)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--steps", type=int, default=100, help="diffusion timesteps")
    ap.add_argument("--batch-size", type=int, default=0, help="0 = codec preset default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir", default="./ILSVRC2012_img_val")
    ap.add_argument("--data-workers", type=int, default=4,
                    help="batch-producer threads for decode+degrade (the batch "
                         "stream is identical for any count)")
    ap.add_argument("--no-cache-decoded", action="store_true",
                    help="disable the decoded-image RAM cache")
    ap.add_argument("--checkpoint-dir", default="./checkpoints")
    ap.add_argument("--consistency", default="surrogate",
                    choices=["surrogate", "callback", "host_loop"])
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on N synthetic images instead of --data-dir")
    ap.add_argument("--synthetic-kind", default="waves",
                    choices=["waves", "dead_leaves", "natural", "mixed"])
    ap.add_argument("--real", type=int, default=0, metavar="N")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="learning rate (0 = the codec preset's reference value)")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="EMA of params for validation/serving (e.g. 0.999); 0 = off")
    ap.add_argument("--ckpt-interval", type=int, default=1,
                    help="minimum epochs between checkpoint saves (the last epoch always saves)")
    ap.add_argument("--augment", action="store_true",
                    help="dihedral-8 augmentation of the clean image before degradation")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--auto-restart", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"{what} is not ported yet")

    cfg = train_config_from(args)
    dataset = None
    if args.synthetic:
        from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset

        dataset = SyntheticImageDataset(args.synthetic, cfg.model.image_size,
                                        kind=args.synthetic_kind)

    from ddpm_image_restoration_tpu_torch.train.loop import train_model

    return train_model(cfg, dataset=dataset, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
