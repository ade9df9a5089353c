"""Training entry point (port of cli/train.py, the JAX package's
`ddpm-ir-train`):

    python -m ddpm_image_restoration_tpu_torch.cli.train --codec webp \
        --attn flash --attn-max-res 32 --ema-decay 0.999 \
        --synthetic 400 --synthetic-kind natural --epochs 10 \
        --checkpoint-dir ./ckpt

Runs on `--device` (default cuda; there is no fallback to the CPU). Every
codec trains: `--codec all` is the unified model on mixed-codec batches.
`--real N` adds bundled photographic patches (data/real_patches.py) to the
training set, `--remat` rematerialises each UNet block in the backward,
`--consistency callback|host_loop` validates through the exact host codec,
and `--auto-restart N` resumes from the last checkpoint after a crash, up to
N times.

Under `torchrun` it trains data-parallel over gcd(batch size, ranks) ranks,
each rank on its own card (`cuda:LOCAL_RANK`, NCCL) and its own block of
every batch; `--fsdp` also splits the f32 masters, both Adam moments and the
EMA over them. Rank 0 logs and writes the checkpoints, which load into any
world size:

    torchrun --nproc-per-node 8 -m ddpm_image_restoration_tpu_torch.cli.train \
        --codec webp --attn flash --attn-max-res 32 --ema-decay 0.999 \
        --batch-size 144 --fsdp --synthetic 4000 --checkpoint-dir ./ckpt
"""

from __future__ import annotations

import argparse

from ddpm_image_restoration_tpu_torch.cli.common import add_model_flags, train_config_from


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
    ap.add_argument("--real", type=int, default=0, metavar="N",
                    help="append N real photographic patches from package-bundled "
                         "images to the training set (-1 = all; the 'train' split, "
                         "disjoint from evaluate --real)")
    ap.add_argument("--fsdp", action="store_true",
                    help="under torchrun: split the f32 masters, Adam moments and EMA "
                         "over the data-parallel ranks (ZeRO-3)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialise each UNet block in the backward (less "
                         "activation memory, one more forward of each block)")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="learning rate (0 = the codec preset's reference value)")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="EMA of params for validation/serving (e.g. 0.999); 0 = off")
    ap.add_argument("--ckpt-interval", type=int, default=1,
                    help="minimum epochs between checkpoint saves (the last epoch always saves)")
    ap.add_argument("--augment", action="store_true",
                    help="dihedral-8 augmentation of the clean image before degradation")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--auto-restart", type=int, default=0, metavar="N",
                    help="on a crash, resume from the last checkpoint, up to N times")
    args = ap.parse_args(argv)

    cfg = train_config_from(args)
    dataset = None
    if args.synthetic:
        from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset

        dataset = SyntheticImageDataset(args.synthetic, cfg.model.image_size,
                                        kind=args.synthetic_kind)
    if args.real:
        from ddpm_image_restoration_tpu_torch.data.real_patches import (
            ConcatDataset,
            RealPatchDataset,
        )

        real = RealPatchDataset(0 if args.real < 0 else args.real, cfg.model.image_size,
                                split="train", augment=True)
        dataset = real if dataset is None else ConcatDataset(dataset, real)

    from ddpm_image_restoration_tpu_torch.train.loop import train_model

    attempts = 0
    while True:
        try:
            return train_model(cfg, dataset=dataset, device=args.device,
                               resume=not args.no_resume or attempts > 0)
        except KeyboardInterrupt:
            raise
        except Exception as e:
            attempts += 1
            if attempts > args.auto_restart:
                raise
            print(f"training crashed ({type(e).__name__}: {e}); resuming from the last "
                  f"checkpoint (attempt {attempts}/{args.auto_restart})", flush=True)


if __name__ == "__main__":
    main()
