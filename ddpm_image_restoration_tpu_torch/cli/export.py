"""Export a training checkpoint as the release npz (port of the JAX
package's scripts/export_release_ckpt.py):

    python -m ddpm_image_restoration_tpu_torch.cli.export ./ckpt --codec webp \
        --out artifacts/webp_release.npz [--raw-params]

A checkpoint of `cli/train.py` (`train/checkpoint.py CheckpointManager`,
`ckpt_<step>.pt`) carries the f32 masters, both Adam moments and the EMA. A
release artifact is the inference weights alone, as one fp16 npz in the JAX
package's layout (`export_release_params`), which both packages'
`load_release_params` and the CLIs' `--params-npz` read. The export takes
the best checkpoint by val_psnr, else the latest, and its EMA weights where
the checkpoint has them, else its raw ones; `--raw-params` takes the raw
ones. `--image-size`, `--attn-max-res` and `--width-scale` (the port's
`cli/train.py` flag; the JAX script exports full widths only) must match the
training run: attention submodules exist only at levels <= --attn-max-res.
The model template is built on `--device` (default cuda, which raises
without a card).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Export a training checkpoint as a release npz")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--codec", default="webp", choices=["webp", "jpeg", "avif", "all"])
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--attn-max-res", type=int, default=32,
                    help="must match the training setting: attention submodules (and "
                         "their params) only exist at levels <= this")
    ap.add_argument("--width-scale", type=int, default=1,
                    help="must match the training setting (channel widths divided by this)")
    ap.add_argument("--raw-params", action="store_true",
                    help="export the raw (non-EMA) params")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model template; 'cuda' (the default) raises "
                         "when no card is visible")
    return ap.parse_args(argv)


def release_template(args: argparse.Namespace):
    """The model the flags describe, in f32 on `args.device`: the f32
    masters reach the npz's fp16 rounded once (a bf16 body, the default
    compute dtype, would round them to bf16 first)."""
    from ddpm_image_restoration_tpu_torch.config import ModelConfig
    from ddpm_image_restoration_tpu_torch.device import resolve_device
    from ddpm_image_restoration_tpu_torch.models import build_model

    cfg = ModelConfig(image_size=args.image_size, attn_max_resolution=args.attn_max_res,
                      compute_dtype="float32")
    if args.width_scale > 1:
        cfg = cfg.scaled(args.width_scale)
    return build_model(args.codec, cfg, device=resolve_device(args.device))


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np

    from ddpm_image_restoration_tpu_torch.device import resolve_device
    from ddpm_image_restoration_tpu_torch.train.checkpoint import (
        CheckpointManager,
        export_release_params,
    )

    resolve_device(args.device)
    found = None
    if os.path.isdir(args.checkpoint_dir):
        mgr = CheckpointManager(args.checkpoint_dir)
        found = mgr.restore_params(ema=not args.raw_params)
        if found is not None and found[0] is None:  # trained without an EMA
            found = mgr.restore_params(ema=False)
    if found is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    params, meta = found
    model = release_template(args)
    try:
        model.load_state_dict(params)
    except RuntimeError as e:
        raise SystemExit(f"the checkpoint does not fit a {args.codec} model at --image-size "
                         f"{args.image_size}, --attn-max-res {args.attn_max_res}, "
                         f"--width-scale {args.width_scale} (they must match training):\n"
                         f"{e}") from None
    out = export_release_params(model, args.out, codec=args.codec, meta=meta)
    data = np.load(out)
    n = sum(data[k].size for k in data.files if not k.startswith("__"))
    print(f"exported {n/1e6:.1f}M params -> {out} "
          f"({os.path.getsize(out)/1e6:.0f} MB), meta={meta}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
