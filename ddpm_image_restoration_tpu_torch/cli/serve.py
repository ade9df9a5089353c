"""Batch restoration service on the card: `python -m
ddpm_image_restoration_tpu_torch.cli.serve` (port of cli/serve.py).

Watches a directory for images, restores them in batches with the DDRM
sampler and writes `<name>_restored.png` to the output directory, moving
each served input to `<watch>/done` (undecodable ones to `<watch>/rejected`).

    python -m ddpm_image_restoration_tpu_torch.cli.serve --watch ./in \
        --output-dir ./out --codec webp --quality 30 --params-npz w.npz \
        --solver auto --attn flash --attn-max-res 32 --once

`restore_batch` is the server core for callers that hold tensors. Pillow is
needed only to read and write the image files (and for the exact final
projection); the core runs without it when `final_exact=False`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.codecs.quality import (
    init_timestep_for_quality,
    student_stride,
)
from ddpm_image_restoration_tpu_torch.config import ModelConfig, codec_index, get_preset
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
from ddpm_image_restoration_tpu_torch.diffusion.policy import production_solver_config

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".avif")


def solver_for(init_t: int, quality: float, codec: str, solver: str = "auto",
               stride: int = 1, max_evals: int = 0, encoder_reuse: int = 1) -> tuple:
    """(stride, encoder_reuse, eta, protect) for one batch. 'auto' is the
    production policy (diffusion/policy.py); otherwise `max_evals` derives
    the stride when set, else `stride` as given. eta None = the preset's."""
    if solver == "auto":
        pc = production_solver_config(quality, codec)
        return (student_stride(init_t, pc["max_evals"]), pc["encoder_reuse"],
                pc.get("eta"), pc.get("protect"))
    if max_evals:
        return student_stride(init_t, max_evals), encoder_reuse, None, None
    return stride, encoder_reuse, None, None


def restore_batch(model, y: torch.Tensor, quality: int, codec: str = "webp",
                  steps: int = 100, solver: str = "auto", stride: int = 1,
                  max_evals: int = 0, encoder_reuse: int = 1, final_exact: bool = True,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Restore the NHWC batch `y` in [-1,1], compressed by `codec` at
    `quality`, with `model` (which holds its weights, on y's device).
    Returns what the server writes: the restoration clipped to [-1,1]."""
    preset = get_preset(codec)
    init_t = init_timestep_for_quality(int(quality), steps, preset)
    b_stride, b_enc, b_eta, b_protect = solver_for(
        init_t, float(quality), codec, solver, stride, max_evals, encoder_reuse)
    codec_id = codec_index(codec) if model.cfg.codec_conditioning else None
    out = DDRMSampler(model, preset, codec_id=codec_id).sample(
        y, float(quality), init_t, stride=b_stride, protect=b_protect,
        encoder_reuse=b_enc, eta=b_eta, final_exact=final_exact, generator=generator)
    return out.clamp(-1.0, 1.0)


def _load(path, size):
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0) * 2.0 - 1.0


def _save(path, x):
    from PIL import Image

    Image.fromarray(np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)).save(path)


def main(argv=None):
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.checkpoint import load_release_params

    ap = argparse.ArgumentParser(description="Directory-watching restoration service")
    ap.add_argument("--watch", required=True, help="input directory to watch")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--codec", default="webp", choices=["webp", "jpeg"])
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--width-scale", type=int, default=1,
                    help="divide all channel widths by this")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--attn", default="xla", choices=["xla", "flash"])
    ap.add_argument("--attn-max-res", type=int, default=1024,
                    help="apply self-attention only at spatial sizes <= this")
    ap.add_argument("--params-npz", default=None,
                    help="serve from a release npz (the JAX package's "
                         "export format)")
    ap.add_argument("--random-init", action="store_true",
                    help="serve seeded random weights (no --params-npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quality", type=int, default=30,
                    help="quality the inputs were compressed at")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--solver", default="manual", choices=["manual", "auto"],
                    help="'auto' = the production policy (diffusion/policy.py)")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max-evals", type=int, default=0,
                    help="cap model evaluations per restore (overrides --stride)")
    ap.add_argument("--encoder-reuse", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--poll-seconds", type=float, default=1.0)
    ap.add_argument("--once", action="store_true", help="drain the directory and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.params_npz and not args.random_init:
        ap.error("pass --params-npz or --random-init")

    cfg = ModelConfig(image_size=args.image_size, compute_dtype=args.compute_dtype,
                      attention_impl=args.attn, attn_max_resolution=args.attn_max_res)
    if args.width_scale > 1:
        cfg = cfg.scaled(args.width_scale)
    torch.manual_seed(args.seed)
    model = build_model(args.codec, cfg, device=args.device)
    if args.params_npz:
        model.load_state_dict(load_release_params(args.params_npz))
        print(f"serving with release params: {args.params_npz}", flush=True)
    dev = model.out_conv.weight.device
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    os.makedirs(args.output_dir, exist_ok=True)
    done_dir = os.path.join(args.watch, "done")
    reject_dir = os.path.join(args.watch, "rejected")
    os.makedirs(done_dir, exist_ok=True)
    served = 0
    while True:
        files = sorted(
            f for f in os.listdir(args.watch)
            if f.lower().endswith(_EXTS) and os.path.isfile(os.path.join(args.watch, f))
        )
        if not files:
            if args.once:
                break
            time.sleep(args.poll_seconds)
            continue
        batch, imgs = [], []
        for f in files[: args.batch_size]:
            try:
                imgs.append(_load(os.path.join(args.watch, f), args.image_size))
                batch.append(f)
            except Exception as e:  # a corrupt upload must not stop the server
                os.makedirs(reject_dir, exist_ok=True)
                os.replace(os.path.join(args.watch, f), os.path.join(reject_dir, f))
                print(f"rejected undecodable input {f}: {e}", flush=True)
        if not batch:
            continue
        y = torch.as_tensor(np.stack(imgs), device=dev)
        out = restore_batch(model, y, args.quality, args.codec, args.steps, args.solver,
                            args.stride, args.max_evals, args.encoder_reuse,
                            generator=generator).cpu().numpy()
        for f, img in zip(batch, out):
            _save(os.path.join(args.output_dir, os.path.splitext(f)[0] + "_restored.png"), img)
            os.replace(os.path.join(args.watch, f), os.path.join(done_dir, f))
        served += len(batch)
        print(f"restored {len(batch)} images (total {served})", flush=True)
    print(f"done; served {served} images", flush=True)


if __name__ == "__main__":
    main()
