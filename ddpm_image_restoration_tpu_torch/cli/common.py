"""Shared CLI plumbing: model, training and evaluation configs from flags,
and the restore/serve/evaluate codec flags (port of cli/common.py; the JAX-only `--platform`
and compile-cache setup have no counterpart, and `--device` picks the card
or the CPU)."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.config import (
    EvalConfig,
    ModelConfig,
    TrainConfig,
    codec_index,
)
from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.parallel.mesh import (
    DATA,
    SPATIAL,
    axis_rank,
    broadcast_object,
    gather_batch,
    init_distributed,
    make_mesh,
    rank,
    shard_rows,
    world_size,
)


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


def load_image(path: str, size: int | None) -> np.ndarray:
    """An image file as HWC float32 in [-1,1], squashed to size x size
    unless size is None (Pillow, imported here)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0) * 2.0 - 1.0


def save_image(path: str, x: np.ndarray) -> None:
    """HWC [-1,1] -> 8-bit PNG (clipped)."""
    from PIL import Image

    Image.fromarray(np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)).save(path)


def add_weights_flags(ap: argparse.ArgumentParser) -> None:
    """Where the restore/serve CLIs take their weights from."""
    ap.add_argument("--checkpoint-dir", default="./checkpoints",
                    help="the port's own train/checkpoint.py checkpoints (the "
                         "best by val_psnr, else the latest)")
    ap.add_argument("--params-npz", default=None,
                    help="load the weights from a release npz (the JAX "
                         "package's export format) instead of a checkpoint")
    ap.add_argument("--use-ema", action="store_true",
                    help="restore with the EMA weights of a checkpoint trained "
                         "with --ema-decay > 0")
    ap.add_argument("--random-init", action="store_true",
                    help="PyTorch's init under torch.manual_seed(0), no "
                         "weights loaded (smoke tests)")


def weights_from(args) -> tuple:
    """(state_dict, description) of the weights the flags of
    `add_weights_flags` name; the state_dict is None for --random-init.
    Raises SystemExit when there is no checkpoint to read, before any model
    is built."""
    from ddpm_image_restoration_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_release_params,
    )

    if args.params_npz:
        return load_release_params(args.params_npz), f"release params: {args.params_npz}"
    if args.random_init:
        return None, "random init (PyTorch's init under torch.manual_seed(0))"
    found = None
    if os.path.isdir(args.checkpoint_dir):
        found = CheckpointManager(args.checkpoint_dir).restore_params(ema=args.use_ema)
    if found is None:
        raise SystemExit(
            f"no checkpoint under {args.checkpoint_dir}: the port reads the "
            "ckpt_<step>.pt files of its own cli/train.py; the JAX package's "
            "Orbax checkpoints are not readable here (export them with "
            "scripts/export_release_ckpt.py and pass --params-npz)")
    params, meta = found
    if params is None:
        raise SystemExit("--use-ema: checkpoint has no EMA params "
                         "(train with --ema-decay > 0)")
    return params, f"checkpoint: {meta}"


def build_restore_model(model_codec: str, args):
    """The model of `model_codec` on `--device` with the weights the flags
    name (PyTorch's init under torch.manual_seed(0) for --random-init)."""
    from ddpm_image_restoration_tpu_torch.models import build_model

    params, what = weights_from(args)
    torch.manual_seed(0)
    model = build_model(model_codec, model_config_from(args), device=args.device)
    if params is not None:
        model.load_state_dict(params)
    print(f"weights: {what}", flush=True)
    return model


def add_codec_flags(ap: argparse.ArgumentParser) -> None:
    """`--codec` and `--model-codec` of the restore, serve and evaluate CLIs."""
    ap.add_argument("--codec", default="webp",
                    choices=["webp", "jpeg", "avif", "all", "auto"],
                    help="codec the inputs were compressed with; 'auto' detects "
                         "each input's codec from its bitstream and dispatches "
                         "(needs --model-codec all, or a matching single-codec "
                         "checkpoint); 'all' is a training preset and is refused")
    ap.add_argument("--model-codec", default="",
                    help="codec the weights were trained for when it differs "
                         "from --codec: 'all' pairs a unified checkpoint with "
                         "any target codec (default: same as --codec)")


def resolve_codecs(args, allow_auto: bool = True) -> tuple:
    """(target_codec, model_codec) for the restore/serve/evaluate CLIs. The
    target is what the inputs were compressed with (sampler preset and
    consistency codec); the model codec is what the weights were trained as
    ('all' = unified multi-codec). 'auto' as target means per-file detection
    (restore/serve only: `allow_auto`)."""
    codec = args.codec.lower()
    if codec == "all":
        raise SystemExit(
            "--codec all is a TRAINING preset; restoration/evaluation "
            "target one codec at a time — use --model-codec all with "
            "--codec jpeg|webp|avif" + ("|auto" if allow_auto else "")
        )
    if codec == "auto" and not allow_auto:
        raise SystemExit("--codec auto applies to restore/serve only")
    model_codec = (args.model_codec or codec).lower()
    if model_codec == "auto":
        raise SystemExit("--codec auto needs --model-codec: the preset the "
                         "checkpoint was trained as (jpeg|webp|avif|all)")
    return codec, model_codec


def sampler_codec_id(model, codec: str):
    """Conditioning id for a (possibly unified) model restoring `codec`."""
    return codec_index(codec) if model.cfg.codec_conditioning else None


class DataParallel:
    """`--dp N` of the restore and serve CLIs (the JAX package's data mesh of
    min(N, device count) devices, all of them for N = -1): a ('data',) mesh
    of min(N, world) ranks of the process group (`torchrun`), one rank
    without --dp. With `axis` 'spatial' it is `--sp N` of the restore CLI: a
    ('spatial',) mesh of as many ranks, clamped to the largest divisor of
    the image `height` (the height is split unpadded: codec block grids make
    padding it wrong), with the JAX CLI's message. Rank 0 of the mesh reads
    the inputs and writes the outputs; `share` hands what it read to the
    other ranks, and `run` restores a batch: over 'data' each rank takes its
    block of rows (the batch padded to a multiple of the mesh); over
    'spatial' each rank restores the whole batch, its model splitting the
    height (`parallel.mesh.shard_inference_spatial`). A rank outside the
    mesh is not `active` and has nothing to do. In one process both are the
    identity."""

    def __init__(self, want: int, device: str, axis: str = DATA, height: int = 0):
        init_distributed(device)
        world = world_size()
        self.n = world if want < 0 else max(1, min(want, world))
        if axis == SPATIAL and want:
            while height % self.n:
                self.n -= 1
            if self.n != (want if want > 0 else world):
                print(f"--sp: clamped mesh to {self.n} device(s) (largest divisor of image "
                      f"height {height})", flush=True)
        self.axis = axis
        self.mesh = make_mesh((self.n,), (axis,))
        self.device = device
        r = axis_rank(self.mesh, axis)
        self.active, self.main = r is not None, r == 0
        if not self.active:
            print(f"rank {rank()}: outside the {axis} mesh of {self.n} of {world} rank(s); "
                  "nothing to do", flush=True)

    def share(self, obj):
        """Rank 0's `obj` (picklable) on every rank of the mesh."""
        return broadcast_object(obj, self.mesh, self.axis)

    def run(self, fn, batch: np.ndarray) -> np.ndarray:
        """`fn(batch, rows)` restores rows (start, stop) of the whole NHWC
        `batch` (`rows` None: all of it) and returns them as numpy; this
        returns the whole restored batch, gathered, on every rank."""
        if self.mesh is None or self.axis == SPATIAL:
            return fn(batch, None)
        mine = fn(batch, shard_rows(len(batch), self.mesh))
        return gather_batch(torch.as_tensor(mine, device=resolve_device(self.device)),
                            self.mesh, len(batch)).cpu().numpy()


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
        fsdp=getattr(args, "fsdp", False),
        data_workers=args.data_workers,
        cache_decoded=not args.no_cache_decoded,
        lr_override=args.lr,
        ckpt_min_interval=args.ckpt_interval,
        augment=args.augment,
    )


def eval_config_from(args) -> EvalConfig:
    return EvalConfig(
        codec=args.codec,
        model=model_config_from(args),
        steps=args.steps,
        output_dir=args.output_dir,
        max_images=args.max_images,
        consistency_mode=args.consistency,
        compute_fid=not args.no_fid,
    )
