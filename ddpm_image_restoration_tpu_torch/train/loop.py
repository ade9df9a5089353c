"""The training driver: epochs, validation by restoration, checkpoints,
training curves and restoration grids (port of train/loop.py).

As in the JAX package (train_model_ddrm_* webp_training.py:773-822):
  * per-epoch training under the quality curriculum (in the data pipeline);
  * per-epoch validation that runs the full DDRM sampler at the preset's
    val qualities from init_t = clamp((100−q)/100·steps, ...) and reports
    PSNR/SSIM (webp_training.py:540-599), on the EMA weights when the EMA is
    on (the weights that serving loads); a distilled student validates at
    its own evaluation budget (`n_eval`);
  * checkpoints on a new best val PSNR and every 10 epochs, at most every
    `ckpt_min_interval` epochs, and always after the last epoch, with true
    resume;
  * the training curves every epoch and a restoration grid every
    `viz_every` epochs (utils/viz.py; without matplotlib they warn and are
    skipped, but the grid's restore still runs).

Every codec preset trains: 'jpeg', 'webp', 'avif' and the unified 'all'
model (per-sample mixed-codec batches, validated across the three codecs).
Batches stream from the host degradation pipeline while the card runs the
previous step. On a card, in one process, the step replays one captured
CUDA graph (train/steps.py `make_train_step`): the run's first batch runs
eager, the second captures, every later one replays, validation's sampler
graphs in between included; a resumed run captures anew; block remat
(`--remat`) is captured too. Over a mesh the step stays eager.

Under a process group (`torchrun`, parallel/mesh.py) it trains data-parallel
over a ('data',) mesh, by default of gcd(batch, world) ranks as in the JAX
package, and with `fsdp` splits the masters, moments and EMA over it; a mesh
with a 'model' axis too (`TrainConfig.mesh_shape`/`mesh_axes`) adds tensor
parallelism over 'model' (column-parallel layers). As in the JAX trainer,
the axes are found by name, in any order, and an axis that names neither
(e.g. 'spatial') is replicated over: its ranks hold the same parameters and
the same rows of each batch. Each data rank degrades only its block of
every batch. A rank outside the mesh says so and returns at once, taking no
part. Every rank of the mesh validates the whole validation set (the
numbers are one process's); only the mesh's first rank logs, prints, and
writes checkpoints, curves and grids. A mesh without a 'data' axis is
refused, as the JAX trainer cannot run one either.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch
from ddpm_image_restoration_tpu_torch.codecs.quality import (
    init_timestep_for_quality,
    student_stride,
)
from ddpm_image_restoration_tpu_torch.config import CODECS, TrainConfig, codec_index, get_preset
from ddpm_image_restoration_tpu_torch.data.dataset import (
    ImageFolderDataset,
    SyntheticImageDataset,
    split_indices,
)
from ddpm_image_restoration_tpu_torch.data.pipeline import DegradationLoader
from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
from ddpm_image_restoration_tpu_torch.evaluation.metrics import psnr, ssim_metric
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.parallel.mesh import (
    DATA,
    MODEL,
    axis_size,
    broadcast_object,
    data_rank,
    data_size,
    init_distributed,
    is_main,
    make_mesh,
    put_state,
    rank,
    world_size,
)
from ddpm_image_restoration_tpu_torch.train.checkpoint import CheckpointManager
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step
from ddpm_image_restoration_tpu_torch.utils.logging import MetricLogger
from ddpm_image_restoration_tpu_torch.utils.viz import save_restoration_grid, save_training_curves


def check_supported(cfg: TrainConfig) -> None:
    """Raise for a training mesh that no trainer runs: axes that are not
    distinct or do not match the shape's length, or no 'data' axis (the JAX
    trainer shards each batch over 'data', `parallel/mesh.py
    batch_sharding`, and fails without one). Any other mesh trains: 'data'
    and 'model' found by name, in any order; other axes replicated over."""
    axes, shape = tuple(cfg.mesh_axes), tuple(cfg.mesh_shape)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh {shape} over {axes}: a training mesh needs one distinct "
                         "axis name per dimension")
    if DATA not in axes:
        raise ValueError(f"mesh {shape} over {axes}: a training mesh needs a 'data' axis, "
                         "over which each batch is split; the JAX trainer cannot run one "
                         "without it either")


def train_mesh(cfg: TrainConfig, batch_size: int):
    """The training mesh: by default (mesh_shape (-1,) over ('data',))
    gcd(batch_size, world) ranks, the most that split the batch evenly (the
    JAX package's rule); else `cfg.mesh_shape` over `cfg.mesh_axes`, -1
    absorbing the ranks the other axis leaves. None in one process."""
    shape = list(cfg.mesh_shape)
    if shape == [-1] and tuple(cfg.mesh_axes) == ("data",):
        shape = [math.gcd(batch_size, world_size())]
    mesh = make_mesh(shape, cfg.mesh_axes)
    if batch_size % data_size(mesh):
        raise ValueError(f"batch size {batch_size} does not split over a data mesh of "
                         f"{data_size(mesh)}")
    return mesh


def unified_samplers(model, consistency_mode: str = "surrogate") -> Dict[str, DDRMSampler]:
    """One DDRMSampler per real codec for a unified ('all') model: each pairs
    that codec's preset (sampler constants and consistency codec) with its
    conditioning id."""
    return {c: DDRMSampler(model, get_preset(c), codec_id=codec_index(c),
                           consistency_mode=consistency_mode) for c in CODECS}


def validate_by_restoration(model, cfg: TrainConfig, val_images: np.ndarray,
                            sampler=None, generator: Optional[torch.Generator] = None,
                            n_eval: Optional[int] = None) -> Dict[str, float]:
    """Full-sampler validation at the preset's val qualities
    (validate_ddrm_* webp_training.py:540-599) with `model`'s weights, in
    eval mode, through `cfg.consistency_mode`. The sampler's noise (eta > 0)
    comes from `generator` (default: seed 0 on the model's device), so it is
    not the JAX package's noise; the metrics are. `n_eval` caps the model
    evaluations per restore (a distilled student's budget): the stride is
    `student_stride(init_t, n_eval)` per quality.

    Unified ('all') training validates across codecs instead of across
    qualities: one restore per real codec at that codec's middle val
    quality (as many sampler runs as single-codec validation), averaged.
    `sampler` is then the dict of `unified_samplers`."""
    preset = cfg.preset
    dev = next(model.parameters()).device
    generator = generator or torch.Generator(device=dev).manual_seed(0)
    x0 = torch.as_tensor(val_images, device=dev)
    if preset.name == "all":
        samplers = (sampler if isinstance(sampler, dict)
                    else unified_samplers(model, cfg.consistency_mode))
        cases = [(s, c, s.preset.val_qualities[len(s.preset.val_qualities) // 2])
                 for c, s in samplers.items()]
    else:
        one = sampler or DDRMSampler(model, preset, consistency_mode=cfg.consistency_mode)
        cases = [(one, preset.name, q) for q in preset.val_qualities]
    model.eval()
    totals = {"psnr": 0.0, "ssim": 0.0}
    for smp, codec_name, quality in cases:
        y = torch.as_tensor(compress_batch(val_images, codec_name, quality), device=dev)
        init_t = init_timestep_for_quality(quality, cfg.steps, smp.preset)
        stride = 1 if n_eval is None else student_stride(init_t, n_eval)
        restored = smp.sample(y, quality, init_t, stride=stride, generator=generator)
        totals["psnr"] += float(psnr(restored, x0))
        totals["ssim"] += float(ssim_metric(restored, x0))
    n = len(cases)
    return {"val_psnr": totals["psnr"] / n, "val_ssim": totals["ssim"] / n}


def to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors; on a card through pinned memory with
    asynchronous copies, so the host does not wait for the running step."""
    if dev.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def sync_device(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_model(cfg: TrainConfig, dataset=None, epochs: Optional[int] = None,
                val_batch: int = 4, resume: bool = True, verbose: bool = True,
                device: str | torch.device = "cuda"):
    """End-to-end training on `device`. Returns (state, logger.history).

    Each epoch logs `loss` (mean train loss), `val_psnr`, `val_ssim`,
    `epoch_time` (s, with validation) and, when the epoch has more steps
    than its warm-up, `step_ms`: wall time per train step after the
    epoch's warm-up steps, ending in a device synchronise. The warm-up is
    the first step, and on a card the second too (which captures the
    step's graph in the run's first epoch).

    Under a process group every rank calls it (module docstring); a rank
    outside the training mesh returns (None, {})."""
    check_supported(cfg)
    init_distributed(device)
    dev = resolve_device(device)
    epochs = epochs or cfg.epochs
    preset = cfg.preset

    if dataset is None:
        if os.path.isdir(cfg.data_dir):
            dataset = ImageFolderDataset(cfg.data_dir, cfg.model.image_size,
                                         cache_decoded=cfg.cache_decoded)
        else:
            dataset = SyntheticImageDataset(256, cfg.model.image_size)

    train_idx, val_idx, _ = split_indices(len(dataset), cfg.split_fracs, cfg.split_seed)
    batch_size = cfg.effective_batch_size
    if batch_size > len(train_idx):
        # otherwise drop_remainder yields no batch at all and the run never trains
        print(f"warning: batch size {batch_size} > {len(train_idx)} training "
              f"images; clamping to {len(train_idx)}", flush=True)
        batch_size = len(train_idx)
    mesh = train_mesh(cfg, batch_size)
    if data_rank(mesh) is None:
        print(f"rank {rank()}: outside the data mesh of {data_size(mesh)} of "
              f"{world_size()} ranks (batch {batch_size}); it takes no part in training",
              flush=True)
        return None, {}
    main = is_main(mesh)
    verbose = verbose and main
    if main and mesh is not None:
        tp = axis_size(mesh, MODEL)
        others = [a for a in mesh.mesh_dim_names if a not in (DATA, MODEL)]
        print(f"data-parallel training over {data_size(mesh)} rank(s)"
              f"{f', tensor-parallel over {tp}' if tp > 1 else ''}"
              f"{' with FSDP' if cfg.fsdp else ''}"
              + "".join(f", replicated over '{a}' ({axis_size(mesh, a)})" for a in others),
              flush=True)
    loader = DegradationLoader(dataset, train_idx, preset, batch_size, cfg.steps,
                               seed=cfg.seed, num_workers=cfg.data_workers,
                               augment=cfg.augment, rows=(data_rank(mesh), data_size(mesh)))
    if len(val_idx) == 0:  # tiny datasets: validate on training images
        val_idx = train_idx
    val_images = np.stack([dataset[int(i)] for i in val_idx[:val_batch]])

    # The init is made on the CPU from cfg.seed, so it is the same on any device.
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(cfg.seed)
        model = build_model(cfg.codec, cfg.model, device="cpu")
    model.to(dev)
    state = put_state(create_train_state(model, cfg, max(1, loader.steps_per_epoch())), mesh,
                      fsdp=cfg.fsdp)
    train_step = make_train_step(model, cfg)

    ckpt = CheckpointManager(cfg.checkpoint_dir)
    start_epoch = 0
    if resume:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, meta = restored
            if cfg.ema_decay > 0 and state.ema is None:
                # a checkpoint saved without EMA: seed the average from the params
                state.ema = {n: m.clone() for n, m in state.params.items()}
            elif cfg.ema_decay == 0:
                state.ema = None
            start_epoch = int(meta.get("epoch", 0)) + 1
            if verbose:
                print(f"resumed from epoch {start_epoch - 1}", flush=True)

    logger = MetricLogger(cfg.checkpoint_dir if main else None)
    # Validation runs on the EMA weights when the EMA is on: a second model
    # holds them, in the model's dtypes.
    eval_model = build_model(cfg.codec, cfg.model, device=dev) if cfg.ema_decay > 0 else model
    if state.layout is not None:
        state.layout.shard_module(eval_model)
    if cfg.codec == "all":
        sampler = unified_samplers(eval_model, cfg.consistency_mode)
        viz_sampler = sampler["webp"]  # one codec for the epoch grids
    else:
        sampler = viz_sampler = DDRMSampler(eval_model, preset,
                                            consistency_mode=cfg.consistency_mode)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    # best_psnr tracks the best SAVED checkpoint, so a save skipped by
    # ckpt_min_interval is retried once the interval has passed.
    best_psnr = -float("inf")
    last_save_epoch = -(10 ** 9)

    warm = 2 if dev.type == "cuda" else 1  # steps before `step_ms`'s clock starts
    for epoch in range(start_epoch, epochs):
        t_start = time.time()
        losses = []
        t_warm = None
        for batch in loader.epoch(epoch):
            losses.append(train_step(state, to_device(batch, dev), generator)["loss"])
            if len(losses) == warm:
                sync_device(dev)
                t_warm = time.perf_counter()
        sync_device(dev)
        timed = {}
        if len(losses) > warm:
            timed["step_ms"] = 1e3 * (time.perf_counter() - t_warm) / (len(losses) - warm)
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

        if state.ema is not None and state.layout is not None:
            state.layout.gather_into(eval_model, state.ema)
        elif state.ema is not None:
            with torch.no_grad():
                ps = [p for _, p in eval_model.named_parameters()]
                torch._foreach_copy_(ps, [state.ema[n] for n, _ in eval_model.named_parameters()])
        # data rank 0's numbers decide the saves on every rank (a save is a
        # collective over the mesh)
        val = broadcast_object(validate_by_restoration(eval_model, cfg, val_images, sampler),
                               mesh)
        logger.log(epoch, loss=train_loss, epoch_time=time.time() - t_start, **timed, **val)
        if verbose:
            print(logger.summary(epoch, prefix=f"{preset.name} "), flush=True)

        due = epoch - last_save_epoch >= cfg.ckpt_min_interval
        if (due and (val["val_psnr"] > best_psnr or epoch % 10 == 0)) or epoch == epochs - 1:
            best_psnr = max(best_psnr, val["val_psnr"])
            last_save_epoch = epoch
            ckpt.save(epoch, state, {"epoch": epoch, **val})

        if main:
            save_training_curves(os.path.join(cfg.checkpoint_dir, "curves", "training.png"),
                                 logger.history)
        # every model rank of data rank 0 restores the grid (its layers are
        # column-parallel over them); the first writes it
        if data_rank(mesh) == 0 and epoch % cfg.viz_every == 0:
            save_grid(viz_sampler, cfg, val_images, epoch, write=main)

    return state, logger.history


def save_grid(sampler: DDRMSampler, cfg: TrainConfig, val_images: np.ndarray,
              epoch: int, write: bool = True) -> None:
    """Restore the validation images at the sampler preset's lowest val
    quality (full solver) and, if `write`, save original / compressed /
    restored as `<checkpoint_dir>/viz/epoch_<epoch>.png`."""
    vp = sampler.preset
    q = vp.val_qualities[0]
    dev = sampler.model.out_conv.weight.device
    y = compress_batch(val_images, vp.name, q)
    restored = sampler.sample(torch.as_tensor(y, device=dev), q,
                              init_timestep_for_quality(q, cfg.steps, vp),
                              generator=torch.Generator(device=dev).manual_seed(0))
    if write:
            save_restoration_grid(os.path.join(cfg.checkpoint_dir, "viz", f"epoch_{epoch:04d}.png"),
                              val_images, y, restored.cpu().numpy(), quality=q)
