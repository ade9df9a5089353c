"""Solver distillation (port of train/distill.py): a student, initialised
from a trained teacher, learns per quality bucket to reproduce the teacher's
full-solver restoration in `n_eval` model evaluations.

The student keeps the DDRM sampler's execution shape: it is trained through
the sampler at stride `student_stride(init_t, n_eval)`, so a distilled
checkpoint is an ordinary checkpoint whose weights are good at that stride,
and the restore, serve and evaluate CLIs run it with `--max-evals n`.

Each distill step, for its batch's quality q:
  * the teacher (a second, frozen `CodecDiffusionModel` holding the teacher
    weights) restores the batch under `torch.no_grad()` at its stride;
  * the student restores it through the sampler's loop with grad enabled
    and in eval mode (no dropout, as the JAX package's step applies the model
    without a dropout rng), each solver step (or encoder-reuse group) under
    activation checkpointing, so the backward holds one step's activations
    at a time (the JAX package's full-width run ran out of memory without
    it);
  * loss = loss(student, teacher) + gt_weight·loss(student, x0), then the
    clip + AdamW step on the f32 masters and the warmed-up EMA
    (train/steps.py).
The solver's noise follows the production policy (eta 0), so teacher and
student are deterministic and the step matches the JAX package's step for
step. Qualities go round-robin over the batches, continuing across epochs.

The JAX package jits the step once per quality bucket; on a card, in one
process, the port captures it as one CUDA graph per signature and replays
it (`make_distill_step`), both solver loops inside: the sampler's own
graphs are not entered (graphs do not nest), and each loop's schedule is
prepared on the host once per batch shape, outside the capture.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch
from ddpm_image_restoration_tpu_torch.codecs.quality import (
    init_timestep_for_quality,
    student_stride,
)
from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.data.pipeline import prefetched_map
from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler, _solver_indices
from ddpm_image_restoration_tpu_torch.diffusion.losses import loss_for_preset
from ddpm_image_restoration_tpu_torch.diffusion.policy import production_solver_config
from ddpm_image_restoration_tpu_torch.train.steps import (
    GRAPH_CACHE_SIZE,
    TrainState,
    _graphed,
    _keep_grads,
    _weights,
    create_train_state,
    optimizer_update,
    param_grads,
    state_signature,
    update_ema,
)
from ddpm_image_restoration_tpu_torch.utils.graphs import GraphCache


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Distillation settings on top of a TrainConfig, field for field the
    JAX package's.

    `teacher_dir`: the teacher's checkpoints (its best, else its latest;
    the EMA weights when it has them); `teacher_npz`: a release npz
    instead, which overrides `teacher_dir`. `n_eval`: the student's model
    evaluations per restore; `teacher_stride`: the teacher's solver stride
    (1 = the full solver). `qualities`: the buckets to distill, () = the
    preset's whole eval grid (each quality has its own init_t, and a
    student learns only the budgets it trains). `gt_weight`: the weight of
    the clean-image term of the loss. `progressive`: halve the evaluation
    budget stage by stage down to `n_eval`, each stage's student teaching
    the next (stage k saves under `<checkpoint_dir>/stage<k>`, the last in
    `<checkpoint_dir>`). `teacher_n_eval` is set by the progressive driver:
    the teacher's own budget, which replaces `teacher_stride` by the stride
    derived per quality."""

    teacher_dir: str = "./checkpoints"
    teacher_npz: str = ""
    n_eval: int = 1
    teacher_stride: int = 1
    qualities: Tuple[int, ...] = ()
    gt_weight: float = 0.3
    progressive: bool = False
    teacher_n_eval: int = 0


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """What a quality bucket's step body reads besides the state and the
    batch: the teacher's and the student's samplers, the loss, the gt
    weight, whether the EMA updates, and the student's solver remat."""

    teacher: DDRMSampler
    student: DDRMSampler
    loss_fn: Callable
    gt_weight: float
    ema: bool
    remat: bool


def _step_body(b: _Bucket, state: TrainState, plan_t, plan_s, x0: torch.Tensor,
               xt: torch.Tensor, generator: Optional[torch.Generator]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distill step's device work: the teacher's solver loop under
    no_grad, the student's under grad (`plan_t`, `plan_s`: their
    `DDRMSampler.prepare` plans), the loss with its gt term, the backward,
    the f32 gradients, clip + AdamW on the masters, the write-back and the
    EMA; returns (loss, grad norm). It makes no tensor from host data and
    waits on nothing, so a CUDA graph can capture it; it does not count the
    step."""
    y, x0 = xt.float(), x0.float()
    with torch.no_grad():
        target = b.teacher._loop(y, plan_t.q_vec,
                                 b.teacher.draw_noise(plan_t, y.device, generator), plan_t)[0]
    out = b.student._loop(y, plan_s.q_vec, b.student.draw_noise(plan_s, y.device, generator),
                          plan_s, b.remat)[0]
    loss = b.loss_fn(out, target)
    if b.gt_weight:
        loss = loss + b.gt_weight * b.loss_fn(out, x0)
    loss.backward()
    g_norm = optimizer_update(state, param_grads(state.model))
    if b.ema:
        update_ema(state)
    return loss.detach(), g_norm


def make_distill_step(student, teacher, cfg: TrainConfig, dcfg: DistillConfig, quality: int,
                      remat: bool = True, cache: Optional[GraphCache] = None):
    """The distill step of one quality bucket. Returns (step, init_t,
    student stride, teacher stride), where step(state, batch, generator=None)
    -> {'loss', 'grad_norm'} (0-d tensors) trains `state` (the student's
    train state) on batch = {'x0': clean, 'xt': codec(x0, quality)}, NHWC
    tensors on the student's device. `remat=False` keeps every student
    step's activations for the backward (more memory, no recompute).

    On a card, in one process, without collectives in the student (the
    train step's `_graphed`), the step runs as one captured CUDA graph per
    signature (`_signature`), the JAX package's jitted step: the first call
    eager, the second captures and replays, later ones copy the batch in
    and replay (`utils/graphs.py GraphCache`); a failed capture raises. The
    graph holds `_step_body`: both solver loops (the student's remat
    included), the loss, the backward and the optimizer step. `cache` is
    the cache of graphs: `distill_model` gives every bucket's step one
    cache in one memory pool (buckets never run at once); without one the
    step makes its own. `step.eager` is the step run eagerly, as a
    signature's first call runs it; `step.cache` is the cache."""
    preset = cfg.preset
    init_t = init_timestep_for_quality(quality, cfg.steps, preset)
    s_stride = student_stride(init_t, dcfg.n_eval)
    t_stride = dcfg.teacher_stride
    if dcfg.teacher_n_eval:  # progressive stages: the teacher at its own budget
        t_stride = student_stride(init_t, dcfg.teacher_n_eval)
    policy_eta = production_solver_config(quality).get("eta")
    eta = preset.eta if policy_eta is None else policy_eta
    eta_b = preset.eta_b
    bucket = _Bucket(DDRMSampler(teacher, preset), DDRMSampler(student, preset),
                     loss_for_preset(preset.loss_kind), float(dcfg.gt_weight),
                     cfg.ema_decay > 0, remat)
    cache = GraphCache(GRAPH_CACHE_SIZE, shared_pool=True) if cache is None else cache
    plans: Dict[tuple, tuple] = {}
    static = (quality, init_t, s_stride, t_stride, float(eta), float(eta_b), remat,
              bucket.gt_weight, preset.name, bucket.ema)

    def prepare(state: TrainState, y: torch.Tensor) -> tuple:
        """The host's part of a call: eval mode, no `.grad`, the step's
        scalars on the device, and the teacher's and the student's solver
        plans for this batch shape (made once, so a captured body reads
        them by address)."""
        student.eval()
        for p in student.parameters():
            p.grad = None
        state.load_scalars(cfg.ema_decay)
        key = (tuple(y.shape), y.device)
        if key not in plans:
            plans[key] = tuple(
                sampler.prepare(y, quality, init_t, stride, eta=eta, eta_b=eta_b)
                for sampler, stride in ((bucket.teacher, t_stride), (bucket.student, s_stride)))
        return plans[key]

    def metrics(state: TrainState, loss: torch.Tensor, g_norm: torch.Tensor) -> dict:
        state.step += 1
        return {"loss": loss, "grad_norm": g_norm}

    def eager(state: TrainState, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        plan_t, plan_s = prepare(state, batch["xt"])
        return metrics(state, *_step_body(bucket, state, plan_t, plan_s, batch["x0"],
                                          batch["xt"], generator))

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if not _graphed(state, batch):
            return eager(state, batch, generator)
        plan_t, plan_s = prepare(state, batch["xt"])

        def body(x0, xt):
            return _step_body(bucket, state, plan_t, plan_s, x0, xt, generator)

        return metrics(state, *cache(_signature(state, teacher, batch, generator, static), body,
                                     [batch["x0"], batch["xt"]], generators=(generator,),
                                     after=lambda: _keep_grads(student)))

    step.eager = eager
    step.cache = cache
    return step, init_t, s_stride, t_stride


def _signature(state: TrainState, teacher, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], static: tuple) -> tuple:
    """What a captured distill step is specific to: the student's state
    (`train/steps.py state_signature`), the teacher with its weights'
    addresses and dtypes, its compute dtype and mode, the generator, and
    the bucket's `static` settings (quality, init_t, both strides, eta,
    eta_b, remat, the gt weight, the loss's preset, the EMA on or off)."""
    return state_signature(state, batch) + (teacher, _weights(teacher),
                                             teacher.cfg.compute_dtype, teacher.training,
                                             generator, static)


def teacher_weights(dcfg: DistillConfig, verbose: bool = True) -> Dict[str, torch.Tensor]:
    """The teacher's f32 weights (on the CPU): the release npz, else the
    best checkpoint of `teacher_dir` (the latest when none has a val PSNR),
    its EMA when it has one."""
    from ddpm_image_restoration_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_release_params,
    )

    if dcfg.teacher_npz:
        if verbose:
            print(f"teacher: release params {dcfg.teacher_npz}", flush=True)
        return load_release_params(dcfg.teacher_npz)
    found, which = None, "ema"
    if os.path.isdir(dcfg.teacher_dir):
        mgr = CheckpointManager(dcfg.teacher_dir)
        found = mgr.restore_params(ema=True)
        if found is not None and found[0] is None:  # trained without an EMA
            found, which = mgr.restore_params(ema=False), "raw"
    if found is None:
        raise FileNotFoundError(f"no teacher checkpoint under {dcfg.teacher_dir!r}")
    params, meta = found
    if verbose:
        print(f"teacher: {dcfg.teacher_dir} ({which} params) {meta}", flush=True)
    return params


def distill_model(cfg: TrainConfig, dcfg: DistillConfig, dataset=None,
                  epochs: Optional[int] = None, val_batch: int = 4, resume: bool = True,
                  verbose: bool = True, device: str | torch.device = "cuda"):
    """End-to-end distillation on `device`. Returns (state, history).

    The loop of train_model (train/loop.py), except that the student and
    its EMA start from the teacher's weights, each batch is one quality
    bucket, and validation restores at the student's budget. Each epoch
    logs `loss`, `val_psnr`, `val_ssim`, `epoch_time` and, with two or more
    steps, `step_ms` (wall time per distill step after the epoch's first,
    ending in a device synchronise). With `dcfg.progressive` the budget is
    halved stage by stage (`_distill_progressive`)."""
    if dcfg.progressive:
        return _distill_progressive(cfg, dcfg, dataset=dataset, epochs=epochs,
                                    val_batch=val_batch, resume=resume, verbose=verbose,
                                    device=device)
    from ddpm_image_restoration_tpu_torch.data.dataset import (
        ImageFolderDataset,
        SyntheticImageDataset,
        split_indices,
    )
    from ddpm_image_restoration_tpu_torch.models import build_model
    from ddpm_image_restoration_tpu_torch.train.checkpoint import CheckpointManager
    from ddpm_image_restoration_tpu_torch.train.loop import (
        sync_device,
        to_device,
        validate_by_restoration,
    )
    from ddpm_image_restoration_tpu_torch.utils.logging import MetricLogger

    dev = resolve_device(device)
    epochs = epochs or cfg.epochs
    preset = cfg.preset
    if preset.name == "all":
        raise ValueError(
            "solver distillation is per-codec (the student is trained through "
            "ONE codec's consistency projection); distill a unified teacher "
            "once per target codec with --codec jpeg|webp|avif"
        )
    qualities = tuple(dcfg.qualities) or tuple(preset.eval_qualities)

    if dataset is None:
        if os.path.isdir(cfg.data_dir):
            dataset = ImageFolderDataset(cfg.data_dir, cfg.model.image_size,
                                         cache_decoded=cfg.cache_decoded)
        else:
            dataset = SyntheticImageDataset(256, cfg.model.image_size)
    train_idx, val_idx, _ = split_indices(len(dataset), cfg.split_fracs, cfg.split_seed)
    if len(val_idx) == 0:
        val_idx = train_idx
    val_images = np.stack([dataset[int(i)] for i in val_idx[:val_batch]])

    weights = teacher_weights(dcfg, verbose)
    teacher = build_model(cfg.codec, cfg.model, device=dev)
    teacher.load_state_dict(weights)  # frozen and in eval mode (build_model)
    student = build_model(cfg.codec, cfg.model, device=dev)
    student.load_state_dict(weights)

    batch_size = cfg.effective_batch_size
    n_batches = max(1, len(train_idx) // batch_size)
    state = create_train_state(student, cfg, n_batches)
    with torch.no_grad():  # the masters (and the EMA) are the teacher's f32 weights
        for store in (state.params, state.ema or {}):
            for n, m in store.items():
                m.copy_(weights[n])

    steps, cache = {}, GraphCache(max(GRAPH_CACHE_SIZE, len(qualities)), shared_pool=True)
    for q in qualities:
        steps[q], init_t, s_stride, t_stride = make_distill_step(student, teacher, cfg, dcfg, q,
                                                                 cache=cache)
        if verbose:
            print(f"quality {q}: teacher {init_t} steps/stride {t_stride} -> student "
                  f"stride {s_stride} ({dcfg.n_eval} evals)", flush=True)

    ckpt = CheckpointManager(cfg.checkpoint_dir)
    start_epoch = 0
    if resume:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, meta = restored
            start_epoch = int(meta.get("epoch", 0)) + 1
            if verbose:
                print(f"resumed distillation from epoch {start_epoch - 1}", flush=True)

    logger = MetricLogger(cfg.checkpoint_dir)
    # validation on the EMA weights when the EMA is on: a third model holds them
    val_model = build_model(cfg.codec, cfg.model, device=dev) if cfg.ema_decay > 0 else student
    sampler = DDRMSampler(val_model, preset, consistency_mode=cfg.consistency_mode)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
    best_psnr = -float("inf")  # the best SAVED (see train_model)
    last_save_epoch = -(10 ** 9)

    for epoch in range(start_epoch, epochs):
        t_start = time.time()
        order = np.random.default_rng((cfg.seed, epoch, 17)).permutation(len(train_idx))

        def make_batch(b: int):
            idxs = train_idx[order[b * batch_size: (b + 1) * batch_size]]
            # round-robin continued across epochs: with few batches an epoch,
            # `b % len` alone would train only the first buckets
            q = qualities[(epoch * n_batches + b) % len(qualities)]
            x0 = np.stack([dataset[int(i)] for i in idxs])
            if cfg.augment:  # dihedral-8 before degradation (data/pipeline.py)
                arng = np.random.default_rng((cfg.seed, epoch, b, 23))
                ks = arng.integers(0, 4, size=len(idxs))
                fl = arng.integers(0, 2, size=len(idxs))
                x0 = np.stack([np.ascontiguousarray(np.rot90(img[:, ::-1] if f else img,
                                                             int(k), axes=(0, 1)))
                               for img, k, f in zip(x0, ks, fl)])
            return q, x0, compress_batch(x0, preset.name, q)

        losses, t_warm = [], None
        for q, x0, y in prefetched_map(make_batch, n_batches, cfg.data_workers):
            batch = to_device({"x0": x0, "xt": y}, dev)
            losses.append(steps[q](state, batch, generator)["loss"])
            if t_warm is None:
                sync_device(dev)
                t_warm = time.perf_counter()
        sync_device(dev)
        timed = {}
        if len(losses) > 1:
            timed["step_ms"] = 1e3 * (time.perf_counter() - t_warm) / (len(losses) - 1)
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

        if state.ema is not None:
            with torch.no_grad():
                named = list(val_model.named_parameters())
                torch._foreach_copy_([p for _, p in named], [state.ema[n] for n, _ in named])
        val = validate_by_restoration(val_model, cfg, val_images, sampler, n_eval=dcfg.n_eval)
        logger.log(epoch, loss=train_loss, epoch_time=time.time() - t_start, **timed, **val)
        if verbose:
            print(logger.summary(epoch, prefix=f"{preset.name}-distill "), flush=True)

        due = epoch - last_save_epoch >= cfg.ckpt_min_interval
        if (due and (val["val_psnr"] > best_psnr or epoch % 10 == 0)) or epoch == epochs - 1:
            best_psnr = max(best_psnr, val["val_psnr"])
            last_save_epoch = epoch
            ckpt.save(epoch, state, {"epoch": epoch, **val})

    return state, logger.history


def progressive_budgets(cfg: TrainConfig, dcfg: DistillConfig) -> list:
    """The progressive chain: from half the teacher's largest evaluation
    count over the qualities, halving, down to `dcfg.n_eval`."""
    qualities = tuple(dcfg.qualities) or tuple(cfg.preset.eval_qualities)
    e0 = max(len(_solver_indices(init_timestep_for_quality(q, cfg.steps, cfg.preset),
                                 max(1, dcfg.teacher_stride)))
             for q in qualities)
    budgets = []
    b = e0 // 2
    while b > dcfg.n_eval:
        budgets.append(b)
        b //= 2
    budgets.append(dcfg.n_eval)
    return budgets


def _distill_progressive(cfg: TrainConfig, dcfg: DistillConfig, dataset=None,
                         epochs: Optional[int] = None, val_batch: int = 4, resume: bool = True,
                         verbose: bool = True, device: str | torch.device = "cuda"):
    """The stage driver: one `distill_model` per budget of
    `progressive_budgets`, each stage's checkpoint teaching the next. Stage
    k saves under `<checkpoint_dir>/stage<k>`, the last stage in
    `<checkpoint_dir>` itself."""
    budgets = progressive_budgets(cfg, dcfg)
    teacher_dir, teacher_n_eval = dcfg.teacher_dir, 0
    state = history = None
    for k, budget in enumerate(budgets):
        last = k == len(budgets) - 1
        stage_dir = cfg.checkpoint_dir if last else os.path.join(cfg.checkpoint_dir, f"stage{k}")
        if verbose:
            print(f"[progressive {k + 1}/{len(budgets)}] eval budget {budget} "
                  f"(teacher: {teacher_dir})", flush=True)
        cfg_k = dataclasses.replace(cfg, checkpoint_dir=stage_dir)
        dcfg_k = dataclasses.replace(
            dcfg, teacher_dir=teacher_dir, n_eval=budget,
            # a release-npz teacher only seeds stage 0; later stages teach
            # from the previous stage's checkpoints
            teacher_npz=dcfg.teacher_npz if k == 0 else "",
            teacher_n_eval=teacher_n_eval, progressive=False)
        state, history = distill_model(cfg_k, dcfg_k, dataset=dataset, epochs=epochs,
                                       val_batch=val_batch, resume=resume, verbose=verbose,
                                       device=device)
        teacher_dir, teacher_n_eval = stage_dir, budget
    return state, history
