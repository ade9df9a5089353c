"""Training and validation steps (port of train/steps.py).

Reference training semantics (train_epoch_ddrm_* webp_training.py:476-537):
  * the loss is computed on the reconstruction `xt + pred` against `x0`
    (webp_training.py:518);
  * both the model's t and its compression level are t/steps
    (webp_training.py:514-515, a reference quirk the JAX package keeps);
  * AdamW(lr, betas (0.9, 0.99), weight decay 1e-5) after a global-norm
    gradient clip at 1.0, with cosine warm restarts (webp_training.py:775-776).

The optimizer is written out, not `torch.optim`, because it has to be the
JAX package's optax chain to the bit where that matters:
  * `optax.clip_by_global_norm`: g·max_norm/‖g‖ when ‖g‖ >= max_norm, no eps
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6, another function);
  * `optax.adamw`: eps 1e-8 outside the square root, bias correction by the
    incremented count, weight decay on every parameter added to the Adam
    direction, and the learning rate read at the count BEFORE the increment
    (step 0 uses schedule(0)).

Precision (the JAX package keeps f32 parameters and casts them to the
compute dtype at each use): the port's model holds its body weights in the
compute dtype, so the train state keeps f32 master copies of every
parameter, the Adam moments and the EMA; after each update the masters are
written back into the module, rounded to its dtype, which is the value the
JAX package's cast would compute with. For an f32 parameter the master is
the parameter itself.

Over a mesh (parallel/mesh.py `put_state`) the state carries a
`ShardedState` layout: the step averages the gradients and the loss over
the data axis; under FSDP and over a 'model' axis each rank holds and
updates its blocks of the split masters, moments and EMA, then all-gathers
the module's weights (a column-parallel layer keeps its model block). The
step's arithmetic is the one-process step's on the whole batch.

The JAX package jits its step (`shard_train_step`); on a card, in one
process, the port captures its step as one CUDA graph per signature and
replays it (`make_train_step`): the forward, the loss, the
backward, the f32 gradients, clip + AdamW on the masters, the write-back
and the EMA. The step's body takes nothing from the host: the learning
rate, the bias corrections and the EMA's decay are an f32 vector on the
device (`DeviceScalars`), loaded before every call, eager or replayed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.diffusion.losses import loss_for_preset
from ddpm_image_restoration_tpu_torch.models.unet import set_dropout_generator
from ddpm_image_restoration_tpu_torch.train.schedules import cosine_warm_restarts
from ddpm_image_restoration_tpu_torch.utils.graphs import GraphCache


@dataclasses.dataclass
class ClipAdamW:
    """`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))` over lists of f32 tensors, updated in place."""

    schedule: Callable[[int], np.float32]
    max_norm: float
    b1: float
    b2: float
    weight_decay: float
    eps: float = 1e-8

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               mu: List[torch.Tensor], nu: List[torch.Tensor], scalars: torch.Tensor,
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step: clips `grads` (not in place), updates the moments and
        `params` in place, and returns the global gradient norm before
        clipping (a 0-d tensor; nothing here waits for the device or reads
        the host). `scalars` is an f32 tensor on the params' device whose
        first three entries are the step's lr, 1 − b1^n and 1 − b2^n
        (`step_scalars`). `g_norm` is that norm when the caller has it (the
        lists then hold parts of the tensors: FSDP)."""
        lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
        if g_norm is None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: t if ‖g‖ < max_norm else (t/‖g‖)·max_norm
        grads = torch._foreach_mul(grads, torch.clamp(self.max_norm / g_norm, max=1.0))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(params, upd)
        return g_norm


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1) -> ClipAdamW:
    schedule = cosine_warm_restarts(
        base_lr=cfg.lr_override or cfg.preset.lr,
        t0=cfg.cosine_t0 * steps_per_epoch,
        t_mult=cfg.cosine_t_mult,
    )
    return ClipAdamW(schedule, cfg.grad_clip, cfg.betas[0], cfg.betas[1], cfg.weight_decay)


# the f32 scalars of one step, in this order (`step_scalars`)
STEP_SCALARS = 5


def step_scalars(tx: ClipAdamW, count: int, ema_decay: float) -> np.ndarray:
    """[lr, 1 − b1^n, 1 − b2^n, d, 1 − d] in f32 for the step at optimizer
    count `count` (steps taken so far), n = count + 1, in the jitted JAX
    step's f32 arithmetic: optax's `schedule(count)` and `1 - decay**n`
    (powf of the f32 decay), and the EMA's warm-up decay d = min(decay,
    (1 + n)/(10 + n)) from the incremented count (steps.py:102-103 of the
    JAX package): early on the EMA is a running average and does not keep
    the random init."""
    n, one = np.float32(count + 1), np.float32(1.0)
    d = min(np.float32(ema_decay), (one + n) / (np.float32(10.0) + n))
    return np.array([tx.schedule(count), one - np.float32(tx.b1) ** n,
                     one - np.float32(tx.b2) ** n, d, one - d], np.float32)


class DeviceScalars:
    """A small f32 vector that a step reads on the device (`value`),
    loaded before every call of the step, eager or replayed: a captured
    graph reads it by address, so no value freezes into the capture. On a
    card a load is one asynchronous copy from pinned host memory (the
    caching host allocator does not reuse that block before the copy has
    run)."""

    def __init__(self, size: int, device: torch.device):
        self.value = torch.zeros(size, dtype=torch.float32, device=device)

    def load(self, values: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(values)
        if self.value.is_cuda:
            host = host.pin_memory()
        self.value.copy_(host, non_blocking=True)
        return self.value


@dataclasses.dataclass
class TrainState:
    """The model and what training keeps beside it: f32 master parameters
    (`params`, keyed by parameter name), the Adam moments, the optional EMA
    of the masters, and the count of optimizer steps taken. `layout` is the
    `parallel.mesh.ShardedState` over a mesh (None in one process): then
    the dicts hold this rank's parts of the split tensors."""

    model: nn.Module
    tx: ClipAdamW
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]
    step: int = 0
    layout: Optional[Any] = None
    scalars: Optional["DeviceScalars"] = dataclasses.field(default=None, repr=False)

    def load_scalars(self, ema_decay: float) -> torch.Tensor:
        """Put the f32 scalars of the step at `self.step` on the params'
        device (`step_scalars`), where the step reads them; returns that
        vector."""
        if self.scalars is None:
            self.scalars = DeviceScalars(STEP_SCALARS,
                                         next(iter(self.params.values())).device)
        return self.scalars.load(step_scalars(self.tx, self.step, ema_decay))

    def write_back(self) -> None:
        """Copy the masters into the module's parameters that are not f32
        (rounding them to the parameter's dtype); over a mesh, every
        parameter the layout splits, all-gathered."""
        if self.layout is not None:
            self.layout.gather_into(self.model, self.params)
            return
        pairs = [(p, self.params[n]) for n, p in self.model.named_parameters()
                 if p.dtype != torch.float32]
        if pairs:
            with torch.no_grad():
                torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])

    def state_dict(self) -> dict:
        """Everything a resume needs, on the CPU, in the one-process layout
        (over a mesh a collective: every rank calls it)."""
        def cpu(d):
            if d is None:
                return None
            if self.layout is not None:
                return self.layout.full(d)
            return {k: v.detach().cpu() for k, v in d.items()}
        return {"step": self.step, "params": cpu(self.params), "mu": cpu(self.mu),
                "nu": cpu(self.nu), "ema": cpu(self.ema)}

    def load_state_dict(self, sd: dict) -> None:
        """Restore `state_dict()` output (the one-process layout; over a
        mesh each rank takes its parts). The EMA is taken from `sd` only
        (None when it holds none), never from the current masters."""
        def mine(k, v):
            return v if self.layout is None else self.layout.local(k, v)

        with torch.no_grad():
            for name in ("params", "mu", "nu"):
                dst = getattr(self, name)
                for k, v in sd[name].items():
                    dst[k].copy_(mine(k, v))
            dev = next(iter(self.params.values())).device
            self.ema = None if sd["ema"] is None else {
                k: mine(k, v.to(dev, torch.float32)).clone() for k, v in sd["ema"].items()}
        self.step = int(sd["step"])
        self.write_back()


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       steps_per_epoch: int = 1) -> TrainState:
    """Train state over `model`'s current weights (its init, or loaded
    weights); makes the model's parameters require gradients."""
    model.requires_grad_(True)
    with torch.no_grad():
        params = {n: p.detach().float() for n, p in model.named_parameters()}
        ema = {n: m.clone() for n, m in params.items()} if cfg.ema_decay > 0 else None
    return TrainState(
        model=model, tx=make_optimizer(cfg, steps_per_epoch), params=params,
        mu={n: torch.zeros_like(m) for n, m in params.items()},
        nu={n: torch.zeros_like(m) for n, m in params.items()}, ema=ema)


def optimizer_update(state: TrainState, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Clip + AdamW on the masters with `grads` (f32, keyed like
    `state.params`, in its layout), then the write-back into the module:
    the device work of an optimizer step, at the scalars `load_scalars`
    put on the device. It does not count the step; returns the global norm
    of `grads`."""
    names = list(state.params)
    with torch.no_grad():
        g_norm = None if state.layout is None else state.layout.grad_norm(grads)
        g_norm = state.tx.update([state.params[n] for n in names], [grads[n] for n in names],
                                 [state.mu[n] for n in names], [state.nu[n] for n in names],
                                 state.scalars.value, g_norm)
    state.write_back()
    return g_norm


def update_ema(state: TrainState) -> None:
    """ema = ema·d + params·(1 − d) at the step's d (`step_scalars`), on
    the device."""
    d, keep = state.scalars.value[3], state.scalars.value[4]
    names = list(state.ema)
    with torch.no_grad():
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul([state.params[n] for n in names], keep))


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor],
                    ema_decay: float = 0.0) -> torch.Tensor:
    """One whole optimizer step, eager: load its scalars, clip + AdamW on
    the masters with `grads`, write back, update the EMA when `ema_decay`
    > 0, and count the step; returns the global norm of `grads`."""
    state.load_scalars(ema_decay)
    g_norm = optimizer_update(state, grads)
    if ema_decay > 0:
        update_ema(state)
    state.step += 1
    return g_norm


def param_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as f32 (zeros for a parameter the loss
    did not reach, as `jax.grad` gives)."""
    return {n: (torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float())
            for n, p in model.named_parameters()}


# Captured steps kept per step function, train or distill, with a cache of
# its own (each holds its activations' memory).
GRAPH_CACHE_SIZE = 2


def _prepare(state: TrainState, generator: Optional[torch.Generator], cfg: TrainConfig) -> None:
    """What a call does on the host before the step's device work: training
    mode, the dropout generator, and the step's scalars on the device."""
    m, layout = state.model, state.layout
    m.train()
    set_dropout_generator(m, generator, (0, 1) if layout is None else (layout.rank, layout.n))
    state.load_scalars(cfg.ema_decay)


def _step_body(state: TrainState, batch: Dict[str, torch.Tensor], loss_fn: Callable,
               cfg: TrainConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's device work: the forward, the loss, the backward, the f32
    gradients, clip + AdamW on the masters, the write-back and the EMA;
    returns (loss, grad norm). It makes no tensor from host data and waits
    on nothing, so a CUDA graph can capture it; it does not count the
    step."""
    m, layout = state.model, state.layout
    for p in m.parameters():
        p.grad = None
    t_norm = batch["t"].float() / cfg.steps
    pred = m(batch["xt"], t_norm, t_norm, codec_id=batch.get("codec_id"))
    loss = loss_fn(batch["xt"] + pred, batch["x0"])
    loss.backward()
    grads = param_grads(m) if layout is None else layout.reduce_grads(m)
    g_norm = optimizer_update(state, grads)
    if cfg.ema_decay > 0:
        update_ema(state)
    loss = loss.detach()
    return (loss if layout is None else layout.mean(loss)), g_norm


def _graphed(state: TrainState, batch: Dict[str, torch.Tensor]) -> bool:
    """Whether this call replays a captured graph: a CUDA batch, one process
    (no layout: the data mesh, FSDP and the 'model' axis reduce over
    process groups, which are not captured), and no collective in the
    model's forward (a spatial mesh or column-parallel layers). Block remat
    is captured too: its regions draw nothing (utils/remat.py)."""
    m = state.model
    return (batch["xt"].is_cuda and state.layout is None
            and getattr(m, "spatial_mesh", None) is None
            and not any(getattr(mod, "column_parallel", False) for mod in m.modules()))


def _weights(m: nn.Module) -> tuple:
    """A module's parameters and buffers by address and dtype."""
    return tuple((t.data_ptr(), t.dtype) for t in itertools.chain(m.parameters(), m.buffers()))


def state_signature(state: TrainState, batch: Dict[str, torch.Tensor]) -> tuple:
    """What any captured optimizer step (this module's and the distill
    step) is specific to: the model with its weights' addresses and dtypes,
    the addresses of the masters, moments, EMA (or None: the EMA off) and
    step scalars (a replaced tensor recaptures; an in-place change is read
    by the replay), the batch's keys, shapes, dtypes and device, the
    compute dtype, the optimizer's constants, the TF32 settings the kernels
    were picked under, and training mode."""
    m, tx = state.model, state.tx

    def addresses(d):
        return None if d is None else tuple(t.data_ptr() for t in d.values())

    return (m, _weights(m), addresses(state.params), addresses(state.mu), addresses(state.nu),
            addresses(state.ema), state.scalars.value.data_ptr(),
            tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items())),
            m.cfg.compute_dtype, (tx.max_norm, tx.b1, tx.b2, tx.weight_decay, tx.eps),
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, m.training)


def _signature(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], cfg: TrainConfig) -> tuple:
    """What a captured train step is specific to: `state_signature`, block
    remat, the dropout rate and generator. What `cfg` decides (the loss,
    whether the EMA updates) is fixed for a step function, which keeps its
    own graphs."""
    m = state.model
    return state_signature(state, batch) + (m.cfg.remat, m.cfg.dropout, generator)


def _keep_grads(model: nn.Module) -> Callable[[], None]:
    """After a capture: a function that points each parameter's `.grad`
    back at the gradient the capture left (the graph's static tensor,
    which each replay rewrites with this step's)."""
    grads = [(p, p.grad) for p in model.parameters()]

    def keep() -> None:
        for p, g in grads:
            p.grad = g

    return keep


def make_train_step(model: nn.Module, cfg: TrainConfig) -> Callable:
    """train_step(state, batch, generator) -> metrics: one optimizer step
    on `batch` (a dict of tensors on the model's device: `x0`, `xt` NHWC,
    `t` [B] int, optionally `codec_id`), with training dropout drawing its
    masks from `generator`. Returns {'loss', 'grad_norm'} as 0-d tensors;
    the parameters' `.grad` keep this step's gradients.

    On a card, in one process, without collectives in the model
    (`_graphed`; block remat or not), the step runs as a captured CUDA
    graph from the second call of its signature (`_signature`) on: the first call
    runs eager (the warm-up of autograd and the cuBLAS, cuDNN and cuFFT
    plans), the second captures and replays, later ones copy the batch in
    and replay (`utils/graphs.py GraphCache`). A replay draws the dropout
    masks the same number of eager steps would, and counts as they do; a
    failed capture raises. `train_step.eager` is the step run eagerly, as
    a signature's first call runs it; `train_step.cache` is the graph
    cache, `train_step.graphs` its captured steps.

    Over a mesh (`state.layout`), `batch` is this data rank's block of the
    whole batch (the same on every model rank of it): the dropout masks are
    the whole batch's block, and the gradients and the loss are averaged
    over the data axis (the loss of the whole batch); `.grad` keeps this
    rank's own gradients (of its blocks, in a column-parallel layer)."""
    loss_fn = loss_for_preset(cfg.preset.loss_kind)
    cache = GraphCache(GRAPH_CACHE_SIZE)

    def metrics(state: TrainState, loss: torch.Tensor, g_norm: torch.Tensor) -> dict:
        state.step += 1
        return {"loss": loss, "grad_norm": g_norm}

    def eager(state: TrainState, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        _prepare(state, generator, cfg)
        return metrics(state, *_step_body(state, batch, loss_fn, cfg))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        if not _graphed(state, batch):
            return eager(state, batch, generator)
        _prepare(state, generator, cfg)
        keys = sorted(batch)

        def body(*tensors):
            return _step_body(state, dict(zip(keys, tensors)), loss_fn, cfg)

        return metrics(state, *cache(_signature(state, batch, generator, cfg), body,
                                     [batch[k] for k in keys], generators=(generator,),
                                     after=lambda: _keep_grads(state.model)))

    train_step.eager = eager
    train_step.cache = cache
    train_step.graphs = cache.graphs
    return train_step


def make_eval_loss_step(model: nn.Module, cfg: TrainConfig) -> Callable:
    """eval_step(batch) -> loss: the deterministic loss on a degraded batch
    with the model's current weights (no sampler), a cheap val metric."""
    loss_fn = loss_for_preset(cfg.preset.loss_kind)
    steps = cfg.steps

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        t_norm = batch["t"].float() / steps
        pred = model(batch["xt"], t_norm, t_norm, codec_id=batch.get("codec_id"))
        return loss_fn(batch["xt"] + pred, batch["x0"])

    return eval_step

