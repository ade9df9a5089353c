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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ddpm_image_restoration_tpu_torch.config import TrainConfig
from ddpm_image_restoration_tpu_torch.diffusion.losses import loss_for_preset
from ddpm_image_restoration_tpu_torch.models.unet import set_dropout_generator
from ddpm_image_restoration_tpu_torch.train.schedules import cosine_warm_restarts


@dataclasses.dataclass
class ClipAdamW:
    """`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))` over lists of f32 tensors, updated in place."""

    schedule: Callable[[int], float]
    max_norm: float
    b1: float
    b2: float
    weight_decay: float
    eps: float = 1e-8

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               mu: List[torch.Tensor], nu: List[torch.Tensor], count: int,
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step at optimizer count `count` (steps taken so far): clips
        `grads` (not in place), updates the moments and `params` in place,
        and returns the global gradient norm before clipping (a 0-d tensor;
        nothing here waits for the device). `g_norm` is that norm when the
        caller has it (the lists then hold parts of the tensors: FSDP)."""
        if g_norm is None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: t if ‖g‖ < max_norm else (t/‖g‖)·max_norm
        grads = torch._foreach_mul(grads, torch.clamp(self.max_norm / g_norm, max=1.0))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        n = count + 1
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** n))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** n)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-self.schedule(count))
        return g_norm


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1) -> ClipAdamW:
    schedule = cosine_warm_restarts(
        base_lr=cfg.lr_override or cfg.preset.lr,
        t0=cfg.cosine_t0 * steps_per_epoch,
        t_mult=cfg.cosine_t_mult,
    )
    return ClipAdamW(schedule, cfg.grad_clip, cfg.betas[0], cfg.betas[1], cfg.weight_decay)


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


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Clip + AdamW on the masters with `grads` (f32, keyed like
    `state.params`, in its layout), write back, count the step; returns the
    global norm of `grads`."""
    names = list(state.params)
    with torch.no_grad():
        g_norm = None if state.layout is None else state.layout.grad_norm(grads)
        g_norm = state.tx.update([state.params[n] for n in names], [grads[n] for n in names],
                                 [state.mu[n] for n in names], [state.nu[n] for n in names],
                                 state.step, g_norm)
    state.step += 1
    state.write_back()
    return g_norm


def update_ema(state: TrainState, decay: float) -> None:
    """ema = ema·d + params·(1 − d) with the warm-up d = min(decay,
    (1 + t)/(10 + t)), t the step count after this step's increment (the
    first step uses t = 1): early on the EMA is a running average and does
    not keep the random init (steps.py:92-110 of the JAX package)."""
    t = float(state.step)
    d = min(decay, (1.0 + t) / (10.0 + t))
    names = list(state.ema)
    with torch.no_grad():
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [state.params[n] for n in names], alpha=1.0 - d)


def param_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as f32 (zeros for a parameter the loss
    did not reach, as `jax.grad` gives)."""
    return {n: (torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float())
            for n, p in model.named_parameters()}


def make_train_step(model: nn.Module, cfg: TrainConfig) -> Callable:
    """train_step(state, batch, generator) -> metrics: one optimizer step
    on `batch` (a dict of tensors on the model's device: `x0`, `xt` NHWC,
    `t` [B] int, optionally `codec_id`), with training dropout drawing its
    masks from `generator`. Returns {'loss', 'grad_norm'} as 0-d tensors;
    the parameters' `.grad` keep this step's gradients.

    Over a mesh (`state.layout`), `batch` is this data rank's block of the
    whole batch (the same on every model rank of it): the dropout masks are
    the whole batch's block, and the gradients and the loss are averaged
    over the data axis (the loss of the whole batch); `.grad` keeps this
    rank's own gradients (of its blocks, in a column-parallel layer)."""
    loss_fn = loss_for_preset(cfg.preset.loss_kind)
    steps = cfg.steps

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        m, layout = state.model, state.layout
        m.train()
        set_dropout_generator(m, generator, (0, 1) if layout is None else (layout.rank, layout.n))
        for p in m.parameters():
            p.grad = None
        t_norm = batch["t"].float() / steps
        pred = m(batch["xt"], t_norm, t_norm, codec_id=batch.get("codec_id"))
        loss = loss_fn(batch["xt"] + pred, batch["x0"])
        loss.backward()
        grads = param_grads(m) if layout is None else layout.reduce_grads(m)
        g_norm = apply_gradients(state, grads)
        if cfg.ema_decay > 0:
            update_ema(state, cfg.ema_decay)
        loss = loss.detach()
        return {"loss": loss if layout is None else layout.mean(loss), "grad_norm": g_norm}

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

