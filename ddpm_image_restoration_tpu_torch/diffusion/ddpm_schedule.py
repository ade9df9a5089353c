"""Classic DDPM β-schedule machinery of the historical experiment models
(port of diffusion/ddpm_schedule.py; the reference's ddpm.ipynb).

β linear 1e-4 → 0.02 over T = 100, quality → timestep t = 101 - QF, the
ε-target ε = (xt − √ᾱ_t·x0) / √(1−ᾱ_t), the posterior-mean update
x_{t-1} = (xt − (1−α_t)/√(1−ᾱ_t)·ε̂) / √α_t, DDIM on a subsampled grid, and
the cosine quality schedule of dct.ipynb, quality(t) = 100 − 95·cos²(πt/2).

The schedule is f32 tensors on the CPU; each step moves the few entries
it needs to the images' device. Images are in any layout for the
deterministic functions; `ddim_inference` draws its
noise as the JAX package does, in NHWC order from a JAX-layout key through
`evaluation/prng.py`, and takes NCHW images like the experimental models,
so at eta > 0 it makes the JAX package's samples.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.evaluation import prng


class DDPMSchedule(NamedTuple):
    betas: torch.Tensor        # [T]
    alphas: torch.Tensor       # [T]
    alpha_bars: torch.Tensor   # [T] cumulative products

    @property
    def T(self) -> int:
        return self.betas.shape[0]


def make_ddpm_schedule(T: int = 100, beta_start: float = 1e-4,
                       beta_end: float = 0.02) -> DDPMSchedule:
    betas = torch.linspace(beta_start, beta_end, T, dtype=torch.float32)
    alphas = 1.0 - betas
    return DDPMSchedule(betas, alphas, torch.cumprod(alphas, 0))


def quality_to_timestep(quality) -> torch.Tensor:
    """QF in [1,100] -> t in [1,100] (ddpm.ipynb: t = 101 - qf)."""
    return 101 - torch.as_tensor(quality).to(torch.int32)


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.to(like.device).reshape(-1, *([1] * (like.dim() - 1)))


def _index(t) -> torch.Tensor:
    return torch.as_tensor(t).to(torch.long).cpu() - 1


def ddpm_noise_target(x0: torch.Tensor, xt: torch.Tensor, t,
                      sched: DDPMSchedule) -> torch.Tensor:
    """ε = (xt − √ᾱ_t x0)/√(1−ᾱ_t): the codec output as the DDPM noisy state."""
    ab = _col(sched.alpha_bars.cpu()[_index(t)], x0)
    return (xt - torch.sqrt(ab) * x0) / torch.sqrt(1.0 - ab)


def ddpm_posterior_step(xt: torch.Tensor, eps_hat: torch.Tensor, t,
                        sched: DDPMSchedule) -> torch.Tensor:
    """One reverse posterior-mean update (no noise injection, as the reference)."""
    ti = _index(t)
    a = _col(sched.alphas.cpu()[ti], xt)
    ab = _col(sched.alpha_bars.cpu()[ti], xt)
    return (xt - (1.0 - a) / torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(a)


@torch.no_grad()
def ddpm_inference(model_apply, y: torch.Tensor, T: int = 70,
                   sched: Optional[DDPMSchedule] = None) -> torch.Tensor:
    """The reverse chain t = T..1 (ddpm.ipynb ddpm_inference);
    `model_apply(x, t_vec)` predicts ε, t_vec the [B] f32 timesteps."""
    sched = sched or make_ddpm_schedule()
    xt, b = y, y.shape[0]
    for t in range(T, 0, -1):
        eps = model_apply(xt, torch.full((b,), float(t), device=y.device))
        xt = ddpm_posterior_step(xt, eps, torch.full((b,), t), sched)
    return xt


def ddim_grid(T: int, n_steps: int) -> np.ndarray:
    """[(t, s)] pairs of the descending DDIM grid: T..1 subsampled to
    n_steps points (endpoints kept), each t paired with the next, the last
    with s = 0 (x0)."""
    grid = np.unique(np.round(np.linspace(1, T, n_steps)).astype(np.int64))[::-1]
    return np.stack([grid, np.append(grid[1:], 0)], axis=1)


@torch.no_grad()
def ddim_inference(model_apply, y: torch.Tensor, T: int = 70, n_steps: int = 0,
                   eta: float = 0.0, sched: Optional[DDPMSchedule] = None,
                   key: Optional[np.ndarray] = None) -> torch.Tensor:
    """DDIM sampling (Song et al., arXiv:2010.02502) over the same
    β-schedule on the `ddim_grid` of n_steps (0: every step) from the NCHW
    y; eta = 0 is deterministic, eta = 1 DDPM-like.

        x_s = √ᾱ_s · x̂0 + √(1−ᾱ_s−σ²) · ε̂ + σ·z,
        x̂0 = (x_t − √(1−ᾱ_t)·ε̂)/√ᾱ_t,
        σ = eta·√((1−ᾱ_s)/(1−ᾱ_t))·√(1−ᾱ_t/ᾱ_s),   ᾱ_0 := 1

    z is drawn every step (also at eta 0, as the JAX package does) from
    `key` (default `prng.prng_key(0)`) in NHWC order."""
    sched = sched or make_ddpm_schedule()
    ab_all = sched.alpha_bars.cpu()
    key = prng.prng_key(0) if key is None else np.asarray(key, np.uint32)
    b, c, h, w = y.shape
    xt = y
    for t, s in ddim_grid(T, n_steps or T):
        key, nkey = prng.split(key)
        eps = model_apply(xt, torch.full((b,), float(t), device=y.device))
        ab_t = ab_all[t - 1]
        ab_s = ab_all[s - 1] if s > 0 else torch.tensor(1.0)
        x0_hat = (xt - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
        sigma = eta * torch.sqrt((1.0 - ab_s) / (1.0 - ab_t)) * torch.sqrt(1.0 - ab_t / ab_s)
        dir_xt = torch.sqrt(torch.clamp(1.0 - ab_s - sigma ** 2, min=0.0)) * eps
        noise = torch.from_numpy(prng.normal(nkey, (b, h, w, c))).permute(0, 3, 1, 2)
        xt = (torch.sqrt(ab_s) * x0_hat + dir_xt
              + sigma.item() * noise.to(device=y.device, dtype=xt.dtype))
    return xt


def cosine_quality_schedule(t, mode: str = "cosine") -> torch.Tensor:
    """dct.ipynb get_quality_schedule: t normalised in [0,1] -> quality."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if mode == "cosine":
        return 100.0 - 95.0 * torch.cos(t * torch.pi / 2) ** 2
    return 100.0 - 95.0 * t
