"""Activation rematerialisation for regions that draw no random numbers.

`torch.utils.checkpoint.checkpoint` (non-reentrant) keeps a region's inputs
and recomputes its forward during the backward. Its `preserve_rng_state`
saves and restores the global CPU and CUDA RNG states from the host around
the recompute, which a CUDA graph capture cannot hold (the state of a
generator being captured lives on the device). The port's regions draw
nothing, so there is nothing to restore:
  * a UNet block under `ModelConfig.remat` draws its dropout mask from the
    trainer's generator before the region and passes it in
    (models/unet.py `ResAttnBlock`), so the recompute reads the forward's
    mask;
  * a solver group (diffusion/ddrm.py `DDRMSampler._loop`) reads the eta
    noise drawn before the loop.
A region that drew from any generator would draw other numbers in its
recompute, and its gradients would be silently wrong: draw outside and
pass the numbers in.
"""

from __future__ import annotations

from typing import Callable

import torch.utils.checkpoint


def checkpoint(fn: Callable, *args):
    """fn(*args) under `torch.utils.checkpoint.checkpoint(use_reentrant=False)`,
    without saving or restoring any RNG state: `fn` must draw nothing."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)
