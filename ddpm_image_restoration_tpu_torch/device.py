"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's card under torchrun (`LOCAL_RANK`; 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent
    (the port never carries on on the CPU in place of the card). Under a
    process group, 'cuda' without an index is this rank's card,
    `cuda:LOCAL_RANK` (torchrun's variable; 0 when unset)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", local_rank())
    return dev
