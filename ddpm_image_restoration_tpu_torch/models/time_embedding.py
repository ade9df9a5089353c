"""Sinusoidal timestep embedding + MLP (port of models/time_embedding.py).

Input is a normalised float t in [0,1]; frequencies exp(-log(10000)·k/(half-1))
for k in [0, half); sin/cat/cos; Linear(dim, 4dim) -> SiLU -> Linear(4dim,
dim). Always f32, whatever the model's compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class TimeEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.proj_in = nn.Linear(dim, dim * 4)
        self.proj_out = nn.Linear(dim * 4, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * -(math.log(10000.0) / (half - 1))
        )
        args = t[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
        return self.proj_out(F.silu(self.proj_in(emb)))
