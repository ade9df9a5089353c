"""Spatial-parallel model evaluation: one image's height over a
('spatial',) mesh (the port of the JAX package's `shard_inference_spatial`,
whose layout XLA's SPMD partitioner turns into halo exchanges and gathers).

PyTorch has no partitioner, so the model does explicitly what XLA does.
The solver's state (x_t, y: B×H×W×3) stays whole and replicated on every
rank; only the UNet runs split. `encode` keeps each rank's block of rows,
the levels that `split_plan` splits run on their row blocks, and
`decode_shallow` all-gathers the 3-channel output along the height. A level
runs split only if the mesh size divides its height, each shard holds whole
blocks of the frequency module's block transform, and each shard has at
least 2 rows; the first level that fails and every deeper one run on the
all-gathered tensor, replicated on every rank. On the way up, a replicated
level's output is upsampled whole and each rank keeps its rows.

The ops of a split level that cross the shard edges, each exact up to the
order of f32 sums:
  * 3×3 convolutions: a one-row halo from each neighbour, zeros at the
    image's top and bottom, then the convolution without height padding
    (`conv3x3`);
  * the 2x bilinear upsample: a one-row halo, the edge row repeated at the
    image's borders (as `F.interpolate` clamps), then the upsample, cropped
    by 2 rows each side (`upsample_2x`);
  * GroupNorm: the per-sample, per-group mean all-reduced, then the
    centred sum of squares, in f32 (`group_norm`);
  * self-attention: q, k and v all-gathered along the tokens (a height
    block is a contiguous range of row-major tokens), the attention over
    all of them on every rank, each rank keeping its own rows: the flash
    kernel sees the whole T (`gather_tokens`, `own_tokens`);
  * the AVIF gates' adaptive pooling to s×s: each rank's rows weighted
    into the cells of the s×s grid by the pooling's own row weights, the
    partial sums all-reduced; the small grid runs replicated and each rank
    keeps its rows of the resize back (`pooled`, `take_rows`).
The block DCT, its low-frequency mask and the AVIF block transform are
local once each shard holds whole blocks; max pooling, 1×1 convolutions,
the gates and the time and codec embeddings are local or replicated.

Without a spatial mesh the model is given no `SpatialLevel`, and each op
here is the plain one.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddpm_image_restoration_tpu_torch.ops.resize import adaptive_avg_pool, upsample_2x_bilinear
from ddpm_image_restoration_tpu_torch.parallel.mesh import (
    SPATIAL,
    all_gather,
    all_reduce_,
    axis_rank,
    axis_size,
    gather_dim,
)


def split_plan(height: int, n_levels: int, block: int, m: int) -> Tuple[bool, ...]:
    """For each level i = 0..n_levels of a UNet over images `height` rows
    high (level i is height >> i rows; the last is the bottleneck), whether
    it runs split over `m` ranks: `m` divides its height, each shard holds
    whole `block`-row blocks and at least 2 rows, and every shallower level
    is split too."""
    plan, ok = [], m > 1
    for i in range(n_levels + 1):
        h = height >> i
        ok = ok and h % m == 0 and (h // m) % block == 0 and h // m >= 2
        plan.append(ok)
    return tuple(plan)


class SpatialLevel:
    """One split level of the model over the spatial mesh: this rank's
    index `r` of `m` and the level's whole `height`; the rank holds rows
    r·h .. (r+1)·h − 1, h = height / m."""

    def __init__(self, mesh, height: int):
        self.mesh, self.height = mesh, height
        self.m, self.r = axis_size(mesh, SPATIAL), axis_rank(mesh, SPATIAL)
        self.rows = height // self.m

    def __repr__(self) -> str:
        return f"SpatialLevel(height={self.height}, rank {self.r} of {self.m})"


def take_rows(x: torch.Tensor, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """This rank's rows of the whole NCHW `x` (`x` itself without `sp`)."""
    if sp is None:
        return x
    return x[:, :, sp.r * sp.rows:(sp.r + 1) * sp.rows].contiguous()


def gather_rows(x: torch.Tensor, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """The whole NCHW tensor from every rank's rows (`x` without `sp`)."""
    return x if sp is None else gather_dim(x, 2, sp.mesh, SPATIAL)


def _halo(x: torch.Tensor, sp: SpatialLevel, edge: str) -> torch.Tensor:
    """`x` (this rank's rows) with the row above and the row below it in the
    whole image; past the image's top and bottom, zeros (`edge` 'zeros') or
    the edge row again ('repeat')."""
    ends = all_gather(torch.stack([x[:, :, :1], x[:, :, -1:]]), sp.mesh, SPATIAL)
    fill = torch.zeros_like if edge == "zeros" else (lambda t: t)
    above = ends[2 * sp.r - 1] if sp.r > 0 else fill(x[:, :, :1])
    below = ends[2 * sp.r + 2] if sp.r < sp.m - 1 else fill(x[:, :, -1:])
    return torch.cat([above, x, below], dim=2)


def conv3x3(conv: nn.Conv2d, x: torch.Tensor, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """`conv(x)` for a 3×3 convolution with padding 1, on this rank's rows."""
    if sp is None:
        return conv(x)
    return F.conv2d(_halo(x, sp, "zeros"), conv.weight, conv.bias, padding=(0, 1))


def upsample_2x(x: torch.Tensor, sp_in: Optional[SpatialLevel],
                sp_out: Optional[SpatialLevel]) -> torch.Tensor:
    """`upsample_2x_bilinear` from a level laid out as `sp_in` to the next
    level up, laid out as `sp_out` (None: whole)."""
    if sp_in is not None:
        return upsample_2x_bilinear(_halo(x, sp_in, "repeat"))[:, :, 2:-2]
    return take_rows(upsample_2x_bilinear(x), sp_out)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """`norm(x)` on this rank's rows of an f32 `x`: each sample's group mean
    all-reduced first, then its centred sum of squares."""
    if sp is None:
        return norm(x)
    b, c, h, w = x.shape
    g = norm.num_groups
    xg = x.reshape(b, g, -1)
    count = (c // g) * sp.height * w
    mean = all_reduce_(xg.sum(-1), sp.mesh, SPATIAL) / count
    d = xg - mean[..., None]
    var = all_reduce_((d * d).sum(-1), sp.mesh, SPATIAL) / count
    y = (d * torch.rsqrt(var + norm.eps)[..., None]).reshape(b, c, h, w)
    if norm.affine:
        y = y * norm.weight[None, :, None, None] + norm.bias[None, :, None, None]
    return y


def gather_tokens(t: torch.Tensor, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """[B, T_rank, ...] row-major tokens of this rank's rows -> all [B, T,
    ...] tokens."""
    return t if sp is None else gather_dim(t, 1, sp.mesh, SPATIAL)


def own_tokens(t: torch.Tensor, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """This rank's tokens of all [B, T, ...] tokens."""
    if sp is None:
        return t
    n = t.shape[1] // sp.m
    return t[:, sp.r * n:(sp.r + 1) * n]


@functools.lru_cache(maxsize=None)
def _pool_weights(h: int, w: int, s: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_h [s, h], A_w [s, w]): `adaptive_avg_pool` of an h×w map to s×s
    is A_h · X · A_wᵀ (separable, each output a weighted mean). Read off the
    op itself on indicator maps: rows of ones give the columns of A_h."""
    def axis_weights(n: int, rows: bool) -> torch.Tensor:
        eye = torch.eye(n, dtype=torch.float32, device=device)
        basis = (eye[:, None, :, None].expand(n, 1, n, w) if rows
                 else eye[:, None, None, :].expand(n, 1, h, n))
        pooled = adaptive_avg_pool(basis.contiguous(), s)           # [n, 1, s, s]
        return (pooled[:, 0, :, 0] if rows else pooled[:, 0, 0, :]).T.contiguous()

    return axis_weights(h, True), axis_weights(w, False)


def pooled(x: torch.Tensor, s: int, sp: Optional[SpatialLevel]) -> torch.Tensor:
    """`adaptive_avg_pool(whole x, s)` (whole: every rank's rows), on every
    rank, from this rank's rows of `x`."""
    if sp is None:
        return adaptive_avg_pool(x, s)
    a_h, a_w = _pool_weights(sp.height, x.shape[3], s, str(x.device))
    mine = a_h[:, sp.r * sp.rows:(sp.r + 1) * sp.rows]
    part = torch.einsum("ih,bchw,jw->bcij", mine, x.float(), a_w)
    return all_reduce_(part.contiguous(), sp.mesh, SPATIAL).to(x.dtype)
