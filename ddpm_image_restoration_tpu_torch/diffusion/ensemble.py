"""Test-time self-ensemble (dihedral TTA) for restoration (port of
diffusion/ensemble.py).

Restore the 2, 4 or 8 flip / dihedral transforms of the degraded input,
invert each restoration and average (the "geometric self-ensemble" of EDSR,
arXiv:1707.02921). Every variant has the input's shape, so the cost is
exactly N restores.

Flips keep the JPEG/WebP block grid aligned whenever H and W are multiples
of the block size, so a flipped input shows a valid artifact pattern of the
same codec. The transforms with k >= 4 also swap H and W and need square
inputs.
"""

from __future__ import annotations

import torch


def dihedral(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th (0..7) dihedral-group element applied to NHWC `x`: k = 0..3
    identity, flip-W, flip-H, flip-both; k = 4..7 the same after an H<->W
    transpose (square inputs only)."""
    if not 0 <= k < 8:
        raise ValueError(f"k must be in [0, 8), got {k}")
    if k >= 4:
        if x.shape[1] != x.shape[2]:
            raise ValueError("dihedral k>=4 (transpositions) needs H == W")
        x = x.transpose(1, 2)
    if k % 4 in (1, 3):
        x = torch.flip(x, (2,))
    if k % 4 in (2, 3):
        x = torch.flip(x, (1,))
    return x


def dihedral_inverse(x: torch.Tensor, k: int) -> torch.Tensor:
    """Invert `dihedral(·, k)` (flips invert themselves; the transpose last)."""
    if not 0 <= k < 8:
        raise ValueError(f"k must be in [0, 8), got {k}")
    if k % 4 in (1, 3):
        x = torch.flip(x, (2,))
    if k % 4 in (2, 3):
        x = torch.flip(x, (1,))
    if k >= 4:
        x = x.transpose(1, 2)
    return x


def sample_ensemble(sampler, y: torch.Tensor, quality, steps, n_transforms: int = 4,
                    **kw) -> torch.Tensor:
    """`sampler.sample(y, quality, steps, **kw)` averaged over
    `n_transforms` in {1, 2, 4, 8} dihedral variants of `y` (8 needs square
    inputs)."""
    if n_transforms not in (1, 2, 4, 8):
        raise ValueError(f"n_transforms must be 1, 2, 4 or 8, got {n_transforms}")
    acc = None
    for k in range(n_transforms):
        out = dihedral_inverse(sampler.sample(dihedral(y, k).contiguous(), quality, steps, **kw),
                               k)
        acc = out if acc is None else acc + out
    return acc / n_transforms
