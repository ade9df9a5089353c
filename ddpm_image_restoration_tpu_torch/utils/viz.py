"""Visualization: restoration grids and training curves (copy of
utils/viz.py in the JAX package).

Original / compressed / restored rows with PSNR titles
(visualize_*_restoration, webp_training.py:602-655), and panels of every
logged metric series (plot_training_curves, webp_training.py:742-770).
Matplotlib is imported lazily; without it each call warns and returns."""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        warnings.warn("matplotlib unavailable; skipping visualization")
        return None


def _to01(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x, np.float32) * 0.5 + 0.5, 0, 1)


def _psnr(a, b) -> float:
    mse = float(np.mean((_to01(a) - _to01(b)) ** 2))
    return -10.0 * np.log10(mse + 1e-8)


def save_restoration_grid(
    path: str,
    original: np.ndarray,
    compressed: np.ndarray,
    restored: np.ndarray,
    quality: Optional[int] = None,
    max_images: int = 4,
):
    """3-row grid: original / compressed(+PSNR) / restored(+PSNR)."""
    plt = _plt()
    if plt is None:
        return
    n = min(max_images, original.shape[0])
    fig, axes = plt.subplots(3, n, figsize=(3 * n, 9.5))
    if n == 1:
        axes = axes[:, None]
    rows = [("Original", original, None), ("Compressed", compressed, True), ("Restored", restored, True)]
    for r, (label, imgs, show_psnr) in enumerate(rows):
        for c in range(n):
            ax = axes[r, c]
            ax.imshow(_to01(imgs[c]))
            ax.axis("off")
            title = label
            if show_psnr:
                title += f" {_psnr(imgs[c:c+1], original[c:c+1]):.2f}dB"
            if r == 0 and quality is not None and c == 0:
                title += f" (q={quality})"
            ax.set_title(title, fontsize=9)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_training_curves(path: str, history: Dict[str, List[float]]):
    """Panels of every logged metric series (loss / PSNR / SSIM / LPIPS...)."""
    plt = _plt()
    if plt is None:
        return
    keys = [k for k, v in history.items() if len(v) > 0]
    if not keys:
        return
    n = len(keys)
    cols = min(3, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.5 * rows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot(history[k])
        ax.set_title(k)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
