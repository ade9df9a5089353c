"""Real photographic patches harvested from images that installed Python
packages ship (port of data/real_patches.py; numpy, with Pillow imported at
use).

The sources are the four natural photographs the JAX package's audit found
among installed packages: matplotlib's grace_hopper.jpg, sklearn's
china.jpg and flower.jpg, and pygame's camera_rgb.jpg. They are located
from each package's install directory without importing it; a package that
is not installed contributes nothing, so on a machine without any of them
the list is empty and `RealPatchDataset` raises.

The train/eval split is by image region: each photograph is cut at
(1 − eval_frac) of its width, the left part feeds 'train' and the right
'eval', and each part is tiled on its own at every scale, so the two splits
share no source pixel at any scale. `augment=True` expands each patch
through the 8 dihedral transforms (for training only). Patches come out
index for index as the JAX package's.
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_SPLITS = ("all", "train", "eval")
# (package, path inside its install directory) of each bundled photograph
_BUNDLED = (
    ("matplotlib", ("mpl-data", "sample_data", "grace_hopper.jpg")),
    ("sklearn", ("datasets", "images", "china.jpg")),
    ("sklearn", ("datasets", "images", "flower.jpg")),
    ("pygame", ("docs", "generated", "_images", "camera_rgb.jpg")),
)


def _package_dir(name: str) -> Optional[str]:
    try:
        spec = importlib.util.find_spec(name)
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.submodule_search_locations:
        return None
    return list(spec.submodule_search_locations)[0]


def bundled_source_paths() -> List[str]:
    """Absolute paths of the bundled photographs that exist here, sorted."""
    paths = []
    for package, parts in _BUNDLED:
        root = _package_dir(package)
        if root is not None and os.path.exists(os.path.join(root, *parts)):
            paths.append(os.path.join(root, *parts))
    return sorted(paths)


def _harvest_array(arr_full: np.ndarray, size: int, scales: Sequence[int],
                   min_std: float) -> List[np.ndarray]:
    """Non-overlapping size² uint8 crops of an RGB array at each downscale
    factor (Pillow BOX resampling), dropping near-constant ones (grayscale
    std in [0,1] below `min_std`)."""
    from PIL import Image

    img = Image.fromarray(arr_full)
    out: List[np.ndarray] = []
    for f in scales:
        w, h = img.size[0] // f, img.size[1] // f
        if w < size or h < size:
            continue
        arr = np.asarray(img.resize((w, h), Image.BOX), dtype=np.uint8)
        for y in range(0, h - size + 1, size):
            for x in range(0, w - size + 1, size):
                patch = arr[y:y + size, x:x + size]
                gray = patch.astype(np.float32).mean(axis=-1) / 255.0
                if float(gray.std()) >= min_std:
                    out.append(patch)
    return out


def _harvest_split(path: str, size: int, scales: Sequence[int], min_std: float,
                   eval_frac: float) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(train patches, eval patches) of one photograph, cut at
    round(width·(1 − eval_frac))."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    cut = int(round(arr.shape[1] * (1.0 - eval_frac)))
    return (_harvest_array(arr[:, :cut], size, scales, min_std),
            _harvest_array(arr[:, cut:], size, scales, min_std))


def _dihedral(patch: np.ndarray, k: int) -> np.ndarray:
    """k-th element (0-7) of the dihedral group: rot90^(k%4) ∘ flip^(k//4)."""
    if k >= 4:
        patch = patch[:, ::-1]
    return np.ascontiguousarray(np.rot90(patch, k % 4))


class RealPatchDataset:
    """[-1,1] float32 HWC patches of the bundled photographs.

    `n` distinct patches (0 = all of the split), `image_size` pixels a
    side; `seed` seeds the shuffle within the split (and so which patches a
    truncated set keeps); `split` is 'all', 'train' or 'eval' ('all' is
    train then eval); `eval_frac` the width share of each photograph held
    out for 'eval'; `scales` the downscale factors tiled; `min_std` the
    near-constant rejection threshold; `augment` expands each patch through
    the 8 dihedral transforms (len becomes 8x); `extra_sources` adds image
    files, split the same way."""

    def __init__(self, n: int = 0, image_size: int = 64, seed: int = 99,
                 split: str = "all", eval_frac: float = 0.3,
                 scales: Sequence[int] = (1, 2, 4), min_std: float = 0.03,
                 augment: bool = False, extra_sources: Optional[Sequence[str]] = None):
        if split not in _SPLITS:
            raise ValueError(f"split must be one of {_SPLITS}, got {split!r}")
        sources = bundled_source_paths() + sorted(extra_sources or [])
        if not sources:
            raise RuntimeError(
                "no bundled real-image sources found (matplotlib/sklearn/"
                "pygame sample images missing) and no extra_sources given")
        train_p: List[np.ndarray] = []
        eval_p: List[np.ndarray] = []
        for p in sources:
            tr, ev = _harvest_split(p, image_size, scales, min_std, eval_frac)
            train_p.extend(tr)
            eval_p.extend(ev)
        patches = {"train": train_p, "eval": eval_p, "all": train_p + eval_p}[split]
        if not patches:
            raise RuntimeError(
                f"no {image_size}^2 patches survived harvesting the {split!r} "
                f"regions of {len(sources)} sources")
        order = np.random.default_rng(seed).permutation(len(patches))
        if n:
            order = order[:n]
        self.image_size = image_size
        self.split = split
        self.augment = bool(augment)
        self._data = np.stack([patches[int(i)] for i in order])  # uint8 NHWC

    def __len__(self) -> int:
        return len(self._data) * (8 if self.augment else 1)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self.augment:
            patch = _dihedral(self._data[idx // 8], idx % 8)
        else:
            patch = self._data[idx]
        return patch.astype(np.float32) / 255.0 * 2.0 - 1.0


class ConcatDataset:
    """Concatenation of datasets with the [-1,1] HWC `__getitem__` protocol."""

    def __init__(self, *datasets):
        if not datasets:
            raise ValueError("need at least one dataset")
        self.datasets = datasets
        sizes = {getattr(d, "image_size", None) for d in datasets}
        sizes.discard(None)
        if len(sizes) > 1:
            raise ValueError(f"mismatched image sizes: {sorted(sizes)}")
        self._offsets = np.cumsum([len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> np.ndarray:
        if idx < 0:
            idx += len(self)
        if idx < 0 or idx >= len(self):
            raise IndexError(f"index {idx - len(self) if idx < 0 else idx} "
                             f"out of range for {len(self)} items")
        d = int(np.searchsorted(self._offsets, idx, side="right"))
        prev = 0 if d == 0 else int(self._offsets[d - 1])
        return self.datasets[d][idx - prev]
