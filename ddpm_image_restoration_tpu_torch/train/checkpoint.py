"""Checkpoints: the train state with resume (`CheckpointManager`), and the
release weights, the JAX package's flat fp16 npz <-> a torch state_dict.

Release weights:

The npz (written by `train/checkpoint.py export_release_params` in the JAX
package) holds one array per Flax parameter, keyed by its module path joined
with '/', e.g. `down2/attn/qkv/kernel`. The port names its modules like the
Flax ones, so a key maps to `down2.attn.qkv.weight` and only the layouts
change:

  * Conv `kernel` HWIO -> `weight` OIHW;
  * Dense `kernel` [in, out] -> `weight` [out, in];
  * GroupNorm `scale` -> `weight`; Embed `embedding` -> `weight`;
  * `bias` and any other leaf (e.g. `transform_weights`) as they are.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat '/'-joined Flax params -> torch state_dict (f32 tensors; keys
    starting with '__' are metadata and skipped). `load_state_dict` then
    casts each value to its parameter's dtype."""
    out = {}
    for key, value in flat.items():
        if key.startswith("__"):
            continue
        *path, leaf = key.split("/")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)           # HWIO -> OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            arr = arr.T                               # [in,out] -> [out,in]
        name = ".".join([*path, _LEAF_TO_TORCH.get(leaf, leaf)])
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_release_params(npz_path: str) -> Dict[str, torch.Tensor]:
    """Release npz -> torch state_dict, for the --params-npz serving path."""
    with np.load(npz_path) as data:
        return params_from_jax({k: data[k] for k in data.files})


def jax_layout(module: nn.Module, p_name: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(Flax leaf name, axis order) of `module`'s parameter `p_name`: the
    JAX package's array is this parameter's `permute(order)`."""
    if p_name == "weight":
        if isinstance(module, nn.Conv2d):
            return "kernel", (2, 3, 1, 0)                 # OIHW -> HWIO
        if isinstance(module, nn.Linear):
            return "kernel", (1, 0)                       # [out,in] -> [in,out]
        if isinstance(module, nn.GroupNorm):
            return "scale", tuple(range(ndim))
        if isinstance(module, nn.Embedding):
            return "embedding", tuple(range(ndim))
    return p_name, tuple(range(ndim))


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_jax` for `model`'s parameters (f32 numpy)."""
    flat = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            leaf, order = jax_layout(module, p_name, p.dim())
            arr = p.detach().float().cpu().numpy().transpose(order)
            path = mod_name.split(".") if mod_name else []
            flat["/".join([*path, leaf])] = np.ascontiguousarray(arr)
    return flat


def export_release_params(model: nn.Module, out: str, codec: str = "webp",
                          meta: Optional[Dict[str, Any]] = None) -> str:
    """Write `model`'s parameters as the JAX package's release npz (fp16),
    readable by either package's `load_release_params`."""
    arrays = {k: v.astype(np.float16) for k, v in params_to_jax(model).items()}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, __codec__=np.str_(codec),
                        __meta__=np.str_(str(meta or {})), **arrays)
    return out


class CheckpointManager:
    """Train-state checkpoints with true resume (port of the JAX package's
    Orbax `CheckpointManager`).

    `save(step, state, metrics)` writes `ckpt_<step>.pt` with `torch.save`:
    the f32 master parameters, the Adam moments, the EMA, the optimizer step
    and the metrics. Retention serves both readers, as in the JAX package:
    the best `max_to_keep` by `val_psnr` (for `restore_best`) and the latest
    two (for `restore_latest`, the resume); the rest are deleted. The
    metrics of the kept checkpoints are listed in `checkpoints.json`. Saves
    are synchronous and atomic (written aside, then renamed).

    Over a data mesh (a state with a `layout`) every rank of the mesh calls
    `save`: the state is gathered to the one-process layout, data rank 0
    writes it between two barriers, and every rank loads a checkpoint into
    its own parts. So a file moves freely between world sizes and between
    FSDP and replicated runs."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "checkpoints.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _index(self) -> Dict[int, Dict[str, float]]:
        if not os.path.exists(self._index_path):
            return {}
        with open(self._index_path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def _write_index(self, index: Dict[int, Dict[str, float]]) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(index.items())}, f)
        os.replace(tmp, self._index_path)

    @staticmethod
    def _psnr(metrics: Dict[str, float]) -> float:
        return metrics.get("val_psnr", -float("inf"))

    def save(self, step: int, state, metrics: Optional[Dict[str, float]] = None) -> str:
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        path = self._path(step)
        sd = state.state_dict()
        layout = getattr(state, "layout", None)
        if layout is not None:
            layout.barrier()  # every rank is done reading the directory
            try:
                if layout.rank == 0:
                    self._write(step, path, sd, metrics)
            finally:
                layout.barrier()  # the files are there for every rank
            return path
        self._write(step, path, sd, metrics)
        return path

    def _write(self, step: int, path: str, sd: dict, metrics: Dict[str, float]) -> None:
        tmp = path + ".tmp"
        torch.save({"state": sd, "metadata": dict(metrics, step=step)}, tmp)
        os.replace(tmp, path)
        index = self._index()
        index[step] = metrics
        best = sorted(index, key=lambda s: self._psnr(index[s]), reverse=True)[:self.max_to_keep]
        keep = set(best) | set(sorted(index)[-2:])
        for s in [s for s in index if s not in keep]:
            if os.path.exists(self._path(s)):
                os.remove(self._path(s))
            del index[s]
        self._write_index(index)

    def all_steps(self) -> list:
        return sorted(self._index())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        index = self._index()
        return max(index, key=lambda s: self._psnr(index[s])) if index else None

    def restore(self, step: int, state) -> Tuple[Any, Dict]:
        """Load checkpoint `step` into the train state `state` (in place);
        returns (state, metadata)."""
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.load_state_dict(payload["state"])
        return state, payload["metadata"]

    def restore_latest(self, state) -> Optional[Tuple[Any, Dict]]:
        step = self.latest_step()
        return None if step is None else self.restore(step, state)

    def restore_best(self, state) -> Optional[Tuple[Any, Dict]]:
        step = self.best_step()
        return None if step is None else self.restore(step, state)

    def restore_params(self, ema: bool = False) -> Optional[Tuple[Optional[Dict[str, torch.Tensor]],
                                                                  Dict]]:
        """(weights, metadata) for restoring: the best checkpoint by
        `val_psnr`, else the latest; its f32 master parameters, or with
        `ema` its EMA (None when it was trained without one). None when the
        directory holds no checkpoint."""
        index = self._index()
        scored = [s for s in index if "val_psnr" in index[s]]
        step = max(scored, key=lambda s: self._psnr(index[s])) if scored else self.latest_step()
        if step is None:
            return None
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True, mmap=True)
        return payload["state"]["ema" if ema else "params"], payload["metadata"]
