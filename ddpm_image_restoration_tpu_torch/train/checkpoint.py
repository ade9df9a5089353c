"""Release weights: the JAX package's flat fp16 npz <-> a torch state_dict.

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

import os
from typing import Any, Dict, Optional

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


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_jax` for `model`'s parameters (f32 numpy)."""
    flat = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            arr = p.detach().float().cpu().numpy()
            leaf = p_name
            if p_name == "weight":
                if isinstance(module, nn.Conv2d):
                    leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
                elif isinstance(module, nn.Linear):
                    leaf, arr = "kernel", arr.T
                elif isinstance(module, nn.GroupNorm):
                    leaf = "scale"
                elif isinstance(module, nn.Embedding):
                    leaf = "embedding"
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
