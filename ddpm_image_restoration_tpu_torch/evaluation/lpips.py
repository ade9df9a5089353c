"""LPIPS perceptual distance (port of evaluation/lpips.py): canonical when
weights exist, the seeded proxy otherwise.

The computation is LPIPS's (deep features -> unit-normalise over channels ->
squared difference -> linear calibration -> spatial mean -> sum over
layers) over one of two backbones:

  * **canonical** (`lpips_alex`): torchvision AlexNet's feature topology
    (conv11/4 - pool3/2 - conv5 - pool3/2 - conv3 x3, ReLU taps after each
    conv) with the lpips package's input scaling, loaded from the npz that
    the JAX package's `scripts/import_metric_weights.py` writes;
  * **proxy** (`lpips_proxy`): a fixed-seed random conv pyramid. Its
    kernels are the JAX package's own draws from `jax.random.PRNGKey(seed)`,
    made here by `evaluation/prng.py`, so both packages compute the same
    metric. Its convolutions pad as XLA's "SAME" does, asymmetrically.

The npz is probed at `$DDPM_IR_LPIPS_WEIGHTS`, then
`<repo>/weights/lpips_alex.npz`; `name` says which backbone is in use.
Inputs are NHWC in [-1, 1] (numpy or tensors); the work runs NCHW on the
LPIPS object's device, in full f32 (no TF32).
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.evaluation import prng

# lpips.ScalingLayer constants (input in [-1,1] is shifted/scaled before
# entering AlexNet; values from the LPIPS reference implementation).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# (kernel, stride, width) of the proxy pyramid, mirroring AlexNet's stages
_PROXY_SPECS = [(11, 4, 64), (5, 2, 192), (3, 2, 384), (3, 2, 256), (3, 1, 256)]


def _default_weights_path() -> Optional[str]:
    env = os.environ.get("DDPM_IR_LPIPS_WEIGHTS")
    if env and os.path.exists(env):
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(here, "weights", "lpips_alex.npz")
    return cand if os.path.exists(cand) else None


@contextlib.contextmanager
def full_f32():
    """f32 convolutions in full f32 inside the block (cuDNN defaults its f32
    convolutions to TF32, ~1e-3 relative)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """`lax.conv_general_dilated(..., padding="SAME")` over NCHW: output
    ceil(H / stride), the padding split with the odd element on the high
    side, which `Conv2d(padding=...)` cannot express."""
    pads = []
    for size, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def normalize_channels(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def hwio_to_oihw(k: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1))
                            ).to(device)


def as_nchw(x, device) -> torch.Tensor:
    """NHWC numpy or tensor -> NCHW f32 tensor on `device`."""
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device).permute(0, 3, 1, 2)


class LPIPS:
    """Perceptual distance d(a, b) for NHWC images in [-1, 1].

    `weights_path`: npz with conv{0..4}_w [HWIO] / conv{0..4}_b [O] (AlexNet
    features) and lin{0..4} [C] (LPIPS linear calibration); "auto" probes
    for it, and without it the fixed-seed proxy backbone is used.
    `linear_weights_path` (legacy) applies a linear calibration on top of the
    proxy."""

    def __init__(self, seed: int = 7, linear_weights_path: Optional[str] = None,
                 weights_path: Optional[str] = "auto", device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if weights_path == "auto":
            weights_path = _default_weights_path()
        if weights_path:
            self._init_alex(weights_path)
            return
        key = prng.prng_key(seed)
        self.kernels: List[torch.Tensor] = []
        in_c = 3
        for ksz, _, w in _PROXY_SPECS:
            key, sub = prng.split(key)
            k = prng.normal(sub, (ksz, ksz, in_c, w)) / np.float32(np.sqrt(ksz * ksz * in_c))
            self.kernels.append(hwio_to_oihw(k, self.device))
            in_c = w
        self.strides = [s for _, s, _ in _PROXY_SPECS]
        self.lin = None
        self.name = "lpips_proxy"
        if linear_weights_path:
            data = np.load(linear_weights_path)
            self.lin = [torch.as_tensor(data[f"lin{i}"], dtype=torch.float32, device=self.device)
                        for i in range(len(_PROXY_SPECS))]
            self.name = "lpips"

    def _proxy_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for k, s in zip(self.kernels, self.strides):
            x = torch.relu(conv_same(x, k, s))
            feats.append(x)
        return feats

    def _init_alex(self, weights_path: str) -> None:
        def vectors(fmt):
            return [torch.as_tensor(data[fmt.format(i)], dtype=torch.float32,
                                    device=self.device) for i in range(5)]

        with np.load(weights_path) as data:
            self.alex_w = [hwio_to_oihw(data[f"conv{i}_w"], self.device) for i in range(5)]
            self.alex_b, self.lin = vectors("conv{}_b"), vectors("lin{}")
        self.name = "lpips_alex"

    def _alex_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """torchvision AlexNet .features with ReLU taps (LPIPS slices):
        conv(11,s4,p2) R | pool | conv(5,s1,p2) R | pool | conv(3) R x3."""
        shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
        scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
        x = (x - shift) / scale
        w, b = self.alex_w, self.alex_b
        f0 = torch.relu(F.conv2d(x, w[0], b[0], stride=4, padding=2))
        f1 = torch.relu(F.conv2d(F.max_pool2d(f0, 3, 2), w[1], b[1], padding=2))
        f2 = torch.relu(F.conv2d(F.max_pool2d(f1, 3, 2), w[2], b[2], padding=1))
        f3 = torch.relu(F.conv2d(f2, w[3], b[3], padding=1))
        f4 = torch.relu(F.conv2d(f3, w[4], b[4], padding=1))
        return [f0, f1, f2, f3, f4]

    @torch.no_grad()
    def __call__(self, a, b) -> torch.Tensor:
        """Per-sample distances [B] (f32, on this object's device); inputs
        NHWC in [-1, 1]."""
        a, b = as_nchw(a, self.device), as_nchw(b, self.device)
        n = a.shape[0]
        features = self._proxy_features if self.name != "lpips_alex" else self._alex_features
        with full_f32():
            feats = features(torch.cat([a, b]))
        total = torch.zeros(n, device=self.device)
        for i, f in enumerate(feats):
            d = (normalize_channels(f[:n]) - normalize_channels(f[n:])) ** 2
            if self.lin is not None:
                total = total + (d * self.lin[i][None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
            else:
                total = total + d.mean(dim=(1, 2, 3))
        return total
