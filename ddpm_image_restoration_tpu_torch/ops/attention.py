"""Self-attention over spatial tokens, [B, T, H, D] as in the JAX package.

  * 'xla'   — the plain softmax(QKᵀ/√d)·V in torch ops (the JAX package's
              jax.nn.dot_product_attention path).
  * 'flash' — the sm_90a flash-attention kernels for T >= 1024
              (ops/flash_attention.py), the threshold of the JAX package's
              flash_attention (ops/pallas/flash_attention.py:395); below it
              the plain path, as the JAX package uses XLA there. When a
              gradient is needed, the call goes through `FlashAttention`
              (forward kernel saving the LSE, backward kernels for dQ and
              dK/dV); otherwise only the forward kernel runs, without LSE.
"""

from __future__ import annotations

import torch

from ddpm_image_restoration_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_fwd,
    flash_attention_plain,
)

MIN_TOKENS_FOR_KERNEL = 1024


def _to_bhtd(x: torch.Tensor) -> torch.Tensor:
    """[B,T,H,D] -> contiguous [B·H,T,D] (the kernels' layout; at B = 1 the
    reshape alone is a strided view)."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      impl: str = "xla") -> torch.Tensor:
    """Scaled dot-product attention, [B,T,H,D] -> [B,T,H,D]."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    b, t, h, d = q.shape
    if impl == "flash" and t >= MIN_TOKENS_FOR_KERNEL:
        q, k, v = _to_bhtd(q), _to_bhtd(k), _to_bhtd(v)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            out = FlashAttention.apply(q, k, v)
        else:
            out = flash_attention_fwd(q, k, v)
    else:
        out = flash_attention_plain(_to_bhtd(q), _to_bhtd(k), _to_bhtd(v))
    return out.reshape(b, h, t, d).transpose(1, 2)
