"""Flash-attention forward over [BH, T, D]: the hand-written sm_90a kernel
(`csrc/flash_attention_fwd.cu`) and its plain PyTorch version.

Counterpart of `ops/pallas/flash_attention.py` `_flash_bhtd` in the JAX
package. A CPU tensor takes the plain version; a CUDA tensor always takes the
kernel, and anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ddpm_image_restoration_tpu_torch.ops import build

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          save_lse: bool = False):
    """softmax(q·kᵀ/√D)·v over [BH, T, D] in f32, output in q's dtype; with
    `save_lse` also the per-query log-sum-exp as [BH, T] f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.exp(s - lse[..., None]), v.float()).to(q.dtype)
    return (out, lse) if save_lse else out


def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        save_lse: bool = False):
    """[BH, T, D] attention forward; see `flash_attention_plain` for what it
    computes. Launches the kernel for CUDA tensors (bf16 or f32, contiguous,
    D <= 128) and counts each launch in `flash_attention_fwd.launches`. The
    kernel is built for the head dims in HEAD_DIMS; a smaller D is
    zero-padded to the next one (zero lanes add nothing to the scores, and
    the softmax scale stays 1/√D), as the JAX wrapper pads D to 128 lanes."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, save_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention_fwd: q, k, v must share one [BH,T,D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtype must be float32 or "
                         f"bfloat16 for all of q, k, v, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    bh, t, d = q.shape
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention_fwd: head dim {d} > {HEAD_DIMS[-1]}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    d_kernel = next(h for h in HEAD_DIMS if h >= d)
    if d_kernel != d:
        q, k, v = (torch.nn.functional.pad(z, (0, d_kernel - d)) for z in (q, k, v))
    lib = _lib()
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) if save_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if save_lse else None, bh, t, d_kernel, _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: launch failed with CUDA error {err}")
    flash_attention_fwd.launches += 1
    if d_kernel != d:
        out = out[..., :d].contiguous()
    return (out, lse) if save_lse else out


flash_attention_fwd.launches = 0
