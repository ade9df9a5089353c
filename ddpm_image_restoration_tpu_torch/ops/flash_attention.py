"""Flash attention over [BH, T, D]: the hand-written sm_90a kernels
(`csrc/flash_attention_fwd.cu`, `csrc/flash_attention_bwd.cu`), their plain
PyTorch versions, and the `torch.autograd.Function` that joins them.

Counterpart of `ops/pallas/flash_attention.py` in the JAX package:
`flash_attention_fwd` of `_flash_bhtd`, `flash_attention_bwd_dq` and
`flash_attention_bwd_dkv` of the two kernels of `_flash_bhtd_bwd`, and
`FlashAttention` of the `_flash_diff` custom VJP. A CPU tensor takes the
plain version; a CUDA tensor always takes the kernel, and anything the
kernel does not take raises.

Which design serves which dtype on the card:
  * bf16: the forward, dQ and dK/dV run their products by Hopper's
    `wgmma`, their tiles arriving by TMA into an mbarrier ring, with f32
    accumulation, P and dS carried as a bf16 hi/lo pair;
  * f32: the forward, dQ and dK/dV run on TF32 `wgmma` with the 3xTF32
    split (every product as hi*hi + hi*lo + lo*hi of TF32 parts, f32
    accumulation: f32 accuracy, where one TF32 product would not be),
    their tiles arriving by TMA and split into hi/lo by a producer
    warpgroup.
The tensor-core kernels read rows by TMA, whose tensor maps need 16-byte
aligned bases, so every CUDA input must start 16-byte aligned (a
contiguous view at an odd offset is refused, not copied).

Head dims: each kernel is built for the dims in `HEAD_DIMS`, and the three
bf16 kernels for D = 8 too (zero-filled to the wgmma depth of 16 in shared
memory); a smaller D is zero-padded to the next built one
(`kernel_head_dim`), so the f32 kernels pad D = 8 to 16 and every kernel
runs a D of 129-256 as 256. D = 256 is the widest head any configuration
reaches (the 1024-channel bottleneck over 4 heads, attended at T = 1024
from 1024² images); a wider D is refused on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ddpm_image_restoration_tpu_torch.ops import build

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
HEAD_DIMS = (16, 32, 64, 128, 256)
# The bf16 kernels (wgmma) are built for D = 8 too.
WGMMA_HEAD_DIMS = (8, *HEAD_DIMS)
WGMMA_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
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


def _bwd_terms(q, k, v, do, lse, delta):
    """P = exp(scale·q·kᵀ − LSE) and dS = P∘(dO·vᵀ − Delta), [BH, T, T] f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(q.float() * scale, k.float().transpose(-1, -2)) - lse[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None])
    return p, ds, scale


def _delta(o, do):
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_dq_plain(q, k, v, o, do, lse):
    """dQ = scale·dS·k in q's dtype, and Delta = rowsum(dO∘O) as [BH, T] f32."""
    delta = _delta(o, do)
    _, ds, scale = _bwd_terms(q, k, v, do, lse, delta)
    return (scale * torch.matmul(ds, k.float())).to(q.dtype), delta


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta):
    """dK = scale·dSᵀ·q and dV = Pᵀ·dO, in q's dtype."""
    p, ds, scale = _bwd_terms(q, k, v, do, lse, delta)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, do, lse):
    """(dQ, dK, dV) of `flash_attention_plain` from its output `o`, the
    cotangent `do` and the forward's [BH, T] f32 `lse`, by the explicit
    formulas of the JAX package's backward kernels (not by autograd)."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta))


_SIGNATURES = {
    # name: (pointer arguments, library)
    "flash_attention_fwd": (5, KERNEL),
    "flash_attention_bwd_dq": (8, BWD_KERNEL),
    "flash_attention_bwd_dkv": (8, BWD_KERNEL),
}


def _launcher(name: str):
    """The C launcher `name`: its pointer arguments, then bh, t, d, dtype
    (ints), the softmax scale (float) and the stream; returns a CUDA error."""
    n_ptr, lib_name = _SIGNATURES[name]
    fn = getattr(build.load(lib_name), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, *tensors: torch.Tensor) -> None:
    """Raises unless the [BH, T, D] tensors are CUDA, contiguous, 16-byte
    aligned, of one shape, float32 or bfloat16 alike, with D <= 256."""
    q = tensors[0]
    if q.dim() != 3 or any(z.shape != q.shape for z in tensors):
        raise ValueError(f"{name}: inputs must share one [BH,T,D] shape, got "
                         f"{[tuple(z.shape) for z in tensors]}")
    if q.dtype not in _DTYPE_CODE or any(z.dtype != q.dtype for z in tensors):
        raise ValueError(f"{name}: dtype must be float32 or bfloat16 for all "
                         f"inputs, got {[z.dtype for z in tensors]}")
    if q.shape[-1] > HEAD_DIMS[-1]:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > {HEAD_DIMS[-1]}, the widest "
                         f"the kernels are built for; no model configuration reaches it "
                         f"(the widest head is 1024 channels over 4 heads)")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(z.device != q.device for z in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if not all(z.is_contiguous() for z in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    _check_aligned(name, *tensors)


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raises unless every tensor's first element is 16-byte aligned."""
    bad = [z.data_ptr() % 16 for z in tensors if z.data_ptr() % 16]
    if bad:
        raise ValueError(f"{name}: inputs must start 16-byte aligned, got "
                         f"offsets {bad} (mod 16)")


def _check_stats(name: str, q: torch.Tensor, *stats: torch.Tensor) -> None:
    for s in stats:
        if s.shape != q.shape[:2] or s.dtype != torch.float32 or s.device != q.device \
                or not s.is_contiguous():
            raise ValueError(f"{name}: per-row statistics must be contiguous "
                             f"[BH,T] float32 on {q.device}, got {tuple(s.shape)} "
                             f"{s.dtype} on {s.device}")


def kernel_head_dim(name: str, d: int, dtype: torch.dtype) -> int:
    """The head dim the launcher `name` runs for a D of `d` in `dtype`: the
    smallest of its built dims that holds it (WGMMA_HEAD_DIMS for the bf16
    kernels, HEAD_DIMS for the f32 ones)."""
    wgmma = dtype == torch.bfloat16 and name in WGMMA_KERNELS
    return next(h for h in (WGMMA_HEAD_DIMS if wgmma else HEAD_DIMS) if h >= d)


def _pad_d(name: str, d: int, *tensors: torch.Tensor):
    """`kernel_head_dim` and the tensors zero-padded to it (zero lanes add
    nothing to any dot product, and the scale stays 1/√d)."""
    d_kernel = kernel_head_dim(name, d, tensors[0].dtype)
    if d_kernel == d:
        return d_kernel, tensors
    return d_kernel, tuple(torch.nn.functional.pad(z, (0, d_kernel - d)) for z in tensors)


def _launch(name: str, pointers, bh: int, t: int, d_kernel: int, dtype, d: int,
            device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher(name)(*pointers, bh, t, d_kernel, _DTYPE_CODE[dtype],
                              1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        save_lse: bool = False):
    """[BH, T, D] attention forward; see `flash_attention_plain` for what it
    computes. Launches the kernel for CUDA tensors (bf16 or f32, contiguous,
    D <= 256) and counts each launch in `flash_attention_fwd.launches`. The
    kernel is built for the head dims in HEAD_DIMS; a smaller D is
    zero-padded to the next one (`kernel_head_dim`: zero lanes add nothing
    to the scores, and the softmax scale stays 1/√D), as the JAX wrapper
    pads D to 128 lanes."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, save_lse)
    _check("flash_attention_fwd", q, k, v)
    bh, t, d = q.shape
    d_kernel, (q, k, v) = _pad_d("flash_attention_fwd", d, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) if save_lse else None
    _launch("flash_attention_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if save_lse else None), bh, t, d_kernel, q.dtype, d, q.device)
    flash_attention_fwd.launches += 1
    if d_kernel != d:
        out = out[..., :d].contiguous()
    return (out, lse) if save_lse else out


def flash_attention_bwd_dq(q, k, v, o, do, lse):
    """(dQ in q's dtype, Delta = rowsum(dO∘O) as [BH, T] f32); see
    `flash_attention_bwd_dq_plain`. Launches the dQ kernel for CUDA tensors
    and counts each launch in `flash_attention_bwd_dq.launches`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, do, lse)
    _check("flash_attention_bwd_dq", q, k, v, o, do)
    _check_stats("flash_attention_bwd_dq", q, lse)
    bh, t, d = q.shape
    d_kernel, (q, k, v, o, do) = _pad_d("flash_attention_bwd_dq", d, q, k, v, o, do)
    dq = torch.empty_like(q)
    delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dq.data_ptr(), delta.data_ptr()), bh, t, d_kernel, q.dtype, d,
            q.device)
    flash_attention_bwd_dq.launches += 1
    return (dq[..., :d].contiguous() if d_kernel != d else dq), delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta):
    """(dK, dV) in q's dtype from the LSE and the Delta of
    `flash_attention_bwd_dq`; see `flash_attention_bwd_dkv_plain`. Launches
    the dK/dV kernel for CUDA tensors and counts each launch in
    `flash_attention_bwd_dkv.launches`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    _check("flash_attention_bwd_dkv", q, k, v, do)
    _check_stats("flash_attention_bwd_dkv", q, lse, delta)
    bh, t, d = q.shape
    d_kernel, (q, k, v, do) = _pad_d("flash_attention_bwd_dkv", d, q, k, v, do)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("flash_attention_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()), bh, t, d_kernel, q.dtype, d,
            q.device)
    flash_attention_bwd_dkv.launches += 1
    if d_kernel != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
# the wrappers that count their launches (a captured graph adds its own
# launches to them on each replay: utils/graphs.py `CapturedGraph`)
COUNTED_KERNELS = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)


def flash_attention_bwd(q, k, v, o, do, lse):
    """(dQ, dK, dV): the dQ kernel, then the dK/dV kernel on the Delta it
    wrote (each wrapper takes the plain version for CPU tensors)."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable [BH, T, D] flash attention (the JAX package's
    `_flash_diff`): the forward kernel saving the LSE, and the two backward
    kernels on the saved q, k, v, o and LSE."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v, save_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, do.contiguous(), lse)
