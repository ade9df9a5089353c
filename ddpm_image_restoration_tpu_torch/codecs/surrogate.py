"""Device-resident codec surrogates (JPEG / WebP / AVIF) in torch.

Port of `codecs/surrogate.py` in the JAX package: colour transform to
YCbCr, optional 4:2:0 chroma round-trip blended by quality, blockwise DCT as
one Kronecker matmul, quantisation by the codec's quality-scaled table times a
calibrated multiplier, a calibrated in-loop deblocking pass, and back to RGB.
The calibration tables are the JAX package's, interpolated in quality by
`interp` (torch has no `interp`). Images are NHWC in [-1, 1], as in the JAX
package.

The JAX package's surrogate always runs jitted, and XLA compiles its
divisions by a constant into multiplications by the constant's f32
reciprocal. The port multiplies by the same f32 numbers where the quotient
reaches a rounding: the quant tables' `/ 100` (so they round where the
compiled JAX function rounds them: an entry of exact value k + 0.5 can come
out as k) and the chroma blend's `/ 50`. The last `/ 255` feeds only the
output's clip, which a last-bit change cannot step, and stays a division.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Colour transforms (JPEG / BT.601 full-range)
# ---------------------------------------------------------------------------

_RGB2YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)
_YCC2RGB = np.linalg.inv(_RGB2YCC).astype(np.float32)


def _color_matmul(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    c0, c1, c2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack(
        [float(m[d, 0]) * c0 + float(m[d, 1]) * c1 + float(m[d, 2]) * c2
         for d in range(3)],
        dim=-1,
    )


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """[...,3] RGB in [0,1] -> YCbCr with Y in [0,1], Cb/Cr centred at 0."""
    return _color_matmul(x, _RGB2YCC)


def ycbcr_to_rgb(y: torch.Tensor) -> torch.Tensor:
    return _color_matmul(y, _YCC2RGB)


# ---------------------------------------------------------------------------
# Blockwise orthonormal DCT
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, rows = frequencies (D @ D.T = I)."""
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    m = np.cos(np.pi * (2 * j + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] = np.sqrt(1.0 / n)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def kron_dct_matrix(n: int) -> np.ndarray:
    """D ⊗ D [n², n²]: vec(D·X·Dᵀ) = (D⊗D)·vec(X) for row-major vec."""
    d = dct_matrix(n).astype(np.float64)
    return np.kron(d, d).astype(np.float32)


def _kron(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(kron_dct_matrix(n)).to(device=like.device, dtype=like.dtype)


def blockify(x: torch.Tensor, b: int) -> torch.Tensor:
    """[..., H, W] -> [..., H//b, W//b, b, b]."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // b, b, w // b, b).movedim(-3, -2)


def unblockify(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    x = x.movedim(-2, -3)  # [..., H//b, b, W//b, b]
    return x.reshape(*x.shape[:-4], h, w)


def block_dct2(x: torch.Tensor, b: int) -> torch.Tensor:
    """Blockwise 2-D DCT of [..., H, W] -> block layout [..., H//b, W//b, b, b]."""
    blocks = blockify(x, b)
    flat = blocks.reshape(*blocks.shape[:-2], b * b)
    return torch.matmul(flat, _kron(b, x).T).reshape(blocks.shape)


def block_idct2(coeffs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = coeffs.shape[-1]
    flat = coeffs.reshape(*coeffs.shape[:-2], b * b)
    blocks = torch.matmul(flat, _kron(b, coeffs)).reshape(coeffs.shape)
    return unblockify(blocks, h, w)


# ---------------------------------------------------------------------------
# Quantisation tables
# ---------------------------------------------------------------------------

_JPEG_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_JPEG_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _vp8_style_table(b: int = 4) -> np.ndarray:
    i = np.arange(b)[:, None] + np.arange(b)[None, :]
    return (12.0 + 6.0 * i).astype(np.float32)


def _av1_style_table(b: int = 8) -> np.ndarray:
    i = np.arange(b)[:, None] + np.arange(b)[None, :]
    return (14.0 + 4.5 * i).astype(np.float32)


# f32 reciprocals of the JAX code's constant divisors, as XLA folds them
_INV_100 = float(np.float32(1 / 100))
_INV_50 = float(np.float32(1 / 50))


def jpeg_quality_scale(quality: torch.Tensor) -> torch.Tensor:
    """libjpeg quality -> table scale factor (in %)."""
    quality = torch.clamp(quality, 1, 100).float()
    # a tensor over a tensor: torch computes `5000.0 / quality` as
    # 5000 * (1 / quality), rounded twice, where XLA divides once
    return torch.where(quality < 50.0, quality.new_tensor(5000.0) / quality,
                       200.0 - 2.0 * quality)


def _scaled_table(base: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    scale = jpeg_quality_scale(quality) * _INV_100
    table = base * scale[..., None, None]
    return torch.clamp(torch.floor(table + 0.5), 1.0, 255.0)


def interp(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """Piecewise-linear interpolation like `np.interp` / `jnp.interp`:
    increasing knots `xp`, values `fp`, constant beyond the end knots."""
    xp = torch.as_tensor(xp, dtype=torch.float32, device=x.device)
    fp = torch.as_tensor(fp, dtype=torch.float32, device=x.device)
    x = x.float().contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    w = (x - x0) / (x1 - x0)
    out = f0 + w * (f1 - f0)
    out = torch.where(x <= xp[0], fp[0], out)
    return torch.where(x >= xp[-1], fp[-1], out)


# ---------------------------------------------------------------------------
# Straight-through rounding
# ---------------------------------------------------------------------------


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) whose gradient is the identity (the JAX package's
    `ste_round` custom VJP): the rounding error is added as a constant."""
    return x + (torch.round(x) - x).detach()


# ---------------------------------------------------------------------------
# In-loop deblocking (WebP/AVIF)
# ---------------------------------------------------------------------------


def _deblock(chan: torch.Tensor, b: int, strength: torch.Tensor,
             thresh: torch.Tensor) -> torch.Tensor:
    """One pass of the VP8/AV1-style in-loop deblocking approximation on
    [B, H, W] (0-255 units): at every b-aligned boundary, pull the two pixels
    on each side toward the boundary by (strength/2, strength/4), gated by
    T²/(T²+d²) so large steps (true edges) pass through."""
    s = strength.float()[:, None, None]
    t2 = torch.square(thresh.float())[:, None, None]

    def axis_pass(x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.movedim(dim, -1)
        n = x.shape[-1] // b
        if n < 2:
            return x.movedim(-1, dim)
        length = n * b
        p0 = x[..., b - 1::b][..., : n - 1]
        q0 = x[..., b::b]
        d = q0 - p0
        g = t2 / (t2 + d * d)
        adj = s * g * d
        x = x.clone()
        x[..., b - 2:length - 2:b] += 0.25 * adj
        x[..., b - 1:length - 1:b] += 0.5 * adj
        x[..., b:length:b] += -0.5 * adj
        x[..., b + 1:length:b] += -0.25 * adj
        return x.movedim(-1, dim)

    return axis_pass(axis_pass(chan, 2), 1)


def _subsample_420(c: torch.Tensor) -> torch.Tensor:
    """[B,H,W] -> 2x2 average pooled and nearest-upsampled back."""
    b, h, w = c.shape
    pooled = c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    return pooled.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# The surrogate
# ---------------------------------------------------------------------------

_BLOCK = {"jpeg": 8, "webp": 4, "avif": 8}
# Quality-indexed quant-strength multipliers (fitted by the JAX package's
# scripts/calibrate_surrogate.py), linearly interpolated in quality.
_CALIBRATION = {
    "jpeg": ([1, 5, 10, 20, 30, 40, 50, 60, 70, 75, 80, 85, 90, 95, 100],
             [1.0108, 1.0387, 1.1612, 1.5343, 1.8622, 0.9875, 0.9984, 1.0158,
              1.03, 1.0391, 1.0515, 1.0816, 1.1182, 1.246, 2.4953]),
    "webp": ([1, 5, 10, 20, 30, 40, 50, 60, 70, 75, 80, 85, 90, 95, 100],
             [0.7292, 0.7568, 1.2344, 1.9233, 2.289, 2.562, 2.7477, 2.9979,
              3.5427, 3.8976, 3.9432, 4.1925, 4.7712, 7.8653, 17.6325]),
    "avif": ([1, 5, 10, 20, 30, 40, 50, 60, 70, 75, 80, 85, 90, 95, 100],
             [0.5248, 0.4866, 0.7057, 0.8411, 0.8425, 0.7761, 0.7214, 0.3868,
              0.3944, 0.4037, 0.431, 0.4488, 0.5409, 0.7992, 2.0384]),
}
# Quality-indexed deblocking (strength, edge-threshold) for `_deblock`;
# JPEG has no in-loop filter, so its strengths are zero.
_DEBLOCK = {
    "jpeg": ([1, 100], [0.0, 0.0], [8.0, 8.0]),
    "webp": ([1, 5, 10, 20, 30, 40, 50, 60, 70, 75, 80, 85, 90, 95, 100],
             [1.0, 0.8, 1.0, 0.8, 1.0, 0.8, 0.8, 0.8, 0.8, 0.8, 0.6, 0.6,
              0.8, 0.6, 0.6],
             [32.0, 32.0, 24.0, 24.0, 16.0, 16.0, 16.0, 16.0, 12.0, 12.0,
              12.0, 12.0, 8.0, 8.0, 8.0]),
    "avif": ([1, 5, 10, 20, 30, 40, 50, 60, 70, 75, 80, 85, 90, 95, 100],
             [1.0, 1.0, 1.0, 0.8, 1.0, 0.8, 0.8, 0.45, 0.3, 0.3, 0.15, 0.15,
              0.15, 0.15, 0.0],
             [32.0, 32.0, 32.0, 32.0, 16.0, 16.0, 12.0, 6.0, 6.0, 6.0, 8.0,
              6.0, 4.0, 4.0, 4.0]),
}


def _base_tables(codec: str):
    if codec == "jpeg":
        return _JPEG_LUMA, _JPEG_CHROMA
    if codec == "webp":
        t = _vp8_style_table(4)
        return t, t * 1.4
    if codec == "avif":
        t = _av1_style_table(8)
        return t, t * 1.3
    raise ValueError(f"unknown codec {codec!r}")


def _per_sample(v, bsz: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(bsz)


def codec_surrogate(x: torch.Tensor, quality, codec: str = "jpeg",
                    subsample: bool = True) -> torch.Tensor:
    """Codec round-trip approximation of NHWC `x` in [-1, 1] at `quality`
    (a scalar or a [B] vector); H, W divisible by the codec block size (and
    by 2 when `subsample`). Returns [-1, 1] in x's dtype."""
    q_vec = _per_sample(quality, x.shape[0], x.device)
    q_grid, m_grid = _CALIBRATION[codec]
    mult = interp(q_vec, q_grid, m_grid)
    dq_grid, s_grid, t_grid = _DEBLOCK[codec]
    return _surrogate_raw(x, q_vec, codec, subsample, mult,
                          interp(q_vec, dq_grid, s_grid),
                          interp(q_vec, dq_grid, t_grid))


def _surrogate_raw(x: torch.Tensor, quality, codec: str, subsample: bool,
                   strength_mult, deblock=0.0, deblock_thresh=8.0) -> torch.Tensor:
    """Uncalibrated surrogate core: `strength_mult` scales the quant tables,
    `deblock`/`deblock_thresh` (scalar or [B]) set the in-loop filter."""
    orig_dtype = x.dtype
    x = x.float()
    b = _BLOCK[codec]
    bsz, h, w, _ = x.shape
    dev = x.device
    quality = _per_sample(quality, bsz, dev)
    strength_mult = _per_sample(strength_mult, bsz, dev)[:, None, None]

    rgb01 = (x + 1.0) * 0.5
    ycc = rgb_to_ycbcr(rgb01) * 255.0
    y = ycc[..., 0] - 128.0
    cb = ycc[..., 1]
    cr = ycc[..., 2]

    if subsample:
        w420 = torch.clamp((75.0 - quality) * _INV_50, 0.0, 1.0)[:, None, None]
        cb = w420 * _subsample_420(cb) + (1.0 - w420) * cb
        cr = w420 * _subsample_420(cr) + (1.0 - w420) * cr

    luma_t, chroma_t = _base_tables(codec)
    qt_l = _scaled_table(torch.from_numpy(luma_t).to(dev), quality) * strength_mult
    qt_c = _scaled_table(torch.from_numpy(chroma_t).to(dev), quality) * strength_mult

    def quantize_channel(chan: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        coeffs = block_dct2(chan, b)                       # [B,H/b,W/b,b,b]
        # the orthonormal DCT's coefficients scale as b/8 against JPEG's gauge
        t = table[:, None, None] * (b / 8.0)
        q = ste_round(coeffs / t) * t
        return block_idct2(q, h, w)

    y_q = quantize_channel(y, qt_l)
    cb_q = quantize_channel(cb, qt_c)
    cr_q = quantize_channel(cr, qt_c)

    deblock = _per_sample(deblock, bsz, dev)
    deblock_thresh = _per_sample(deblock_thresh, bsz, dev)
    # the codecs' loop filter runs after dequantisation, before the colour transform
    y_q = _deblock(y_q, b, deblock, deblock_thresh)
    cb_q = _deblock(cb_q, b, deblock, deblock_thresh)
    cr_q = _deblock(cr_q, b, deblock, deblock_thresh)

    ycc_q = torch.stack([y_q + 128.0, cb_q, cr_q], dim=-1) / 255.0
    rgb = ycbcr_to_rgb(ycc_q)
    return torch.clamp(rgb * 2.0 - 1.0, -1.0, 1.0).to(orig_dtype)
