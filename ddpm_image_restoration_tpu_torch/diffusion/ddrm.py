"""DDRM-codec sampler, static-schedule path (port of diffusion/ddrm.py).

Per reverse step i (descending, t = i/steps), as in the reference
(webp_training.py:424-473):

    x̂  = model(x_t, t, t)
    ĉ  = codec_surrogate(x̂, quality)
    x'  = x̂ - ĉ + y
    not last:  x_t = η_b·x' + (1-η_b)·x̂ + η·N(0, (noise_scale·t)²), and
               every `phase_period` steps while quality < threshold,
               x_t = phase_consistency(x_t, y, α)
    last:      x_t = x'

The JAX package runs the loop as one `lax.scan` under jit; PyTorch runs
eagerly, so here it is a Python loop with the same step algebra. Encoder
reuse k > 1 encodes on every k-th step of the schedule and decodes from the
cached features in between, which is the JAX package's scan over groups of k
steps plus its tail. Sampler statistics stay f32 whatever the model's
compute dtype. Noise comes from a `torch.Generator`, so at eta > 0 the
samples differ from the JAX package's; at eta 0 (the production policy) the
two agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate, interp
from ddpm_image_restoration_tpu_torch.config import CodecPreset


def phase_consistency(x: torch.Tensor, ref: torch.Tensor, alpha: float) -> torch.Tensor:
    """Recombine x's FFT magnitude with ref's phase, blended with weight
    alpha (webp_training.py:402-421). NHWC; FFT over the spatial axes."""
    x = x.float()
    x_mag = torch.fft.fft2(x, dim=(1, 2)).abs()
    ref_phase = torch.angle(torch.fft.fft2(ref.float(), dim=(1, 2)))
    spec = torch.complex(x_mag * torch.cos(ref_phase), x_mag * torch.sin(ref_phase))
    adjusted = torch.fft.ifft2(spec, dim=(1, 2)).real
    return alpha * x + (1.0 - alpha) * adjusted


def _quality_col(quality, like: torch.Tensor) -> torch.Tensor:
    """Scalar or [B] quality as a [B,1,1,1] f32 column (or a 0-d tensor)."""
    q = torch.as_tensor(quality, dtype=torch.float32, device=like.device)
    return q[:, None, None, None] if q.dim() == 1 else q


def quality_gated_blend(restored: torch.Tensor, y: torch.Tensor, quality,
                        lo: float, hi: float) -> torch.Tensor:
    """Blend toward the observation with a linear ramp in quality: full
    restoration at quality <= lo, untouched observation at quality >= hi."""
    w = torch.clamp((hi - _quality_col(quality, y)) / (hi - lo), 0.0, 1.0)
    return w * restored.float() + (1.0 - w) * y.float()


# Expected codec damage D(q): RMS of (codec(x0) - x0) in [-1,1] units on
# the JAX package's `natural` calibration corpus (results/r5).
_DAMAGE_Q = np.array([0.0, 5.0, 10.0, 20.0, 30.0, 50.0, 70.0, 90.0, 100.0])
_DAMAGE_RMS = {
    "webp": np.array([0.0909, 0.0656, 0.0598, 0.0533, 0.0483,
                      0.0417, 0.0362, 0.0248, 0.0192]),
    "jpeg": np.array([0.1480, 0.1115, 0.0791, 0.0563, 0.0469,
                      0.0323, 0.0272, 0.0211, 0.0077]),
    "avif": np.array([0.1201, 0.1011, 0.0870, 0.0651, 0.0547,
                      0.0366, 0.0244, 0.0158, 0.0064]),
}


def residual_trust_blend(restored: torch.Tensor, y: torch.Tensor, quality,
                         codec: str, beta=2.0, window: int = 8) -> torch.Tensor:
    """Cap the restoration residual's local energy at beta x the calibrated
    codec damage D(quality): per window x window tile,
    w = min(1, beta·D(q) / rms_local(restored - y)), upsampled bilinearly,
    out = y + w·(restored - y). `beta` is a scalar or a (q_knots,
    beta_knots) pair interpolated at each sample's quality."""
    r = restored.float() - y.float()
    b, h, w_, c = r.shape
    q = torch.as_tensor(quality, dtype=torch.float32, device=r.device).reshape(-1).expand(b)
    if isinstance(beta, tuple):
        qk, bk = beta
        beta = interp(q, qk, bk)[:, None, None]
    d = interp(q, _DAMAGE_Q, _DAMAGE_RMS[codec])
    hw, ww = h // window, w_ // window
    local_rms = torch.sqrt(
        (r[:, : hw * window, : ww * window, :] ** 2)
        .reshape(b, hw, window, ww, window, c)
        .mean(dim=(2, 4, 5))
        + 1e-12
    )
    w = torch.clamp(beta * d[:, None, None] / local_rms, max=1.0)  # [B, hw, ww]
    w_full = F.interpolate(w[:, None], size=(h, w_), mode="bilinear",
                           align_corners=False)[:, 0]
    return y.float() + w_full[..., None] * r


def _solver_indices(steps: int, stride: int) -> np.ndarray:
    """Descending step indices (webp_training.py:437); stride > 1 ends at 0,
    except stride >= steps, the single-evaluation budget, which keeps only
    the first index."""
    idxs = np.arange(steps - 1, -1, -stride)
    if idxs[-1] != 0 and stride < steps:
        idxs = np.append(idxs, 0)
    return idxs


def _last_flags(idxs: np.ndarray) -> np.ndarray:
    flags = np.zeros(len(idxs), bool)
    flags[-1] = True
    return flags


def _ddrm_update(x_theta, c, y, i: int, last: bool, t, q_first: float, eta: float,
                 eta_b: float, preset: CodecPreset, generator=None) -> torch.Tensor:
    """Post-consistency update (webp_training.py:455-471) for one static
    step `i`. The phase gate is a batch decision keyed off the first
    sample's quality, as in the reference (avif.py:518-520)."""
    x_prime = x_theta - c + y
    if last:
        return x_prime
    x_next = eta_b * x_prime + (1.0 - eta_b) * x_theta
    if eta:
        noise = torch.randn(y.shape, generator=generator, device=y.device,
                            dtype=torch.float32)
        x_next = x_next + eta * noise * (t * preset.sampler_noise_scale)[:, None, None, None]
    if (q_first < preset.phase_quality_threshold and i % preset.phase_period == 0
            and i > 0):
        x_next = phase_consistency(x_next, y, preset.phase_alpha)
    return x_next


class DDRMSampler:
    """DDRM-codec restoration with the on-device codec surrogate.

    Example:
        sampler = DDRMSampler(model, preset)
        restored = sampler.sample(y, quality=10, steps=70, stride=5)
    """

    def __init__(self, model, preset: CodecPreset, codec_id: Optional[int] = None):
        """`codec_id`: conditioning index (config.codec_index) for a unified
        multi-codec model; the target codec's preset goes with it. The model
        output is taken as x̂ itself (the JAX package's prediction='direct',
        the reference's sampling convention)."""
        self.model = model
        self.preset = preset
        self.codec_id = codec_id

    @torch.no_grad()
    def sample(self, y: torch.Tensor, quality, steps: int, eta: Optional[float] = None,
               eta_b: Optional[float] = None, stride: int = 1,
               protect: Optional[tuple] = None, protect_adaptive=None,
               encoder_reuse: int = 1, final_exact: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Restore the NHWC observation y in [-1,1] at codec `quality` (a
        scalar or a per-sample [B] vector).

        `steps` is both the schedule length and the time normaliser;
        `stride` > 1 is the reduced-step solver; `encoder_reuse` = k runs the
        UNet encoder on every k-th evaluation only. `final_exact` recomputes
        the final projection x' = x̂ − codec(x̂) + y with the exact host codec
        (needs Pillow). `protect` = (lo, hi) applies `quality_gated_blend`,
        then `protect_adaptive` = beta applies `residual_trust_blend`.
        """
        if encoder_reuse < 1:
            raise ValueError("encoder_reuse must be >= 1")
        preset, model, cond = self.preset, self.model, self.codec_id
        eta = preset.eta if eta is None else eta
        eta_b = preset.eta_b if eta_b is None else eta_b
        b = y.shape[0]
        y = y.float()
        q_host = np.broadcast_to(np.asarray(quality, np.float32).reshape(-1), (b,))
        q_vec = torch.tensor(q_host, device=y.device)
        idxs = _solver_indices(steps, stride)
        lasts = _last_flags(idxs)

        x_t = x_theta = y
        for p, (i, last) in enumerate(zip(idxs.tolist(), lasts.tolist())):
            t = torch.full((b,), float(i), dtype=torch.float32, device=y.device) / steps
            if p % encoder_reuse == 0:
                feats = model.encode(x_t, t, t, codec_id=cond)
            x_theta = model.decode(feats, t, t, codec_id=cond).float()
            c = codec_surrogate(x_theta, q_vec, codec=preset.name).float()
            x_t = _ddrm_update(x_theta, c, y, i, last, t, float(q_host[0]), eta,
                               eta_b, preset, generator)

        out = x_t
        if final_exact:
            from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch

            c_real = compress_batch(x_theta.cpu().numpy(), preset.name, q_host)
            out = x_theta - torch.as_tensor(c_real, device=y.device) + y
        if protect is not None:
            lo, hi = protect
            out = quality_gated_blend(out, y, q_vec, float(lo), float(hi))
        if protect_adaptive is not None:
            out = residual_trust_blend(out, y, q_vec, preset.name, beta=protect_adaptive)
        return out
