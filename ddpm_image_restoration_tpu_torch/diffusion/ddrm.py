"""DDRM-codec sampler (port of diffusion/ddrm.py): the static schedule and
the traced-budget solver, with encoder and decoder reuse.

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
eagerly, so here it is a Python loop over solver slots with the same step
algebra. Encoder reuse k > 1 encodes on every k-th slot and decodes from the
cached features in between, which is the JAX package's scan over groups of k
steps plus its tail; decoder reuse caches the deep decoder stages over the
same groups. The traced-budget solver (the JAX package's `_build_budget`)
gives each sample its own step indices in a fixed number of slots, with
per-sample masks; its schedule is host data here, so its branches cost no
wait on the card. Sampler statistics stay f32 whatever the model's compute
dtype. Noise comes from a `torch.Generator`, so at eta > 0 the
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


def _budget_schedule(init_t, n_slots: int, s_max: int = 512):
    """The traced-budget schedule: for each sample's init_t (a [B] vector),
    the step indices that `student_stride(init_t, n_slots)` and
    `_solver_indices` give, laid out in `n_slots` slots. Returns (idx, used,
    last), each [n_slots, B] (int32, bool, bool). A sample whose schedule has
    fewer steps pads with unused slots (idx 0) after its last step.

    The stride is the smallest s with ceil(init_t/s) + (0 missed) <=
    n_slots; when none qualifies (n_slots == 1) it is init_t, one evaluation
    at the degradation's own t, as `_solver_indices` does for stride >=
    steps."""
    s = np.asarray(init_t, np.int32).reshape(-1)                      # [B]
    n = int(n_slots)
    st_grid = np.arange(1, s_max + 1, dtype=np.int32)[:, None]        # [S,1]
    n_main_g = (s[None, :] + st_grid - 1) // st_grid                  # [S,B]
    miss_g = ((s[None, :] - 1) % st_grid) != 0
    ok = (n_main_g + miss_g) <= n
    st = np.where(ok.any(axis=0), ok.argmax(axis=0).astype(np.int32) + 1, s)
    st = np.where(n >= s, 1, st)                                      # [B]
    n_main = (s + st - 1) // st
    miss = (((s - 1) % st) != 0) & (st < s)
    n_used = np.where(st >= s, 1, n_main + miss)
    k = np.arange(n, dtype=np.int32)[:, None]                         # [N,1]
    idx = np.where(k < n_main[None, :], np.maximum(s[None, :] - 1 - k * st[None, :], 0), 0)
    used = k < n_used[None, :]
    last = k == (n_used[None, :] - 1)
    return idx.astype(np.int32), used, last


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None, None, None]


def _ddrm_update(x_theta, c, y, t, last: np.ndarray, last_d: torch.Tensor,
                 phase: np.ndarray, phase_d: torch.Tensor, eta: float, eta_b: float,
                 preset: CodecPreset, generator=None) -> torch.Tensor:
    """Post-consistency update (webp_training.py:455-471) for one solver
    slot. `last` and `phase` are the slot's per-sample flags on the host
    (they pick the branches, so nothing waits on the card), `last_d` and
    `phase_d` the same flags on the card for the per-lane selects. The
    static schedule gives every lane the same flags; the traced budget gives
    each sample its own."""
    x_prime = x_theta - c + y
    if last.all():
        return x_prime
    x_next = eta_b * x_prime + (1.0 - eta_b) * x_theta
    if eta:
        noise = torch.randn(y.shape, generator=generator, device=y.device,
                            dtype=torch.float32)
        x_next = x_next + eta * noise * (t * preset.sampler_noise_scale)[:, None, None, None]
    if phase.any():
        adjusted = phase_consistency(x_next, y, preset.phase_alpha)
        x_next = adjusted if phase.all() else torch.where(_lanes(phase_d), adjusted, x_next)
    if last.any():
        x_next = torch.where(_lanes(last_d), x_prime, x_next)
    return x_next


class DDRMSampler:
    """DDRM-codec restoration with the on-device codec surrogate.

    Example:
        sampler = DDRMSampler(model, preset)
        restored = sampler.sample(y, quality=10, steps=70, stride=5)
    """

    def __init__(self, model, preset: CodecPreset, codec_id: Optional[int] = None,
                 prediction: str = "direct"):
        """`codec_id`: conditioning index (config.codec_index) for a unified
        multi-codec model; the target codec's preset goes with it.
        `prediction='direct'` takes the model output as x̂ itself (the
        reference's sampling convention); 'residual' adds x_t to it first."""
        if prediction not in ("direct", "residual"):
            raise ValueError(prediction)
        self.model = model
        self.preset = preset
        self.codec_id = codec_id
        self.prediction = prediction

    def _schedule(self, steps, stride: int, q_host: np.ndarray, encoder_reuse: int,
                  traced_budget: int):
        """Per-slot, per-sample (idx, used, last, t, phase) as [slots, B]
        host arrays. Static: one index list for the whole batch, t = i/steps,
        the phase gate keyed off the first sample's quality (the reference's
        batch-scalar rule, avif.py:518-520). Traced budget: each sample's own
        schedule from its init_t, t = i/init_t, the phase gate per sample,
        and the slots padded with unused ones to whole encoder-reuse
        groups."""
        preset, b = self.preset, len(q_host)
        if traced_budget:
            it = np.broadcast_to(np.asarray(steps, np.int32).reshape(-1), (b,))
            idx, used, last = _budget_schedule(it, traced_budget)
            pad = -len(idx) % encoder_reuse
            if pad:
                idx, used, last = (np.concatenate([a, np.zeros((pad, b), a.dtype)])
                                   for a in (idx, used, last))
            t = idx.astype(np.float32) / it.astype(np.float32)
            q_gate = q_host[None, :]
        else:
            idxs = _solver_indices(steps, stride)
            idx = np.repeat(idxs[:, None], b, axis=1)
            used = np.ones(idx.shape, bool)
            last = np.repeat(_last_flags(idxs)[:, None], b, axis=1)
            t = idx.astype(np.float32) / np.float32(steps)
            q_gate = q_host[0]
        phase = ((q_gate < preset.phase_quality_threshold)
                 & (idx % preset.phase_period == 0) & (idx > 0))
        return idx, used, last, t, phase

    @torch.no_grad()
    def sample(self, y: torch.Tensor, quality, steps, eta: Optional[float] = None,
               eta_b: Optional[float] = None, stride: int = 1,
               protect: Optional[tuple] = None, protect_adaptive=None,
               encoder_reuse: int = 1, decoder_reuse_depth: int = 0,
               final_exact: bool = True, traced_budget: int = 0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Restore the NHWC observation y in [-1,1] at codec `quality` (a
        scalar or a per-sample [B] vector).

        `steps` is both the schedule length and the time normaliser;
        `stride` > 1 is the reduced-step solver; `encoder_reuse` = k runs the
        UNet encoder on every k-th evaluation only; `decoder_reuse_depth` =
        d > 0 (with k > 1) also runs the deep decoder stages once per
        encoder-reuse group (`decode_deep` at the group's first t) and only
        the last d stages and the head on each step (`decode_shallow`).

        `traced_budget` = N > 0 is the fixed-budget solver: `steps` is each
        sample's init_t (an int or a [B] vector), `stride` is ignored, and
        every sample runs its own `student_stride(init_t, N)` schedule in N
        slots (padded to whole encoder-reuse groups). Unused slots still
        evaluate the model and keep the previous x_t and x̂; the phase gate is
        decided per sample. A quality-mixed batch thus restores each image as
        it would be restored alone.

        `final_exact` recomputes the final projection x' = x̂ − codec(x̂) + y
        with the exact host codec (needs Pillow). `protect` = (lo, hi)
        applies `quality_gated_blend`, then `protect_adaptive` = beta applies
        `residual_trust_blend`.
        """
        if encoder_reuse < 1:
            raise ValueError("encoder_reuse must be >= 1")
        if decoder_reuse_depth < 0:
            raise ValueError("decoder_reuse_depth must be >= 0")
        if decoder_reuse_depth and encoder_reuse == 1:
            raise ValueError(
                "decoder_reuse_depth requires encoder_reuse > 1 (the deep "
                "decoder is cached per encoder-reuse group)"
            )
        preset, model, cond, depth = self.preset, self.model, self.codec_id, decoder_reuse_depth
        eta = preset.eta if eta is None else eta
        eta_b = preset.eta_b if eta_b is None else eta_b
        b = y.shape[0]
        y = y.float()
        q_host = np.broadcast_to(np.asarray(quality, np.float32).reshape(-1), (b,))
        q_vec = torch.tensor(q_host, device=y.device)
        if torch.is_tensor(steps):
            steps = steps.cpu().numpy()
        idx, used, last, t_host, phase = self._schedule(steps, stride, q_host, encoder_reuse,
                                                        traced_budget)
        used_d, last_d, phase_d, t_all = (torch.from_numpy(np.ascontiguousarray(a)).to(y.device)
                                          for a in (used, last, phase, t_host))

        x_t = x_theta = y
        for p in range(len(idx)):
            t = t_all[p]
            if p % encoder_reuse == 0:
                feats = model.encode(x_t, t, t, codec_id=cond)
                if depth:
                    deep = model.decode_deep(feats, t, t, depth=depth, codec_id=cond)
            if depth:
                x_new = model.decode_shallow(deep, feats[0], t, t, depth=depth, codec_id=cond)
            else:
                x_new = model.decode(feats, t, t, codec_id=cond)
            x_new = x_new.float()
            if self.prediction == "residual":
                x_new = x_t + x_new
            c = codec_surrogate(x_new, q_vec, codec=preset.name).float()
            x_next = _ddrm_update(x_new, c, y, t, last[p], last_d[p], phase[p], phase_d[p],
                                  eta, eta_b, preset, generator)
            if used[p].all():
                x_t, x_theta = x_next, x_new
            else:
                u = _lanes(used_d[p])
                x_t, x_theta = torch.where(u, x_next, x_t), torch.where(u, x_new, x_theta)

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
