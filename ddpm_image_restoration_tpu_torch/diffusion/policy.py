"""Per-quality production solver policy (copy of diffusion/policy.py in the
JAX package; see its docstring for the round-3 experiment behind it)."""

from __future__ import annotations

from typing import Dict

# Model-evaluation budget per restore. 14 = the stride-5 compute point at
# q30 (init_t 70 / 5). init_t already shrinks as quality rises, so the
# derived stride falls from ~6 (q0) to ~1.4 (q90) automatically at a fixed
# budget.
PRODUCTION_MAX_EVALS = 14

# Encoder-propagation reuse (arXiv:2312.09608). With the deterministic
# solver this halves encoder FLOPs at no measured quality cost (E3 beats
# stride-1/enc1 reference mode at every quality WITH enc2 on).
PRODUCTION_ENCODER_REUSE = 2

# Deterministic solver: no per-step noise re-injection (see module
# docstring, finding 1). None would mean "preset default" (0.85).
PRODUCTION_ETA = 0.0


# Per-codec near-lossless protection (diffusion/ddrm.py
# quality_gated_blend): full restoration at q <= lo, untouched observation
# at q >= hi. AVIF is the one codec whose high-quality tier is effectively
# lossless on this model's input statistics (q90 compresses to ~45 dB,
# ~9 dB above WebP q90) — every accelerated config ever measured LOSES
# PSNR there (r1 -1.45, r2 -1.17, r4 unified -1.10) because there is
# nothing left to restore and any model rewrite is damage. The ramp keeps
# the strongly-positive q <= 50 gains untouched and fades restoration out
# across the q50->q90 knee measured in results/r{1,2,4} (q50 +0.99..+1.24,
# q70 +0.04, q90 negative everywhere).
PRODUCTION_PROTECT = {
    "avif": (60.0, 90.0),
}


def production_solver_config(quality, codec: str = None) -> Dict[str, object]:
    """Solver kwargs for a production restore at `quality` (scalar; serving
    buckets per-file estimates first, cli/serve.py quality_for).

    Quality-independent since the round-3 retune: the budgeted stride is
    already quality-adaptive through init_t, and the deterministic solver
    removed the one regime (few steps, high q) where the fixed budget lost
    quality. The signature keeps `quality` so serving call sites stay
    stable if a future retune goes per-quality again. `codec` adds the
    per-codec protection blend (None = no protection — callers that don't
    know their codec keep the old behaviour).
    """
    del quality
    cfg: Dict[str, object] = {
        "max_evals": PRODUCTION_MAX_EVALS,
        "encoder_reuse": PRODUCTION_ENCODER_REUSE,
        "eta": PRODUCTION_ETA,
    }
    protect = PRODUCTION_PROTECT.get(codec)
    if protect is not None:
        cfg["protect"] = protect
    return cfg


# Calibrated quality-tapered trust schedule for REAL-PHOTOGRAPH serving
# (diffusion/ddrm.py residual_trust_blend with beta=REAL_PHOTO_TRUST).
# Measured on the held-out real patch split with the r5 natural-corpus
# teacher (results/r5/probe_real_rewrite.log, q90 beta sweep in the round-5
# session log): the model's rewrite magnitude is ~quality-independent while
# true codec damage shrinks with quality, so the trust radius tapers.
# beta 0.25 maximises q10/q50 gains (+0.09/+0.12 offline); q90 turns
# positive only at beta ~0.1. NOT the blanket production default: the
# synthetic-corpus tables are measured without it, and a capped rewrite
# necessarily trades some peak synthetic gain for real-photo safety.
REAL_PHOTO_TRUST = (
    (0.0, 30.0, 50.0, 70.0, 90.0, 100.0),
    (0.30, 0.25, 0.25, 0.18, 0.10, 0.08),
)
