"""Evaluation harness (port of evaluation/harness.py): the reference's
`test_*_restoration` (webp_inference.py:604-952, avif_inference.py:462-810,
`svd imagenet.ipynb`).

For every quality: compress with the host codec -> restore with the DDRM
sampler -> per-image PSNR / SSIM / LPIPS / L2 of the compressed and the
restored images, the Fréchet distance of each set to the originals, a
comparative table, metric-vs-quality panels, example grids and
`metrics_summary.json` (rewritten atomically after every quality).

Restores run in batches of `batch_size` on the model's device; the last
partial batch is padded up to `batch_size` by repeating its last image
(metrics count the real images only), so every batch has one shape, as in
the JAX package. Metrics and features are computed on the device; the
Fréchet statistics and the files on the host. The solver's noise (eta > 0)
comes from one `torch.Generator` seeded 0, so it is not the JAX package's
noise; at eta 0 (the production policy) the two agree.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import compress_batch
from ddpm_image_restoration_tpu_torch.codecs.quality import (
    init_timestep_for_quality,
    student_stride,
)
from ddpm_image_restoration_tpu_torch.config import EvalConfig, codec_index
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
from ddpm_image_restoration_tpu_torch.diffusion.ensemble import sample_ensemble
from ddpm_image_restoration_tpu_torch.diffusion.losses import ssim
from ddpm_image_restoration_tpu_torch.diffusion.policy import production_solver_config
from ddpm_image_restoration_tpu_torch.evaluation.fid import (
    compute_statistics,
    default_feature_extractor,
    frechet_distance,
)
from ddpm_image_restoration_tpu_torch.evaluation.lpips import LPIPS
from ddpm_image_restoration_tpu_torch.utils.viz import save_restoration_grid


def _to01(x):
    return np.clip(np.asarray(x, np.float32) * 0.5 + 0.5, 0, 1)


@torch.no_grad()
def _per_image_metrics(pred: torch.Tensor, target: torch.Tensor):
    """Per-image PSNR / SSIM / normalized-L2 ([B] each) of NHWC pairs in
    [-1, 1], rescaled to [0, 1] and clipped."""
    p = torch.clamp(pred.float() * 0.5 + 0.5, 0, 1)
    t = torch.clamp(target.float() * 0.5 + 0.5, 0, 1)
    sq = (p - t) ** 2
    psnr = -10.0 * torch.log10(sq.mean(dim=(1, 2, 3)) + 1e-8)
    l2 = torch.sqrt(sq.sum(dim=(1, 2, 3))) / np.sqrt(np.prod(pred.shape[1:]))
    return psnr, ssim(p, t, size_average=False), l2


def evaluate_restoration(
    cfg: EvalConfig,
    model,
    images: np.ndarray,
    batch_size: int = 8,
    save_examples: int = 4,
    verbose: bool = True,
    prediction: str = "direct",
    stride: int = 1,
    protect=None,
    protect_adaptive=None,
    encoder_reuse: int = 1,
    decoder_reuse_depth: int = 0,
    ensemble: int = 1,
    max_evals: int = 0,
    final_exact=None,
    eta=None,
    eta_b=None,
    init_t_override: int = 0,
    phase_threshold=None,
    solver: str = "manual",
    traced: bool = False,
) -> Dict:
    """Run the full evaluation of `model` (its own weights, on its device)
    over `images` [N,H,W,3] in [-1,1]; returns the metrics-summary dict
    (also written to `cfg.output_dir/metrics_summary.json`).

    The arguments are the JAX harness's: `eta`/`eta_b` replace the
    sampler's noise and consistency weights, `init_t_override` > 0 pins the
    start step for every quality, `phase_threshold` replaces the preset's
    phase-consistency gate; `solver='auto'` takes each quality's budget,
    encoder reuse, eta and protection from the production policy
    (diffusion/policy.py); `max_evals` derives the stride per quality;
    `traced=True` (needs a budget) runs the traced-budget solver. Each
    override is recorded in the summary."""
    preset = cfg.preset
    if phase_threshold is not None:
        preset = dataclasses.replace(preset, phase_quality_threshold=int(phase_threshold))
    os.makedirs(cfg.output_dir, exist_ok=True)
    if cfg.max_images:
        images = images[: cfg.max_images]  # AVIF caps at 500 (avif_inference.py:509-512)
    dev = model.out_conv.weight.device

    # unified ('all') models: condition on the TARGET codec while the
    # sampler uses that codec's own preset
    codec_id = codec_index(preset.name) if model.cfg.codec_conditioning else None
    sampler = DDRMSampler(model, preset, codec_id=codec_id, prediction=prediction,
                          consistency_mode=cfg.consistency_mode)
    lpips_fn = LPIPS(device=dev)
    extractor = default_feature_extractor(dev) if cfg.compute_fid else None

    # Fréchet statistics from per-batch features: the originals' once, then
    # per quality only [N, D] feature blocks accumulate
    orig_stats = None
    if cfg.compute_fid:
        orig_feats = np.concatenate([extractor(_to01(images[i: i + batch_size]))
                                     for i in range(0, len(images), batch_size)])
        orig_stats = compute_statistics(orig_feats)

    results: Dict[str, Dict[str, float]] = {}
    cfg_stride = int(stride)  # `stride` is re-derived per quality under max_evals
    generator = torch.Generator(device=dev).manual_seed(0)

    for quality in cfg.eval_qualities:
        acc: Dict[str, List[float]] = defaultdict(list)
        init_t = init_t_override or init_timestep_for_quality(quality, cfg.steps, preset)
        q_max_evals, q_enc_reuse, q_eta, q_protect = max_evals, encoder_reuse, eta, protect
        if solver == "auto":
            pc = production_solver_config(quality, preset.name)
            q_max_evals = pc["max_evals"]
            q_enc_reuse = pc["encoder_reuse"]
            if eta is None:  # an explicit eta still overrides the policy
                q_eta = pc.get("eta")
            if protect is None:  # an explicit protect overrides the policy
                q_protect = pc.get("protect")
        if q_max_evals:  # budgeted solver: stride derived per quality
            stride = student_stride(init_t, q_max_evals)
        q_traced_budget = 0
        if traced:
            if not q_max_evals:
                raise ValueError("traced=True needs a fixed eval budget: pass max_evals "
                                 "or solver='auto'")
            q_traced_budget = int(q_max_evals)
        comp_all, rest_all = [], []
        t_start = time.time()
        n_restored = 0

        for i in range(0, len(images), batch_size):
            x0 = images[i: i + batch_size]
            y = compress_batch(x0, preset.name, quality)
            n_valid = len(x0)
            y_in = y
            if n_valid < batch_size:  # pad to one batch shape with the last image
                y_in = np.concatenate([y, np.repeat(y[-1:], batch_size - n_valid, axis=0)])
            restored = sample_ensemble(
                sampler, torch.as_tensor(y_in, device=dev), quality, init_t,
                n_transforms=ensemble, stride=stride, protect=q_protect,
                protect_adaptive=protect_adaptive, encoder_reuse=q_enc_reuse,
                decoder_reuse_depth=decoder_reuse_depth, final_exact=final_exact,
                traced_budget=q_traced_budget, eta=q_eta, eta_b=eta_b,
                generator=generator)[:n_valid]
            n_restored += n_valid

            x0_d = torch.as_tensor(x0, device=dev)
            for tag, img in (("compressed", torch.as_tensor(y, device=dev)),
                             ("restored", restored)):
                p, s, l2 = _per_image_metrics(img, x0_d)
                acc[f"{tag}_psnr"] += p.cpu().tolist()
                acc[f"{tag}_ssim"] += s.cpu().tolist()
                acc[f"{tag}_l2"] += l2.cpu().tolist()
                acc[f"{tag}_lpips"] += lpips_fn(img, x0_d).cpu().tolist()
            restored = restored.cpu().numpy()

            if cfg.compute_fid:
                comp_all.append(extractor(_to01(y)))
                rest_all.append(extractor(_to01(restored)))

            if i == 0 and save_examples:
                save_restoration_grid(
                    os.path.join(cfg.output_dir, f"examples_q{quality}.png"),
                    x0[:save_examples], y[:save_examples], restored[:save_examples],
                    quality=quality)

        row = {k: float(np.mean(v)) for k, v in acc.items()}
        # 95% CIs on the per-image restoration DELTAS (paired, so the
        # image-difficulty variance cancels)
        row["n"] = len(acc["restored_psnr"])
        for m in ("psnr", "ssim"):
            d = np.asarray(acc[f"restored_{m}"]) - np.asarray(acc[f"compressed_{m}"])
            row[f"delta_{m}"] = float(d.mean())
            row[f"delta_{m}_ci95"] = (float(1.96 * d.std(ddof=1) / np.sqrt(len(d)))
                                      if len(d) > 1 else float("nan"))
        if cfg.compute_fid:
            row["compressed_fid"] = frechet_distance(
                *compute_statistics(np.concatenate(comp_all)), *orig_stats)
            row["restored_fid"] = frechet_distance(
                *compute_statistics(np.concatenate(rest_all)), *orig_stats)
            row["fid_kind"] = extractor.name
        row["images_per_sec"] = n_restored / (time.time() - t_start)
        # per-quality solver config (varies under solver='auto' / max_evals)
        row["solver_stride"] = int(stride)
        row["solver_encoder_reuse"] = int(q_enc_reuse)
        row["solver_init_t"] = int(init_t)
        row["solver_eta"] = None if q_eta is None else float(q_eta)
        row["solver_protect"] = None if q_protect is None else [float(v) for v in q_protect]
        row["solver_protect_adaptive"] = (
            None if protect_adaptive is None
            else [list(map(float, k)) for k in protect_adaptive]
            if isinstance(protect_adaptive, tuple)
            else float(protect_adaptive))
        results[str(quality)] = row
        # the summary after EVERY quality (atomic rename), so a cut run
        # keeps its finished rows with n and CIs
        _write_summary(cfg, preset, images, cfg_stride, max_evals, encoder_reuse, solver,
                       traced, final_exact, eta, eta_b, init_t_override, phase_threshold,
                       lpips_fn, results, partial=True)
        if verbose:
            print(f"q={quality:3d}: PSNR {row['compressed_psnr']:.2f}->{row['restored_psnr']:.2f} "
                  f"SSIM {row['compressed_ssim']:.4f}->{row['restored_ssim']:.4f} "
                  f"({row['images_per_sec']:.2f} img/s)", flush=True)

    summary = _write_summary(cfg, preset, images, cfg_stride, max_evals, encoder_reuse,
                             solver, traced, final_exact, eta, eta_b, init_t_override,
                             phase_threshold, lpips_fn, results, partial=False)
    if verbose:
        print(format_comparative_table(summary), flush=True)
    plot_metric_panels(summary, os.path.join(cfg.output_dir, "metric_panels.png"))
    return summary


def _write_summary(cfg, preset, images, cfg_stride, max_evals, encoder_reuse,
                   solver, traced, final_exact, eta, eta_b, init_t_override,
                   phase_threshold, lpips_fn, results, partial):
    """Assemble and atomically write metrics_summary.json. `partial=True`
    marks an in-progress checkpoint (quality loop not finished); the final
    write clears the flag."""
    summary = {
        "codec": preset.name,
        "num_images": int(len(images)),
        "steps": cfg.steps,
        "stride": cfg_stride,
        "max_evals": int(max_evals),
        "encoder_reuse": int(encoder_reuse),
        "solver": solver,
        "traced": bool(traced),
        "consistency_mode": cfg.consistency_mode,
        "final_exact": bool(final_exact if final_exact is not None
                            else cfg.consistency_mode == "surrogate"),
        "eta": None if eta is None else float(eta),
        "eta_b": None if eta_b is None else float(eta_b),
        "init_t_override": int(init_t_override),
        "phase_threshold": None if phase_threshold is None else int(phase_threshold),
        "lpips_kind": lpips_fn.name,
        "results": results,
    }
    if partial:
        summary["partial"] = True
    path = os.path.join(cfg.output_dir, "metrics_summary.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, path)
    return summary


def format_comparative_table(summary: Dict) -> str:
    """Comparative table (display_comparative_results,
    webp_inference.py:799-858): compressed -> restored with deltas, n, and
    the paired 95% CI on the PSNR delta."""
    lines = [
        f"=== {summary['codec'].upper()} restoration (n={summary['num_images']} images) ===",
        f"{'Q':>4} | {'PSNR (dB)':>30} | {'SSIM':>22} | {'LPIPS':>22} | {'L2':>20}",
    ]
    for q, r in summary["results"].items():
        def fmt(name, digits=4, ci=False):
            c, s = r[f"compressed_{name}"], r[f"restored_{name}"]
            cell = f"{c:.{digits}f}->{s:.{digits}f} ({s - c:+.{digits}f}"
            ci_v = r.get(f"delta_{name}_ci95")
            if ci and ci_v is not None and np.isfinite(ci_v):
                cell += f"±{ci_v:.{digits}f}"
            return cell + ")"

        lines.append(f"{q:>4} | {fmt('psnr', 2, ci=True):>30} | {fmt('ssim'):>22} | "
                     f"{fmt('lpips'):>22} | {fmt('l2'):>20}")
        if "restored_fid" in r:
            lines[-1] += (f" | FID({r.get('fid_kind', '?')}) "
                          f"{r['compressed_fid']:.2f}->{r['restored_fid']:.2f}")
    return "\n".join(lines)


def plot_metric_panels(summary: Dict, path: str):
    """6-panel metric-vs-quality plots (webp_inference.py:860-952); nothing
    without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    qs = [int(q) for q in summary["results"]]
    metrics = ["psnr", "ssim", "lpips", "l2"]
    if any("restored_fid" in r for r in summary["results"].values()):
        metrics.append("fid")
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    for ax, m in zip(axes.flat, metrics):
        for tag, style in (("compressed", "o--"), ("restored", "s-")):
            vals = [summary["results"][str(q)].get(f"{tag}_{m}") for q in qs]
            if all(v is not None for v in vals):
                ax.plot(qs, vals, style, label=tag)
        ax.set_title(m.upper())
        ax.set_xlabel("quality")
        ax.grid(alpha=0.3)
        ax.legend()
    for ax in axes.flat[len(metrics):]:
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
