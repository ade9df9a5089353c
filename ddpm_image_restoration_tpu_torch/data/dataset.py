"""Host-side image datasets (port of data/dataset.py; numpy, with scipy
for the `natural` kind and Pillow for image files, both imported at use).

`ImageFolderDataset` reads a directory of png/jpg/jpeg/bmp/webp files,
resized to the model's size and normalized to [-1,1]
(webp_training.py:32-51); `SyntheticImageDataset` makes seeded procedural
images for tests, benchmarks and `--synthetic` runs; `split_indices` is the
seeded 80/10/10 split. Samples are numpy NHWC float32, index for index the
JAX package's.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class ImageFolderDataset:
    """Directory image dataset -> [-1,1] float32 NHWC samples.

    Scans recursively (sorted by full path, deterministic), so both the
    reference's flat ImageNet-val layout (webp_training.py:32-51) and the
    class-subdirectory ImageNet-train layout work unchanged.

    ``cache_decoded=True`` keeps the decoded+resized images in host RAM as
    uint8 (s*s*3 bytes per image: 64^2 over ImageNet-val's 50k images is
    ~0.6 GB) so epochs after the first pay zero decode cost — at 64^2 the
    decode of a full-resolution source JPEG dominates the whole input
    pipeline. The uint8->float conversion is exactly the uncached math.
    """

    def __init__(self, root: str, image_size: int = 64,
                 cache_decoded: bool = False, recursive: bool = True):
        """recursive=False restricts to the top level (the reference's exact
        os.listdir behaviour) — set it if the directory contains nested
        non-dataset images (e.g. previous run outputs) that the recursive
        scan would otherwise ingest, changing the seeded split membership."""
        self.root = root
        self.image_size = image_size
        if recursive:
            self.files = sorted(
                os.path.join(dirpath, f)
                for dirpath, _, filenames in os.walk(root)
                for f in filenames
                if f.lower().endswith(_EXTENSIONS)
            )
        else:
            self.files = sorted(
                os.path.join(root, f)
                for f in os.listdir(root)
                if f.lower().endswith(_EXTENSIONS)
            )
        if not self.files:
            raise ValueError(f"no images found under {root!r}")
        self._cache: list = [None] * len(self.files) if cache_decoded else None
        est_gb = len(self.files) * image_size * image_size * 3 / 1e9
        if cache_decoded and est_gb > 4.0:
            print(f"ImageFolderDataset: decoded-image cache will grow to "
                  f"~{est_gb:.1f} GB host RAM ({len(self.files)} images at "
                  f"{image_size}^2); disable with cache_decoded=False / "
                  f"--no-cache-decoded if that is too much")

    def __len__(self) -> int:
        return len(self.files)

    def _decode(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.files[idx]).convert("RGB")
        s = self.image_size
        img = img.resize((s, s), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None:
            arr = self._cache[idx]
            if arr is None:
                arr = self._decode(idx)
                self._cache[idx] = arr  # GIL-atomic list store: thread-safe
        else:
            arr = self._decode(idx)
        return np.asarray(arr, dtype=np.float32) / 255.0 * 2.0 - 1.0


class SyntheticImageDataset:
    """Deterministic procedural images, index-seeded — compressible structure
    without any files on disk. Three generators:

      * ``waves`` — sums of oriented sinusoids + a soft disk (smooth,
        band-limited; the original smoke-test distribution).
      * ``dead_leaves`` — occluding disks with a power-law radius
        distribution p(r) ∝ r^-3 plus per-leaf shading: the classical
        natural-image-statistics model (scale-invariant power spectrum,
        sharp occlusion edges) — much closer to photographs than sinusoids
        for training codec-artifact restoration without a dataset on disk.
      * ``natural`` — dead-leaves occlusion structure passed through a
        camera model: per-leaf 1/f fractal texture, correlated (low-
        saturation) color palette, optical Gaussian blur, and Poisson-
        Gaussian sensor noise. Parameters are tuned so the WebP
        rate-distortion curve of the corpus matches the bundled REAL
        photographic patches (the JAX package's data/real_patches.py) within ~1 dB at every
        quality — the closest photographic-statistics stand-in this
        environment can produce (round-5; the plain ``dead_leaves`` kind
        is ~7 dB harder than photographs and ``waves`` ~8 dB easier).
      * ``mixed`` — alternates waves and dead_leaves per index.
    """

    KINDS = ("waves", "dead_leaves", "natural", "mixed")

    def __init__(self, n: int = 256, image_size: int = 64, seed: int = 0,
                 kind: str = "waves"):
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}, got {kind!r}")
        self.n = n
        self.image_size = image_size
        self.seed = seed
        self.kind = kind

    def __len__(self) -> int:
        return self.n

    def _waves(self, rng: np.random.Generator) -> np.ndarray:
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.zeros((s, s, 3), np.float32)
        for _ in range(3):
            fx, fy = rng.uniform(1, 8, 2)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.2, 0.5, 3)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
            img += wave[..., None] * amp[None, None, :]
        cx, cy, r = rng.uniform(0.2, 0.8, 3)
        disk = np.clip(1.0 - ((xx - cx) ** 2 + (yy - cy) ** 2) / (0.1 * r + 1e-3), 0, 1)
        img += disk[..., None] * rng.uniform(-0.5, 0.5, 3)[None, None, :]
        return img

    def _dead_leaves(self, rng: np.random.Generator) -> np.ndarray:
        # Rendered at 4x and box-downsampled (the standard dead-leaves
        # recipe): drawing disks directly on the pixel grid leaves aliased
        # single-pixel edges everywhere — content so far outside natural
        # image statistics that WebP q90 only reached ~23 dB on it, leaving
        # no quality gradient for restoration training to exploit
        # (results/onchip_queue_0818c/teacher_eval_*.log).
        ss = 4
        s = self.image_size * ss
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        img = np.empty((s, s, 3), np.float32)
        # background leaf (fills whatever stays uncovered)
        img[...] = rng.uniform(-0.8, 0.8, 3)[None, None, :]
        covered = np.zeros((s, s), bool)
        # r_min 0.12: at 0.04 the r^-3 law fills the frame with ~3px disks —
        # colored noise the codecs cannot represent at ANY quality (WebP
        # q0->q90 spread of only 7 dB), leaving no restoration signal.
        # Measured spreads at 64^2: rmin 0.04: 11.5->18.5 dB; 0.12:
        # 14.9->22.2 dB (still ~7 dB harder than ImageNet-val — dead leaves
        # is an edge-density stress kind, not a quality-parity proxy; use
        # kind='waves' for restoration-gain validation runs).
        r_min, r_max = 0.12 * s, 0.7 * s
        # inverse-CDF sampling of p(r) ∝ r^-3 on [r_min, r_max]
        inv2 = lambda u: 1.0 / np.sqrt(
            (1 - u) / r_min**2 + u / r_max**2
        )
        for _ in range(300):
            r = inv2(rng.uniform())
            cx, cy = rng.uniform(-0.1 * s, 1.1 * s, 2)
            leaf = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            fresh = leaf & ~covered
            if not fresh.any():
                continue
            base = rng.uniform(-0.9, 0.9, 3).astype(np.float32)
            # per-leaf linear shading — gives gradients inside flat regions
            gx, gy = rng.uniform(-0.3, 0.3, 2) / max(r, 1.0)
            shade = (gx * (xx - cx) + gy * (yy - cy)).astype(np.float32)
            img[fresh] = np.clip(base[None, :] + shade[fresh, None], -1, 1)
            covered |= leaf
            if covered.mean() > 0.995:
                break
        t = self.image_size
        return img.reshape(t, ss, t, ss, 3).mean(axis=(1, 3))

    def _natural(self, rng: np.random.Generator) -> np.ndarray:
        """Dead-leaves structure through a camera model (see class docstring).

        Four stages, each carrying one statistic of photographs the plain
        generators miss:
          1. occlusion skeleton with a CORRELATED palette — leaf colors are
             a shared low-saturation chroma axis plus a wide luma spread
             (photographic RGB channels correlate ~0.9; independent uniform
             leaf colors give chroma energy no codec budget expects);
          2. per-leaf 1/f fractal micro-texture (foliage/fabric/skin detail
             — the scale-invariant spectrum measured in natural images);
          3. optical blur: Gaussian PSF, sigma varied per image (lens +
             anti-alias filter; also what keeps occlusion edges at
             photographic sharpness instead of single-pixel steps);
          4. Poisson-Gaussian sensor noise (signal-dependent shot noise +
             read noise) — the grain a restoration model must learn to
             PRESERVE: with noise in the clean target x0, smoothing it
             away is penalized by the loss, which is exactly the failure
             mode of the waves-trained teachers on real photos
             (results/r3/webp_real_auto, results/r4/webp_real_auto_r4).
        """
        ss = 2  # supersampling: blur provides the antialiasing, 2x suffices
        s = self.image_size * ss
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        # 1/f fractal field, one per image, unit std (FFT synthesis)
        f = np.fft.rfftfreq(s)[None, :] ** 2 + np.fft.fftfreq(s)[:, None] ** 2
        amp = np.where(f > 0, 1.0 / np.sqrt(f + 1e-12) ** 1.2, 0.0)
        spec = amp * (rng.standard_normal(amp.shape)
                      + 1j * rng.standard_normal(amp.shape))
        tex = np.fft.irfft2(spec, s=(s, s)).astype(np.float32)
        tex /= tex.std() + 1e-8
        # correlated palette: shared chroma axis, low saturation
        chroma_axis = rng.standard_normal(3).astype(np.float32)
        chroma_axis /= np.linalg.norm(chroma_axis) + 1e-8
        base_luma = rng.uniform(-0.35, 0.35)
        img = np.empty((s, s, 3), np.float32)
        luma0 = base_luma + rng.uniform(-0.5, 0.5)
        img[...] = luma0 + chroma_axis[None, None, :] * rng.uniform(-0.25, 0.25)
        covered = np.zeros((s, s), bool)
        # Parameters below (r_min, blur, texture amplitude, noise sigmas)
        # are the round-5 sweep winners: mean |PSNR gap| to the real-patch
        # WebP RD curve = 0.47 dB over q in {0,10,30,50,70,90} (sweep in
        # results/r5/natural_corpus_calibration.md).
        r_min, r_max = 0.10 * s, 0.7 * s
        inv2 = lambda u: 1.0 / np.sqrt((1 - u) / r_min**2 + u / r_max**2)
        for _ in range(220):
            r = inv2(rng.uniform())
            cx, cy = rng.uniform(-0.1 * s, 1.1 * s, 2)
            leaf = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            fresh = leaf & ~covered
            if not fresh.any():
                continue
            luma = base_luma + rng.uniform(-0.5, 0.5)
            col = (luma + chroma_axis * rng.uniform(-0.3, 0.3)
                   + rng.uniform(-0.06, 0.06, 3)).astype(np.float32)
            gx, gy = rng.uniform(-0.25, 0.25, 2) / max(r, 1.0)
            shade = (gx * (xx - cx) + gy * (yy - cy)).astype(np.float32)
            t_amp = rng.uniform(0.0, 0.10)
            img[fresh] = (col[None, :]
                          + (shade + t_amp * tex)[fresh, None])
            covered |= leaf
            if covered.mean() > 0.995:
                break
        # optical blur at capture resolution, then box-downsample
        from scipy.ndimage import gaussian_filter

        sigma = rng.uniform(1.2, 2.6) * ss / 2.0
        img = gaussian_filter(img, sigma=(sigma, sigma, 0))
        t = self.image_size
        img = img.reshape(t, ss, t, ss, 3).mean(axis=(1, 3))
        img = np.clip(img, -1, 1)
        # Poisson-Gaussian sensor noise in [0,1] luminance units
        lum01 = (img + 1.0) * 0.5
        sigma_read = rng.uniform(0.002, 0.006)
        sigma_shot = rng.uniform(0.003, 0.010)
        noise_std = sigma_read + sigma_shot * np.sqrt(np.clip(lum01, 0.0, 1.0))
        img = img + 2.0 * noise_std * rng.standard_normal(img.shape).astype(
            np.float32
        )
        return img.astype(np.float32)

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        kind = self.kind
        if kind == "mixed":
            kind = "dead_leaves" if idx % 2 else "waves"
        gen = {"waves": self._waves, "dead_leaves": self._dead_leaves,
               "natural": self._natural}[kind]
        return np.clip(gen(rng), -1, 1).astype(np.float32)


def split_indices(
    n: int, fracs: Sequence[float] = (0.8, 0.1, 0.1), seed: int = 42
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic train/val/test index split (reference: random_split with
    torch.manual_seed(42), avif_inference.py:830)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(n * fracs[0])
    n_val = int(n * fracs[1])
    return perm[:n_train], perm[n_train : n_train + n_val], perm[n_train + n_val :]
