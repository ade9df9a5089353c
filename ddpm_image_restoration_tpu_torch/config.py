"""Config presets: a copy of the JAX package's `config.py` `CodecPreset`,
the codec presets, `CODECS`, `get_preset`, `ModelConfig`, `TrainConfig` and
`EvalConfig`.

The port keeps its own copy so that it imports nothing of the JAX package;
tests/test_torch_config.py holds every field to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CodecPreset:
    """Everything that differs between the JPEG / WebP / AVIF pipelines."""

    name: str                                  # 'jpeg' | 'webp' | 'avif'

    # --- codec frontend (reference: webp_compress webp_training.py:80-102,
    #     jpeg_compress `svd imagenet.ipynb` cell 0, avif_compress avif.py:81-123)
    quality_min: int                           # WebP clamps to 0, JPEG/AVIF to 1
    quality_max: int = 100
    # JPEG/AVIF subsampling switches to 4:4:4 above this quality
    subsampling_switch_quality: int = 30

    # --- frequency module (reference: WebPFreqAwareBlock webp_training.py:206-270,
    #     JPEGFreqAwareBlock `svd imagenet.ipynb` cell 0, AVIFFreqAwareBlock avif.py:250-322)
    dct_block_size: int = 8                    # 4 for WebP (VP8), 8 for JPEG/AVIF
    low_freq_size: int = 4                     # top-left DCT coeffs kept as "low" (3 WebP, 4 JPEG)
    high_boost_clamp: Tuple[float, float] = (0.2, 2.0)   # (0.15,1.9) WebP : webp_training.py:263
    # AVIF-only knobs (avif.py:312-316)
    color_boost_clamp: Tuple[float, float] = (0.3, 1.5)
    edge_boost_clamp: Tuple[float, float] = (0.5, 1.3)
    adaptive_transform: bool = False           # AVIF learnable transform instead of fixed DCT

    # --- model (reference: {WebP,JPEG,AVIF}DiffusionModel webp_training.py:330-399, avif.py:382-451)
    attn_heads: int = 4                        # 8 for AVIF (avif.py:347)
    dct_fusion_scale: float = 0.1              # u5 + scale*dct(u5): 0.1 webp_training.py:397, 0.15 avif.py:449

    # --- loss (frequency_aware_loss webp_training.py:105-132, avif variant avif.py:126-164)
    loss_kind: str = "frequency_aware"         # or 'avif_frequency_aware'

    # --- sampler (DDRM*Sampler webp_training.py:424-473, avif.py:476-525)
    eta: float = 0.85
    eta_b: float = 1.0
    sampler_noise_scale: float = 0.2           # 0.15 for AVIF (avif.py:511)
    phase_quality_threshold: int = 20          # apply phase consistency when quality < this
    phase_period: int = 5                      # every k steps (3 for AVIF avif.py:518)
    phase_alpha: float = 0.7                   # 0.8 for AVIF (avif.py:455)

    # --- quality<->timestep maps (webp_training.py:503,561-562; avif.py:613-614)
    init_t_clamp: Tuple[int, int] = (20, 80)   # (15,75) for AVIF

    # --- training (train_model_ddrm_* webp_training.py:773-822, avif.py:794-843)
    lr: float = 2e-4                           # 1.5e-4 for AVIF (avif.py:796)
    batch_size: int = 18                       # 8 for AVIF (avif.py:75)
    val_qualities: Tuple[int, ...] = (10, 30, 50)   # (20,50,80) AVIF (avif.py:606)
    # curriculum low-quality range starts at quality_min (WebP from 0: webp_training.py:496)

    # --- evaluation (webp_inference.py:976; avif_inference.py:858; svd imagenet.ipynb)
    eval_qualities: Tuple[int, ...] = (10, 20, 30, 50)

    def clamp_quality(self, q) -> int:
        return max(self.quality_min, min(self.quality_max, int(q)))


_JPEG = CodecPreset(
    name="jpeg",
    quality_min=1,
    dct_block_size=8,
    low_freq_size=4,
    high_boost_clamp=(0.2, 2.0),
    attn_heads=4,
    dct_fusion_scale=0.1,
    loss_kind="frequency_aware",
    eta=0.85,
    sampler_noise_scale=0.2,
    phase_quality_threshold=20,
    phase_period=5,
    phase_alpha=0.7,
    init_t_clamp=(20, 80),
    lr=2e-4,
    batch_size=18,
    val_qualities=(10, 30, 50),
    eval_qualities=(10, 20, 30, 50),
)

_WEBP = CodecPreset(
    name="webp",
    quality_min=0,
    dct_block_size=4,
    low_freq_size=3,
    high_boost_clamp=(0.15, 1.9),
    attn_heads=4,
    dct_fusion_scale=0.1,
    loss_kind="frequency_aware",
    eta=0.85,
    sampler_noise_scale=0.2,
    phase_quality_threshold=15,
    phase_period=5,
    phase_alpha=0.7,
    init_t_clamp=(20, 80),
    lr=2e-4,
    batch_size=18,
    val_qualities=(10, 30, 50),
    eval_qualities=(0, 5, 10, 30, 50, 70, 90),
)

_AVIF = CodecPreset(
    name="avif",
    quality_min=1,
    subsampling_switch_quality=50,             # avif.py:104 (4:4:4 if q>50)
    dct_block_size=8,
    low_freq_size=4,
    adaptive_transform=True,
    attn_heads=8,
    dct_fusion_scale=0.15,
    loss_kind="avif_frequency_aware",
    eta=0.85,
    sampler_noise_scale=0.15,
    phase_quality_threshold=30,
    phase_period=3,
    phase_alpha=0.8,
    init_t_clamp=(15, 75),
    lr=1.5e-4,
    batch_size=8,
    val_qualities=(20, 50, 80),
    eval_qualities=(1, 10, 20, 30, 50, 70, 90),
)

# The unified multi-codec pipeline (NOT in the reference, which trains one
# model per codec): a single model trained on a per-sample mix of JPEG / WebP
# / AVIF degradations, conditioned on a learned codec embedding
# (ModelConfig.codec_conditioning). Architecture constants follow the JPEG
# preset (8x8 DCT — the common denominator; WebP's 4x4 VP8 transform and
# AVIF's learnable transform are codec-specialisations the conditioning
# replaces). Sampler constants here are only used when a caller does not
# override them with the target codec's own preset — the CLIs always do
# (restore/serve/evaluate build the sampler from the DETECTED codec's preset
# and pass codec_id to the model).
_ALL = dataclasses.replace(
    _JPEG,
    name="all",
    quality_min=1,
    val_qualities=(10, 30, 50),
    eval_qualities=(10, 20, 30, 50, 70),
)

_PRESETS = {"jpeg": _JPEG, "webp": _WEBP, "avif": _AVIF, "all": _ALL}

# Stable codec-id space for the unified model's conditioning embedding and
# the per-sample codec column in mixed training batches.
CODECS = ("jpeg", "webp", "avif")


def codec_index(name: str) -> int:
    try:
        return CODECS.index(name.lower())
    except ValueError:
        raise ValueError(f"unknown codec {name!r}; expected one of {CODECS}")


def get_preset(name: str) -> CodecPreset:
    try:
        return _PRESETS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; expected one of {sorted(_PRESETS)}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """UNet architecture knobs (reference hard-codes all of these)."""

    image_size: int = 64                       # 64x64 override of the declared 128 transform
                                               # (webp_training.py:54-58) — reproduced as default
    in_channels: int = 3
    time_dim: int = 256                        # webp_training.py:333
    # encoder widths 3->64->128->256->512->512 (webp_training.py:337-342)
    enc_widths: Tuple[int, ...] = (64, 128, 256, 512, 512)
    bottleneck_widths: Tuple[int, ...] = (1024, 1024, 512)   # webp_training.py:345-349
    dropout: float = 0.1
    # attention implementation: 'xla' (plain softmax(QK^T/sqrt(d))V in torch
    # ops, the JAX package's XLA path) or 'flash' (the sm_90a kernel at T >= 1024)
    attention_impl: str = "xla"
    # dtype policy: compute in bf16, norms/time-embedding/head/sampler stats fp32
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # apply full self-attention only at/below this spatial size (reference applies it
    # everywhere, incl. 64x64 = 4096 tokens; set to >=image_size for exact parity)
    attn_max_resolution: int = 1024
    # rematerialize each ResAttnBlock on the backward pass (training only:
    # a block runs under activation checkpointing only when grad is enabled)
    remat: bool = False
    # Unified multi-codec model (the 'all' preset): add a learned per-codec
    # embedding to the time embedding; model methods then REQUIRE a codec_id
    # ([B] int or scalar, see config.CODECS order). build_model('all', ...)
    # enables this automatically.
    codec_conditioning: bool = False

    def validate(self) -> "ModelConfig":
        """Fail fast on impossible geometry instead of an opaque shape error."""
        n_pools = len(self.enc_widths)  # one pool before each later stage + bottleneck
        min_size = 2 ** n_pools
        if self.image_size < min_size:
            raise ValueError(
                f"image_size={self.image_size} too small for {len(self.enc_widths)} "
                f"encoder stages (bottleneck would be "
                f"{self.image_size / min_size:.2f}px); need >= {min_size}, or use "
                f"fewer enc_widths"
            )
        if self.image_size % min_size:
            raise ValueError(
                f"image_size={self.image_size} must be divisible by {min_size} "
                f"({len(self.enc_widths)} pooling stages)"
            )
        return self

    def scaled(self, factor: int) -> "ModelConfig":
        """Shrink widths by `factor` (for tests / the minimum end-to-end slice)."""
        return dataclasses.replace(
            self,
            enc_widths=tuple(max(8, w // factor) for w in self.enc_widths),
            bottleneck_widths=tuple(max(8, w // factor) for w in self.bottleneck_widths),
            time_dim=max(16, self.time_dim // factor),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training knobs, field for field the JAX package's `TrainConfig`.

    The port's trainer (train/loop.py) trains over a ('data',) or a
    ('data', 'model') mesh of the process group's ranks, with `fsdp`
    optional, and refuses any other mesh."""

    codec: str = "webp"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    epochs: int = 100
    steps: int = 100                           # diffusion timesteps (webp_training.py:825)
    batch_size: int = 0                        # 0 = use the codec preset's batch size
    weight_decay: float = 1e-5                 # webp_training.py:775
    betas: Tuple[float, float] = (0.9, 0.99)
    grad_clip: float = 1.0                     # webp_training.py:523
    # EMA of params for eval/serving (0 = off = reference behaviour).
    # Validation and best-checkpoint selection use the EMA when enabled.
    ema_decay: float = 0.0
    cosine_t0: int = 100                       # CosineAnnealingWarmRestarts(T_0=100, T_mult=2)
    cosine_t_mult: int = 2
    seed: int = 0
    data_dir: str = "./ILSVRC2012_img_val"     # webp_training.py:61
    checkpoint_dir: str = "./checkpoints"
    viz_every: int = 5                         # webp_training.py:808-812
    # Minimum epochs between checkpoint saves (the last epoch always saves).
    ckpt_min_interval: int = 1
    # Dihedral-8 augmentation of the clean image before codec degradation
    # (not in the reference). Off by default.
    augment: bool = False
    # 80/10/10 split (webp_training.py:64-71); AVIF eval seeds with 42 (avif_inference.py:830)
    split_fracs: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    split_seed: int = 42
    # consistency step inside the validation sampler: 'surrogate' (the
    # on-device codec approximation), or 'callback'/'host_loop' (the exact
    # host codec each step; the same thing in the port's eager loop)
    consistency_mode: str = "surrogate"
    # parallelism: (-1,) over ('data',) = gcd(batch, world) ranks; or e.g.
    # (-1, 2) over ('data', 'model'): tensor parallelism over pairs of ranks
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = False
    # host input pipeline: batch-producer threads (the batch stream is
    # identical for any count) and the decoded-image RAM cache
    data_workers: int = 4
    cache_decoded: bool = True
    # learning-rate override: 0 = the codec preset's reference value
    lr_override: float = 0.0

    @property
    def preset(self) -> CodecPreset:
        return get_preset(self.codec)

    @property
    def effective_batch_size(self) -> int:
        return self.batch_size or self.preset.batch_size


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation knobs, field for field the JAX package's `EvalConfig`."""

    codec: str = "webp"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    steps: int = 100
    output_dir: str = "./eval_results"
    max_images: int = 0                        # 0 = all; AVIF caps at 500 (avif_inference.py:509-512)
    consistency_mode: str = "surrogate"
    compute_fid: bool = True
    qualities_override: Tuple[int, ...] = ()   # empty = preset.eval_qualities

    @property
    def preset(self) -> CodecPreset:
        return get_preset(self.codec)

    @property
    def eval_qualities(self) -> Tuple[int, ...]:
        return self.qualities_override or self.preset.eval_qualities
