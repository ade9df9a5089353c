"""The codec-conditioned residual-attention UNet (port of models/unet.py).

Same skeleton and parameter names as the Flax model, so the release npz maps
onto it key for key (train/checkpoint.py):

  encoder    3 -> w1 -> ... -> w5, 2x2 max-pool between stages
  bottleneck w5 -> b1 -> b2 -> b3 at image_size/32
  decoder    5 stages of concat([bilinear-up 2x, skip]) -> ResAttnBlock
  fusion     u5 + fusion_scale * DCT(u5)
  head       GroupNorm -> SiLU -> conv3x3 -> tanh

Layout: the public methods take and return NHWC images like the JAX package;
inside, feature maps (and the `encode` features) are NCHW. Dtype policy as in
the JAX package (unet.py:43-48,180-183): the block bodies (convs, dense
layers, attention, frequency module) hold their weights and compute in
`cfg.compute_dtype`, while GroupNorm, the time embedding, the codec
embedding and the output head stay f32. Flax's GroupNorm uses eps 1e-6 and
`nn.gelu` is the tanh form; both are kept.

With `spatial_mesh` set (parallel/mesh.py `shard_inference_spatial`) the
public methods still take and return whole images, but inside each rank
computes only its rows of the levels that `parallel/spatial.py split_plan`
splits (that module says how each op crosses the shard edges).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ddpm_image_restoration_tpu_torch.config import CODECS, CodecPreset, ModelConfig, get_preset
from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.models.freq_blocks import (
    AVIFFreqAwareBlock,
    DCTFreqAwareBlock,
)
from ddpm_image_restoration_tpu_torch.models.time_embedding import TimeEmbedding
from ddpm_image_restoration_tpu_torch.ops.attention import spatial_attention
from ddpm_image_restoration_tpu_torch.ops.dct import adjusted_group_count, spatial_block_dct
from ddpm_image_restoration_tpu_torch.ops.resize import max_pool_2x
from ddpm_image_restoration_tpu_torch.parallel import spatial
from ddpm_image_restoration_tpu_torch.parallel.mesh import SPATIAL, axis_rank, axis_size
from ddpm_image_restoration_tpu_torch.utils.remat import checkpoint

_GN_EPS = 1e-6  # Flax GroupNorm's epsilon


def _group_norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(adjusted_group_count(c), c, eps=_GN_EPS)


class Dropout(nn.Module):
    """Flax's `nn.Dropout`: in training mode keep each element with
    probability 1 − rate and scale it by 1/(1 − rate); in eval mode (and at
    rate 0) the identity. The mask is drawn from `self.generator`, a
    `torch.Generator` on the input's device that the trainer owns and sets
    with `set_dropout_generator`, never from the global RNG.

    Under data parallelism (`self.shard` = (r, n), this rank's input being
    the r-th of n equal blocks of the batch) it draws the mask of the whole
    batch and keeps its block, so the masks are those of one process on the
    whole batch (as JAX's partitionable threefry gives the sharded mask);
    each rank pays n times the RNG work of its own rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Tuple[int, int] = (0, 1)

    @property
    def active(self) -> bool:
        return self.training and self.rate != 0.0

    def keep_mask(self, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
        """The boolean mask of kept elements for an input of `shape`, drawn
        from `self.generator` (the draw `forward` makes without one)."""
        if self.generator is None:
            raise RuntimeError("training dropout needs a torch.Generator: "
                               "call set_dropout_generator(model, generator)")
        r, n = self.shard
        b = shape[0]
        u = torch.rand((n * b, *shape[1:]), generator=self.generator, device=device)
        return u[r * b:(r + 1) * b] < 1.0 - self.rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`keep`: the mask drawn beforehand by `keep_mask` (a
        rematerialised block draws it outside its checkpoint), else drawn
        here."""
        if not self.active:
            return x
        if keep is None:
            keep = self.keep_mask(x.shape, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator],
                          shard: Tuple[int, int] = (0, 1)) -> None:
    """Let every `Dropout` of `model` draw its training masks from
    `generator`, as block `shard` = (r, n) of the whole batch's masks."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.shard = shard


class SpatialSelfAttention(nn.Module):
    """Multi-head self-attention over all H*W tokens: fused `qkv` projection
    split into q/k/v, then into heads; `out` projection; both with bias.
    Given a `SpatialLevel`, `x` is this rank's rows: q, k and v of every
    rank's tokens are gathered, and the output keeps this rank's."""

    def __init__(self, channels: int, num_heads: int, impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.impl = impl
        self.qkv = nn.Linear(channels, 3 * channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        b, c, h, w = x.shape
        heads = self.num_heads
        tokens = x.flatten(2).transpose(1, 2)                # [B,T,C]
        qkv = spatial.gather_tokens(self.qkv(tokens), sp)
        t = qkv.shape[1]
        q, k, v = (z.reshape(b, t, heads, c // heads) for z in qkv.chunk(3, dim=-1))
        out = spatial.own_tokens(spatial_attention(q, k, v, impl=self.impl), sp)
        return self.out(out.reshape(b, h * w, c)).transpose(1, 2).reshape(b, c, h, w)


class ResAttnBlock(nn.Module):
    """GN -> conv3x3 -> +time -> GN -> GELU -> dropout -> conv3x3 ->
    self-attention (residual, only at resolution <= cfg.attn_max_resolution)
    -> frequency module (the AVIF block when the preset has the adaptive
    transform, else the DCT block) -> shortcut(x) + h
    (webp_training.py:273-327).

    With `cfg.remat` (the JAX package's `nn.remat(ResAttnBlock)`) a call
    made with grad enabled keeps only the block's inputs and recomputes its
    body in the backward. In training its dropout mask is drawn before the
    checkpointed region, as the plain block would draw it, and passed in,
    so the recompute reads the forward's mask and the region draws nothing
    (utils/remat.py): a CUDA graph captures it like the plain block.

    `sp` is the block's `parallel.spatial.SpatialLevel` when its level runs
    split over a spatial mesh (set by the model), else None."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 preset: CodecPreset, cfg: ModelConfig):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.remat = cfg.remat
        self.sp = None
        self.norm1 = _group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_proj = nn.Linear(cfg.time_dim, out_channels)
        self.norm2 = _group_norm(out_channels)
        self.dropout = Dropout(cfg.dropout)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.attn = (
            SpatialSelfAttention(out_channels, preset.attn_heads, cfg.attention_impl)
            if resolution <= cfg.attn_max_resolution else None
        )
        if preset.adaptive_transform:
            self.freq_guide = AVIFFreqAwareBlock(
                out_channels, preset.dct_block_size, preset.color_boost_clamp,
                preset.edge_boost_clamp)
        else:
            self.freq_guide = DCTFreqAwareBlock(
                out_channels, preset.dct_block_size, preset.low_freq_size,
                preset.high_boost_clamp)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)
        for m in (self.conv1, self.time_proj, self.conv2, self.attn,
                  self.freq_guide, self.shortcut):
            if m is not None:
                m.to(self.dtype)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                compression_level: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            keep = None
            if self.dropout.active:  # the mask of conv1's output, which keeps x's rows
                keep = self.dropout.keep_mask(
                    (x.shape[0], self.conv1.out_channels, *x.shape[2:]), x.device)
            return checkpoint(self._body, x, t_emb, compression_level, keep)
        return self._body(x, t_emb, compression_level)

    def _body(self, x: torch.Tensor, t_emb: torch.Tensor, compression_level: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt, sp = self.dtype, self.sp
        h = spatial.conv3x3(self.conv1, spatial.group_norm(self.norm1, x.float(), sp).to(dt), sp)
        h = h + self.time_proj(t_emb.to(dt))[:, :, None, None]
        h = F.gelu(spatial.group_norm(self.norm2, h.float(), sp).to(dt), approximate="tanh")
        h = spatial.conv3x3(self.conv2, self.dropout(h, keep), sp)
        if self.attn is not None:
            h = h + self.attn(h, sp)
        h = self.freq_guide(h, compression_level, sp)
        x = x.to(dt)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class CodecDiffusionModel(nn.Module):
    """UNet predicting the restoration in [-1,1], split into `encode`
    (encoder + bottleneck) and `decode` (decoder + DCT fusion + head) so the
    solver can reuse encoder features across steps; `forward` is exactly
    `decode(encode(x))`.

    `spatial_mesh` (None, or a ('spatial',) mesh set by
    `parallel.mesh.shard_inference_spatial`) splits the image height inside
    these methods (module docstring)."""

    def __init__(self, preset: CodecPreset, cfg: ModelConfig):
        super().__init__()
        cfg.validate()
        self.preset, self.cfg = preset, cfg
        self.time_embed = TimeEmbedding(cfg.time_dim)
        if cfg.codec_conditioning:
            self.codec_embed = nn.Embedding(len(CODECS), cfg.time_dim)
        size = cfg.image_size
        in_c = cfg.in_channels
        for i, w in enumerate(cfg.enc_widths):
            res = size >> i
            setattr(self, f"down{i + 1}", ResAttnBlock(in_c, w, res, preset, cfg))
            in_c = w
        bott_res = size >> len(cfg.enc_widths)
        for i, w in enumerate(cfg.bottleneck_widths):
            setattr(self, f"bottleneck{i + 1}", ResAttnBlock(in_c, w, bott_res, preset, cfg))
            in_c = w
        # decoder widths mirror the encoder (up1..up5 -> 512,256,128,64,64)
        self._dec_widths = list(cfg.enc_widths[-2::-1]) + [cfg.enc_widths[0]]
        n = len(self._dec_widths)
        for i, w in enumerate(self._dec_widths):
            skip_c = cfg.enc_widths[n - 1 - i]
            res = size >> (n - 1 - i)
            setattr(self, f"up{i + 1}", ResAttnBlock(in_c + skip_c, w, res, preset, cfg))
            in_c = w
        self.out_norm = _group_norm(cfg.enc_widths[0])
        self.out_conv = nn.Conv2d(cfg.enc_widths[0], cfg.in_channels, 3, padding=1)
        self.spatial_mesh = None
        self._levels = (None, (None,) * (len(cfg.enc_widths) + 1))  # (key, per level)

    def _blocks(self):
        """(level, block) for every ResAttnBlock: down{i+1} at level i, the
        bottleneck at level n, up{i+1} at level n-1-i."""
        n = len(self.cfg.enc_widths)
        for i in range(n):
            yield i, getattr(self, f"down{i + 1}")
        for i in range(len(self.cfg.bottleneck_widths)):
            yield n, getattr(self, f"bottleneck{i + 1}")
        for i in range(n):
            yield n - 1 - i, getattr(self, f"up{i + 1}")

    def spatial_levels(self, height: int) -> tuple:
        """Per level, its `SpatialLevel` when it runs split over
        `spatial_mesh` for images `height` rows high, else None (all None
        without a mesh); sets each block's `sp`, and logs the plan (spatial
        rank 0) the first time a height is seen."""
        key = (height, id(self.spatial_mesh))
        if self._levels[0] == key:
            return self._levels[1]
        n = len(self.cfg.enc_widths)
        m = axis_size(self.spatial_mesh, SPATIAL)
        plan = spatial.split_plan(height, n, self.preset.dct_block_size, m)
        levels = tuple(spatial.SpatialLevel(self.spatial_mesh, height >> i) if split else None
                       for i, split in enumerate(plan))
        for lvl, block in self._blocks():
            block.sp = levels[lvl]
        if m > 1 and axis_rank(self.spatial_mesh, SPATIAL) == 0:
            print(f"spatial plan over {m} ranks at height {height}: " + ", ".join(
                f"{height >> i}: {'split' if s else 'replicated'}" for i, s in enumerate(plan)),
                flush=True)
        self._levels = (key, levels)
        return levels

    def _prep(self, t, compression_level, codec_id=None):
        dev = self.out_conv.weight.device
        if not (torch.is_tensor(t) and t.device == dev and t.dtype == torch.float32):
            t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if t.dim() == 0:
            t = t[None]
        t_emb = self.time_embed(t)
        if self.cfg.codec_conditioning:
            if codec_id is None:
                raise ValueError("codec_conditioning=True: pass codec_id "
                                 "(config.codec_index of the degradation codec)")
            if isinstance(codec_id, numbers.Integral):  # a fill on the device, no host copy
                cid = torch.full(t.shape, int(codec_id), dtype=torch.long, device=dev)
            elif torch.is_tensor(codec_id) and codec_id.device == dev:  # a batch's ids
                cid = codec_id.long().expand(t.shape)
            else:
                cid = torch.as_tensor(codec_id, dtype=torch.long, device=dev).expand(t.shape)
            t_emb = t_emb + self.codec_embed(cid)
        if compression_level is None:
            compression_level = t  # webp_training.py:373-374
        return t_emb, compression_level

    def encode(self, x: torch.Tensor, t, compression_level=None, codec_id=None):
        """NHWC image -> (skips tuple, bottleneck features), both NCHW."""
        t_emb, level = self._prep(t, compression_level, codec_id)
        # NCHW in the contiguous layout: a permuted NHWC tensor would carry
        # channels-last strides through every conv, and GroupNorm's CPU
        # backward crashes on those
        h = x.permute(0, 3, 1, 2).to(getattr(torch, self.cfg.compute_dtype),
                                     memory_format=torch.contiguous_format)
        sp = self.spatial_levels(h.shape[2])
        h = spatial.take_rows(h, sp[0])
        skips = []
        for i in range(len(self.cfg.enc_widths)):
            h = getattr(self, f"down{i + 1}")(h if i == 0 else self._pool(h, i), t_emb, level)
            skips.append(h)
        h = self._pool(h, len(self.cfg.enc_widths))
        for i in range(len(self.cfg.bottleneck_widths)):
            h = getattr(self, f"bottleneck{i + 1}")(h, t_emb, level)
        return tuple(skips), h

    def decode_deep(self, features, t, compression_level=None, depth: int = 1,
                    codec_id=None) -> torch.Tensor:
        """Decoder stages up1..up{n-depth} over `encode` output (NCHW)."""
        t_emb, level = self._prep(t, compression_level, codec_id)
        skips, h = features
        for i in range(len(self._dec_widths) - depth):
            h = torch.cat([self._up(h, i), skips[-(i + 1)]], dim=1)
            h = getattr(self, f"up{i + 1}")(h, t_emb, level)
        return h

    def _pool(self, h: torch.Tensor, lvl: int) -> torch.Tensor:
        """The 2x2 max pool into level `lvl`, gathered where that level runs
        whole and the one above it split."""
        sp = self._levels[1]
        h = max_pool_2x(h)
        return spatial.gather_rows(h, sp[lvl - 1]) if sp[lvl] is None else h

    def _up(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """The 2x upsample into decoder stage i (level n-1-i), in the
        layouts of the two levels."""
        sp, lvl = self._levels[1], len(self._dec_widths) - 1 - i
        return spatial.upsample_2x(h, sp[lvl + 1], sp[lvl])

    def decode_shallow(self, h: torch.Tensor, skips, t, compression_level=None,
                       depth: int = 1, codec_id=None) -> torch.Tensor:
        """The last `depth` decoder stages + DCT fusion + head, from a
        `decode_deep` output; returns the NHWC f32 image."""
        t_emb, level = self._prep(t, compression_level, codec_id)
        n = len(self._dec_widths)
        for i in range(n - depth, n):
            h = torch.cat([self._up(h, i), skips[-(i + 1)]], dim=1)
            h = getattr(self, f"up{i + 1}")(h, t_emb, level)
        sp = self._levels[1][0]
        h = h + self.preset.dct_fusion_scale * spatial_block_dct(h, self.preset.dct_block_size)
        h = F.silu(spatial.group_norm(self.out_norm, h.float(), sp))
        h = spatial.conv3x3(self.out_conv, h, sp)
        return spatial.gather_rows(torch.tanh(h), sp).permute(0, 2, 3, 1)

    def decode(self, features, t, compression_level=None, codec_id=None) -> torch.Tensor:
        """Decoder + fusion + head over `encode` output: exactly
        `decode_shallow(decode_deep(...))` split at depth 0."""
        h = self.decode_deep(features, t, compression_level, depth=0, codec_id=codec_id)
        return self.decode_shallow(h, features[0], t, compression_level, depth=0,
                                   codec_id=codec_id)

    def forward(self, x: torch.Tensor, t, compression_level=None,
                codec_id=None) -> torch.Tensor:
        dev = self.out_conv.weight.device
        if torch.is_tensor(t) and t.device == dev:  # already on the device: no host copy
            t = t.float()
        else:
            t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        features = self.encode(x, t, compression_level, codec_id)
        return self.decode(features, t, compression_level, codec_id)


def build_model(codec: str, cfg: Optional[ModelConfig] = None,
                device: str | torch.device = "cuda") -> CodecDiffusionModel:
    """The model for `codec` on `device`, in eval mode. Weights are PyTorch's
    default init under the current torch seed; load release weights with
    `model.load_state_dict(load_release_params(path))`."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig()
    if codec.lower() == "all" and not cfg.codec_conditioning:
        cfg = dataclasses.replace(cfg, codec_conditioning=True)
    with dev:
        model = CodecDiffusionModel(get_preset(codec), cfg)
    return model.eval().requires_grad_(False)
