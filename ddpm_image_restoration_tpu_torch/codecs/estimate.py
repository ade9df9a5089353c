"""Degradation-level estimation from compressed bitstreams (a copy of
`codecs/estimate.py` in the JAX package; pure Python and numpy).

The reference treats the codec quality as ground-truth input everywhere
(test_webp_restoration takes quality_levels, webp_inference.py:604; the
samplers take `quality` directly). In production the quality of a file is
unknown — but it is (partly) recoverable from the bitstream:

  * JPEG: exact — the quantization tables encode libjpeg's quality setting
    (see `quality.estimate_jpeg_quality`).
  * WebP (lossy/VP8): approximate — the frame header carries the base
    quantizer index `y_ac_qi` (0..127). libwebp's rate control adapts qi to
    content, so a single quality maps to a small qi band; the inverse of a
    dead-leaves-calibrated median curve recovers quality to roughly +-5 on
    natural images (noise-like content skews lower).

The VP8 header walk below implements just enough of RFC 6386 (frame tag,
segmentation/filter blocks, then the quantizer block, 9.6) with the
standard boolean entropy decoder (7.3) to reach y_ac_qi.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np


class _BoolDecoder:
    """RFC 6386 7.3 boolean decoder (only prob=128 literals are needed for
    the header fields we read, but read_bool takes any prob)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 2
        self.value = (data[0] << 8) | data[1]
        self.range = 255
        self.bit_count = 0

    def read_bool(self, prob: int = 128) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            ret = 1
            self.range -= split
            self.value -= big
        else:
            ret = 0
            self.range = split
        while self.range < 128:
            self.value = (self.value << 1) & 0xFFFF
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                    self.pos += 1
        return ret

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bool()
        return v

    def flagged_signed(self, n: int) -> int:
        """flag bit -> (n-bit magnitude, sign bit); 0 when the flag is 0."""
        if not self.read_bool():
            return 0
        v = self.literal(n)
        return -v if self.read_bool() else v


def parse_webp_y_ac_qi(data: Union[bytes, str, os.PathLike]) -> Optional[int]:
    """Base quantizer index (0..127) of a lossy WebP's VP8 key frame, or
    None for non-WebP input, lossless (VP8L), or parse failure."""
    if not isinstance(data, (bytes, bytearray)):
        try:
            with open(data, "rb") as f:
                data = f.read()
        except OSError:
            return None
    b = bytes(data)
    try:
        if b[:4] != b"RIFF" or b[8:12] != b"WEBP":
            return None
        pos = 12
        payload = None
        while pos + 8 <= len(b):
            tag = b[pos : pos + 4]
            size = int.from_bytes(b[pos + 4 : pos + 8], "little")
            if tag == b"VP8 ":
                payload = b[pos + 8 : pos + 8 + size]
                break
            pos += 8 + size + (size & 1)  # chunks are 2-byte aligned
        if payload is None:
            return None
        tag0 = payload[0] | (payload[1] << 8) | (payload[2] << 16)
        if tag0 & 1:  # interframe — WebP stills are always key frames
            return None
        if payload[3:6] != b"\x9d\x01\x2a":
            return None
        d = _BoolDecoder(payload[10:])  # 3B tag + 3B start code + 4B dims
        d.read_bool()  # color_space
        d.read_bool()  # clamping_type
        if d.read_bool():  # segmentation_enabled (9.3)
            update_map = d.read_bool()
            if d.read_bool():  # update_segment_feature_data
                d.read_bool()  # segment_feature_mode
                for _ in range(4):
                    d.flagged_signed(7)  # per-segment quantizer
                for _ in range(4):
                    d.flagged_signed(6)  # per-segment loop filter
            if update_map:
                for _ in range(3):
                    if d.read_bool():
                        d.literal(8)  # segment prob
        d.read_bool()  # filter_type (9.4)
        d.literal(6)  # loop_filter_level
        d.literal(3)  # sharpness_level
        if d.read_bool():  # loop_filter_adj_enable
            if d.read_bool():  # mode_ref_lf_delta_update
                for _ in range(4):
                    d.flagged_signed(6)
                for _ in range(4):
                    d.flagged_signed(6)
        d.literal(2)  # log2(token partitions) (9.5)
        return d.literal(7)  # y_ac_qi (9.6)
    except IndexError:
        return None


# Median y_ac_qi of PIL/libwebp encodes over dead-leaves (natural-image-
# statistics) content, quality 0..100 step 5 (spread was +-4 qi; noise-like
# content can sit ~15 qi lower at low quality). Regenerate with
# scripts/calibrate_webp_qi.py.
_WEBP_CAL_QUALITY = np.arange(0, 101, 5, dtype=np.float32)
_WEBP_CAL_QI = np.array(
    [127, 101, 91, 84, 78, 72, 67, 63, 59, 55, 51,
     48, 44, 41, 38, 35, 27, 19, 12, 6, 0],
    dtype=np.float32,
)


def estimate_webp_quality(data: Union[bytes, str, os.PathLike]) -> Optional[int]:
    """Approximate encoder quality of a lossy WebP (+-5-ish on natural
    images) by inverting the calibrated quality->y_ac_qi curve."""
    qi = parse_webp_y_ac_qi(data)
    if qi is None:
        return None
    # np.interp needs increasing x: the curve is decreasing, so flip both
    q = np.interp(qi, _WEBP_CAL_QI[::-1], _WEBP_CAL_QUALITY[::-1])
    return int(np.clip(round(float(q)), 0, 100))


# ---------------------------------------------------------------------------
# AVIF (AV1) — base_q_idx from the uncompressed frame header
# ---------------------------------------------------------------------------


class _BitReader:
    """MSB-first f(n)/uvlc reader for AV1's uncompressed header bits."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.d[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        lz = 0
        while self.f(1) == 0:
            lz += 1
        return self.f(lz) + (1 << lz) - 1 if lz else 0

    def ns(self, n: int) -> int:
        """AV1 ns(n): non-symmetric uint over [0, n)."""
        if n <= 1:
            return 0
        w = (n - 1).bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)


class _Seq:
    """The sequence-header fields frame-header parsing depends on."""


def _parse_av1_sequence_header(data: bytes) -> _Seq:
    r = _BitReader(data)
    s = _Seq()
    s.seq_profile = r.f(3)
    r.f(1)  # still_picture
    s.reduced = r.f(1)
    s.decoder_model_info_present = 0
    if s.reduced:
        r.f(5)  # seq_level_idx
    else:
        if r.f(1):  # timing_info_present
            r.f(32)  # num_units_in_display_tick
            r.f(32)  # time_scale
            if r.f(1):  # equal_picture_interval
                r.uvlc()
            s.decoder_model_info_present = r.f(1)
            if s.decoder_model_info_present:
                s.buffer_delay_length = r.f(5) + 1
                r.f(32)  # num_units_in_decoding_tick
                r.f(5)  # buffer_removal_time_length_minus_1
                r.f(5)  # frame_presentation_time_length_minus_1
        initial_display_delay_present = r.f(1)
        for _ in range(r.f(5) + 1):  # operating points
            r.f(12)  # operating_point_idc
            if r.f(5) > 7:  # seq_level_idx
                r.f(1)  # seq_tier
            if s.decoder_model_info_present and r.f(1):
                r.f(s.buffer_delay_length)  # decoder_buffer_delay
                r.f(s.buffer_delay_length)  # encoder_buffer_delay
                r.f(1)  # low_delay_mode_flag
            if initial_display_delay_present and r.f(1):
                r.f(4)  # initial_display_delay_minus_1
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.max_w = r.f(s.frame_width_bits) + 1
    s.max_h = r.f(s.frame_height_bits) + 1
    s.frame_id_numbers_present = 0 if s.reduced else r.f(1)
    if s.frame_id_numbers_present:
        delta_len = r.f(4) + 2
        s.frame_id_len = r.f(3) + delta_len + 1
    s.use_128x128_superblock = r.f(1)
    r.f(1)  # enable_filter_intra
    r.f(1)  # enable_intra_edge_filter
    if s.reduced:
        s.enable_order_hint = 0
        s.force_screen_content_tools = 2  # SELECT
        s.force_integer_mv = 2
        s.order_hint_bits = 0
    else:
        r.f(4)  # enable_{interintra_compound,masked_compound,warped_motion,dual_filter}
        s.enable_order_hint = r.f(1)
        if s.enable_order_hint:
            r.f(2)  # enable_jnt_comp, enable_ref_frame_mvs
        s.force_screen_content_tools = 2 if r.f(1) else r.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = 2 if r.f(1) else r.f(1)
        else:
            s.force_integer_mv = 2
        s.order_hint_bits = (r.f(3) + 1) if s.enable_order_hint else 0
    s.enable_superres = r.f(1)
    r.f(1)  # enable_cdef
    r.f(1)  # enable_restoration
    # color_config (5.5.2)
    high_bitdepth = r.f(1)
    if s.seq_profile == 2 and high_bitdepth:
        r.f(1)  # twelve_bit
    bitdepth12 = s.seq_profile == 2 and high_bitdepth  # only need the flag shape
    mono = 0 if s.seq_profile == 1 else r.f(1)
    cp = tc = mc = 2  # unspecified
    if r.f(1):  # color_description_present
        cp, tc, mc = r.f(8), r.f(8), r.f(8)
    if mono:
        r.f(1)  # color_range
    elif cp == 1 and tc == 13 and mc == 0:  # sRGB/identity: 4:4:4, full range
        pass
    else:
        r.f(1)  # color_range
        if s.seq_profile == 0:
            sub_x = sub_y = 1
        elif s.seq_profile == 1:
            sub_x = sub_y = 0
        else:
            if bitdepth12:
                sub_x = r.f(1)
                sub_y = r.f(1) if sub_x else 0
            else:
                sub_x, sub_y = 1, 0
        if sub_x and sub_y:
            r.f(2)  # chroma_sample_position
    if not mono:
        r.f(1)  # separate_uv_delta_q
    r.f(1)  # film_grain_params_present
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _parse_av1_base_q_idx(frame_header: bytes, s: _Seq) -> Optional[int]:
    """Walk uncompressed_header (5.9.2) of a KEY frame to base_q_idx.
    Returns None for frame shapes this still-image parser doesn't cover."""
    r = _BitReader(frame_header)
    if s.decoder_model_info_present:
        return None
    if s.reduced:
        show_frame = 1
        error_resilient = 0
    else:
        if r.f(1):  # show_existing_frame
            return None
        if r.f(2) != 0:  # frame_type != KEY
            return None
        show_frame = r.f(1)
        if not show_frame:
            r.f(1)  # showable_frame
        error_resilient = 1 if show_frame else r.f(1)
    r.f(1)  # disable_cdf_update (value only matters below for non-reduced)
    disable_cdf_update = (r.d[(r.pos - 1) >> 3] >> (7 - ((r.pos - 1) & 7))) & 1
    allow_screen_content_tools = (
        r.f(1) if s.force_screen_content_tools == 2 else s.force_screen_content_tools
    )
    if allow_screen_content_tools and s.force_integer_mv == 2:
        r.f(1)  # force_integer_mv
    if s.frame_id_numbers_present:
        r.f(s.frame_id_len)  # current_frame_id
    frame_size_override = 0 if s.reduced else r.f(1)
    if s.enable_order_hint:
        r.f(s.order_hint_bits)  # order_hint
    # KEY frame: primary_ref_frame = NONE, no bits
    if not show_frame:
        r.f(8)  # refresh_frame_flags
    # frame_size()
    if frame_size_override:
        width = r.f(s.frame_width_bits) + 1
        height = r.f(s.frame_height_bits) + 1
    else:
        width, height = s.max_w, s.max_h
    # superres_params(): SuperresDenom = coded_denom + SUPERRES_DENOM_MIN (9),
    # FrameWidth = (UpscaledWidth * SUPERRES_NUM (8) + denom/2) / denom
    superres_on = bool(s.enable_superres and r.f(1))
    upscaled_eq_frame = not superres_on
    if superres_on:
        denom = r.f(3) + 9
        width = (width * 8 + denom // 2) // denom
    # render_size()
    if r.f(1):  # render_and_frame_size_different
        r.f(16)
        r.f(16)
    if allow_screen_content_tools and upscaled_eq_frame:
        r.f(1)  # allow_intrabc
    if not s.reduced and not disable_cdf_update:
        r.f(1)  # disable_frame_end_update_cdf
    # tile_info() (5.9.15)
    mi_cols = 2 * ((width + 7) >> 3)
    mi_rows = 2 * ((height + 7) >> 3)
    if s.use_128x128_superblock:
        sb_cols = (mi_cols + 31) >> 5
        sb_rows = (mi_rows + 31) >> 5
        sb_size_log2 = 7
    else:
        sb_cols = (mi_cols + 15) >> 4
        sb_rows = (mi_rows + 15) >> 4
        sb_size_log2 = 6
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(
        min_log2_tile_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols)
    )
    if r.f(1):  # uniform_tile_spacing_flag
        tile_cols_log2 = min_log2_tile_cols
        while tile_cols_log2 < max_log2_tile_cols and r.f(1):
            tile_cols_log2 += 1
        min_log2_tile_rows = max(min_log2_tiles - tile_cols_log2, 0)
        tile_rows_log2 = min_log2_tile_rows
        while tile_rows_log2 < max_log2_tile_rows and r.f(1):
            tile_rows_log2 += 1
        tile_sb = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2
        n_cols = (sb_cols + tile_sb - 1) // tile_sb
        tile_sb = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2
        n_rows = (sb_rows + tile_sb - 1) // tile_sb
    else:
        widest = 0
        start_sb = 0
        n_cols = 0
        while start_sb < sb_cols:
            w = r.ns(min(sb_cols - start_sb, max_tile_width_sb)) + 1
            widest = max(widest, w)
            start_sb += w
            n_cols += 1
        max_tile_height_sb = max(max_tile_area_sb // widest, 1)
        start_sb = 0
        n_rows = 0
        while start_sb < sb_rows:
            h = r.ns(min(sb_rows - start_sb, max_tile_height_sb)) + 1
            start_sb += h
            n_rows += 1
        tile_cols_log2 = _tile_log2(1, n_cols)
        tile_rows_log2 = _tile_log2(1, n_rows)
    if tile_cols_log2 > 0 or tile_rows_log2 > 0:
        r.f(tile_cols_log2 + tile_rows_log2)  # context_update_tile_id
        r.f(2)  # tile_size_bytes_minus_1
    return r.f(8)  # quantization_params(): base_q_idx


def parse_avif_base_q_idx(data: Union[bytes, str, os.PathLike]) -> Optional[int]:
    """base_q_idx (0..255) of an AVIF still's AV1 key frame, or None."""
    if not isinstance(data, (bytes, bytearray)):
        try:
            with open(data, "rb") as f:
                data = f.read()
        except OSError:
            return None
    b = bytes(data)
    try:
        if b[4:8] != b"ftyp":
            return None
        # find the (first) mdat box — single-image AVIFs keep the primary
        # item's OBUs there
        pos = 0
        payload = None
        while pos + 8 <= len(b):
            size = int.from_bytes(b[pos : pos + 4], "big")
            typ = b[pos + 4 : pos + 8]
            hdr = 8
            if size == 1:
                size = int.from_bytes(b[pos + 8 : pos + 16], "big")
                hdr = 16
            elif size == 0:
                size = len(b) - pos
            if typ == b"mdat":
                payload = b[pos + hdr : pos + size]
                break
            pos += size
        if payload is None:
            return None
        # walk OBUs: sequence header (type 1), then frame/frame_header (6/3)
        seq = None
        pos = 0
        while pos < len(payload):
            hdr = payload[pos]
            obu_type = (hdr >> 3) & 0xF
            pos += 1 + ((hdr >> 2) & 1)  # + extension byte
            if (hdr >> 1) & 1:  # has_size: leb128
                size = 0
                shift = 0
                while True:
                    byte = payload[pos]
                    pos += 1
                    size |= (byte & 0x7F) << shift
                    shift += 7
                    if not byte & 0x80:
                        break
            else:
                size = len(payload) - pos
            body = payload[pos : pos + size]
            pos += size
            if obu_type == 1:
                seq = _parse_av1_sequence_header(body)
            elif obu_type in (3, 6) and seq is not None:
                return _parse_av1_base_q_idx(body, seq)
        return None
    except (IndexError, ValueError):
        return None


# libavif's quality -> base_q_idx map, measured for q = 1..100 (content- and
# size-independent; several adjacent qualities share a qidx, so inversion is
# exact to the shared pair). Regenerate: encode any image at each q via PIL
# and record parse_avif_base_q_idx.
_AVIF_QIDX_BY_QUALITY = np.array(
    [249, 249, 244, 240, 240, 236, 236, 232, 228, 228, 224, 220, 220, 216,
     216, 212, 208, 208, 204, 200, 200, 196, 196, 192, 188, 188, 184, 180,
     180, 176, 172, 172, 168, 168, 164, 160, 160, 156, 152, 152, 148, 148,
     144, 140, 140, 136, 132, 132, 128, 128, 124, 120, 120, 116, 112, 112,
     108, 104, 104, 100, 100, 96, 92, 92, 88, 84, 84, 80, 80, 76, 72, 72,
     68, 64, 64, 60, 56, 56, 52, 52, 48, 44, 44, 40, 36, 36, 32, 32, 28,
     24, 24, 20, 16, 16, 12, 12, 8, 4, 4, 0],
    dtype=np.int32,
)


def estimate_avif_quality(data: Union[bytes, str, os.PathLike]) -> Optional[int]:
    """Encoder quality of an AVIF still from base_q_idx via the measured
    libavif table (nearest entry; exact up to qualities sharing a qidx —
    +-1 — for libavif encodes, nearest-quality for other AV1 encoders)."""
    qidx = parse_avif_base_q_idx(data)
    if qidx is None:
        return None
    return int(np.argmin(np.abs(_AVIF_QIDX_BY_QUALITY - qidx))) + 1


def detect_codec(data: Union[bytes, str, os.PathLike]) -> Optional[str]:
    """Identify the codec of a compressed image from its magic bytes:
    'jpeg' (SOI marker), 'webp' (RIFF/WEBP fourcc), 'avif' (ISOBMFF ftyp
    with an avif/avis brand), or None for anything else (PNG, BMP...).
    Accepts a path or the leading bytes themselves. This is what
    `--codec auto` on the restore/serve CLIs dispatches on (per file),
    pairing a unified `--model-codec all` checkpoint with the detected
    codec's sampler preset."""
    if isinstance(data, (bytes, bytearray)):
        head = bytes(data[:32])
    else:
        try:
            with open(data, "rb") as f:
                head = f.read(32)
        except OSError:
            return None
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    if head[4:8] == b"ftyp" and (b"avif" in head[8:32] or b"avis" in head[8:32]):
        return "avif"
    return None


def estimate_quality(path: Union[str, os.PathLike]) -> Optional[int]:
    """Best-effort quality estimate for a compressed image file: exact for
    JPEG (quantization tables) and AVIF (AV1 base_q_idx), approximate for
    lossy WebP (VP8 quantizer index), None otherwise (PNG, lossless
    WebP...)."""
    from ddpm_image_restoration_tpu_torch.codecs.quality import estimate_jpeg_quality

    codec = detect_codec(path)
    if codec == "jpeg":
        return estimate_jpeg_quality(path)
    if codec == "webp":
        return estimate_webp_quality(path)
    if codec == "avif":
        return estimate_avif_quality(path)
    return None
