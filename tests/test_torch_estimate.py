"""The port's bitstream estimators (`codecs/estimate.py`, the JPEG
estimator in `codecs/quality.py`) and tiling (`utils/tiling.py`) against the
JAX package's on the same inputs: exact equality."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from ddpm_image_restoration_tpu.codecs import estimate as jest
from ddpm_image_restoration_tpu.codecs import quality as jquality
from ddpm_image_restoration_tpu.utils import tiling as jtiling
from ddpm_image_restoration_tpu_torch.codecs import estimate, quality
from ddpm_image_restoration_tpu_torch.codecs.pil_codecs import avif_available
from ddpm_image_restoration_tpu_torch.utils import tiling

torch.set_num_threads(1)


def _images():
    """A noise image and a smooth one, the second 77x123 (no block multiple)."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:77, 0:123].astype(np.float32)
    smooth = 127 + 100 * np.sin(xx / 9.0)[..., None] * np.cos(yy[..., None] / 7.0 + np.arange(3))
    return [Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)),
            Image.fromarray(smooth.astype(np.uint8))]


CASES = [("JPEG", q) for q in (5, 30, 75, 95)] + [("WEBP", q) for q in (10, 30, 50, 70, 90)] \
    + [("AVIF", q) for q in (30, 70)]


@pytest.mark.parametrize("fmt,q", CASES)
def test_detect_and_estimate_match_jax(tmp_path, fmt, q):
    """Files written by Pillow: the same codec and quality from both
    packages, from the path and from the bytes; JPEG is also exact."""
    if fmt == "AVIF" and not avif_available():
        pytest.skip("this Pillow has no AVIF encoder")
    for i, im in enumerate(_images()):
        path = tmp_path / f"im{i}.{fmt.lower()}"
        im.save(path, fmt, quality=q)
        data = path.read_bytes()
        assert estimate.detect_codec(str(path)) == jest.detect_codec(str(path)) \
            == {"JPEG": "jpeg", "WEBP": "webp", "AVIF": "avif"}[fmt]
        assert estimate.detect_codec(data) == jest.detect_codec(data)
        got = estimate.estimate_quality(str(path))
        assert got is not None and got == jest.estimate_quality(str(path))
        if fmt == "JPEG":
            assert got == q == quality.estimate_jpeg_quality(Image.open(path))
        if fmt == "WEBP":
            assert estimate.parse_webp_y_ac_qi(data) == jest.parse_webp_y_ac_qi(data)
        if fmt == "AVIF":
            assert estimate.parse_avif_base_q_idx(data) == jest.parse_avif_base_q_idx(data)


def test_non_lossy_inputs_give_none(tmp_path):
    png = tmp_path / "a.png"
    _images()[0].save(png, "PNG")
    buf = io.BytesIO()
    _images()[0].save(buf, "PNG")
    for mod in (estimate, jest):
        assert mod.detect_codec(str(png)) is None
        assert mod.detect_codec(buf.getvalue()) is None
        assert mod.estimate_quality(str(png)) is None
        assert mod.estimate_quality(str(tmp_path / "missing.webp")) is None
    assert quality.estimate_jpeg_quality(str(png)) is None


def test_expected_jpeg_tables_match_jax():
    for q in range(1, 101):
        for got, want in zip(quality._expected_jpeg_tables(q), jquality._expected_jpeg_tables(q)):
            np.testing.assert_array_equal(got, want)


# (h, w, overlap): square, non-multiple-of-16 sides, wider than tall, an
# image smaller than one tile, no overlap
TILE_CASES = [(64, 64, 24), (70, 45, 16), (40, 100, 8), (20, 12, 4), (96, 80, 0)]


@pytest.mark.parametrize("h,w,overlap", TILE_CASES)
def test_tiling_matches_jax(h, w, overlap):
    """plan_tiles and restore_tiled bit for bit, with one numpy restore_fn
    (a per-tile affine map, so the blend weights decide the output)."""
    tile = 32
    assert tiling.plan_tiles(h, w, tile, overlap) == jtiling.plan_tiles(h, w, tile, overlap)
    img = np.random.default_rng(h * w).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    calls = []

    def restore_fn(batch):
        calls.append(batch.shape)
        return 0.9 * batch + 0.05 * np.arange(len(batch), dtype=np.float32)[:, None, None, None]

    got = tiling.restore_tiled(restore_fn, img, tile, overlap=overlap, batch_size=3)
    want = jtiling.restore_tiled(restore_fn, img, tile, overlap=overlap, batch_size=3)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    assert all(s == (3, tile, tile, 3) for s in calls)
    np.testing.assert_array_equal(tiling.blend_window(tile, overlap),
                                  jtiling.blend_window(tile, overlap))
    for mod in (tiling, jtiling):  # an overlap of a whole tile is refused
        with pytest.raises(ValueError):
            mod.plan_tiles(h, w, tile, tile)
