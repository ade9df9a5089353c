"""The port's data path against the JAX package's: synthetic datasets of
each kind, the seeded split, the quality curriculum and two epochs of
degraded training batches must be IDENTICAL (both are numpy and the same
Pillow, so no tolerance)."""

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.codecs import quality as jquality
from ddpm_image_restoration_tpu.config import get_preset as j_get_preset
from ddpm_image_restoration_tpu.data.dataset import (
    SyntheticImageDataset as JSynthetic,
    split_indices as j_split_indices,
)
from ddpm_image_restoration_tpu.data.pipeline import DegradationLoader as JLoader
from ddpm_image_restoration_tpu_torch.codecs import quality as tquality
from ddpm_image_restoration_tpu_torch.config import get_preset
from ddpm_image_restoration_tpu_torch.data.dataset import (
    ImageFolderDataset,
    SyntheticImageDataset,
    split_indices,
)
from ddpm_image_restoration_tpu_torch.data.pipeline import DegradationLoader, prefetched_map

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", SyntheticImageDataset.KINDS)
def test_synthetic_identical(kind):
    a, b = SyntheticImageDataset(6, 32, seed=3, kind=kind), JSynthetic(6, 32, seed=3, kind=kind)
    assert len(a) == len(b) == 6
    for i in range(len(a)):
        x = a[i]
        assert x.dtype == np.float32 and x.shape == (32, 32, 3)
        np.testing.assert_array_equal(x, b[i])
    with pytest.raises(ValueError):
        SyntheticImageDataset(kind="noise")


def test_split_and_quality_maps_identical():
    for n in (1, 10, 37, 1000):
        for got, want in zip(split_indices(n), j_split_indices(n)):
            np.testing.assert_array_equal(got, want)
    t = np.arange(1, 100)
    for qr in ((0, 40), (40, 70), (70, 100)):
        np.testing.assert_array_equal(tquality.quality_for_timestep(t, 100, qr),
                                      jquality.quality_for_timestep(t, 100, qr))
    for codec in ("webp", "jpeg", "avif"):
        for epoch in (0, 50, 150):
            r1, r2 = np.random.default_rng(epoch), np.random.default_rng(epoch)
            got = [tquality.sample_quality_range(r1, epoch, get_preset(codec)) for _ in range(50)]
            want = [jquality.sample_quality_range(r2, epoch, j_get_preset(codec))
                    for _ in range(50)]
            assert got == want


@pytest.mark.parametrize("codec,workers", [("webp", 0), ("jpeg", 3)])
def test_degradation_batches_identical(codec, workers):
    """Two epochs of (x0, t, quality, xt) batches, serial and pooled."""
    ds = SyntheticImageDataset(20, 16, kind="mixed")
    idx = np.arange(20)
    a = DegradationLoader(ds, idx, get_preset(codec), 6, seed=5, num_workers=workers,
                          augment=True)
    b = JLoader(JSynthetic(20, 16, kind="mixed"), idx, j_get_preset(codec), 6, seed=5,
                augment=True)
    assert a.steps_per_epoch() == b.steps_per_epoch() == 3
    for epoch in (0, 1):
        got, want = list(a.epoch(epoch)), list(b.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"x0", "xt", "t", "quality"}
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_refuses_native_backend_and_eval_batches():
    ds = SyntheticImageDataset(5, 16)
    with pytest.raises(NotImplementedError, match="native_surrogate"):
        DegradationLoader(ds, np.arange(5), get_preset("webp"), 2,
                          degradation_backend="native_surrogate")
    with pytest.raises(ValueError):
        DegradationLoader(ds, np.arange(5), get_preset("webp"), 2, degradation_backend="x")
    loader = DegradationLoader(ds, np.arange(5), get_preset("webp"), 2)
    batches = list(loader.eval_batches())
    assert [len(b) for b in batches] == [2, 2, 1]
    np.testing.assert_array_equal(batches[2][0], ds[4])
    assert list(prefetched_map(lambda i: i * i, 5, num_workers=3)) == [0, 1, 4, 9, 16]


def test_image_folder(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    (tmp_path / "sub").mkdir()
    for i, name in enumerate(("a.png", "sub/b.jpg", "c.txt")):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
            tmp_path / name, format="PNG" if name.endswith((".png", ".txt")) else "JPEG")
    ds = ImageFolderDataset(str(tmp_path), image_size=16, cache_decoded=True)
    assert len(ds) == 2
    x = ds[1]
    assert x.shape == (16, 16, 3) and x.dtype == np.float32 and -1 <= x.min() <= x.max() <= 1
    np.testing.assert_array_equal(ds[1], x)  # from the cache
    assert len(ImageFolderDataset(str(tmp_path), 16, recursive=False)) == 1
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        ImageFolderDataset(str(tmp_path / "empty"), 16)


@pytest.mark.parametrize("dither", [False, True])
def test_forward_process_identical(dither):
    """`forward_process` of both packages on the same batch, timesteps and
    seeded dither: the same degraded batch and qualities."""
    from ddpm_image_restoration_tpu.diffusion.forward import forward_process as j_forward
    from ddpm_image_restoration_tpu_torch.diffusion.forward import forward_process

    x0 = np.stack([SyntheticImageDataset(4, 16)[i] for i in range(4)])
    t = np.array([1, 30, 64, 99])
    for codec in ("jpeg", "webp"):
        got = forward_process(x0, t, 100, codec, (10, 90), np.random.default_rng(3), dither)
        want = j_forward(x0, t, 100, codec, (10, 90), np.random.default_rng(3), dither)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.float32


def _bundled_photos():
    from ddpm_image_restoration_tpu_torch.data.real_patches import bundled_source_paths

    paths = bundled_source_paths()
    if not paths:
        pytest.skip("no bundled photographs here (matplotlib, sklearn and pygame ship them)")
    return paths


@pytest.mark.parametrize("split,augment,n", [("train", True, 0), ("eval", False, 0),
                                             ("all", False, 37)])
def test_real_patches_identical(split, augment, n):
    """`RealPatchDataset` of both packages, item by item (the same source
    list, region split, tiling, shuffle and dihedral transforms); skipped
    where no bundled photograph is installed."""
    from ddpm_image_restoration_tpu.data.real_patches import (
        RealPatchDataset as JReal,
        bundled_source_paths as j_sources,
    )
    from ddpm_image_restoration_tpu_torch.data.real_patches import RealPatchDataset

    assert _bundled_photos() == j_sources()
    got = RealPatchDataset(n, 32, split=split, augment=augment)
    want = JReal(n, 32, split=split, augment=augment)
    assert len(got) == len(want) > 0 and (n == 0 or len(got) == n)
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i], want[i])
    with pytest.raises(ValueError):
        RealPatchDataset(2, 32, split="test")


def test_concat_dataset_identical():
    """`ConcatDataset` of synthetic images and real patches in both packages:
    the same length and items (negative indices included), and the same
    refusals."""
    from ddpm_image_restoration_tpu.data.real_patches import (
        ConcatDataset as JConcat,
        RealPatchDataset as JReal,
    )
    from ddpm_image_restoration_tpu_torch.data.real_patches import (
        ConcatDataset,
        RealPatchDataset,
    )

    _bundled_photos()
    got = ConcatDataset(SyntheticImageDataset(3, 32), RealPatchDataset(4, 32, split="eval"))
    want = JConcat(JSynthetic(3, 32), JReal(4, 32, split="eval"))
    assert len(got) == len(want) == 7
    for i in [*range(7), -1, -7]:
        np.testing.assert_array_equal(got[i], want[i])
    for bad in (7, -8):
        with pytest.raises(IndexError):
            got[bad]
    with pytest.raises(ValueError, match="image sizes"):
        ConcatDataset(SyntheticImageDataset(1, 16), RealPatchDataset(1, 32))
    with pytest.raises(ValueError):
        ConcatDataset()


def test_cli_real_patches(tmp_path):
    """`--real`, which both CLIs refused before: the trainer appends real
    'train' patches to the synthetic set, the evaluator evaluates on 'eval'
    patches beside synthetic images (width/16 at 32², the CPU)."""
    from ddpm_image_restoration_tpu_torch.cli.evaluate import main as evaluate_main
    from ddpm_image_restoration_tpu_torch.cli.train import main as train_main

    _bundled_photos()
    flags = ["--device", "cpu", "--image-size", "32", "--width-scale", "16", "--attn-max-res",
             "16", "--steps", "20"]
    state, hist = train_main([*flags, "--synthetic", "2", "--real", "6", "--epochs", "1",
                              "--batch-size", "8", "--data-workers", "1",
                              "--checkpoint-dir", str(tmp_path / "ck")])
    # 2 synthetic + 6 patches x 8 dihedral variants = 50 images: 40 train, 5 steps of 8
    assert state.step == 5 and np.isfinite(hist["loss"]).all()
    summary = evaluate_main([*flags, "--random-init", "--synthetic", "1", "--real", "3",
                             "--qualities", "30", "--max-evals", "2", "--batch-size", "4",
                             "--no-fid", "--output-dir", str(tmp_path / "ev")])
    assert summary["num_images"] == 4 and summary["results"]["30"]["n"] == 4
