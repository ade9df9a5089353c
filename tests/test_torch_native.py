"""The port's native codec engine (codecs/native.py) against the JAX
package's wrapper and against the port's own surrogate (CPU): built from
`native/codec_engine.cpp` into build/, never touching `native/`; thread-
count determinism, the bad-shape error, the fallback where no compiler
works, and a `native_surrogate` DegradationLoader batch equal to JAX's."""

import hashlib
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.codecs import native as jnative
from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate as jax_surrogate
from ddpm_image_restoration_tpu.config import get_preset as j_get_preset
from ddpm_image_restoration_tpu.data.dataset import SyntheticImageDataset as JSynthetic
from ddpm_image_restoration_tpu.data.pipeline import DegradationLoader as JLoader
from ddpm_image_restoration_tpu_torch.codecs import native
from ddpm_image_restoration_tpu_torch.codecs.surrogate import codec_surrogate
from ddpm_image_restoration_tpu_torch.config import get_preset
from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
from ddpm_image_restoration_tpu_torch.data.pipeline import DegradationLoader

torch.set_num_threads(1)

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"


def _digests():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(NATIVE_DIR.iterdir()) if p.is_file()}


@pytest.fixture(scope="module", autouse=True)
def native_dir_untouched():
    """Every file in native/ (the tracked library too) is byte-identical
    after this module's tests."""
    before = _digests()
    yield
    assert _digests() == before


@pytest.fixture
def jax_engine(tmp_path, monkeypatch):
    """The JAX wrapper building its engine from a copy of native/ in a
    temporary directory (its own `make` would otherwise rebuild the
    tracked library in place whenever the source looks newer)."""
    src = tmp_path / "native"
    src.mkdir()
    for name in ("codec_engine.cpp", "Makefile"):
        shutil.copy(NATIVE_DIR / name, src / name)
    monkeypatch.setattr(jnative, "_native_dir", lambda: str(src))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_LIB_FAILED", False)
    assert jnative.native_available()
    return jnative


@pytest.fixture
def batch():
    return np.clip(np.random.default_rng(0).normal(0, 0.4, (4, 32, 32, 3)), -1, 1).astype("f")


def test_built_from_source_into_build():
    assert native.native_available()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "build" and NATIVE_DIR not in lib.parents
    assert "-march=native" in native.build_command(lib) or \
        "-march=native" not in (NATIVE_DIR / "Makefile").read_text()


@pytest.mark.parametrize("codec", ["jpeg", "webp", "avif"])
def test_matches_jax_wrapper_and_surrogates(jax_engine, batch, codec):
    """The same source built with the same flags from the same inputs: equal
    to the JAX wrapper's output bit for bit. Against the surrogates (the
    port's and JAX's) within tests/test_native.py's bounds: a coefficient at
    a rounding edge can flip between the C++ and the tensor summation
    orders."""
    q = np.array([5, 30, 60, 95], np.int32)
    got = native.codec_surrogate_native(batch, q, codec=codec)
    np.testing.assert_array_equal(got, jax_engine.codec_surrogate_native(batch, q, codec=codec))
    for ref in (codec_surrogate(torch.from_numpy(batch), torch.from_numpy(q.astype("f")),
                                codec=codec).numpy(),
                np.asarray(jax_surrogate(jnp.asarray(batch), jnp.asarray(q, jnp.float32),
                                         codec=codec))):
        diff = np.abs(got - ref)
        assert diff.mean() < 5e-3 and diff.max() < 8e-2 and (diff > 1e-3).mean() < 0.25


def test_scalar_quality_no_subsampling_matches_jax(jax_engine, batch):
    got = native.codec_surrogate_native(batch, 40, "webp", subsample=False)
    np.testing.assert_array_equal(
        got, jax_engine.codec_surrogate_native(batch, 40, "webp", subsample=False))
    errs = [float(np.mean((native.codec_surrogate_native(batch, q, "jpeg") - batch) ** 2))
            for q in (5, 50, 95)]
    assert errs[0] > errs[1] > errs[2]


def test_threading_deterministic(batch):
    a = native.codec_surrogate_native(batch, 30, "jpeg", n_threads=1)
    for n in (2, 4, 0):
        np.testing.assert_array_equal(a, native.codec_surrogate_native(batch, 30, "jpeg",
                                                                        n_threads=n))


def test_bad_shape_raises(batch):
    with pytest.raises(ValueError, match="divisible"):
        native.codec_surrogate_native(batch[:, :30], 30, "jpeg")  # 30 is not a multiple of 8
    with pytest.raises(ValueError, match="RGB"):
        native.codec_surrogate_native(batch[..., :2], 30, "jpeg")


def test_falls_back_to_the_surrogate_without_a_compiler(batch, monkeypatch, tmp_path):
    """No compiler: one warning, then the port's codec_surrogate on the
    CPU."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", False)
    with pytest.warns(UserWarning, match="native codec engine unavailable"):
        assert not native.native_available()
    q = np.array([10, 20, 30, 40], np.int32)
    got = native.codec_surrogate_native(batch, q, "avif")
    want = codec_surrogate(torch.from_numpy(batch), torch.tensor([10.0, 20, 30, 40]),
                           codec="avif")
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("codec", ["webp", "all"])
def test_native_loader_batches_equal_jax(jax_engine, codec):
    """Two epochs of `degradation_backend='native_surrogate'` batches (the
    unified preset draws a codec per sample) equal the JAX package's,
    quality floored at 1 as there."""
    kw = dict(batch_size=4, seed=3, degradation_backend="native_surrogate")
    a = DegradationLoader(SyntheticImageDataset(12, 16, kind="mixed"), np.arange(12),
                          get_preset(codec), **kw)
    b = JLoader(JSynthetic(12, 16, kind="mixed"), np.arange(12), j_get_preset(codec), **kw)
    for epoch in (0, 1):
        got, want = list(a.epoch(epoch)), list(b.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
