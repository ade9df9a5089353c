"""The port's config copy, quality maps and solver policy against the JAX
package's originals (field by field, exact)."""

import dataclasses

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu import config as jcfg
from ddpm_image_restoration_tpu.codecs.quality import init_timestep_for_quality as j_init_t
from ddpm_image_restoration_tpu.diffusion import policy as jpolicy
from ddpm_image_restoration_tpu.train.distill import student_stride as j_student_stride
from ddpm_image_restoration_tpu_torch import config as tcfg
from ddpm_image_restoration_tpu_torch.codecs.quality import (
    init_timestep_for_quality,
    student_stride,
)
from ddpm_image_restoration_tpu_torch.diffusion import policy as tpolicy

torch.set_num_threads(1)


@pytest.mark.parametrize("codec", ["jpeg", "webp", "avif", "all"])
def test_presets_match(codec):
    assert dataclasses.asdict(tcfg.get_preset(codec)) == dataclasses.asdict(
        jcfg.get_preset(codec))
    assert tcfg.get_preset(codec).clamp_quality(150) == jcfg.get_preset(codec).clamp_quality(150)


def test_model_config_and_codecs_match():
    assert dataclasses.asdict(tcfg.ModelConfig()) == dataclasses.asdict(jcfg.ModelConfig())
    for f in (2, 8, 64):
        assert dataclasses.asdict(tcfg.ModelConfig().scaled(f)) == dataclasses.asdict(
            jcfg.ModelConfig().scaled(f))
    assert tcfg.CODECS == jcfg.CODECS
    assert [tcfg.codec_index(c) for c in tcfg.CODECS] == [0, 1, 2]
    with pytest.raises(ValueError):
        tcfg.ModelConfig(image_size=16).validate()
    with pytest.raises(ValueError):
        tcfg.get_preset("png")


def test_train_config_matches():
    assert dataclasses.asdict(tcfg.TrainConfig()) == dataclasses.asdict(jcfg.TrainConfig())
    for codec, bs in (("webp", 0), ("avif", 0), ("jpeg", 7)):
        t, j = tcfg.TrainConfig(codec=codec, batch_size=bs), jcfg.TrainConfig(codec=codec,
                                                                              batch_size=bs)
        assert t.effective_batch_size == j.effective_batch_size
        assert dataclasses.asdict(t.preset) == dataclasses.asdict(j.preset)


def test_eval_config_matches():
    assert dataclasses.asdict(tcfg.EvalConfig()) == dataclasses.asdict(jcfg.EvalConfig())
    for codec, override in (("webp", ()), ("avif", ()), ("jpeg", (10, 30))):
        t = tcfg.EvalConfig(codec=codec, qualities_override=override)
        j = jcfg.EvalConfig(codec=codec, qualities_override=override)
        assert t.eval_qualities == j.eval_qualities
        assert dataclasses.asdict(t.preset) == dataclasses.asdict(j.preset)


@pytest.mark.parametrize("codec", ["jpeg", "webp", "avif"])
def test_quality_maps_match(codec):
    for steps in (4, 20, 100, 1000):
        for q in range(0, 101, 5):
            assert init_timestep_for_quality(q, steps, tcfg.get_preset(codec)) == \
                j_init_t(q, steps, jcfg.get_preset(codec))
    for init_t in (1, 2, 7, 20, 50, 70, 80):
        for n_eval in (1, 2, 3, 7, 14, 100):
            assert student_stride(init_t, n_eval) == j_student_stride(init_t, n_eval)
    with pytest.raises(ValueError):
        student_stride(10, 0)


def test_policy_matches():
    for codec in (None, "jpeg", "webp", "avif"):
        assert tpolicy.production_solver_config(30, codec) == \
            jpolicy.production_solver_config(30, codec)
    assert tpolicy.REAL_PHOTO_TRUST == jpolicy.REAL_PHOTO_TRUST
    np.testing.assert_equal(tpolicy.PRODUCTION_PROTECT, jpolicy.PRODUCTION_PROTECT)
