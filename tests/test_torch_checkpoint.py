"""Release weights through the npz: port export -> JAX load -> JAX export
-> port load is the identity, with the layouts each package expects."""

import numpy as np
import pytest
import torch
from tests._tiny import MINI, TINY5
from tests._torch_parity import model_pair

from ddpm_image_restoration_tpu.train.checkpoint import (
    export_release_params as jax_export,
)
from ddpm_image_restoration_tpu_torch.train.checkpoint import (
    export_release_params,
    load_release_params,
    params_from_jax,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("codec,cfg", [("webp", TINY5), ("all", MINI)])
def test_weight_roundtrip(tmp_path, codec, cfg):
    _, jvars, tm = model_pair(codec, cfg, tmp_path / "t.npz")
    jax_export(jvars["params"], str(tmp_path / "j.npz"), codec=codec)
    back = load_release_params(str(tmp_path / "j.npz"))
    want = tm.state_dict()
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].to(v.dtype).float().numpy(),
                                      v.float().numpy(), err_msg=k)
    with np.load(tmp_path / "t.npz") as d, np.load(tmp_path / "j.npz") as e:
        assert str(d["__codec__"]) == codec
        assert set(d.files) == set(e.files)
        for k in d.files:
            if not k.startswith("__"):
                assert d[k].dtype == np.float16
                np.testing.assert_array_equal(d[k], e[k], err_msg=k)


def test_layouts():
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 3, 4, 8)).astype(np.float16)     # HWIO
    dense = rng.normal(size=(4, 12)).astype(np.float16)         # [in, out]
    sd = params_from_jax({
        "__meta__": np.str_("{}"),
        "a/conv1/kernel": conv, "a/conv1/bias": np.ones(8, np.float16),
        "a/qkv/kernel": dense, "a/norm1/scale": np.ones(4, np.float16),
        "codec_embed/embedding": np.ones((3, 5), np.float16),
    })
    assert set(sd) == {"a.conv1.weight", "a.conv1.bias", "a.qkv.weight",
                       "a.norm1.weight", "codec_embed.weight"}
    assert sd["a.conv1.weight"].shape == (8, 4, 3, 3)
    assert sd["a.conv1.weight"][5, 2, 0, 1] == float(conv[0, 1, 2, 5])
    assert sd["a.qkv.weight"].shape == (12, 4)
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_load_casts_to_module_dtype(tmp_path):
    """fp16 npz values land in the bf16 body and the f32 norms/head."""
    import dataclasses

    cfg = dataclasses.replace(MINI, compute_dtype="bfloat16")
    _, jvars, tm = model_pair("webp", cfg, tmp_path / "w.npz")
    assert tm.down1.conv1.weight.dtype == torch.bfloat16
    assert tm.down1.norm1.weight.dtype == torch.float32
    assert tm.out_conv.weight.dtype == torch.float32
    k = np.asarray(jvars["params"]["down1"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        tm.down1.conv1.weight.float().permute(2, 3, 1, 0).numpy(),
        torch.from_numpy(k).to(torch.bfloat16).float().numpy())
    sd = load_release_params(str(tmp_path / "w.npz"))
    assert set(sd) == set(tm.state_dict())
