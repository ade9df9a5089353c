"""The spatial-parallel restore (`restore --sp`, parallel/spatial.py,
parallel/mesh.py `shard_inference_spatial`) over gloo ranks spawned on the
CPU (tests/_torch_parallel_worker.py), against one process and against the
JAX package's single-device sampler on the same npz weights.

Each split op is exact up to the order of f32 sums, so a split op agrees
with the whole op within 1e-5 (1e-6 of the largest entry for GroupNorm and
the pooled grids), and a 4-step restore with each image's height split
agrees with the one-process restore within 1e-5: the solver's state is whole
on every rank and every rank draws the noise of the whole batch. The JAX
package asserts that its own spatial-parallel restore equals its
single-device one within 1e-4 (tests/test_parallel.py
`test_sp_restore_matches_single_device`), and the port's is held to that
single-device restore within 1e-4 at eta 0 (no noise to draw alike). The
restores leave out the exact final projection: a last-bit change of x̂ can
move libwebp's re-encode by a quantisation step on random weights."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.codecs.surrogate import codec_surrogate as jax_surrogate
from ddpm_image_restoration_tpu.config import ModelConfig as JModelConfig
from ddpm_image_restoration_tpu.config import get_preset as jax_preset
from ddpm_image_restoration_tpu.diffusion.ddrm import DDRMSampler as JDDRMSampler
from ddpm_image_restoration_tpu_torch.config import ModelConfig, get_preset
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.parallel import mesh as pm
from ddpm_image_restoration_tpu_torch.parallel.spatial import split_plan

from . import _torch_parallel_worker as w
from ._tiny import MINI as J_MINI
from ._torch_parity import model_pair, smooth_images
from .test_torch_parallel_cli import TINY_FLAGS, _assert_saved_equal, _write_inputs

torch.set_num_threads(1)

# The AVIF preset's 8-row blocks need 32 rows to split over 4 ranks.
J_AVIF32 = dataclasses.replace(J_MINI, image_size=32)
CODECS = {"webp": J_MINI, "avif": J_AVIF32}
ETAS = {"noise": None, "eta0": 0.0}   # None: the preset's eta (0.85 WebP, AVIF's own)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Per codec: the npz both packages load, the JAX model and variables,
    and a batch of 2 surrogate-compressed images at q30."""
    tmp = tmp_path_factory.mktemp("sp_weights")
    out = {}
    for codec, jcfg in CODECS.items():
        npz = tmp / f"{codec}.npz"
        jm, jv, _ = model_pair(codec, jcfg, npz, seed=1)
        x0 = smooth_images(2, jcfg.image_size, seed=4)
        y = np.array(jax_surrogate(jnp.asarray(x0), 30, codec=codec))
        out[codec] = {"npz": str(npz), "jm": jm, "jv": jv, "y": y, "cfg": _port_cfg(jcfg)}
    return out


def _cases(weights):
    """(key, sp_restore arguments) for every codec, eta and encoder reuse
    (1; 2; 2 with the deep decoder stage cached too, "2d")."""
    reuses = {1: (1, 0), 2: (2, 0), "2d": (2, 1)}
    return [((codec, eta_name, reuse), (codec, wt["cfg"], wt["npz"], wt["y"], eta, *reuses[reuse]))
            for codec, wt in weights.items() for eta_name, eta in ETAS.items()
            for reuse in reuses]


def _cli_files(tmp: Path):
    cfg = JModelConfig(image_size=32, compute_dtype="float32", attention_impl="flash",
                       attn_max_resolution=32).scaled(8)
    npz = tmp / "cli.npz"
    model_pair("webp", cfg, npz, seed=2)
    files = _write_inputs(tmp / "in")
    return [*files, *TINY_FLAGS, "--params-npz", str(npz), "--quality", "30", "--max-evals",
            "4", "--encoder-reuse", "2", "--output-dir"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """World 2 and world 4 (one spawn each, started together), and the same
    restores and CLI call in one process."""
    tmp = tmp_path_factory.mktemp("sp")
    cases = _cases(weights)
    cli = _cli_files(tmp)
    jobs2 = [("ops", w.scenario_sp_ops, ()), ("restores", w.scenario_sp_restores, (cases,)),
             ("cli", w.scenario_cli, ("restore", [*cli, str(tmp / "c2"), "--sp", "2"]))]
    jobs4 = [("ops", w.scenario_sp_ops, ()), ("restores", w.scenario_sp_restores, (cases,)),
             ("cli", w.scenario_cli, ("restore", [*cli, str(tmp / "c4"), "--sp", "-1"])),
             ("clamp", w.scenario_cli, ("restore", [*cli, str(tmp / "c3"), "--sp", "3"]))]
    join2 = w.start(w.scenario_many, 2, tmp / "spawn2", jobs2)
    join4 = w.start(w.scenario_many, 4, tmp / "spawn4", jobs4)
    one = {key: w.sp_restore(*case) for key, case in cases}
    one_cli = w.scenario_cli(0, 1, tmp, "restore", [*cli, str(tmp / "c1")])
    return {"tmp": tmp, 2: join2(), 4: join4(), "one": one, "one_cli": one_cli}


# ---- the split rule

@pytest.mark.parametrize("m,want_webp,want_block8", [
    (2, (True, True, False), (True, False, False)),
    (3, (False, False, False), (False, False, False)),
    (4, (True, False, False), (False, False, False))])
def test_split_plan_mini(m, want_webp, want_block8):
    """MINI (16², 2 pooling stages): a level splits while the mesh size
    divides its height, each shard holds whole DCT blocks (4 rows for WebP,
    8 for JPEG and AVIF) and at least 2 rows; below the first level that
    fails, none does."""
    assert split_plan(16, 2, 4, m) == want_webp
    assert split_plan(16, 2, 8, m) == want_block8
    assert split_plan(16, 2, 4, 1) == (False,) * 3


@pytest.mark.parametrize("m,want", [
    (2, {4: (True,) * 4 + (False,) * 2, 8: (True,) * 3 + (False,) * 3}),
    (3, {4: (False,) * 6, 8: (False,) * 6}),
    (4, {4: (True,) * 3 + (False,) * 3, 8: (True,) * 2 + (False,) * 4})])
def test_split_plan_full_width(m, want):
    """The full-width 64² model (5 pooling stages, the bottleneck at 2²):
    at m = 2 WebP splits 64² to 8² and the 4² and 2² levels run
    replicated; `CodecDiffusionModel.spatial_levels` follows the plan for
    every preset's block."""
    for codec in ("webp", "jpeg", "avif"):
        block = get_preset(codec).dct_block_size
        assert split_plan(64, 5, block, m) == want[block], codec
    torch.manual_seed(0)
    model = build_model("webp", ModelConfig().scaled(32), device="cpu")
    model.spatial_mesh = _FakeSpatialMesh(m)
    levels = model.spatial_levels(64)
    assert tuple(lvl is not None for lvl in levels) == want[4]
    assert all(lvl.height == 64 >> i and lvl.rows == (64 >> i) // m
               for i, lvl in enumerate(levels) if lvl is not None)
    assert model.down1.sp is levels[0] and model.up5.sp is levels[0]
    assert model.bottleneck1.sp is None and model.up1.sp is levels[4]


class _FakeSpatialMesh:
    """A ('spatial',) mesh of m ranks seen from rank 0 (what
    `spatial_levels` reads)."""

    mesh_dim_names = ("spatial",)

    def __init__(self, m):
        self.m = m

    def size(self, dim):
        return self.m

    def get_coordinate(self):
        return [0]


# ---- the split ops

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["conv", "upsample", "upsample_whole", "group_norm",
                                  "attention", "dct_block", "avif_block", "pooled",
                                  "pooled_resize"])
def test_split_op_matches_whole_op(name, world, runs):
    """Each edge-crossing op on the ranks' row blocks, concatenated, equals
    the op on the whole tensor: the halo convolution (zeros at the image
    borders), the halo upsample from a split level and from a whole one
    (edge rows repeated), GroupNorm with all-reduced statistics, the
    attention over gathered q/k/v, the DCT and AVIF frequency blocks (their
    3x3 convolutions, block transforms and pooled gates), and the pooled
    grids (window pooling and the antialiased resize)."""
    mod, x = w.sp_op_cases()[name]
    want = w.sp_op(name, mod, x, None)
    outs = [r["ops"][name] for r in runs[world]]
    got = outs[0] if name.startswith("pooled") else torch.cat(outs, dim=2)
    assert got.shape == want.shape
    atol = 1e-6 * want.abs().max().item() if name in ("group_norm", "pooled",
                                                      "pooled_resize") else 1e-5
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    if name.startswith("pooled"):
        assert all(torch.equal(o, outs[0]) for o in outs)


# ---- the restore

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("codec", ["webp", "avif"])
def test_sp_restore_matches_one_process(codec, world, runs):
    """4 steps at q30, at the preset's eta (noise drawn) and at eta 0, with
    encoder reuse 1 and 2 and decoder reuse at depth 1 (each rank caches its
    own split or whole features): every rank returns the whole restore,
    equal to one process's within 1e-5; at world 4 AVIF's 32² level (8 rows
    a rank) is the only split one."""
    for key, want in runs["one"].items():
        if key[0] != codec:
            continue
        for r, out in enumerate(runs[world]):
            np.testing.assert_allclose(out["restores"][key].numpy(), want.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("codec", ["webp", "avif"])
@pytest.mark.parametrize("reuse", [1, 2])
def test_sp_restore_matches_jax_single_device(codec, reuse, weights, runs):
    """At eta 0 the ranks' restore equals the JAX package's single-device
    `DDRMSampler.sample` on the same npz weights and inputs within 1e-4, at
    worlds 2 and 4."""
    wt = weights[codec]
    want = np.asarray(JDDRMSampler(wt["jm"], jax_preset(codec)).sample(
        wt["jv"], jnp.asarray(wt["y"]), 30, 4, eta=0.0, encoder_reuse=reuse,
        final_exact=False))
    for world in (2, 4):
        got = runs[world][0]["restores"][(codec, "eta0", reuse)].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=f"world {world}")


# ---- the CLI

def test_restore_cli_sp_matches_one_process(runs):
    """`restore --sp 2` (world 2) and `--sp -1` (world 4) on 3 WebPs at
    32² (flash attention at 32², T = 1024 gathered; 4 evaluations, encoder
    reuse 2, the preset's eta, the exact final projection) write, from rank
    0 only, what one process writes."""
    want = runs["one_cli"]["saved"]
    for world in (2, 4):
        ranks = [r["cli"] for r in runs[world]]
        assert all(r["exit"] is None for r in ranks)
        assert f"spatial-parallel restore over {world} device(s)" in ranks[0]["printed"]
        _assert_saved_equal(ranks[0]["saved"], want)
        assert all(r["saved"] == {} for r in ranks[1:])


def test_restore_cli_sp_clamps_to_a_divisor(runs):
    """`--sp 3` on four ranks at height 32 (the CLI's smallest: five pooling
    stages) clamps the mesh to 2 ranks with the JAX CLI's message (the
    height is split unpadded); the other two say they have nothing to do,
    and the output is one process's."""
    ranks = [r["clamp"] for r in runs[4]]
    assert ("--sp: clamped mesh to 2 device(s) (largest divisor of image height 32)"
            in ranks[0]["printed"])
    assert "spatial-parallel restore over 2 device(s)" in ranks[0]["printed"]
    for r in (2, 3):
        assert "outside the spatial mesh of 2 of 4 rank(s); nothing to do" in \
            ranks[r]["printed"]
    _assert_saved_equal(ranks[0]["saved"], runs["one_cli"]["saved"])


def test_shard_inference_spatial_without_mesh_is_identity():
    """Without a mesh the model splits nothing and stays as it was."""
    torch.manual_seed(0)
    model = build_model("webp", _port_cfg(J_MINI), device="cpu")
    assert pm.shard_inference_spatial(model, None) is model
    assert model.spatial_mesh is None
    assert all(lvl is None for lvl in model.spatial_levels(16))


# ---- against the JAX package's own sharded run

@pytest.mark.slow
def test_sp_restore_matches_jax_shard_inference_spatial(weights, runs):
    """The JAX package's `shard_inference_spatial` over its faked 8-device
    ('spatial',) mesh (MINI's 16 rows, 2 a device) against the port's split
    restore at world 2 and 4 on the same weights, eta 0: within 1e-4 (each
    within 1e-4 of the single-device restore)."""
    from ddpm_image_restoration_tpu.parallel.mesh import make_mesh, shard_inference_spatial

    wt = weights["webp"]
    mesh = make_mesh((-1,), ("spatial",))
    assert mesh.shape == {"spatial": 8}
    params, y = shard_inference_spatial(wt["jv"], jnp.asarray(wt["y"]), mesh)
    want = np.asarray(JDDRMSampler(wt["jm"], jax_preset("webp")).sample(
        params, y, 30, 4, eta=0.0, final_exact=False))
    assert jax.device_count() == 8
    for world in (2, 4):
        got = runs[world][0]["restores"][("webp", "eta0", 1)].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
