"""The 'model' (tensor-parallel) mesh axis (parallel/mesh.py
`param_shardings`, `ShardedState`, column-parallel layers) over gloo ranks
spawned on the CPU (tests/_torch_parallel_worker.py), against one process,
the JAX package's `_kernel_spec`/`_fsdp_spec` rule and its sharded step.

Tolerances as in tests/test_torch_parallel.py (its module docstring): the
losses and grad norms agree to rel 1e-5, every master, EMA and module entry
to 1e-5 except the entries whose one-process gradient is f32 noise (the
biases, and the time projections, that feed a GroupNorm), which Adam may
move by up to 2·lr a step; the moments to 1e-5 of their largest entry."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ddpm_image_restoration_tpu.config import TrainConfig as JTrainConfig
from ddpm_image_restoration_tpu.parallel.mesh import _fsdp_spec, _kernel_spec
from ddpm_image_restoration_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ddpm_image_restoration_tpu.parallel.mesh import put_batch, put_state, shard_train_step
from ddpm_image_restoration_tpu.train.steps import make_train_step as j_make_train_step
from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.parallel import mesh as pm
from ddpm_image_restoration_tpu_torch.train.checkpoint import CheckpointManager, jax_layout
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state

from . import _torch_parallel_worker as w
from ._torch_parity import as_jax_layout, flatten_jax, jax_train_state
from .test_torch_parallel import (  # noqa: F401  (jax_weights: a fixture)
    STEPS,
    _grads_of_one_step,
    assert_params_match,
    jax_weights,
)

torch.set_num_threads(1)

SHAPES = {2: (1, 2), 4: (2, 2)}
# Meshes whose axes the trainer finds by name, as the JAX trainer does: name
# -> (shape, axes, fsdp) at world 4 and 2. 'model' before 'data', with and
# without FSDP; and ('data', 'spatial'), whose 'spatial' ranks hold the same
# blocks and the same batch rows, nothing reduced over them.
AXES_JOBS = {4: {"model_data": ((2, 2), ("model", "data"), False),
                 "model_data_fsdp": ((2, 2), ("model", "data"), True),
                 "data_spatial_fsdp": ((2, 2), ("data", "spatial"), True)},
             2: {"model_data": ((2, 1), ("model", "data"), False),
                 "data_spatial": ((1, 2), ("data", "spatial"), False)}}
# The (1, 2) step under block remat (the column-parallel hooks run again in
# the recompute, with the dropout masks replayed) and on the AVIF model
# (its transform weights split in the state, gathered into the module).
OTHER_CFGS = {"remat": w.train_cfg(remat=True), "avif": w.train_cfg(codec="avif")}


class _FakeMesh:
    """A ('data', 'model') mesh of the given sizes (all `param_shardings`
    reads)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n, m):
        self.sizes = (n, m)

    def size(self, dim):
        return self.sizes[dim]


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_weights):
    """Every world-4 scenario, and the world-2 ones, in one spawn each,
    started together."""
    tmp = tmp_path_factory.mktemp("tp4")
    tmp2 = tmp_path_factory.mktemp("tp2")
    batch = w.make_batch()
    one = w.run_steps(w.train_cfg(fsdp=True), batch, 1)
    CheckpointManager(str(tmp / "ck_one")).save(1, one.pop("_state"), {"val_psnr": 1.0})
    trainer = TrainConfig(codec="webp", model=dataclasses.replace(w.MINI, dropout=0.1),
                          batch_size=4, ema_decay=0.9, steps=20, mesh_shape=(-1, 2),
                          mesh_axes=("data", "model"), checkpoint_dir=str(tmp / "trainer"),
                          data_workers=1)
    trainer_md = dataclasses.replace(trainer, mesh_shape=(2, -1), mesh_axes=("model", "data"),
                                     checkpoint_dir=str(tmp / "trainer_md"))
    jobs4 = [("dp", w.scenario_tp_train, ((2, 2), w.train_cfg(), batch, STEPS)),
             ("fsdp", w.scenario_tp_train, ((2, 2), w.train_cfg(fsdp=True), batch, STEPS)),
             ("jax", w.scenario_tp_train, ((2, 2), w.train_cfg(dropout=0.0, ema_decay=0.0),
                                           batch, 1, jax_weights[0])),
             ("ckpt", w.scenario_tp_checkpoints, (w.train_cfg(fsdp=True), batch)),
             ("trainer", w.scenario_tp_trainer, (trainer,)),
             ("trainer_md", w.scenario_tp_trainer, (trainer_md,)),
             ("dryrun", w.scenario_dryrun, ())]
    jobs2 = [("dp", w.scenario_tp_train, ((1, 2), w.train_cfg(), batch, STEPS)),
             ("fsdp", w.scenario_tp_train, ((1, 2), w.train_cfg(fsdp=True), batch, STEPS))]
    jobs2 += [(name, w.scenario_tp_train, ((1, 2), cfg, batch, STEPS))
              for name, cfg in OTHER_CFGS.items()]
    for world, jobs in ((4, jobs4), (2, jobs2)):
        jobs += [(name, w.scenario_tp_train, (shape, w.train_cfg(fsdp=fsdp), batch, STEPS, None,
                                              axes))
                 for name, (shape, axes, fsdp) in AXES_JOBS[world].items()]
    join4 = w.start(w.scenario_many, 4, tmp, jobs4)
    join2 = w.start(w.scenario_many, 2, tmp2 / "spawn", jobs2)
    return {"tmp": tmp, "batch": batch, "one_ckpt": one, 4: join4(), 2: join2()}


# ---- the layout

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("n", [1, 2])
def test_param_shardings_match_jax_kernel_and_fsdp_spec(m, n):
    """For every parameter of MINI and of the full-width WebP, AVIF and
    unified ('all') models, the dimensions `param_shardings` splits over
    'model' and (with FSDP) 'data' are the ones the JAX package's
    `_kernel_spec` and then `_fsdp_spec` shard in its layout of that
    parameter. `out_conv` (3 outputs) stays whole, and most of the weights
    are split over 'model'."""
    for codec, cfg in (("webp", w.MINI), ("webp", ModelConfig()), ("avif", ModelConfig()),
                       ("all", ModelConfig())):
        model = build_model(codec, cfg, device="meta")
        got = pm.param_shardings(model, _FakeMesh(n, m), fsdp=True)
        split = 0
        for mod_name, module in model.named_modules():
            for p_name, p in module.named_parameters(recurse=False):
                _, order = jax_layout(module, p_name, p.dim())
                shape = tuple(p.shape[k] for k in order)
                spec = _kernel_spec("", shape, m)
                if n > 1:
                    spec = _fsdp_spec(shape, spec, n)
                spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
                want = pm.Split(*(order[spec.index(ax)] if ax in spec else None
                                  for ax in ("model", "data")))
                name = f"{mod_name}.{p_name}"
                assert got[name] == want, (codec, name, shape)
                split += p.numel() if want.model is not None else 0
        assert got["out_conv.weight"].model is None and got["out_conv.bias"].model is None
        assert split > 0.9 * sum(p.numel() for p in model.parameters()), codec


def test_column_parallel_layers():
    """The convolutions and dense layers whose output channels the rule
    splits are the column-parallel ones; GroupNorm scales, embeddings and
    the AVIF transform weights are split in the state but held whole in the
    module."""
    model = build_model("all", ModelConfig(), device="meta")
    splits = pm.param_shardings(model, _FakeMesh(1, 2))
    cols = set(pm.column_parallel_modules(model, splits))
    assert "down1.conv1" in cols and "down2.attn.qkv" in cols and "time_embed.proj_in" in cols
    assert "out_conv" not in cols
    assert splits["codec_embed.weight"].model == 1 and "codec_embed" not in cols
    assert splits["down1.norm2.weight"].model == 0 and splits["down1.norm1.weight"].model is None
    avif = build_model("avif", ModelConfig(), device="meta")
    s = pm.param_shardings(avif, _FakeMesh(1, 2))
    assert s["down1.freq_guide.adaptive_transform.transform_weights"].model == 2


# ---- the step

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
def test_model_axis_step_matches_one_process(world, fsdp, world4):
    """Two steps of MINI with dropout 0.1 and EMA 0.9 on batch 8 over a
    (1, 2) and a (2, 2) ('data', 'model') mesh, with and without FSDP,
    equal two one-process steps on the whole batch: loss and grad norm,
    masters, moments and EMA in the one-process layout, and the module on
    every rank (a column-parallel layer's weight and bias: that model
    rank's block of output channels)."""
    cfg = w.train_cfg(fsdp=fsdp)
    one = w.run_steps(cfg, world4["batch"], STEPS)
    grads = _grads_of_one_step(cfg, world4["batch"])
    for out in world4[world]:
        _assert_steps_match(out["fsdp" if fsdp else "dp"], one, grads, SHAPES[world][1])


def _assert_steps_match(got, one, grads, m):
    """A rank's `run_steps` over a mesh with `m` model ranks against one
    process's: loss and grad norm, masters, moments and EMA in the
    one-process layout, and the module (a column-parallel layer's weight
    and bias: the rank's block of output channels)."""
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=1e-5)
    for d in ("params", "ema"):
        assert_params_match(got["state"][d], one["state"][d], grads, STEPS)
    for d in ("mu", "nu"):
        top = max(v.abs().max().item() for v in one["state"][d].values())
        for k, v in one["state"][d].items():
            np.testing.assert_allclose(got["state"][d][k], v, rtol=0, atol=1e-5 * top,
                                       err_msg=f"{d} {k}")
    module = {}
    for k, v in one["module"].items():
        held = got["module"][k]
        module[k] = v if held.shape == v.shape else v.chunk(m, 0)[got["coords"]["model"]]
    assert_params_match(got["module"], module, grads, STEPS)
    assert got["state"]["step"] == STEPS


@pytest.mark.parametrize("world,name", [(n, name) for n, jobs in AXES_JOBS.items()
                                        for name in jobs])
def test_steps_over_axes_found_by_name_match_one_process(world, name, world4):
    """Two steps (the fixture's) over a ('model', 'data') mesh, with and
    without FSDP, and over a ('data', 'spatial') one equal two one-process
    steps on the whole batch (the module docstring's tolerances): the
    layout finds 'data' and 'model' by name, and the 'spatial' ranks, which
    take the same batch rows, hold what their data rank holds."""
    shape, axes, fsdp = AXES_JOBS[world][name]
    cfg = w.train_cfg(fsdp=fsdp)
    one = w.run_steps(cfg, world4["batch"], STEPS)
    grads = _grads_of_one_step(cfg, world4["batch"])
    sizes = dict(zip(axes, shape))
    seen = set()
    for out in world4[world]:
        got = out[name]
        seen.add(tuple(got["coords"][a] for a in axes))
        _assert_steps_match(got, one, grads, sizes.get("model", 1))
        want = [k for k, s in pm.param_shardings(
            w.mini_model(), _FakeMesh(sizes["data"], sizes.get("model", 1)), fsdp=fsdp).items()
            if s != pm.Split()]
        assert got["sharded"] == want
    assert len(seen) == world  # every coordinate of the mesh once


@pytest.mark.parametrize("name", list(OTHER_CFGS))
def test_model_axis_step_remat_and_avif(name, world4):
    """The (1, 2) steps with block remat and on the AVIF model equal one
    process's (the module docstring's tolerances)."""
    cfg = OTHER_CFGS[name]
    one = w.run_steps(cfg, world4["batch"], STEPS)
    grads = _grads_of_one_step(cfg, world4["batch"])
    if name == "avif":
        k = "down1.freq_guide.adaptive_transform.transform_weights"
        assert world4[2][0][name]["held"][k]["params"] == one["state"]["params"][k].numel() // 2
    for r, out in enumerate(world4[2]):
        got = out[name]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=1e-5)
        for d in ("params", "ema"):
            assert_params_match(got["state"][d], one["state"][d], grads, STEPS)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
def test_model_axis_holds_blocks(world, fsdp, world4):
    """Each rank holds, of every parameter split over 'model', its 1/m block
    in its masters, both moments and its EMA, and with FSDP a 1/n block of
    that along its 'data' dimension; a column-parallel layer's module weight
    is its 1/m block."""
    n, m = SHAPES[world]
    model = w.mini_model()
    full = {k: p.numel() for k, p in model.named_parameters()}
    splits = pm.param_shardings(model, _FakeMesh(n, m), fsdp=fsdp)
    want = [k for k, s in splits.items() if s != pm.Split()]
    assert sum(full[k] for k in want if splits[k].model is not None) > 0.9 * sum(full.values())
    cols = set(pm.column_parallel_modules(model, splits))
    for out in world4[world]:
        got = out["fsdp" if fsdp else "dp"]
        assert got["sharded"] == want
        for k in want:
            parts = (m if splits[k].model is not None else 1) * (
                n if splits[k].data is not None else 1)
            assert got["held"][k] == dict.fromkeys(("params", "mu", "nu", "ema"),
                                                   full[k] // parts), k
        for k, v in got["module"].items():
            in_col = k.rpartition(".")[0] in cols
            assert v.numel() == full[k] // (m if in_col else 1), k


def test_model_axis_step_matches_jax(world4, jax_weights):
    """The (2, 2) step of the port (dropout 0, npz weights) against the JAX
    package's single-device step on the same weights and batch: loss rel
    1e-5, every parameter within 1e-5 under the noise rule."""
    path, jm, jmc, jvars = jax_weights
    jcfg = JTrainConfig(codec="webp", model=jmc, batch_size=8)
    state = jax_train_state(jm, jcfg, jvars["params"])
    step = jax.jit(j_make_train_step(jm, jcfg))
    jstate, jmetrics = step(state, world4["batch"], jax.random.PRNGKey(3))
    _check_against_jax(world4, jax_weights, jstate, jmetrics, 1e-5)


def _check_against_jax(world4, jax_weights, jstate, jmetrics, rtol):
    path = jax_weights[0]
    grads = _grads_of_one_step(w.train_cfg(dropout=0.0, ema_decay=0.0), world4["batch"], path)
    model = w.mini_model(path)
    want = flatten_jax(jstate.params)
    grads_jax = as_jax_layout(model, grads)
    for out in world4[4]:
        got = out["jax"]
        np.testing.assert_allclose(got["loss"][0], float(jmetrics["loss"]), rtol=rtol)
        got_jax = as_jax_layout(model, got["state"]["params"])
        assert_params_match(got_jax, want, {k: torch.from_numpy(v) for k, v in grads_jax.items()},
                            1)


@pytest.mark.slow
def test_model_axis_step_matches_jax_shard_train_step(world4, jax_weights):
    """The JAX package's `shard_train_step` on its faked 8-device (4, 2)
    ('data', 'model') mesh (`test_2d_mesh_train_step`): the port's (2, 2)
    step within loss rel 1e-4 and the parameters under the noise rule."""
    path, jm, jmc, jvars = jax_weights
    jcfg = JTrainConfig(codec="webp", model=jmc, batch_size=8)
    state = jax_train_state(jm, jcfg, jvars["params"])
    mesh = jax_make_mesh((4, 2), ("data", "model"))
    step = shard_train_step(j_make_train_step(jm, jcfg), mesh, state)
    jstate, jmetrics = step(put_state(state, mesh), put_batch(world4["batch"], mesh),
                            jax.random.PRNGKey(3))
    assert P(None, None, None, "model") in {
        s.sharding.spec for s in jax.tree_util.tree_leaves(jstate.params)}
    _check_against_jax(world4, jax_weights, jstate, jmetrics, 1e-4)


# ---- checkpoints, the trainer and the dry run

def test_checkpoints_move_between_2x2_and_one_process(world4):
    """A checkpoint written by the (2, 2) FSDP ranks loads into one process
    as their state, gathered; one written by one process loads into the
    (2, 2) ranks, each keeping its blocks, their modules holding its
    weights (a column-parallel layer: its block)."""
    tmp = world4["tmp"]
    saved = world4[4][0]["ckpt"]["saved"]
    state = create_train_state(w.mini_model(), w.train_cfg(fsdp=True))
    _, meta = CheckpointManager(str(tmp / "ck_tp")).restore_latest(state)
    assert meta["step"] == 1
    for d in ("params", "mu", "nu", "ema"):
        for k, v in saved[d].items():
            assert torch.equal(getattr(state, d)[k], v), (d, k)
    one = world4["one_ckpt"]["state"]
    for r, out in enumerate(world4[4]):
        got = out["ckpt"]
        for d in ("params", "mu", "nu", "ema"):
            for k, v in one[d].items():
                assert torch.equal(got["loaded"][d][k], v), (r, d, k)
        for k, v in one["params"].items():
            held = got["loaded_module"][k]
            want = v if held.shape == v.shape else v.chunk(2, 0)[r % 2]
            assert torch.equal(held, want), (r, k)
        assert all(n < one["params"][k].numel() for k, n in got["loaded_held"].items())


def test_trainer_over_data_and_model(world4):
    """`train_model` on a (-1, 2) ('data', 'model') mesh at world 4: a (2,
    2) mesh, one epoch of 2 steps with validation and the restoration grid
    (column-parallel on every model rank of data rank 0), the same history
    on every rank, and one checkpoint written; and on a (2, -1) ('model',
    'data') mesh, the same losses."""
    outs = [r["trainer"] for r in world4[4]]
    for out in outs:
        assert out["mesh"] == {"data": 2, "model": 2}
        assert out["step"] == 2
        for k in ("loss", "val_psnr", "val_ssim"):  # (times differ between ranks)
            assert out["history"][k] == outs[0]["history"][k]
        assert np.isfinite(out["history"]["loss"]).all()
        assert np.isfinite(out["history"]["val_psnr"]).all()
    assert [f for f in outs[0]["files"] if f.startswith("ckpt_")] == ["ckpt_0.pt"]
    # the same trainer over ('model', 'data') (2, -1): the same (2, 2) mesh,
    # its axes found by name, the same losses
    for out in (r["trainer_md"] for r in world4[4]):
        assert out["mesh"] == {"model": 2, "data": 2} and out["step"] == 2
        np.testing.assert_allclose(out["history"]["loss"], outs[0]["history"]["loss"],
                                   rtol=1e-5)
        assert np.isfinite(out["history"]["val_psnr"]).all()
    files = world4[4][0]["trainer_md"]["files"]
    assert [f for f in files if f.startswith("ckpt_")] == ["ckpt_0.pt"]


def test_dryrun_world4(world4):
    """`parallel/dryrun.py` at world 4, as `dryrun_multichip`: the FSDP step
    on a (2, 2) ('data', 'model') mesh, the data-parallel restore of its
    batch of 4 and the spatial-parallel restore of 2 images over every
    rank."""
    outs = [r["dryrun"] for r in world4[4]]
    for out in outs:
        assert out["world"] == 4 and out["mesh"] == {"data": 2, "model": 2}
        assert np.isfinite(out["loss"]) and out["loss"] == outs[0]["loss"]
        assert out["restored_shape"] == (4, 16, 16, 3)
        assert out["sp_restored_shape"] == (2, 16, 16, 3)
