"""The port's parallel layer (parallel/mesh.py on torch.distributed) against
one process and against the JAX package's mesh: gloo ranks spawned on the
CPU (tests/_torch_parallel_worker.py) stand in for the JAX tests' faked
8-device mesh (tests/test_parallel.py).

Tolerances. The losses agree to rel 1e-5 and every parameter entry to
1e-5 after the steps, except the entries of parameters whose gradient is
analytically zero (the biases that feed a GroupNorm, which subtracts their
per-channel shift again): their gradients are f32 rounding noise, at most
1e-6 of the largest gradient entry, which sums in another order turn into
other noise, and Adam divides each gradient by its own magnitude, so such
an entry may move by up to 2·lr per step in one run and not the other (22
of MINI's 45,057 entries do). Those are held to 2·lr per step, and to being
noise."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ddpm_image_restoration_tpu.config import TrainConfig as JTrainConfig
from ddpm_image_restoration_tpu.parallel.mesh import _fsdp_spec
from ddpm_image_restoration_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ddpm_image_restoration_tpu.parallel.mesh import put_batch, put_state, shard_train_step
from ddpm_image_restoration_tpu.train.steps import make_train_step as j_make_train_step
from ddpm_image_restoration_tpu_torch.config import ModelConfig, get_preset
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.parallel import mesh as pm
from ddpm_image_restoration_tpu_torch.train.checkpoint import CheckpointManager, jax_layout
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

from . import _torch_parallel_worker as w
from ._tiny import MINI as J_MINI
from ._torch_parity import as_jax_layout, flatten_jax, jax_train_state, model_pair
from .test_torch_evaluate_phase import counted_kernels  # noqa: F401

torch.set_num_threads(1)

LR = get_preset("webp").lr
STEPS = 2
RESTORE_Y = np.clip(np.random.default_rng(5).normal(0, 0.4, (5, 16, 16, 3)), -1, 1).astype(
    np.float32)


def _grads_of_one_step(cfg, batch, weights=None):
    """The one-process gradients of the first step (the reference for which
    entries are noise)."""
    model = w.mini_model(weights, cfg.model, cfg.codec)
    state = create_train_state(model, cfg)
    make_train_step(model, cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(3))
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def assert_params_match(got, want, grads, steps, atol=1e-5):
    """`got` and `want` (name -> tensor) within `atol`, except parameters
    whose reference gradient is noise (module docstring)."""
    g_max = max(g.abs().max().item() for g in grads.values())
    for k, v in want.items():
        diff = np.abs(np.asarray(got[k], np.float32) - np.asarray(v, np.float32)).max()
        if diff > atol:
            assert grads[k].abs().max().item() <= 1e-6 * g_max, (k, diff)
            assert diff <= steps * 2 * LR * 1.01, (k, diff)


class _FakeMesh:
    """A mesh of n ranks on its data axis (all `param_shardings` reads)."""

    mesh_dim_names = ("data",)

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return self.n


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """MINI weights in a release npz (both packages read it), dropout 0."""
    path = tmp_path_factory.mktemp("weights") / "w.npz"
    jmc = dataclasses.replace(J_MINI, dropout=0.0)
    jm, jvars, _ = model_pair("webp", jmc, path)
    return str(path), jm, jmc, jvars


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_weights):
    """Every world-2 scenario in one spawn of two gloo ranks."""
    tmp = tmp_path_factory.mktemp("world2")
    batch = w.make_batch()
    # a checkpoint written by one process, for the ranks to load under FSDP
    one = w.run_steps(w.train_cfg(fsdp=True), batch, 1, weights=None)
    CheckpointManager(str(tmp / "ck_one")).save(1, one.pop("_state"), {"val_psnr": 1.0})
    jobs = [("dp", w.scenario_train, (w.train_cfg(), batch, STEPS)),
            ("fsdp", w.scenario_train, (w.train_cfg(fsdp=True), batch, STEPS)),
            ("jax", w.scenario_train, (w.train_cfg(dropout=0.0, ema_decay=0.0), batch, 1,
                                       jax_weights[0])),
            ("ckpt", w.scenario_checkpoints, (w.train_cfg(fsdp=True), batch)),
            ("restore", w.scenario_restore, (RESTORE_Y, 30, 10, 0.85)),
            ("dryrun", w.scenario_dryrun, ())]
    ranks = w.spawn(w.scenario_many, 2, tmp, jobs)
    return {"tmp": tmp, "batch": batch, "one_ckpt": one, "ranks": ranks}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    batch = w.make_batch()
    jobs = [("mesh", w.scenario_mesh_shapes, ()),
            ("dp", w.scenario_train, (w.train_cfg(), batch, STEPS)),
            ("fsdp", w.scenario_train, (w.train_cfg(fsdp=True), batch, STEPS))]
    return {"batch": batch, "ranks": w.spawn(w.scenario_many, 4, tmp, jobs)}


def test_make_mesh_shapes(world4):
    """-1 absorbs the ranks the other axes leave; ranks past a smaller mesh
    are outside it; one process has no mesh."""
    for r, out in enumerate(world4["ranks"]):
        shapes = out["mesh"]
        assert shapes[(-1,)] == ({"data": 4}, r)
        assert shapes[(2,)] == ({"data": 2}, r if r < 2 else None)
        assert shapes[(2, 2)] == ({"data": 2, "model": 2}, r // 2)
        assert shapes[(-1, 2)] == ({"data": 2, "model": 2}, r // 2)
    assert pm.make_mesh() is None and pm.make_mesh((1,)) is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.make_mesh((2,))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_param_shardings_match_jax_fsdp_spec(n):
    """For every parameter of the TINY5-shaped WebP model (and MINI's), the
    axis `param_shardings` splits over 'data' is the one the JAX package's
    `_fsdp_spec` shards in its own layout of that parameter, or neither
    shards it (a data-only mesh splits nothing over 'model')."""
    from ._tiny import TINY5

    for cfg in (J_MINI, TINY5):
        torch.manual_seed(0)
        model = build_model("webp", ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
        dims = pm.param_shardings(model, None, fsdp=True)  # no mesh: one rank, nothing split
        assert set(dims.values()) == {pm.Split()}
        dims = {}
        for mod_name, module in model.named_modules():
            for p_name, p in module.named_parameters(recurse=False):
                _, order = jax_layout(module, p_name, p.dim())
                jax_shape = tuple(p.shape[k] for k in order)
                spec = tuple(_fsdp_spec(jax_shape, P(), n))
                want = spec.index("data") if "data" in spec else None
                got = pm.fsdp_dim(jax_shape, n)
                assert got == want, (mod_name, p_name, jax_shape)
                dims[f"{mod_name}.{p_name}" if mod_name else p_name] = (
                    None if got is None else order[got])
        assert pm.param_shardings(model, _FakeMesh(n), fsdp=True) == {
            k: pm.Split(None, d) for k, d in dims.items()}
        assert any(d is not None for d in dims.values())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_step_matches_one_process(world, fsdp, world2, world4):
    """Two data-parallel (or FSDP) steps of MINI with dropout 0.1 and EMA 0.9
    on batch 8 equal two one-process steps on the whole batch (module
    docstring for the tolerances): loss and grad norm rel 1e-5; masters,
    both moments and the EMA; the module's weights on every rank."""
    res = (world2 if world == 2 else world4)["ranks"]
    cfg = w.train_cfg(fsdp=fsdp)
    one = w.run_steps(cfg, world2["batch"], STEPS)
    grads = _grads_of_one_step(cfg, world2["batch"])
    for out in res:
        got = out["dp" if not fsdp else "fsdp"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=1e-5)
        for d in ("params", "ema"):
            assert_params_match(got["state"][d], one["state"][d], grads, STEPS)
        for d in ("mu", "nu"):  # as the gradients: within 1e-5 of the largest entry
            top = max(v.abs().max().item() for v in one["state"][d].values())
            for k, v in one["state"][d].items():
                np.testing.assert_allclose(got["state"][d][k], v, rtol=0, atol=1e-5 * top,
                                           err_msg=f"{d} {k}")
        assert_params_match(got["module"], one["module"], grads, STEPS)
        assert got["state"]["step"] == STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_shards_the_large_tensors(world, world2, world4):
    """Under FSDP each rank holds exactly 1/world of every parameter that
    `param_shardings` splits, in its masters, both moments and its EMA, and
    the split ones are those the JAX rule shards (most of the weights)."""
    res = (world2 if world == 2 else world4)["ranks"]
    model = w.mini_model()
    full = {n: p.numel() for n, p in model.named_parameters()}
    want = [k for k, d in pm.param_shardings(model, _FakeMesh(world), fsdp=True).items()
            if d.data is not None]
    assert sum(full[k] for k in want) > 0.9 * sum(full.values())
    for out in res:
        got = out["fsdp"]
        assert got["sharded"] == want
        for k in want:
            assert got["held"][k] == dict.fromkeys(("params", "mu", "nu", "ema"),
                                                   full[k] // world), k
        assert out["dp"]["held"] == {}


def test_dp_step_matches_jax_shard_train_step(world2, jax_weights):
    """The port's step at world 2 against the JAX package's
    `shard_train_step` over its faked 8-device mesh, on the same npz
    weights and numpy batch, dropout 0: loss rel 1e-5; every parameter
    within 1e-5 (module docstring for the noise entries)."""
    path, jm, jmc, jvars = jax_weights
    jcfg = JTrainConfig(codec="webp", model=jmc, batch_size=8)
    state = jax_train_state(jm, jcfg, jvars["params"])
    mesh = jax_make_mesh((-1,), ("data",))
    assert mesh.shape == {"data": 8}
    step = shard_train_step(j_make_train_step(jm, jcfg), mesh, state)
    batch = world2["batch"]
    jstate, jmetrics = step(put_state(state, mesh), put_batch(batch, mesh),
                            jax.random.PRNGKey(3))
    grads = _grads_of_one_step(w.train_cfg(dropout=0.0, ema_decay=0.0), batch, path)
    model = w.mini_model(path)
    want = flatten_jax(jstate.params)
    grads_jax = as_jax_layout(model, grads)
    for out in world2["ranks"]:
        got = out["jax"]
        np.testing.assert_allclose(got["loss"][0], float(jmetrics["loss"]), rtol=1e-5)
        got_jax = as_jax_layout(model, got["state"]["params"])
        assert_params_match(got_jax, want, {k: torch.from_numpy(v) for k, v in grads_jax.items()},
                            1)


def test_checkpoints_move_between_fsdp_and_one_process(world2):
    """A checkpoint written by two FSDP ranks loads into one process as the
    ranks' state, gathered; one written by one process loads into the FSDP
    ranks, each keeping its part, and their module holds its weights."""
    tmp = world2["tmp"]
    saved = world2["ranks"][0]["ckpt"]["saved"]
    state = create_train_state(w.mini_model(), w.train_cfg(fsdp=True))
    _, meta = CheckpointManager(str(tmp / "ck_fsdp")).restore_latest(state)
    assert meta["step"] == 1
    for d in ("params", "mu", "nu", "ema"):
        for k, v in saved[d].items():
            assert torch.equal(getattr(state, d)[k], v), (d, k)
    one = world2["one_ckpt"]["state"]
    for r, out in enumerate(world2["ranks"]):
        got = out["ckpt"]
        for d in ("params", "mu", "nu", "ema"):
            for k, v in one[d].items():
                assert torch.equal(got["loaded"][d][k], v), (r, d, k)
        for k, v in one["params"].items():
            assert torch.equal(got["loaded_module"][k], v), (r, k)
        assert all(n < one["params"][k].numel() for k, n in got["loaded_held"].items())


def test_dp_restore_matches_one_process(world2):
    """The sampler at eta 0.85 (the WebP preset's noise) on 5 images, data-
    parallel over 2 ranks (rows 0-2 and 3-5, the last padding), equals one
    process's restore of the 5: the ranks draw the noise of the whole batch
    and keep their rows. atol 1e-5."""
    torch.manual_seed(0)
    model = w.mini_model()
    want = DDRMSampler(model, get_preset("webp")).sample(
        torch.from_numpy(RESTORE_Y), 30, 10, eta=0.85, final_exact=False,
        generator=torch.Generator().manual_seed(7))
    for r, out in enumerate(world2["ranks"]):
        assert out["restore"]["rows"] == (3 * r, 3 * r + 3)
        np.testing.assert_allclose(out["restore"]["restored"].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
    # eta 0.85 draws noise: another noise seed gives another restore
    other = DDRMSampler(model, get_preset("webp")).sample(
        torch.from_numpy(RESTORE_Y), 30, 10, eta=0.85, final_exact=False,
        generator=torch.Generator().manual_seed(8))
    assert (other - want).abs().max().item() > 1e-3


def test_dryrun_world2(world2):
    """One FSDP step and a 2-step data-parallel restore over the world."""
    for out in world2["ranks"]:
        got = out["dryrun"]
        assert got["world"] == 2 and np.isfinite(got["loss"])
        assert got["restored_shape"] == (4, 16, 16, 3)
    assert world2["ranks"][0]["dryrun"]["loss"] == world2["ranks"][1]["dryrun"]["loss"]


def test_parallel_phase_counts_on_cpu(tmp_path, monkeypatch, counted_kernels, capsys):
    """chip_smoke.py's `parallel` phase on the CPU at width/16: part (a)
    under a world-1 gloo group in this process, part (b)'s two ranks
    spawned here (the script's own children need a card); every count the
    phase derives from its schedules must equal the calls reaching the
    kernels' call sites, and every gate must hold."""
    import chip_smoke
    from tests.test_torch_evaluate_phase import CPU_FLAGS

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "PARALLEL_BACKEND", "gloo")
    monkeypatch.setattr(chip_smoke, "RESTORE_FLAGS", [*CPU_FLAGS, "--max-evals", "4",
                                                      "--encoder-reuse", "2"])
    monkeypatch.setattr(chip_smoke, "CARD_FLAGS", CPU_FLAGS)
    monkeypatch.setattr(chip_smoke, "PARALLEL_MEMORY_SCALE", 16)
    monkeypatch.setattr(chip_smoke, "PARALLEL_TIMED_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "RESTORE_QUALITIES", (30,))
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "run_parallel_children",
                        lambda state, work: w.spawn(w.scenario_chip_child, 2,
                                                    Path(work) / "spawn", 16))
    state = {"smi": "CPU"}
    chip_smoke.phase_parallel(state)
    log = capsys.readouterr().out
    assert log.count("schedule implies") == 8, log  # each CLI plain, --dp, --dp, plain
    assert log.count("against the plain step") == 3, log
    assert "wrote the same 2 PNGs as the plain CLIs: True" in log, log
    for r in (0, 1):  # the ranks' own lines go to the spawned processes' output
        assert f"rank {r}: FSDP against the data mesh" in log, log
    counts = state["launches_parallel"]
    # 4 one-rank steps (plain twice, data mesh, FSDP), and per rank a
    # data-mesh, an FSDP and a model-axis step and the model axis's first
    # full-width step, 2 levels each
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 2 * (4 + 8)
    assert not (tmp_path / "build" / "chip_smoke_parallel").exists()
