"""Multi-process harness of the port's parallel tests: `spawn` runs a
function in N spawned ranks joined by gloo over a FileStore (no TCP port, so
xdist workers never collide), one thread each. This module imports no JAX,
so the ranks start quickly; each scenario returns what its rank saw, and
the tests compare it with the same work in one process."""

import multiprocessing as mp
import traceback
from pathlib import Path

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig, get_preset
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.parallel import mesh as pm
from ddpm_image_restoration_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_release_params,
)
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

# tests/_tiny.py MINI, in the port's config (no JAX here)
MINI = ModelConfig(image_size=16, enc_widths=(8, 16), bottleneck_widths=(16, 16), time_dim=32,
                   compute_dtype="float32")
SPAWN_TIMEOUT_S = 240


def spawn(fn, world: int, tmp: Path, *args) -> list:
    """fn(rank, world, tmp, *args) in `world` ranks; returns each rank's
    return value. Fails, with the ranks' tracebacks, when a rank fails or
    outlives SPAWN_TIMEOUT_S."""
    return start(fn, world, tmp, *args)()


def start(fn, world: int, tmp: Path, *args):
    """`spawn` without waiting: returns the function that waits for the
    ranks and returns their values."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()

    def join() -> list:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            errors = "\n".join(f.read_text() for f in sorted(tmp.glob("error_*.txt")))
            raise AssertionError(f"ranks exited with {codes} ({len(hung)} hung):\n{errors}")
        return [torch.load(tmp / f"result_{r}.pt", weights_only=False) for r in range(world)]

    return join


def _rank_main(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    try:
        pm.init_distributed("cpu", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank)
        out = fn(rank, world, Path(tmp), *args)
        torch.save(out, f"{tmp}/result_{rank}.pt")
        torch.distributed.destroy_process_group()
    except BaseException:
        Path(tmp, f"error_{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def make_batch(b: int = 8, s: int = 16, seed: int = 0) -> dict:
    """The JAX parallel tests' batch (tests/test_parallel.py `_batch`)."""
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.normal(0, 0.4, (b, s, s, 3)), -1, 1).astype(np.float32)
    xt = np.clip(x0 + rng.normal(0, 0.1, x0.shape), -1, 1).astype(np.float32)
    return {"x0": x0, "xt": xt, "t": rng.integers(1, 100, b).astype(np.int32),
            "quality": np.full((b,), 30, np.int32)}


def mini_model(weights=None, cfg: ModelConfig = MINI, codec: str = "webp"):
    """The MINI model of `codec` (WebP) on the CPU: PyTorch's init under seed
    0, or `weights` (a state_dict, or the path of a release npz)."""
    torch.manual_seed(0)
    model = build_model(codec, cfg, device="cpu")
    if weights is not None:
        model.load_state_dict(load_release_params(weights) if isinstance(weights, str)
                              else weights)
    return model


def train_cfg(dropout: float = 0.1, ema_decay: float = 0.9, fsdp: bool = False,
              batch: int = 8, codec: str = "webp", remat: bool = False) -> TrainConfig:
    import dataclasses

    return TrainConfig(codec=codec, model=dataclasses.replace(MINI, dropout=dropout,
                                                              remat=remat),
                       batch_size=batch, ema_decay=ema_decay, fsdp=fsdp)


def run_steps(cfg: TrainConfig, batch: dict, n_steps: int, mesh=None, weights=None) -> dict:
    """`n_steps` train steps of the MINI model (generator seed 3, the JAX
    tests' key) on `batch`, over `mesh` (this rank's rows) or in one
    process; the losses, grad norms, the state in the one-process layout,
    and each split parameter's numel in this rank's masters, moments and
    EMA."""
    model = mini_model(weights, cfg.model, cfg.codec)
    state = pm.put_state(create_train_state(model, cfg), mesh, fsdp=cfg.fsdp)
    step = make_train_step(model, cfg)
    local = {k: torch.from_numpy(pm.shard_batch(v, mesh)) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    losses, norms = [], []
    for _ in range(n_steps):
        m = step(state, local, gen)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    layout = state.layout
    held = {}
    if layout is not None:
        for k in layout.sharded:
            held[k] = {d: getattr(state, d)[k].numel() for d in ("params", "mu", "nu", "ema")
                       if getattr(state, d) is not None}
    module = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {"loss": losses, "grad_norm": norms, "state": state.state_dict(), "held": held,
            "sharded": [] if layout is None else list(layout.sharded), "module": module,
            "_state": state}


def scenario_many(rank, world, tmp, jobs):
    """Each (name, scenario, args) of `jobs` in turn, in one spawn."""
    return {name: fn(rank, world, tmp, *args) for name, fn, args in jobs}


def scenario_train(rank, world, tmp, cfg, batch, n_steps, weights=None):
    out = run_steps(cfg, batch, n_steps, pm.make_mesh(), weights)
    out.pop("_state")
    return out


def scenario_checkpoints(rank, world, tmp, cfg, batch):
    """One FSDP step, saved; then a fresh FSDP state loads the checkpoint
    that one process wrote (tmp/ck_one, written before the spawn) and
    returns it in the one-process layout."""
    mesh = pm.make_mesh()
    out = run_steps(cfg, batch, 1, mesh)
    CheckpointManager(str(tmp / "ck_fsdp")).save(1, out.pop("_state"), {"val_psnr": 1.0})
    fresh = pm.put_state(create_train_state(mini_model(), cfg), mesh, fsdp=True)
    CheckpointManager(str(tmp / "ck_one")).restore_latest(fresh)
    params = {n: p.detach().clone() for n, p in fresh.model.named_parameters()}
    return {"saved": out["state"], "loaded": fresh.state_dict(), "loaded_module": params,
            "loaded_held": {k: fresh.params[k].numel() for k in fresh.layout.sharded}}


def scenario_restore(rank, world, tmp, y, quality, steps, eta):
    """A data-parallel restore of `y` (every rank's rows, gathered)."""
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler

    mesh = pm.make_mesh()
    model = mini_model()
    rows = pm.shard_inference(model, len(y), mesh)
    mine = DDRMSampler(model, get_preset("webp")).sample(
        torch.from_numpy(y), quality, steps, eta=eta, rows=rows, final_exact=False,
        generator=torch.Generator().manual_seed(7))
    return {"rows": rows, "restored": pm.gather_batch(mine, mesh, len(y))}


def scenario_mesh_shapes(rank, world, tmp):
    """make_mesh's shapes and the ranks outside a smaller mesh."""
    out = {}
    for shape, axes in [((-1,), ("data",)), ((2,), ("data",)), ((2, 2), ("data", "model")),
                        ((-1, 2), ("data", "model"))]:
        m = pm.make_mesh(shape, axes)
        out[shape] = (dict(zip(m.mesh_dim_names, m.shape)), pm.data_rank(m))
    return out


def scenario_dryrun(rank, world, tmp):
    from ddpm_image_restoration_tpu_torch.parallel.dryrun import dryrun

    return dryrun("cpu")


def scenario_cli(rank, world, tmp, cli: str, argv: list) -> dict:
    """`cli/<cli>.py main(argv)` on this rank: what it printed, the floats it
    handed to `save_image` (by file name), its SystemExit message (None
    when it returned) and, for the trainer, (optimizer step, history)."""
    import contextlib
    import importlib
    import io
    import os

    mod = importlib.import_module(f"ddpm_image_restoration_tpu_torch.cli.{cli}")
    saved, printed, exit_msg, result = {}, io.StringIO(), None, None
    write = getattr(mod, "save_image", None)

    def save(path, x):
        saved[os.path.basename(path)] = np.array(x)
        write(path, x)

    if write is not None:
        mod.save_image = save
    try:
        with contextlib.redirect_stdout(printed):
            result = mod.main(argv)
    except SystemExit as e:
        exit_msg = str(e)
    finally:
        if write is not None:
            mod.save_image = write
    if isinstance(result, tuple):
        result = (None if result[0] is None else result[0].step, dict(result[1]))
    return {"saved": saved, "printed": printed.getvalue(), "exit": exit_msg, "result": result}


def scenario_chip_child(rank, world, tmp, scale):
    """chip_smoke.py's `parallel_child` on the CPU at widths/`scale`, one
    timed step, with the kernels' call sites counting as
    tests/test_torch_evaluate_phase.py has them count."""
    import chip_smoke
    from ddpm_image_restoration_tpu_torch.ops import attention
    from ddpm_image_restoration_tpu_torch.ops import flash_attention as fa
    from tests.test_torch_evaluate_phase import _counting

    fwd = _counting("flash_attention_fwd", fa.flash_attention_plain)
    fa.flash_attention_fwd = attention.flash_attention_fwd = fwd
    fa.flash_attention_bwd_dq = _counting("flash_attention_bwd_dq",
                                          fa.flash_attention_bwd_dq_plain)
    fa.flash_attention_bwd_dkv = _counting("flash_attention_bwd_dkv",
                                           fa.flash_attention_bwd_dkv_plain)
    chip_smoke.PARALLEL_TIMED_STEPS = 1
    chip_smoke.TRAIN_BATCH = 2
    chip_smoke.RESTORE_QUALITIES = (30,)
    chip_smoke.RESTORE_FLAGS = ["--device", "cpu", "--attn", "flash", "--attn-max-res", "32",
                                "--width-scale", str(scale), "--compute-dtype", "float32",
                                "--max-evals", "4", "--encoder-reuse", "2"]
    torch.cuda.synchronize = lambda *a, **k: None
    return chip_smoke.parallel_child(rank, world, str(tmp), device="cpu", scale=scale,
                                     memory_scale=scale)


# ---- the spatial-parallel restore (tests/test_torch_parallel_spatial.py)

def sp_op_cases(seed: int = 0) -> dict:
    """The edge-crossing ops of a split level, each as (module or None,
    input): seeded modules and NCHW inputs, the same in every process."""
    from torch import nn

    from ddpm_image_restoration_tpu_torch.models.freq_blocks import (
        AVIFFreqAwareBlock,
        DCTFreqAwareBlock,
    )
    from ddpm_image_restoration_tpu_torch.models.unet import SpatialSelfAttention

    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed)

    def x(*shape):
        return torch.randn(*shape, generator=g)

    gn = nn.GroupNorm(4, 8, eps=1e-6)
    with torch.no_grad():
        gn.weight.add_(0.3 * torch.randn(8))
        gn.bias.add_(0.3 * torch.randn(8))
    return {
        "conv": (nn.Conv2d(6, 5, 3, padding=1), x(2, 6, 32, 12)),
        "upsample": (None, x(2, 3, 16, 10)),
        "upsample_whole": (None, x(2, 3, 16, 10)),
        "group_norm": (gn, 3.0 + x(2, 8, 32, 12)),
        "attention": (SpatialSelfAttention(8, 2), x(2, 8, 32, 8)),
        "dct_block": (DCTFreqAwareBlock(8, 4, 2, (0.5, 1.5)), x(2, 8, 32, 16)),
        "avif_block": (AVIFFreqAwareBlock(16, 8), x(2, 16, 32, 32)),
        "pooled": (None, x(2, 4, 32, 32)),
        "pooled_resize": (None, x(2, 4, 24, 24)),
    }


def sp_op(name: str, module, x: torch.Tensor, sp):
    """Op `name` of `sp_op_cases` on this rank's rows of `x` (`sp` a
    SpatialLevel of x's height; None: the whole op); returns this rank's
    rows of its output (the pooled grid, whole, for 'pooled*')."""
    from ddpm_image_restoration_tpu_torch.parallel import spatial
    from ddpm_image_restoration_tpu_torch.parallel.spatial import SpatialLevel

    level = torch.full((x.shape[0],), 0.4)
    mine = spatial.take_rows(x, sp)
    with torch.no_grad():
        if name == "conv":
            return spatial.conv3x3(module, mine, sp)
        if name == "upsample":
            out_sp = None if sp is None else SpatialLevel(sp.mesh, 2 * sp.height)
            return spatial.upsample_2x(mine, sp, out_sp)
        if name == "upsample_whole":
            out_sp = None if sp is None else SpatialLevel(sp.mesh, 2 * sp.height)
            return spatial.upsample_2x(x, None, out_sp)
        if name == "group_norm":
            return spatial.group_norm(module, mine, sp)
        if name == "attention":
            return module(mine, sp)
        if name in ("dct_block", "avif_block"):
            return module(mine, level, sp)
        return torch.cat([spatial.pooled(mine, s, sp).flatten(2) for s in (1, 2, 4, 8)], dim=-1)


def scenario_sp_ops(rank, world, tmp):
    """Every op of `sp_op_cases` on this rank's rows, over a ('spatial',)
    mesh of every rank."""
    from ddpm_image_restoration_tpu_torch.parallel.spatial import SpatialLevel

    mesh = pm.make_mesh((-1,), ("spatial",))
    return {name: sp_op(name, mod, x, SpatialLevel(mesh, x.shape[2]))
            for name, (mod, x) in sp_op_cases().items()}


def sp_restore(codec: str, cfg: ModelConfig, npz: str, y: np.ndarray, eta: float,
               encoder_reuse: int, decoder_reuse_depth: int = 0, mesh=None) -> torch.Tensor:
    """The restore of the spatial tests (q30, steps 4, noise seed 7, no
    exact final projection) with the npz weights, over `mesh` (None: one
    process)."""
    from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler

    model = build_model(codec, cfg, device="cpu")
    model.load_state_dict(load_release_params(npz))
    pm.shard_inference_spatial(model, mesh)
    return DDRMSampler(model, get_preset(codec)).sample(
        torch.from_numpy(y), 30, 4, eta=eta, encoder_reuse=encoder_reuse,
        decoder_reuse_depth=decoder_reuse_depth, final_exact=False,
        generator=torch.Generator().manual_seed(7))


def scenario_sp_restores(rank, world, tmp, cases):
    """`sp_restore` of each (key, (codec, cfg, npz, y, eta, encoder_reuse,
    decoder_reuse_depth)) of `cases` over a ('spatial',) mesh of every
    rank."""
    mesh = pm.make_mesh((-1,), ("spatial",))
    return {key: sp_restore(*case, mesh=mesh) for key, case in cases}


# ---- the 'model' axis (tests/test_torch_parallel_model.py)

def scenario_tp_train(rank, world, tmp, shape, cfg, batch, n_steps, weights=None):
    """`run_steps` over a ('data', 'model') mesh of `shape`."""
    out = run_steps(cfg, batch, n_steps, pm.make_mesh(shape, ("data", "model")), weights)
    out.pop("_state")
    return out


def scenario_tp_checkpoints(rank, world, tmp, cfg, batch):
    """`scenario_checkpoints` on a (2, 2) ('data', 'model') mesh: one step,
    saved into tmp/ck_tp; then a fresh state loads tmp/ck_one (written by
    one process before the spawn)."""
    mesh = pm.make_mesh((2, 2), ("data", "model"))
    out = run_steps(cfg, batch, 1, mesh)
    CheckpointManager(str(tmp / "ck_tp")).save(1, out.pop("_state"), {"val_psnr": 1.0})
    fresh = pm.put_state(create_train_state(mini_model(), cfg), mesh, fsdp=cfg.fsdp)
    if CheckpointManager(str(tmp / "ck_one")).restore_latest(fresh) is None:
        raise FileNotFoundError(f"no checkpoint under {tmp / 'ck_one'}")
    module = {n: p.detach().clone() for n, p in fresh.model.named_parameters()}
    return {"saved": out["state"], "loaded": fresh.state_dict(), "loaded_module": module,
            "loaded_held": {k: fresh.params[k].numel() for k in fresh.layout.sharded}}


def scenario_tp_trainer(rank, world, tmp, cfg):
    """`train/loop.py train_model` for one epoch on 12 synthetic images on
    `cfg`'s mesh: (optimizer step, history, files in the checkpoint
    directory)."""
    import os

    from ddpm_image_restoration_tpu_torch.data.dataset import SyntheticImageDataset
    from ddpm_image_restoration_tpu_torch.train.loop import train_mesh, train_model

    mesh = train_mesh(cfg, cfg.effective_batch_size)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    state, hist = train_model(cfg, SyntheticImageDataset(12, cfg.model.image_size), epochs=1,
                              verbose=False, device="cpu")
    files = sorted(os.listdir(cfg.checkpoint_dir))
    return {"step": state.step, "history": dict(hist), "files": files, "mesh": shape}
