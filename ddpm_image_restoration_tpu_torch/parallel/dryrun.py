"""A multi-rank dry run of the parallel layer, the counterpart of the JAX
package's `__graft_entry__.py dryrun_multichip`:

    torchrun --nproc-per-node N -m ddpm_image_restoration_tpu_torch.parallel.dryrun

One FSDP train step on tiny shapes over every rank of the world: on a
(N/2, 2) ('data', 'model') mesh when N >= 4 and N is even (tensor
parallelism over pairs of ranks, the batch, 2 per data rank, over the data
axis, masters, moments and EMA split over both axes), else on a ('data',)
mesh of N. Then, from the step's weights, a 2-step data-parallel restore of
that batch over every rank, and a 2-step spatial-parallel restore of 2
images over every rank (each image's height split where
`parallel.spatial.split_plan` allows). `--device cpu` runs it under gloo;
without torchrun it is a world of one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig, get_preset
from ddpm_image_restoration_tpu_torch.device import resolve_device
from ddpm_image_restoration_tpu_torch.diffusion.ddrm import DDRMSampler
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.parallel.mesh import (
    data_size,
    gather_batch,
    init_distributed,
    make_mesh,
    put_state,
    shard_batch,
    shard_inference,
    shard_inference_spatial,
    world_size,
)
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

TINY = ModelConfig(image_size=16, enc_widths=(8, 16), bottleneck_widths=(16, 16), time_dim=32,
                   compute_dtype="float32")


def dryrun(device: str | torch.device = "cuda") -> dict:
    """Run the dry run on this rank (every rank of the world calls it);
    returns {'world', 'mesh', 'loss', 'restored_shape', 'sp_restored_shape'}.
    Raises on a non-finite loss or restoration."""
    init_distributed(device)
    dev = resolve_device(device)
    world = world_size()
    if world >= 4 and world % 2 == 0:
        shape, axes = (world // 2, 2), ("data", "model")
    else:
        shape, axes = (world,), ("data",)
    mesh = make_mesh(shape, axes)
    cfg = TrainConfig(codec="webp", model=TINY, batch_size=2 * data_size(mesh), fsdp=True,
                      mesh_shape=shape, mesh_axes=axes, ema_decay=0.999)

    def tiny_model():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return build_model(cfg.codec, cfg.model, device="cpu").to(dev)

    state = put_state(create_train_state(tiny_model(), cfg), mesh, fsdp=cfg.fsdp)
    b, s = cfg.effective_batch_size, cfg.model.image_size
    rng = np.random.default_rng(0)
    batch = {
        "x0": np.clip(rng.normal(0, 0.4, (b, s, s, 3)), -1, 1).astype(np.float32),
        "xt": np.clip(rng.normal(0, 0.4, (b, s, s, 3)), -1, 1).astype(np.float32),
        "t": rng.integers(1, 100, b).astype(np.int32),
    }
    local = {k: torch.from_numpy(shard_batch(v, mesh)).to(dev) for k, v in batch.items()}
    metrics = make_train_step(state.model, cfg)(state, local,
                                                torch.Generator(device=dev).manual_seed(1))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # the restores take the step's weights, whole, in a model of their own
    params = state.state_dict()["params"]
    y = torch.from_numpy(batch["xt"]).to(dev)
    out = {"world": world, "mesh": dict(zip(axes, shape)), "loss": loss}
    for name, axis, n_images in (("restored_shape", "data", b), ("sp_restored_shape",
                                                                 "spatial", 2)):
        model = tiny_model()
        model.load_state_dict(params)
        sub = make_mesh((world,), (axis,))
        sampler = DDRMSampler(model, get_preset(cfg.codec))
        gen = torch.Generator(device=dev).manual_seed(0)
        if axis == "data":
            mine = sampler.sample(y, 30, 2, rows=shard_inference(model, b, sub), generator=gen)
            restored = gather_batch(mine, sub, b)
        else:
            shard_inference_spatial(model, sub)
            restored = sampler.sample(y[:n_images], 30, 2, generator=gen)
        if not torch.isfinite(restored).all():
            raise AssertionError(f"non-finite {axis}-parallel restoration")
        out[name] = tuple(restored.shape)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Multi-rank dry run of the parallel layer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = dryrun(args.device)
    if torch.distributed.is_initialized():
        if torch.distributed.get_rank() == 0:
            print(f"dryrun over {out['world']} rank(s), mesh {out['mesh']}: FSDP step loss "
                  f"{out['loss']:.6f}, data-parallel restore {out['restored_shape']}, "
                  f"spatial-parallel restore {out['sp_restored_shape']}", flush=True)
        torch.distributed.destroy_process_group()
    else:
        print(f"dryrun in one process: loss {out['loss']:.6f}, restore "
              f"{out['restored_shape']}, spatial restore {out['sp_restored_shape']}", flush=True)
    return out


if __name__ == "__main__":
    main()
