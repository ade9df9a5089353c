"""A multi-rank dry run of the parallel layer (the counterpart of the JAX
package's `__graft_entry__.py dryrun_multichip`, without its 'model' axis
and spatial-parallel restore, which the port does not have):

    torchrun --nproc-per-node N -m ddpm_image_restoration_tpu_torch.parallel.dryrun

One FSDP train step on tiny shapes over every rank of the world (the batch,
2 per rank, over the data axis; masters, moments and EMA split), then a
2-step data-parallel restore of that batch. `--device cpu` runs it under
gloo; without torchrun it is a world of one.
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
    world_size,
)
from ddpm_image_restoration_tpu_torch.train.steps import create_train_state, make_train_step

TINY = ModelConfig(image_size=16, enc_widths=(8, 16), bottleneck_widths=(16, 16), time_dim=32,
                   compute_dtype="float32")


def dryrun(device: str | torch.device = "cuda") -> dict:
    """Run the dry run on this rank (every rank of the world calls it);
    returns {'world', 'loss', 'restored_shape'}. Raises on a non-finite
    loss or restoration."""
    init_distributed(device)
    dev = resolve_device(device)
    world = world_size()
    mesh = make_mesh((-1,), ("data",))
    cfg = TrainConfig(codec="webp", model=TINY, batch_size=2 * world, fsdp=True,
                      ema_decay=0.999)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg.codec, cfg.model, device="cpu").to(dev)
    state = put_state(create_train_state(model, cfg), mesh, fsdp=cfg.fsdp)

    b, s = cfg.effective_batch_size, cfg.model.image_size
    rng = np.random.default_rng(0)
    batch = {
        "x0": np.clip(rng.normal(0, 0.4, (b, s, s, 3)), -1, 1).astype(np.float32),
        "xt": np.clip(rng.normal(0, 0.4, (b, s, s, 3)), -1, 1).astype(np.float32),
        "t": rng.integers(1, 100, b).astype(np.int32),
    }
    local = {k: torch.from_numpy(shard_batch(v, mesh)).to(dev) for k, v in batch.items()}
    metrics = make_train_step(model, cfg)(state, local,
                                          torch.Generator(device=dev).manual_seed(1))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    sampler = DDRMSampler(model, get_preset(cfg.codec))
    y = torch.from_numpy(batch["xt"]).to(dev)
    rows = shard_inference(model, b, mesh)
    mine = sampler.sample(y, 30, 2, rows=rows, generator=torch.Generator(device=dev).manual_seed(0))
    restored = gather_batch(mine, mesh, b)
    if not torch.isfinite(restored).all():
        raise AssertionError("non-finite restoration")
    return {"world": data_size(mesh), "loss": loss, "restored_shape": tuple(restored.shape)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Multi-rank dry run of the parallel layer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = dryrun(args.device)
    if torch.distributed.is_initialized():
        if torch.distributed.get_rank() == 0:
            print(f"dryrun over {out['world']} rank(s): FSDP step loss {out['loss']:.6f}, "
                  f"data-parallel restore {out['restored_shape']}", flush=True)
        torch.distributed.destroy_process_group()
    else:
        print(f"dryrun in one process: loss {out['loss']:.6f}, restore "
              f"{out['restored_shape']}", flush=True)
    return out


if __name__ == "__main__":
    main()
