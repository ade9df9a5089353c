"""Device mesh and sharding on torch.distributed (port of parallel/mesh.py).

The JAX package drives every device from one process and annotates
shardings; PyTorch runs one process per device. So here the ranks of the
process group play the part of `jax.devices()`: on cards each rank uses
`cuda:LOCAL_RANK` under NCCL, on the CPU the ranks use gloo, and a process
started without `torchrun` (no process group) is a world of one, in which
`make_mesh` returns None and every function below that takes a mesh is the
identity.

Layouts over the ('data',) axis, as in the JAX package:
  * data parallelism: each rank takes a contiguous block of the leading
    (batch) axis, the batch padded to a multiple of the mesh; parameters are
    replicated; gradients are averaged over the mesh in f32 before the
    optimizer, so a step equals the one-process step on the whole batch up
    to the order of f32 sums.
  * FSDP / ZeRO-3 (`fsdp=True`): each large f32 master, both Adam moments
    and the EMA are split over the mesh along the axis `param_shardings`
    picks (the JAX `_fsdp_spec` rule on the parameter in the JAX layout);
    gradients are reduce-scattered into those shards, the global gradient
    norm is all-reduced, AdamW and the EMA update the shards, and the
    module's weights (bf16 body, f32 norms) are all-gathered after the step.
    The JAX package's `shard_train_step` has no function of its own here:
    `put_state` gives the state its layout (`ShardedState`), and the step of
    `train/steps.py make_train_step` follows it.

Random draws that the JAX package makes for the whole sharded batch (the
dropout masks, the sampler's eta noise) are drawn here for the whole batch
by every rank, which keeps its own rows (`take_rows`): each rank pays the
RNG work of the whole batch, and a sharded run draws what one process
would.

The 'model' (tensor-parallel) axis and the spatial-parallel restore are
not ported: `make_mesh` builds any mesh, and its users refuse the axes they
do not implement.

Every collective goes through the helpers below, the one place where gloo
and NCCL differ: under gloo, CUDA tensors are copied through host memory for
each collective (gloo's CUDA support differs between torch releases: some
lack reduce-scatter and all-gather of CUDA tensors).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ddpm_image_restoration_tpu_torch.device import local_rank, resolve_device
from ddpm_image_restoration_tpu_torch.train.checkpoint import jax_layout

DATA = "data"


def init_distributed(device: str | torch.device = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join a process group: the one `torchrun`'s environment describes, or
    the one `init_method` (e.g. 'file:///tmp/store'), `world_size` and
    `rank` name. The backend defaults to NCCL on CUDA and gloo on the CPU;
    on CUDA it selects `cuda:LOCAL_RANK` first. Returns whether a process
    group is up: False, with nothing done, when neither is given (one
    process). A second call returns True at once."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    dev_type = resolve_device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if dev_type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    if backend == "gloo" and dev_type == "cuda":
        print(f"rank {dist.get_rank()}: gloo on CUDA tensors: every collective copies "
              "them through host memory", flush=True)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = (DATA,)):
    """A `DeviceMesh` over the first prod(shape) ranks; one axis may be -1
    (it absorbs the ranks the others leave). Every rank must call it (it
    creates process groups); a rank outside the mesh gets one whose
    `get_coordinate()` is None. Without a process group: None, and the
    shape must come to one rank."""
    from torch.distributed.device_mesh import DeviceMesh

    world = world_size()
    shape = list(shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1) or 1
        shape[shape.index(-1)] = world // known
    n = math.prod(shape)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; the world has "
                         f"{world}")
    if not dist.is_initialized():
        return None
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def data_size(mesh) -> int:
    """Ranks along the mesh's 'data' axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(DATA))


def data_rank(mesh) -> Optional[int]:
    """This rank's coordinate on the 'data' axis: 0 without a mesh, None
    for a rank outside it."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    return None if coord is None else coord[mesh.mesh_dim_names.index(DATA)]


# ---- collectives over the 'data' axis (the one place gloo and NCCL differ)

def _group(mesh):
    return mesh.get_group(DATA)


def _via_host(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _call(op, group, out: torch.Tensor, inp: Optional[torch.Tensor] = None) -> None:
    """op(out, inp, group) with CUDA tensors staged through host memory under
    gloo; `inp` None for in-place ops."""
    staged = _via_host(group, out)
    o = out.cpu() if staged else out
    i = None if inp is None else (inp.cpu() if staged else inp)
    with warnings.catch_warnings():
        # torch 2.13 renames all_gather_into_tensor/reduce_scatter_tensor;
        # older releases (the card's) have only these names
        warnings.simplefilter("ignore", FutureWarning)
        op(o, i, group)
    if staged:
        out.copy_(o)


def all_reduce_(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `x` over the data axis, in place."""
    if mesh is not None:
        _call(lambda o, _, g: dist.all_reduce(o, group=g), _group(mesh), x)
    return x


def broadcast_(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` from data rank 0 to every rank of the axis, in place."""
    if mesh is not None:
        g = _group(mesh)
        _call(lambda o, _, g: dist.broadcast(o, dist.get_global_rank(g, 0), group=g), g, x)
    return x


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `x` stacked along the leading axis, in data-rank order."""
    if mesh is None:
        return x
    x = x.contiguous()
    out = x.new_empty((data_size(mesh) * x.shape[0], *x.shape[1:]))
    _call(lambda o, i, g: dist.all_gather_into_tensor(o, i, group=g), _group(mesh), out, x)
    return out


def reduce_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the data axis of `x`'s r-th block of leading rows, on
    data rank r (`x.shape[0]` a multiple of the axis size)."""
    if mesh is None:
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // data_size(mesh), *x.shape[1:]))
    _call(lambda o, i, g: dist.reduce_scatter_tensor(o, i, group=g), _group(mesh), out, x)
    return out


def broadcast_object(obj, mesh):
    """A picklable object from data rank 0 (every rank returns it)."""
    if mesh is None:
        return obj
    g = _group(mesh)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(g, 0), group=g)
    return box[0]


def barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=_group(mesh))


def replicated(tensors: nn.Module | Iterable[torch.Tensor], mesh) -> None:
    """Make every rank hold data rank 0's values of `tensors` (a module's
    parameters and buffers, or a list), in place."""
    if mesh is None:
        return
    if isinstance(tensors, nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = broadcast_(_flatten_dense_tensors([t.detach() for t in ts]), mesh)
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)


# ---- batches

def shard_rows(n_rows: int, mesh) -> Tuple[int, int]:
    """(start, stop) of this rank's block of a batch of `n_rows` padded to a
    multiple of the data axis (`stop` may pass `n_rows`: padding)."""
    per = -(-n_rows // data_size(mesh))
    r = data_rank(mesh)
    return r * per, (r + 1) * per


def take_rows(x, rows: Optional[Tuple[int, int]], axis: int = 0):
    """Rows start..stop-1 of `x` (a tensor or numpy array) along `axis`, a
    copy; indices past the end repeat the last row (padding, whose results
    the caller drops). `rows` None: `x` itself."""
    if rows is None:
        return x
    idx = np.minimum(np.arange(*rows), x.shape[axis] - 1)
    if isinstance(x, np.ndarray):
        return np.take(x, idx, axis=axis)
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def shard_batch(x, mesh):
    """This rank's rows of the batch `x` (padded to a multiple of the
    mesh); the JAX package's `batch_sharding` placement."""
    return x if mesh is None else take_rows(x, shard_rows(x.shape[0], mesh))


def gather_batch(local: torch.Tensor, mesh, n_rows: int) -> torch.Tensor:
    """The whole batch of `n_rows` from every rank's `shard_batch` rows (on
    every rank)."""
    return local if mesh is None else all_gather(local, mesh)[:n_rows]


def shard_inference(model: nn.Module, n_rows: int, mesh) -> Optional[Tuple[int, int]]:
    """Data-parallel restoration placement: the model's weights replicated
    from data rank 0, and this rank's (start, stop) rows of a batch of
    `n_rows` (None without a mesh), which `DDRMSampler.sample(..., rows=)`
    restores. Restoration has no cross-sample communication: the sampler
    draws the noise of the whole batch and keeps these rows, so the rows
    come out as a one-process restore of the whole batch gives them."""
    if mesh is None:
        return None
    replicated(model, mesh)
    return shard_rows(n_rows, mesh)


# ---- FSDP

def fsdp_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The JAX package's `_fsdp_spec` on an unsharded spec: the largest axis
    that `n` divides with at least 2n entries (the first of equal ones), or
    None (replicated)."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= 2 * n:
            return i
    return None


def param_shardings(model: nn.Module, mesh, fsdp: bool = False) -> Dict[str, Optional[int]]:
    """For each parameter name, the axis of the port's tensor that is split
    over the data axis, or None (replicated). With `fsdp` and more than one
    rank it is the axis `fsdp_dim` picks in the JAX package's layout of the
    same parameter (HWIO convolutions, [in, out] dense kernels), mapped to
    the port's; otherwise every parameter is replicated."""
    n = data_size(mesh) if fsdp else 1
    dims = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            _, order = jax_layout(module, p_name, p.dim())
            j = fsdp_dim([p.shape[k] for k in order], n) if n > 1 else None
            dims[name] = None if j is None else order[j]
    return dims


class ShardedState:
    """How a `TrainState`'s f32 tensors (masters, Adam moments, EMA) lie over
    a data mesh, and the train step's collectives. A parameter that
    `param_shardings` splits along axis d is held by data rank r as the r-th
    of n equal blocks of `movedim(d, 0)`, flattened; the others are held
    whole on every rank."""

    def __init__(self, model: nn.Module, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.n = data_size(mesh)
        self.rank = data_rank(mesh)
        self.dims = param_shardings(model, mesh, fsdp)
        params = dict(model.named_parameters())
        self.shapes = {k: p.shape for k, p in params.items()}
        self.sharded = [k for k, d in self.dims.items() if d is not None]
        self.replicated = [k for k, d in self.dims.items() if d is None]
        # all-gathered after each step in the module's own dtype, per dtype
        self.gather_groups: Dict[torch.dtype, List[str]] = {}
        for k in self.sharded:
            self.gather_groups.setdefault(params[k].dtype, []).append(k)

    def _numel(self, k: str) -> int:
        return math.prod(self.shapes[k]) // self.n

    def _blocks(self, k: str, x: torch.Tensor) -> torch.Tensor:
        """[n, numel/n]: the n blocks of `x` (shaped like parameter k)."""
        return x.movedim(self.dims[k], 0).reshape(self.n, -1)

    def _whole(self, k: str, blocks: torch.Tensor) -> torch.Tensor:
        """Inverse of `_blocks` (a view when it can be)."""
        d, shape = self.dims[k], self.shapes[k]
        moved = (shape[d], *(s for i, s in enumerate(shape) if i != d))
        return blocks.reshape(moved).movedim(0, d)

    def local(self, k: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of `full` (shaped like parameter k): its block,
        a new tensor, or `full` itself when k is replicated."""
        if self.dims[k] is None:
            return full
        return self._blocks(k, full)[self.rank].clone()

    def reduce_grads(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The mean over the mesh of each parameter's gradient, in f32
        (zeros where the loss did not reach): this rank's block of it for a
        split parameter (one reduce-scatter), the whole of it otherwise (one
        all-reduce)."""
        grads = {n: p.grad for n, p in model.named_parameters()}
        dev = next(model.parameters()).device

        def grad(k):
            g = grads[k]
            return torch.zeros(self.shapes[k], device=dev) if g is None else g

        out = {}
        if self.sharded:
            sizes = [self._numel(k) for k in self.sharded]
            buf = torch.empty((self.n, sum(sizes)), dtype=torch.float32, device=dev)
            for k, part in zip(self.sharded, buf.split(sizes, dim=1)):
                part.copy_(self._blocks(k, grad(k)))
            mine = reduce_scatter(buf.reshape(-1), self.mesh).div_(self.n)
            out.update(zip(self.sharded, mine.split(sizes)))
        if self.replicated:
            flat = torch.cat([grad(k).float().reshape(-1) for k in self.replicated])
            all_reduce_(flat, self.mesh).div_(self.n)
            out.update((k, v.view(self.shapes[k]))
                       for k, v in zip(self.replicated,
                                       flat.split([math.prod(self.shapes[k])
                                                   for k in self.replicated])))
        return {k: out[k] for k in self.dims}

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """The global norm of the reduced `grads` when some are split over
        the mesh (each rank's blocks, plus the replicated ones once, summed
        over the mesh); None when every rank holds them all, where the
        optimizer computes it as in one process."""
        if not self.sharded:
            return None

        def sq(ts):
            if not ts:
                return torch.zeros((), device=grads[self.sharded[0]].device)
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts))) ** 2

        total = sq([grads[k] for k in self.sharded])
        if self.rank == 0:
            total = total + sq([grads[k] for k in self.replicated])
        return all_reduce_(total, self.mesh).sqrt()

    def barrier(self) -> None:
        barrier(self.mesh)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the mesh of the 0-d (or any) tensor `x`."""
        return all_reduce_(x.detach().clone(), self.mesh) / self.n

    def gather_into(self, model: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
        """Write `tensors` (masters or EMA, in this layout) into `model`'s
        parameters, rounded to each parameter's dtype: the split ones
        all-gathered in that dtype, one collective per dtype."""
        params = dict(model.named_parameters())
        with torch.no_grad():
            for k in self.replicated:
                if params[k].data_ptr() != tensors[k].data_ptr():
                    params[k].copy_(tensors[k])
            for dtype, names in self.gather_groups.items():
                mine = torch.cat([tensors[k].to(dtype) for k in names])
                full = all_gather(mine, self.mesh).reshape(self.n, -1)
                for k, part in zip(names, full.split([self._numel(k) for k in names], dim=1)):
                    params[k].copy_(self._whole(k, part))

    def full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`tensors` in the one-process layout, on the CPU (a collective:
        every rank of the mesh calls it)."""
        out = {k: tensors[k].detach().cpu() for k in self.replicated}
        if self.sharded:
            full = all_gather(torch.cat([tensors[k] for k in self.sharded]),
                              self.mesh).reshape(self.n, -1)
            for k, part in zip(self.sharded,
                               full.split([self._numel(k) for k in self.sharded], dim=1)):
                out[k] = self._whole(k, part).contiguous().cpu()
        return {k: out[k] for k in tensors}


def put_state(state, mesh, fsdp: bool = False):
    """Place a one-process `TrainState` on the mesh, in place: data rank 0's
    masters, moments and EMA on every rank, then, with `fsdp`, each rank
    keeps its blocks of the split ones (`ShardedState`); the module takes
    the masters. The train step and checkpoints follow `state.layout`.
    Without a mesh: `state` as it is."""
    if mesh is None:
        return state
    dicts = [state.params, state.mu, state.nu] + ([state.ema] if state.ema is not None else [])
    for d in dicts:
        replicated(list(d.values()), mesh)
    layout = ShardedState(state.model, mesh, fsdp)
    for d in dicts:
        for k in layout.sharded:
            d[k] = layout.local(k, d[k])
    state.layout = layout
    state.write_back()
    return state
