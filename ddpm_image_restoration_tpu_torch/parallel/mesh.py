"""Device mesh and sharding on torch.distributed (port of parallel/mesh.py).

The JAX package drives every device from one process and annotates
shardings; PyTorch runs one process per device. So here the ranks of the
process group play the part of `jax.devices()`: on cards each rank uses
`cuda:LOCAL_RANK` under NCCL, on the CPU the ranks use gloo, and a process
started without `torchrun` (no process group) is a world of one, in which
`make_mesh` returns None and every function below that takes a mesh is the
identity.

Layouts, as in the JAX package:
  * 'data' axis, data parallelism: each rank takes a contiguous block of the
    leading (batch) axis, the batch padded to a multiple of the axis;
    gradients are averaged over the axis in f32 before the optimizer, so a
    step equals the one-process step on the whole batch up to the order of
    f32 sums.
  * 'data' axis, FSDP / ZeRO-3 (`fsdp=True`): each large f32 master, both
    Adam moments and the EMA are split over the axis along the dimension
    `param_shardings` picks (the JAX `_fsdp_spec` rule on the parameter in
    the JAX layout); gradients are reduce-scattered into those blocks, the
    global gradient norm is all-reduced, AdamW and the EMA update the
    blocks, and the module's weights are all-gathered after the step.
  * 'model' axis, tensor parallelism: the JAX `_kernel_spec` rule splits a
    parameter's trailing (output) axis in the JAX layout. Every
    `nn.Conv2d`/`nn.Linear` whose output channels it splits becomes
    column-parallel (`shard_module`): each model rank holds its block of
    output channels of the weight and bias, in the module as in the f32
    master, both moments and the EMA, computes those channels, and the
    output is all-gathered along the channels (`_GatherChannels`); the
    backward takes this rank's slice of the output gradient and all-reduces
    the input gradient over the axis (`_SumInputGrad`). Every other
    parameter the rule splits (GroupNorm affines, embeddings, the AVIF
    transform weights) keeps its master and moments split and is
    all-gathered into the module after each step, as FSDP does. Downstream
    of each gather every model rank computes the same thing, so the
    gradient of a parameter the module holds whole is the same on every
    model rank and is never summed over 'model'. A ('data', 'model') mesh
    takes both, with or without FSDP (which then splits another dimension
    of each parameter over 'data'). The JAX package's `shard_train_step`
    has no function of its own here: `put_state` gives the state its layout
    (`ShardedState`), and the step of `train/steps.py make_train_step`
    follows it.
  * 'spatial' axis, the spatial-parallel restore (`shard_inference_spatial`,
    parallel/spatial.py): the image height of one batch split over the
    ranks inside the model, with halo exchanges, all-reduced statistics
    and gathers where a level's ops cross the shard edges.

Random draws that the JAX package makes for the whole sharded batch (the
dropout masks, the sampler's eta noise) are drawn here for the whole batch
by every rank, which keeps its own rows (`take_rows`): each rank pays the
RNG work of the whole batch, and a sharded run draws what one process
would. The model ranks of one data rank draw the same masks.

Every collective goes through the helpers below, over one named axis of the
mesh, the one place where gloo and NCCL differ: under gloo, CUDA tensors are
copied through host memory for each collective (gloo's CUDA support differs
between torch releases: some lack reduce-scatter and all-gather of CUDA
tensors).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ddpm_image_restoration_tpu_torch.device import local_rank, resolve_device
from ddpm_image_restoration_tpu_torch.train.checkpoint import jax_layout

DATA, MODEL, SPATIAL = "data", "model", "spatial"


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


def axis_size(mesh, axis: str = DATA) -> int:
    """Ranks along the mesh's `axis` (1 without a mesh or that axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str = DATA) -> Optional[int]:
    """This rank's coordinate on `axis`: 0 without a mesh or that axis, None
    for a rank outside the mesh."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    return coord[mesh.mesh_dim_names.index(axis)] if axis in mesh.mesh_dim_names else 0


def data_size(mesh) -> int:
    """Ranks along the mesh's 'data' axis (1 without a mesh)."""
    return axis_size(mesh, DATA)


def data_rank(mesh) -> Optional[int]:
    """This rank's coordinate on the 'data' axis: 0 without a mesh, None
    for a rank outside it."""
    return axis_rank(mesh, DATA)


def is_main(mesh) -> bool:
    """Whether this rank is the mesh's first (coordinate 0 on every axis):
    the one that logs and writes files. True without a mesh."""
    if mesh is None:
        return True
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


# ---- collectives over one axis (the one place gloo and NCCL differ); the
# identity without a mesh or when the mesh lacks the axis

def _has(mesh, axis: str) -> bool:
    return mesh is not None and axis in mesh.mesh_dim_names


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


def all_reduce_(x: torch.Tensor, mesh, axis: str = DATA) -> torch.Tensor:
    """Sum `x` over `axis`, in place."""
    if _has(mesh, axis):
        _call(lambda o, _, g: dist.all_reduce(o, group=g), mesh.get_group(axis), x)
    return x


def broadcast_(x: torch.Tensor, mesh, axis: str = DATA) -> torch.Tensor:
    """`x` from coordinate 0 of `axis` to every rank of the axis, in place."""
    if _has(mesh, axis):
        g = mesh.get_group(axis)
        _call(lambda o, _, g: dist.broadcast(o, dist.get_global_rank(g, 0), group=g), g, x)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str = DATA) -> torch.Tensor:
    """Every rank's `x` stacked along the leading axis, in `axis` order."""
    if not _has(mesh, axis):
        return x
    x = x.contiguous()
    out = x.new_empty((axis_size(mesh, axis) * x.shape[0], *x.shape[1:]))
    _call(lambda o, i, g: dist.all_gather_into_tensor(o, i, group=g), mesh.get_group(axis),
          out, x)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axis: str = DATA) -> torch.Tensor:
    """The sum over `axis` of `x`'s r-th block of leading rows, on rank r of
    the axis (`x.shape[0]` a multiple of the axis size)."""
    if not _has(mesh, axis):
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // axis_size(mesh, axis), *x.shape[1:]))
    _call(lambda o, i, g: dist.reduce_scatter_tensor(o, i, group=g), mesh.get_group(axis),
          out, x)
    return out


def gather_dim(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in `axis` order, as a
    contiguous tensor."""
    if not _has(mesh, axis):
        return x
    n = axis_size(mesh, axis)
    out = all_gather(x.unsqueeze(0), mesh, axis)                 # [n, *x.shape]
    dim = dim % x.dim()
    return out.movedim(0, dim).reshape(*x.shape[:dim], n * x.shape[dim],
                                       *x.shape[dim + 1:]).contiguous()


def broadcast_object(obj, mesh, axis: str = DATA):
    """A picklable object from coordinate 0 of `axis` (every rank of the
    axis returns it)."""
    if not _has(mesh, axis):
        return obj
    g = mesh.get_group(axis)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(g, 0), group=g)
    return box[0]


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (one barrier per axis, in turn)."""
    if mesh is not None:
        for axis in mesh.mesh_dim_names:
            dist.barrier(group=mesh.get_group(axis))


def replicated(tensors: nn.Module | Iterable[torch.Tensor], mesh) -> None:
    """Make every rank of the mesh hold the first rank's values of `tensors`
    (a module's parameters and buffers, or a list), in place: a broadcast
    over each axis in turn."""
    if mesh is None:
        return
    if isinstance(tensors, nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = _flatten_dense_tensors([t.detach() for t in ts])
            for axis in mesh.mesh_dim_names:
                broadcast_(flat, mesh, axis)
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
    """This rank's rows of the batch `x` (padded to a multiple of the data
    axis); the JAX package's `batch_sharding` placement."""
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


def shard_inference_spatial(model: nn.Module, mesh) -> nn.Module:
    """Spatial-parallel restoration placement over a ('spatial',) mesh: the
    model's weights replicated from spatial rank 0, and the mesh set on the
    model, whose `encode`/`decode` then split the image height of whatever
    they are given over the ranks (parallel/spatial.py; the split levels
    follow `spatial.split_plan`). The solver and its inputs stay whole and
    replicated on every rank: the model's 3-channel output is all-gathered,
    and every rank draws the same noise, so each rank holds what one
    process computes. Without a mesh: the model as it is."""
    if mesh is not None:
        replicated(model, mesh)
    model.spatial_mesh = mesh
    return model


# ---- parameter layouts: FSDP over 'data', tensor parallelism over 'model'

class Split(NamedTuple):
    """The dimensions of a parameter (the port's tensor) split over the
    mesh's 'model' and 'data' axes; None where it is not."""

    model: Optional[int] = None
    data: Optional[int] = None


def kernel_dim(shape: Sequence[int], m: int) -> Optional[int]:
    """The JAX package's `_kernel_spec` on a parameter in the JAX layout:
    its trailing (output) axis when `m` divides it and it has at least 2m
    entries, else None (replicated)."""
    if not shape or m < 2:
        return None
    return len(shape) - 1 if shape[-1] % m == 0 and shape[-1] >= 2 * m else None


def fsdp_dim(shape: Sequence[int], n: int, taken: Optional[int] = None) -> Optional[int]:
    """The JAX package's `_fsdp_spec`: the largest axis other than `taken`
    (the one the 'model' axis splits) that `n` divides with at least 2n
    entries (the first of equal ones), or None (replicated)."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != taken and shape[i] % n == 0 and shape[i] >= 2 * n:
            return i
    return None


def param_shardings(model: nn.Module, mesh, fsdp: bool = False) -> Dict[str, Split]:
    """For each parameter name, the dimensions of the port's tensor split
    over the 'model' axis (`kernel_dim`) and, with `fsdp`, over the 'data'
    axis (`fsdp_dim`), each picked in the JAX package's layout of the
    parameter (HWIO convolutions, [in, out] dense kernels) and mapped to the
    port's; `Split()` where nothing is split (always without a mesh)."""
    m = axis_size(mesh, MODEL)
    n = axis_size(mesh, DATA) if fsdp else 1
    splits = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            _, order = jax_layout(module, p_name, p.dim())
            shape = [p.shape[k] for k in order]
            mj = kernel_dim(shape, m)
            dj = fsdp_dim(shape, n, mj) if n > 1 else None
            splits[name] = Split(None if mj is None else order[mj],
                                 None if dj is None else order[dj])
    return splits


def column_parallel_modules(model: nn.Module, splits: Dict[str, Split]) -> List[str]:
    """The names of `model`'s `nn.Conv2d`/`nn.Linear` modules whose output
    channels (the port's dimension 0) `splits` puts over 'model'."""
    return [name for name, mod in model.named_modules()
            if isinstance(mod, (nn.Conv2d, nn.Linear))
            and splits[f"{name}.weight" if name else "weight"].model == 0]


class _SumInputGrad(torch.autograd.Function):
    """The identity forward; the backward all-reduces the gradient over
    'model' (a column-parallel layer's input: each model rank's channels
    contribute their part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.mesh,
                           MODEL), None


class _GatherChannels(torch.autograd.Function):
    """The forward all-gathers a column-parallel layer's output along its
    channel dimension `dim` over 'model' (contiguous, in model-rank order);
    the backward keeps this rank's slice of the output gradient (the same on
    every model rank, as everything downstream is)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, y.shape[dim]
        return gather_dim(y, dim, mesh, MODEL)

    @staticmethod
    def backward(ctx, grad):
        r = axis_rank(ctx.mesh, MODEL)
        return grad.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


def _column_parallel(module: nn.Module, mesh) -> None:
    """Make `module` (its weight and bias already this rank's blocks)
    column-parallel: its input passes `_SumInputGrad`, its output
    `_GatherChannels`."""
    dim = 1 if isinstance(module, nn.Conv2d) else -1
    module.register_forward_pre_hook(
        lambda mod, args: (_SumInputGrad.apply(args[0], mesh), *args[1:]))
    module.register_forward_hook(lambda mod, args, out: _GatherChannels.apply(out, mesh, dim))
    module.column_parallel = True


class ShardedState:
    """How a `TrainState`'s f32 tensors (masters, Adam moments, EMA) lie over
    a ('data',) or ('data', 'model') mesh, and the train step's collectives.
    A parameter that `param_shardings` splits is held by the rank at (data
    rank d, model rank r) as the r-th of m chunks along its 'model'
    dimension, and of that the d-th of n chunks along its 'data'
    dimension (a contiguous tensor); the others are held whole on every
    rank. The module holds the model chunk of a column-parallel layer's
    weight and bias, and every other parameter whole."""

    def __init__(self, model: nn.Module, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.n, self.rank = data_size(mesh), data_rank(mesh)
        self.m, self.mrank = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
        self.main = is_main(mesh)
        self.splits = param_shardings(model, mesh, fsdp)
        self.column_modules = column_parallel_modules(model, self.splits)
        cols = set(self.column_modules)
        self.in_module = {k for k in self.splits if k.rpartition(".")[0] in cols}
        self.shapes = {k: p.shape for k, p in model.named_parameters()}
        self.sharded = [k for k, s in self.splits.items() if s != Split()]
        self.replicated = [k for k, s in self.splits.items() if s == Split()]

    # -- blocks

    def _model_chunk(self, k: str, full: torch.Tensor) -> torch.Tensor:
        d = self.splits[k].model
        return full if d is None else full.chunk(self.m, d)[self.mrank]

    def local(self, k: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of `full` (shaped like parameter k): its block,
        a new tensor, or `full` itself when k is replicated."""
        if self.splits[k] == Split():
            return full
        x = self._model_chunk(k, full)
        if self.splits[k].data is not None:
            x = x.chunk(self.n, self.splits[k].data)[self.rank]
        return x.clone(memory_format=torch.contiguous_format)

    def _gather(self, items: List[Tuple[str, torch.Tensor]], axis: str) -> Dict[str, torch.Tensor]:
        """Each (k, block) of `items` concatenated over `axis` along k's
        dimension on that axis, one all-gather per dtype."""
        size = axis_size(self.mesh, axis)
        out = {}
        by_dtype: Dict[torch.dtype, List[Tuple[str, torch.Tensor]]] = {}
        for k, t in items:
            by_dtype.setdefault(t.dtype, []).append((k, t))
        for group in by_dtype.values():
            dims = [getattr(self.splits[k], axis) for k, _ in group]
            moved = [t.movedim(d, 0) for (_, t), d in zip(group, dims)]
            flat = all_gather(torch.cat([t.reshape(-1) for t in moved]), self.mesh, axis)
            parts = flat.reshape(size, -1).split([t.numel() for t in moved], dim=1)
            for (k, _), t, d, part in zip(group, moved, dims, parts):
                whole = part.reshape(size * t.shape[0], *t.shape[1:])
                out[k] = whole.movedim(0, d)
        return out

    def _reduce_scatter(self, items: List[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """The sum over 'data' of each (k, tensor) of `items` (f32), this
        rank's chunk of it along k's 'data' dimension; one collective."""
        moved = [t.float().movedim(self.splits[k].data, 0) for k, t in items]
        sizes = [t.numel() // self.n for t in moved]
        buf = torch.empty((self.n, sum(sizes)), dtype=torch.float32, device=moved[0].device)
        for t, part in zip(moved, buf.split(sizes, dim=1)):
            part.copy_(t.reshape(self.n, -1))
        mine = reduce_scatter(buf.reshape(-1), self.mesh, DATA).split(sizes)
        return {k: v.reshape(t.shape[0] // self.n, *t.shape[1:]).movedim(0, self.splits[k].data)
                .contiguous() for (k, _), t, v in zip(items, moved, mine)}

    # -- the train step

    def reduce_grads(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The mean over the data axis of each parameter's gradient, in f32
        (zeros where the loss did not reach), in this layout: the model
        chunk of a parameter split over 'model' (its own gradient in a
        column-parallel layer; the slice of the whole gradient, the same on
        every model rank, otherwise), then this rank's data chunk of a
        parameter split over 'data' (one reduce-scatter), the whole of it
        otherwise (one all-reduce)."""
        grads = {}
        for k, p in model.named_parameters():
            g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad
            grads[k] = g if k in self.in_module else self._model_chunk(k, g)
        out = {}
        scattered = [k for k in grads if self.splits[k].data is not None]
        if scattered:
            out.update(self._reduce_scatter([(k, grads[k]) for k in scattered]))
            for k in scattered:
                out[k].div_(self.n)
        whole = [k for k in grads if self.splits[k].data is None]
        if whole:
            flat = torch.cat([grads[k].float().reshape(-1) for k in whole])
            all_reduce_(flat, self.mesh, DATA).div_(self.n)
            out.update((k, v.view(grads[k].shape))
                       for k, v in zip(whole, flat.split([grads[k].numel() for k in whole])))
        return {k: out[k] for k in self.splits}

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """The global norm of the reduced `grads` when some are split over
        the mesh: each block counted once (on the ranks at coordinate 0 of
        every axis that does not split it), summed over both axes; None when
        every rank holds them all, where the optimizer computes it as in one
        process."""
        if not self.sharded:
            return None
        mine = [grads[k] for k, s in self.splits.items()
                if (s.data is not None or self.rank == 0)
                and (s.model is not None or self.mrank == 0)]
        dev = next(iter(grads.values())).device
        total = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(mine))) ** 2
                 if mine else torch.zeros((), device=dev))
        return all_reduce_(all_reduce_(total, self.mesh, DATA), self.mesh, MODEL).sqrt()

    def barrier(self) -> None:
        barrier(self.mesh)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axis of the 0-d (or any) tensor `x` (the
        model ranks of a data rank hold the same)."""
        return all_reduce_(x.detach().clone(), self.mesh, DATA) / self.n

    # -- modules and checkpoints

    def shard_module(self, model: nn.Module) -> None:
        """Make `model` (a module of the shapes this layout was made for,
        holding whole weights) hold this rank's model chunks of the
        column-parallel layers' weights and biases, and compute those layers
        column-parallel. Done once per module."""
        for name in self.column_modules:
            mod = model.get_submodule(name)
            if getattr(mod, "column_parallel", False):
                continue
            for p_name, p in list(mod.named_parameters(recurse=False)):
                k = f"{name}.{p_name}" if name else p_name
                chunk = self._model_chunk(k, p.detach()).clone(
                    memory_format=torch.contiguous_format)
                setattr(mod, p_name, nn.Parameter(chunk, requires_grad=p.requires_grad))
            _column_parallel(mod, self.mesh)

    def gather_into(self, model: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
        """Write `tensors` (masters or EMA, in this layout) into `model`'s
        parameters (a module `shard_module` made column-parallel), rounded
        to each parameter's dtype: the data chunks all-gathered over 'data'
        in that dtype, then the model chunks of the parameters the module
        holds whole over 'model', one collective per dtype and axis."""
        params = dict(model.named_parameters())
        with torch.no_grad():
            vals = {k: tensors[k] for k in params}
            vals.update(self._gather(
                [(k, tensors[k].to(params[k].dtype)) for k in params
                 if self.splits[k].data is not None], DATA))
            vals.update(self._gather(
                [(k, vals[k].to(params[k].dtype)) for k in params
                 if self.splits[k].model is not None and k not in self.in_module], MODEL))
            for k, p in params.items():
                if p.data_ptr() != vals[k].data_ptr():
                    p.copy_(vals[k])

    def full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`tensors` in the one-process layout, on the CPU (a collective:
        every rank of the mesh calls it)."""
        vals = dict(tensors)
        vals.update(self._gather([(k, tensors[k]) for k in tensors
                                  if self.splits[k].data is not None], DATA))
        vals.update(self._gather([(k, vals[k]) for k in tensors
                                  if self.splits[k].model is not None], MODEL))
        return {k: vals[k].detach().contiguous().cpu() for k in tensors}


def put_state(state, mesh, fsdp: bool = False):
    """Place a one-process `TrainState` on the mesh, in place: the first
    rank's masters, moments and EMA on every rank, then each rank keeps its
    blocks of the split ones (`ShardedState`), the module's column-parallel
    layers keep their model chunks, and the module takes the masters. The
    train step and checkpoints follow `state.layout`. Without a mesh:
    `state` as it is."""
    if mesh is None:
        return state
    dicts = [state.params, state.mu, state.nu] + ([state.ema] if state.ema is not None else [])
    for d in dicts:
        replicated(list(d.values()), mesh)
    layout = ShardedState(state.model, mesh, fsdp)
    for d in dicts:
        for k in layout.sharded:
            d[k] = layout.local(k, d[k])
    layout.shard_module(state.model)
    for k, p in state.model.named_parameters():
        # an f32 parameter whose block the module holds is its own master,
        # as in one process
        if (p.dtype == torch.float32 and k in layout.in_module
                and layout.splits[k].data is None):
            state.params[k] = p.detach()
    state.layout = layout
    state.write_back()
    return state
