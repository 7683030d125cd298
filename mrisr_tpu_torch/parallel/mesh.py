"""The ('data', 'model') mesh over a process group (counterpart:
``mrisr_tpu/parallel/mesh.py``).

JAX drives every device from one program: a ('data', 'model') mesh, the
batch sharded on 'data', the parameters replicated, and XLA inserts the
gradient ``psum``.  Here each rank is a process (``torchrun``, or
``torch.multiprocessing``) holding one replica, and the same program is
written out:

- the ranks are laid out as JAX lays out its devices,
  ``reshape(data, model)``: mesh rank r sits at data coordinate
  ``r // model`` and model coordinate ``r % model``;
- the global batch is split into equal contiguous row blocks, the data
  coordinate d taking block d (:func:`shard_batch`), so the ranks of one
  data coordinate take the same rows;
- the parameters and buffers start equal: :func:`replicated` broadcasts
  them from the data group's first rank, and sets the group on every
  ``models/blocks.py:BatchNorm2d``, whose training-mode statistics are then
  those of the global batch, as under JAX's mesh;
- the gradients are averaged by one flat all-reduce between the backward
  and the optimizer step (``train/steps.py:_update``), before the clip;
- every random value is drawn for the global batch from the same stream
  on every rank, and each rank keeps its rows.

A :class:`Mesh` describes the data group of this rank's model coordinate,
so the training code sees a data mesh; with ``model > 1`` the JAX
trainers replicate their state over the whole mesh, and the ``model``
data groups run the same program.  The 'model' axis shards parameters
only where a caller asks for it, as JAX's only user of it does (a test's
eval forward under GSPMD): :func:`param_shardings` picks JAX's kernels,
and :func:`shard_module` runs a module column-parallel over the model
group.  A mesh of one rank is the unmeshed program: every collective is a
no-op.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1    # -1 -> all remaining ranks
    model: int = 1


@dataclass
class Mesh:
    """This process's place in the mesh.

    ``ranks``: the global ranks of its data group (the ranks of its model
    coordinate), in data order; ``rank``: its data coordinate (-1: not a
    member); ``group``: the data group's process group (None: the default
    one, or no group at all for one rank); ``device``: where this rank's
    replica runs.  ``model``: the 'model' axis's size; ``model_ranks``,
    ``model_rank``, ``model_group``: the same for its model group (the
    ranks of its data coordinate; None: this rank alone)."""

    ranks: List[int]
    rank: int
    group: Optional[object] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    model: int = 1
    model_ranks: Optional[List[int]] = None
    model_rank: int = 0
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": self.model}

    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def first(self) -> bool:
        """True on the mesh's first rank (data and model coordinate 0), the
        one that writes checkpoints and histories and prints."""
        return self.rank == 0 and self.model_rank == 0

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of ``global_batch`` rows."""
        if global_batch % self.size:
            raise ValueError(
                f"batch_size {global_batch} not divisible by the mesh's data "
                f"axis ({self.size})")
        n = global_batch // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def barrier(self) -> None:
        """Every rank of the mesh waits here: a one-element all-reduce on
        the group's device (which both backends take) over the data group,
        then over the model group, which together span the mesh."""
        for size, group in ((self.size, self.group),
                            (self.model, self.model_group)):
            if size > 1:
                t = torch.zeros(1, device=self.device)
                dist.all_reduce(t, group=group)
                t.item()


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if initialized() else 0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """Build the data x model mesh over the given global ranks (``None``:
    every rank of the default group) with JAX's checks, laid out as JAX's
    ``np.array(devices).reshape(data, model)``.  ``device``: this rank's
    replica's device (``None``: ``device.resolve_device(None)``, the card
    of this rank).  Every rank of the default group must call it, members
    or not: the groups are made collectively."""
    from mrisr_tpu_torch.device import resolve_device

    spec = spec or MeshSpec()
    ranks = list(devices if devices is not None else range(world_size()))
    n = len(ranks)
    if spec.model < 1:
        # only the data axis takes -1 = "all remaining"
        raise ValueError(
            f"MeshSpec.model must be >= 1 (got {spec.model}); "
            "-1 is only meaningful for the data axis")
    model = spec.model
    assert n % model == 0, f"{n} devices not divisible by model={model}"
    data = spec.data if spec.data > 0 else n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    world = world_size()
    if n > 1 and not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not all among the {world} "
                         "ranks of the process group")
    grid = [ranks[d * model:(d + 1) * model] for d in range(data)]
    # dist.new_group is collective: every rank makes every group, in this
    # order, whether it is a member or not
    data_groups = [_group([row[c] for row in grid], world)
                   for c in range(model)]
    model_groups = [_group(row, world) for row in grid]
    me = global_rank()
    d, c = divmod(ranks.index(me), model) if me in ranks else (-1, -1)
    return Mesh(ranks=[row[max(c, 0)] for row in grid], rank=d,
                group=data_groups[max(c, 0)],
                device=torch.device(device) if device is not None
                else resolve_device(None), model=model,
                model_ranks=grid[max(d, 0)], model_rank=c,
                model_group=model_groups[max(d, 0)])


def _group(members: List[int], world: int):
    """The process group of ``members`` (None: the default group, or one
    rank, which needs none); every rank must call it for every group."""
    if len(members) <= 1 or members == list(range(world)):
        return None
    return dist.new_group(members)


def batch_sharding(mesh: Mesh) -> Mesh:
    """Shard the leading batch dim across 'data': the mesh itself, whose
    :meth:`Mesh.rows` the loaders take (JAX's ``NamedSharding(mesh,
    P('data'))``)."""
    return mesh


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of the global ``batch``."""
    return batch[mesh.rows(batch.shape[0])]


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replicate ``module`` over the data group: its parameters and buffers
    broadcast from the group's first rank, and the group set on its
    BatchNorms (cross-rank training statistics).  Returns the module."""
    from mrisr_tpu_torch.models.blocks import BatchNorm2d

    if mesh.size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.group)
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.data_mesh = mesh if mesh.size > 1 else None
    return module


def _out_dim(layer: torch.nn.Module) -> Optional[int]:
    """The output-feature dim of ``layer``'s weight in torch's layout, the
    dim JAX's trailing one is (HWIO's O, Dense's ``out``): 0 for a conv
    ``(O, I, kh, kw)`` and a linear ``(out, in)``, 1 for a transposed conv
    ``(I, O, kh, kw)``; None for any other layer."""
    if isinstance(layer, torch.nn.ConvTranspose2d):
        return 1
    if isinstance(layer, (torch.nn.Conv2d, torch.nn.Linear)):
        return 0
    return None


def param_shardings(module: torch.nn.Module, mesh: Mesh,
                    min_size: int = 2**16) -> Dict[str, object]:
    """Per-parameter placement by JAX's rule: with a 'model' axis > 1, a
    weight of ndim >= 2 and at least ``min_size`` elements whose output
    dim divides by it is ``('model', dim)``, sharded on that dim (a
    Megatron-style column split); every other parameter (biases, norms,
    small kernels) is ``'replicated'``."""
    out: Dict[str, object] = {}
    for prefix, layer in module.named_modules():
        for name, p in layer.named_parameters(recurse=False):
            dim = _out_dim(layer) if name == "weight" else None
            shard = (mesh.model > 1 and p.ndim >= 2 and dim is not None
                     and p.shape[dim] % mesh.model == 0
                     and p.numel() >= min_size)
            out[f"{prefix}.{name}" if prefix else name] = (
                ("model", dim) if shard else "replicated")
    return out


@torch.no_grad()
def shard_module(module: torch.nn.Module, mesh: Mesh,
                 shardings: Dict[str, object]) -> torch.nn.Module:
    """Run ``module`` column-parallel over the mesh's model group: the
    port's ``jax.device_put(params, shardings)`` and a jitted apply under
    GSPMD, for the eval forward.

    Each layer whose weight ``shardings`` places on 'model' keeps only this
    rank's block of its output channels (weight and bias), computes those
    channels, and a forward hook assembles the full output across the model
    group; the norms, activations and every other layer run replicated on
    the assembled tensors.  The layers keep their classes (the convs'
    routes still apply).  The assembly is an all-reduce of a zero-filled
    full-width buffer holding this rank's block: exact (x + 0 = x), and
    taken by both gloo (on CUDA tensors too) and NCCL.  Returns the
    module, in eval mode."""
    module.eval()
    if mesh.model <= 1:
        return module
    for prefix, layer in module.named_modules():
        place = shardings.get(f"{prefix}.weight" if prefix else "weight")
        if not isinstance(place, tuple):
            continue
        dim = place[1]
        full = layer.weight.shape[dim]
        k = full // mesh.model
        lo = mesh.model_rank * k
        layer.weight = torch.nn.Parameter(
            layer.weight.narrow(dim, lo, k).contiguous(),
            requires_grad=False)
        if layer.bias is not None:
            layer.bias = torch.nn.Parameter(layer.bias[lo:lo + k].clone(),
                                            requires_grad=False)
        if isinstance(layer, torch.nn.Linear):
            layer.out_features, channel = k, -1
        else:
            layer.out_channels, channel = k, 1
        layer.register_forward_hook(functools.partial(
            _assemble_hook, mesh=mesh, channel=channel, full=full))
    return module


def _assemble_hook(layer, inputs, y, *, mesh: Mesh, channel: int, full: int
                   ) -> torch.Tensor:
    """A sharded layer's output block -> the full output, in the model
    group's order (the channels stay last in memory)."""
    y = y.movedim(channel, -1)
    k = y.shape[-1]
    out = y.new_zeros((*y.shape[:-1], full))
    out[..., mesh.model_rank * k:(mesh.model_rank + 1) * k] = y
    dist.all_reduce(out, group=mesh.model_group)
    return out.movedim(-1, channel)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Form the default process group (no-op for one process).

    ``coordinator_address``: 'host:port' of rank 0's store (``tcp://`` is
    added); ``backend``: 'nccl' on the card, 'gloo' for the CPU (the
    default: nccl when a CUDA device is available).  Two ranks sharing one
    card need 'gloo', which NCCL refuses.  A peer that does not join within
    the process group's default timeout makes it raise."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(process_id))
    addr = coordinator_address or "localhost:29500"
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id)


def distributed_init_from_env(backend: Optional[str] = None) -> bool:
    """:func:`distributed_init` from ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); True if
    it formed a group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or initialized():
        return False
    distributed_init(
        f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
        f"{os.environ.get('MASTER_PORT', '29500')}",
        world, int(os.environ["RANK"]), backend=backend)
    return True


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's card index: ``LOCAL_RANK`` (torchrun), else the rank
    modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_id if process_id is not None else global_rank()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(count, 1)


# ---------------------------------------------------- collectives (autograd)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents over the group
    too (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def psum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of ``x`` over the data group, differentiable."""
    if mesh is None or mesh.size <= 1:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def psum_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Mean of ``x`` over the data group, differentiable."""
    if mesh is None or mesh.size <= 1:
        return x
    return psum(x, mesh) / mesh.size


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = _AllReduceSum.apply(grad, ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


def all_gather_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows concatenated in rank order: the global batch,
    differentiable."""
    if mesh is None or mesh.size <= 1:
        return x
    return _AllGather.apply(x, mesh.group, mesh.size, mesh.rank)


@torch.no_grad()
def average_gradients(params: Sequence[torch.Tensor],
                      mesh: Optional[Mesh]) -> None:
    """Replace each parameter's ``.grad`` by its mean over the data group:
    one flat all-reduce (the gradient ``psum`` XLA inserts under JAX's
    mesh)."""
    if mesh is None or mesh.size <= 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def mean_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """Scalar metrics averaged over the data group, in one all-reduce."""
    if mesh is None or mesh.size <= 1 or not metrics:
        return metrics
    keys = list(metrics)
    vec = torch.stack([metrics[k].detach().reshape(()).to(torch.float64)
                       for k in keys])
    dist.all_reduce(vec, group=mesh.group)
    vec.div_(mesh.size)
    return {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(keys)}
