"""The data-parallel mesh and its collectives. Mirrors ``imm_tpu.parallel.mesh``.

The JAX package shards the batch over a 1-D ``'data'`` mesh of devices and
lets XLA insert the gradient all-reduce (``shard_map`` with ``pmean``). Here
each rank of a ``torch.distributed`` process group is one GPU and runs the
whole step on its share of the batch; the step averages what the JAX step
``pmean``s, with the collectives below:

- ``all_reduce_mean``: differentiable, its backward all-reduces the
  cotangents (BatchNorm's statistics, ``models/nets.py``);
- ``all_reduce_mean_flat``: the gradients and the metrics of a step, as one
  flat buffer;
- ``replicate``: the initial state broadcast from rank 0.

Only all-reduce and broadcast are used: the two collectives that the
``gloo`` backend also runs on CUDA tensors, so two ranks may share one card.

The mesh is a small record of the group, this rank and the world size, not
a ``DeviceMesh``: the step needs nothing else, and a ``DeviceMesh`` picks
each rank's device itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh over every rank of a process group (``group``
    None: one process). ``size`` is the number of ranks, ``rank`` this
    process's place among them."""

    group: Any
    rank: int
    size: int

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size}


def make_mesh(n_data: int | None = None) -> Mesh:
    """The mesh over the default process group (one process when none is
    up). ``n_data``, if given, must be the group's size: a rank outside the
    mesh would have nothing to do."""
    if dist.is_available() and dist.is_initialized():
        mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size())
    else:
        mesh = Mesh(None, 0, 1)
    if n_data is not None and n_data != mesh.size:
        if n_data > mesh.size:
            raise ValueError(f"requested {n_data} devices, only {mesh.size} visible")
        raise ValueError(
            f"requested {n_data} devices of a group of {mesh.size} ranks; the mesh "
            "spans every rank of the group"
        )
    return mesh


def axis_group(axis_name: str | None) -> Mesh | None:
    """The mesh that a layer with ``axis_name`` averages over: the default
    group's when it has several ranks, else None (nothing to average)."""
    if axis_name is None or not (dist.is_available() and dist.is_initialized()):
        return None
    mesh = make_mesh()
    return mesh if mesh.size > 1 else None


class _AllReduceMean(torch.autograd.Function):
    """The mean across ranks, whose backward is the mean of the ranks'
    cotangents: the gradient of the global objective (the mean of the ranks'
    objectives) reaches every rank's input, as in ``nn.SyncBatchNorm``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=mesh.group)
        return y / mesh.size

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.group)
        return g / ctx.mesh.size, None


def all_reduce_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` averaged across the mesh's ranks, differentiably (the identity
    on one rank)."""
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceMean.apply(x, mesh)


def all_reduce_mean_flat(tensors: list[torch.Tensor], mesh: Mesh | None) -> list[torch.Tensor]:
    """Each tensor averaged across the mesh's ranks, through one all-reduce
    of one flat float32 buffer; not differentiable. Every rank gets the same
    bits back."""
    if mesh is None or mesh.size == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s random draws: ``seed`` itself on rank 0,
    so one process draws what it always drew, and a stream of its own on
    every other rank (the JAX step's ``fold_in`` of the rank)."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B97F4A7C15) % 2**63


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of a global batch (a tensor, or a dict of them,
    along the first axis); the batch must divide evenly."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"global batch {n} not divisible by {mesh.size} ranks")
    local = n // mesh.size
    return batch[mesh.rank * local:(mesh.rank + 1) * local]


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of ``tree`` (a module's parameters and
    buffers, a train state, dicts and lists of tensors) from rank 0 into
    every rank's own tensors, in place; -> ``tree``."""
    if mesh.size == 1:
        return tree
    kinds: dict[tuple, list[torch.Tensor]] = {}
    for t in _tensors(tree):
        kinds.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in kinds.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
    return tree
