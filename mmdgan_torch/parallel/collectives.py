"""The batch reductions of the data-parallel step, as collectives
(``mmdgan_tpu/parallel/mesh.py:1-24``: the ones XLA's SPMD partitioner
inserts into the JAX step, which is written once with global-batch
semantics).

The convention, one for every reduction over the batch:

- every rank computes the whole global loss, from scores gathered over
  the ranks (``all_gather``), so the loss and its draws are the same on
  every rank;
- every reduction over the batch is a collective whose backward is the
  adjoint of its sum: ``all_gather``'s backward reduce-scatters (sums)
  the cotangents, ``all_reduce``'s all-reduces them;
- the parameter gradients are averaged over the ranks
  (``average_flat``), and so is the gradient of any other value every
  rank holds a copy of;
- the state a rank computes for itself from replicated values (the SN
  power vectors) is rank 0's (``from_rank0``): cuDNN may run a
  nondeterministic algorithm, and identical inputs must leave identical
  replicas.

Why that is the global gradient: the N ranks' graphs joined by the
collectives compute N copies of the loss, and the sum adjoints make the
ranks' gradients add up to the gradient of the N copies, N times the
global one; the average divides the N out. A batch-norm statistic's
cotangent reaches each local row N times, the gathered scores' cotangent
comes back to each rank N-fold, and the average cancels both. A gather
whose backward only takes the rank's own slice of a cotangent mixes
conventions: it drops the cross terms of the witness penalty, whose
rows on rank r depend on every rank's scores.

Each backward is itself a collective ``autograd.Function``, so a
penalty's double backward (``create_graph=True``) differentiates through
it. Every rank issues the same collectives in the same order: the step
runs the same code on every rank, and the autograd engine orders a
graph's nodes by their creation.

A 2-D mesh (``mesh.make_mesh_2d``) runs these batch reductions over its
data axis; averages and rank 0's state span every rank of the mesh
(``dp.world``), so the ranks of a model group, which hold the same rows,
stay bitwise alike. A sharded state (``mesh.StateLayout``) adds the
all-gather of each network's flat shard at step entry and the
reduce-scatter of its flat gradient, over the axis the state is sharded
on (``data`` under fsdp, ``model`` on a 2-D mesh), then, on a 2-D mesh, a
sum of the shard over ``data``.

Transport: NCCL runs on the device and its collectives are captured in
a CUDA graph (the communicator must exist before the first capture:
``DataParallel`` issues one collective when it is made). gloo runs on
the host: a CUDA tensor's buffer is copied to the host for gloo's
collective and back, since gloo's CUDA support does not cover every
collective used here; the compute stays on the card. A host copy cannot
be captured, so a gloo mesh runs its windows eagerly
(``train/step.py`` ``_graphed``). Without a mesh (``dp=None``) every
function here is the plain single-device operation and issues no
collective.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """The ranks of one mesh axis (or of the whole mesh) as the functions
    here take them: a ``DataParallel`` has the same four attributes, for
    its data axis."""

    group: Any
    backend: str
    size: int
    rank: int


def _via_host(t: torch.Tensor, dp) -> bool:
    return dp.backend == "gloo" and t.device.type != "cpu"


def all_reduce_raw(t: torch.Tensor, dp) -> torch.Tensor:
    """The sum of ``t`` over the ranks, a new tensor (no autograd)."""
    host = _via_host(t, dp)
    out = t.detach().to("cpu", copy=True) if host else t.detach().clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=dp.group)
    return out.to(t.device) if host else out


def all_gather_raw(t: torch.Tensor, dp) -> torch.Tensor:
    """The ranks' ``t`` stacked along dim 0 in rank order (no autograd)."""
    src = t.detach().contiguous()
    if dp.backend == "gloo":
        host = _via_host(t, dp)
        src = src.cpu() if host else src
        parts = [torch.empty_like(src) for _ in range(dp.size)]
        dist.all_gather(parts, src, group=dp.group)
        out = torch.cat(parts)
        return out.to(t.device) if host else out
    out = src.new_empty((dp.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=dp.group)
    return out


def broadcast_raw_(t: torch.Tensor, dp) -> torch.Tensor:
    """``t`` overwritten in place by rank 0's (no autograd)."""
    host = _via_host(t, dp)
    staged = host or not t.is_contiguous()
    buf = t.detach()
    if staged:
        buf = buf.to("cpu" if host else t.device, copy=True,
                     memory_format=torch.contiguous_format)
    dist.broadcast(buf, src=dist.get_global_rank(dp.group, 0), group=dp.group)
    if staged:
        with torch.no_grad():
            t.copy_(buf)
    return t


def reduce_scatter_raw(t: torch.Tensor, dp) -> torch.Tensor:
    """This rank's slice along dim 0 of the sum of ``t`` over the ranks
    (no autograd). gloo sums the whole tensor and takes the slice."""
    if dp.backend == "gloo":
        return all_reduce_raw(t, dp).chunk(dp.size)[dp.rank].clone()
    src = t.detach().contiguous()
    out = src.new_empty((src.shape[0] // dp.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=dp.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return all_gather_raw(t, dp)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.dp), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return reduce_scatter_raw(t, dp)

    @staticmethod
    def backward(ctx, grad):
        return _AllGather.apply(grad, ctx.dp), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return all_reduce_raw(t, dp)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.dp), None


def all_gather(t: torch.Tensor, dp) -> torch.Tensor:
    """The ranks' ``t`` along dim 0, rank order; backward reduce-scatters."""
    return _AllGather.apply(t, dp)


def all_reduce(t: torch.Tensor, dp) -> torch.Tensor:
    """The sum of ``t`` over the ranks; backward all-reduces."""
    return _AllReduce.apply(t, dp)


def batch_mean(t: torch.Tensor, dp=None) -> torch.Tensor:
    """The mean of ``t`` over the global batch: ``torch.mean`` without a
    mesh; with one, the sum over the ranks of the local sums over the
    rows the ranks hold, ``t.numel()`` each."""
    if dp is None:
        return torch.mean(t)
    return all_reduce(t.sum(), dp) / (t.numel() * dp.size)


def average_flat(tensors: List[torch.Tensor], dp) -> List[torch.Tensor]:
    """``tensors`` averaged over every rank of the mesh through one flat
    buffer: one collective whatever their number (the gradients of one
    network). On a 2-D mesh the ranks of a model group hold equal copies,
    so this is the average over the data axis."""
    world = dp.world
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce_raw(flat, world).div_(world.size)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def from_rank0(tensors: List[torch.Tensor], dp) -> List[torch.Tensor]:
    """Rank 0's ``tensors`` on every rank of the mesh, through one flat
    buffer."""
    flat = broadcast_raw_(torch.cat([t.detach().reshape(-1) for t in tensors]), dp.world)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def gather_shards(shard: torch.Tensor, axis, targets: List[torch.Tensor],
                  offsets: List[int]) -> None:
    """The step-entry all-gather of a sharded state: ``shard`` is this
    rank's flat shard of a network ([L], rank order), and leaf j of the
    network, ``targets[j]`` (full size), is the ``axis`` ranks' pieces
    ``[offsets[j], offsets[j] + targets[j].numel() / size)`` of their
    shards, in rank order. Writes the targets in place (no autograd)."""
    whole = all_gather_raw(shard, axis).view(axis.size, -1)
    with torch.no_grad():
        torch._foreach_copy_([t.view(axis.size, -1) for t in targets],
                             [whole[:, o:o + t.numel() // axis.size]
                              for t, o in zip(targets, offsets)])


def scatter_gradients(grads: List[torch.Tensor], offsets: List[int], length: int, axis,
                      dp) -> torch.Tensor:
    """The rank's flat shard ([``length``]) of the gradient averaged over
    the mesh: the full-size ``grads`` laid out shard-major (the inverse of
    ``gather_shards``), reduce-scattered over ``axis``, then, when
    ``axis`` is a 2-D mesh's model axis, summed over the data axis, and
    divided by the mesh's rank count."""
    flat = grads[0].new_empty((axis.size, length))
    torch._foreach_copy_([flat[:, o:o + g.numel() // axis.size] for g, o in zip(grads, offsets)],
                         [g.reshape(axis.size, -1) for g in grads])
    shard = reduce_scatter_raw(flat.view(-1), axis)
    if dp.world.size != axis.size:
        shard = all_reduce_raw(shard, dp)
    return shard.div_(dp.world.size)


def gathered_mean(t: torch.Tensor, dp=None) -> torch.Tensor:
    """A metric's mean over the global batch, detached."""
    t = t.detach()
    if dp is None:
        return torch.mean(t)
    return all_reduce_raw(t.sum(), dp) / (t.numel() * dp.size)


__all__ = ["Axis", "all_gather", "all_reduce", "all_gather_raw", "all_reduce_raw",
           "broadcast_raw_", "reduce_scatter_raw", "average_flat", "batch_mean",
           "from_rank0", "gathered_mean", "gather_shards",
           "scatter_gradients"]
