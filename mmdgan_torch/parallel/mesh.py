"""Data parallelism over ``torch.distributed`` (``mmdgan_tpu/parallel/mesh.py``).

The JAX package puts one ``jax.sharding.Mesh`` with a single ``data``
axis over all chips: parameters and optimizer, SN and BN state
replicated, the batch sharded, the step written once with global-batch
semantics, and XLA inserts the collectives. The port keeps the layout
and the semantics: N ranks at a global batch B give what one device
gives at B. PyTorch inserts nothing, so the step is built with the mesh
(``build_train_step(..., dp=dp)`` and the other builders) and issues its
collectives itself (``parallel/collectives.py`` states the convention).

One rank per process, as under ``torchrun``: the JAX package's
multi-process contract (``docs/multihost.md``) applies to every rank.
Each rank feeds its own ``local_batch_size(B)`` rows (its shard of the
pipeline, ``ReadTFRecords.shard``); ``local_rows`` takes a rank's rows of
a global tensor (the step's z and penalty weights are drawn at the global
batch from the replicated generator and sliced so). The state is made
from the same seed on every rank and ``replicate`` broadcasts rank 0's.

The mesh is ``torch.distributed.device_mesh``'s: 1-D, axis ``data``, or
2-D (``make_mesh_2d``), axes ``data`` x ``model``, the model axis
fastest-varying: NCCL for a ``cuda`` device, gloo for ``cpu``. The device
is ``cuda:LOCAL_RANK`` unless the caller names one (``"cpu"``, or
``"cuda:0"`` for ranks sharing a card over gloo). On a 2-D mesh the
batch is sharded over ``data`` only: the ranks of one ``model`` group
feed the same rows, and ``size``/``rank`` are the data axis's.

State sharding (``shard_state``, ``mesh.py:174-299``): ``fsdp=True`` on a
1-D mesh splits the large parameter and optimizer leaves over ``data``
(ZeRO-3's memory layout), a 2-D mesh splits them over ``model``. PyTorch
does not partition a step, so both run JAX's gather-at-entry schedule
(``_fsdp_gather_step``, ``:257-299``) for either axis: the state is
stored sharded between steps (``StateLayout``), the step all-gathers the
weights into full-size buffers made once, computes in the data-parallel
batch-sharded layout, reduce-scatters each network's flat gradient, and
each rank updates its own shards of the parameters and optimizer slots.
The result is the replicated run's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist

from mmdgan_torch import DeviceLike
from mmdgan_torch.data.prefetch import prefetch as _prefetch
from mmdgan_torch.parallel.collectives import (
    Axis,
    all_gather_raw,
    all_reduce_raw,
    average_flat,
    broadcast_raw_,
    gather_shards,
    scatter_gradients,
)
from mmdgan_torch.train.state import TrainState, tree_leaves, tree_rebuild


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` by default (made current),
    else the one named."""
    if device is None or torch.device(device) == torch.device("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh runs on CUDA by default and no GPU is present; "
                               "pass device='cpu' to run it on the CPU over gloo")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
    """Join the process group, once per process: from torchrun's
    environment (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) unless given. NCCL collectives are captured in CUDA
    graphs, which PyTorch's CUDA-graph notes allow with NCCL's
    asynchronous error handling off, set before the group is made."""
    if dist.is_initialized():
        return
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ.get("RANK", 0)) if rank is None else rank,
        world_size=int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size)


def _mesh_device_type(devices=None) -> str:
    if devices is not None:
        return torch.device(devices).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis: str = "data"):
    """A 1-D mesh over every rank of the (joined) process group: ``cuda``
    for an NCCL group, ``cpu`` for gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def make_mesh_2d(data: int, model: int, devices=None, axes=("data", "model")):
    """A 2-D (data x model) mesh over the ranks of the joined process
    group (``mmdgan_tpu/parallel/mesh.py:47-66``): rank ``d * model + m``
    sits at (d, m), so the model axis is the fastest-varying one and its
    per-step collectives stay among neighbouring ranks. ``devices`` names
    the device type (``"cuda"`` or ``"cpu"``; by default that of the
    group's backend). One rank per process: the group must hold exactly
    ``data * model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs a joined process group (init_distributed)")
    n = int(data) * int(model)
    if dist.get_world_size() != n:
        raise ValueError(f"a ({data},{model}) mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_mesh_device_type(devices), (int(data), int(model)),
                            mesh_dim_names=tuple(axes))


def _tree_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v)]
    return []


class DataParallel:
    """Data-parallel context: the ranks, the device, the replication of the
    state and the feeding of batches.

    Usage, one process per rank (``torchrun``)::

        dp = DataParallel()                          # the joined group, axis 'data'
        ts = dp.replicate(init_train_state(model, seed, opt_d, opt_g))
        step = build_train_step(model, opt_d, opt_g, dp=dp)
        for batch in dp.prefetch(pipe.shard().next_batch()):   # local rows
            ts, metrics = step(ts, batch)

    ``mesh``: a 1-D ``DeviceMesh`` (``make_mesh``); by default the
    process group is joined from torchrun's environment (NCCL for a
    ``cuda`` device, gloo for ``cpu``) and the mesh made over it. One
    collective runs here, so an NCCL communicator exists before any
    CUDA graph captures the step's."""

    def __init__(self, mesh=None, axis: str = "data", device: DeviceLike = None):
        self.device = rank_device(device)
        if mesh is None:
            init_distributed("nccl" if self.device.type == "cuda" else "gloo")
            mesh = make_mesh(axis)
        if mesh.ndim not in (1, 2):
            raise ValueError(f"a mesh has 1 or 2 axes, not {mesh.ndim}")
        self.mesh = mesh
        self.axis = mesh.mesh_dim_names[0]
        data = self._axis(self.axis)
        self.group, self.backend, self.size, self.rank = (data.group, data.backend, data.size,
                                                          data.rank)
        #: the model axis of a 2-D mesh (its name, and its ranks as an ``Axis``)
        self.model_axis = mesh.mesh_dim_names[1] if mesh.ndim == 2 else None
        self.model = None if self.model_axis is None else self._axis(self.model_axis)
        #: every rank of the mesh: replication, rank 0's state, gradient averages
        self.world = data if self.model is None else Axis(
            dist.group.WORLD, self.backend, dist.get_world_size(), dist.get_rank())
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh needs a CUDA device, not {self.device}")
        self.barrier()

    def _axis(self, name: str) -> Axis:
        group = self.mesh.get_group(name)
        return Axis(group, dist.get_backend(group), self.mesh.size(
            self.mesh.mesh_dim_names.index(name)), self.mesh.get_local_rank(name))

    @property
    def num_devices(self) -> int:
        return self.world.size

    @property
    def data_size(self) -> int:
        """Number of shards along the data (batch) axis."""
        return self.size

    @property
    def process_count(self) -> int:
        return dist.get_world_size()

    @property
    def is_main(self) -> bool:
        """Rank 0 of the process group: the one that writes files."""
        return dist.get_rank() == 0

    def local_batch_size(self, global_batch_size: int) -> int:
        """The rows of the global batch each rank feeds (one rank per
        process, ``docs/multihost.md``): its data shard's, which the ranks
        of a 2-D mesh's model group share."""
        n = self.size
        if global_batch_size % n:
            raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes "
                             "on the data axis")
        return global_batch_size // n

    def local_rows(self, t: torch.Tensor, micro_batches: int = 1) -> torch.Tensor:
        """This rank's rows of a global tensor (dim 0). Micro-batch m of an
        accumulated step is global rows ``[mB/M, (m+1)B/M)``, normalised
        by its own BN statistics, so rank r takes the r-th B/(MN) rows of
        every micro-batch (micro-major); at M=1 that is the r-th
        contiguous block."""
        n, m = t.shape[0], int(micro_batches)
        if n % (self.size * m):
            raise ValueError(f"batch dim {n} not divisible by {self.size} ranks x {m} "
                             "micro-batches")
        b = n // (self.size * m)
        if m == 1:
            return t.narrow(0, self.rank * b, b)
        return t.reshape((m, self.size, b) + tuple(t.shape[1:]))[:, self.rank].reshape(
            (m * b,) + tuple(t.shape[1:]))

    def shard_batch(self, batch):
        """A rank's batch (its local rows, as its pipeline shard yields
        them) as tensors on the rank's device; None stays None."""
        put = lambda v: None if v is None else torch.as_tensor(v).to(self.device)  # noqa: E731
        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    def shard_multi_batch(self, batches):
        """K-stacked local batches, ``[K, B/N, ...]``."""
        return self.shard_batch(batches)

    def replicate(self, tree):
        """Rank 0's values on every rank, written in place (a CUDA graph
        captured on the buffers stays valid): every tensor of a TrainState
        (or of a nested dict / list of tensors) and the TrainState's
        generator. Every rank must hold a tree of the same shapes (the
        same model and optimizers). A sharded state is not replicated:
        its shards differ by rank by design."""
        if getattr(tree, "layout", None) is not None:
            raise ValueError("replicate() of a sharded state: use ensure_placed, or "
                             "layout.gathered(ts) for its whole value")
        tensors = tree.tensors() if hasattr(tree, "tensors") else _tree_tensors(tree)
        for t in tensors:
            broadcast_raw_(t, self.world)
        rng = getattr(tree, "rng", None)
        if rng is not None:
            state = rng.get_state()
            rng.set_state(broadcast_raw_(
                state if self.backend == "gloo" else state.to(self.device), self.world).cpu())
        return tree

    def _leaf_spec(self, x, min_size: int, axis: Optional[str] = None) -> Optional[str]:
        """The axis a state leaf shards over (default: the model axis), or
        None when it stays replicated (``mesh.py:149-164``). JAX splits
        the last dimension; the port keeps OIHW kernels and splits the
        flat leaf in rank order instead: a floating leaf of at least
        ``min_size`` elements that divide evenly over the axis's ranks.
        Placement only: the step gathers the whole leaf before it
        computes, so the rule changes memory, never the result."""
        axis = self.model_axis if axis is None else axis
        ranks = (self.model if axis == self.model_axis else self).size
        if (isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() > 0
                and x.numel() >= min_size and x.numel() % ranks == 0):
            return axis
        return None

    def shard_state(self, tree, min_size: int = 2048, fsdp: bool = False):
        """Place the train state on the mesh (``mesh.py:174-242``).

        A 1-D mesh replicates (``replicate``). ``fsdp=True`` on a 1-D mesh
        shards the large parameter and optimizer leaves over the data
        axis; a 2-D mesh shards them over its model axis. A TrainState
        comes back as a new TrainState on a ``StateLayout`` (the input is
        left as it is): SN vectors, BN statistics, the loss state, counts,
        ``step`` and the generator stay replicated, and the steps built
        with this mesh run the gather-at-entry schedule on it. A nested
        dict of tensors comes back with each sharded leaf replaced by the
        rank's flat shard."""
        if fsdp:
            assert self.model_axis is None, (
                "fsdp shards over the data axis of a 1-D mesh; a 2-D "
                "mesh already shards state over its model axis")
            axis = self.axis
        elif self.model_axis is None:
            return self.replicate(tree)
        else:
            axis = self.model_axis
        if isinstance(tree, TrainState):
            return StateLayout.shard(self.replicate(tree), self, axis, min_size)
        shard_axis = self if axis == self.axis else self.model

        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            if self._leaf_spec(x, min_size, axis) is None:
                return x
            return x.detach().reshape(shard_axis.size, -1)[shard_axis.rank].clone()

        return put(self.replicate(tree))

    def ensure_placed(self, tree):
        """The state as this mesh's steps take it (``mesh.py:244-255``): a
        state already sharded on this mesh as it is (re-replicating it
        would undo its memory saving), anything else ``shard_state``'s
        default placement."""
        layout = getattr(tree, "layout", None)
        if layout is not None:
            if layout.dp is not self:
                raise ValueError("the state is sharded on another mesh")
            return tree
        return self.shard_state(tree)

    def _is_fsdp_layout(self, state) -> bool:
        """Whether the state is sharded over the DATA axis
        (``shard_state(fsdp=True)``)."""
        layout = getattr(state, "layout", None)
        return layout is not None and layout.axis_name == self.axis

    def compile_step(self, step_fn, out_state_like=None):
        """The step, which must have been built with this mesh
        (``build_train_step(..., dp=dp)``): PyTorch does not partition a
        step written for one device. ``out_state_like``, a state placed on
        this mesh, pins the layout: the step updates a sharded state's
        shards in place, so its layout is the one it came in with."""
        if getattr(step_fn, "dp", None) is not self:
            raise ValueError("the step was not built with this DataParallel: pass dp= to "
                             "its builder")
        layout = getattr(out_state_like, "layout", None)
        if layout is not None and layout.dp is not self:
            raise ValueError("out_state_like is sharded on another mesh")
        return step_fn

    def fully_replicated_value(self, x):
        """A replicated device value on the host."""
        if isinstance(x, dict):
            return {k: self.fully_replicated_value(v) for k, v in x.items()}
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    def prefetch(self, data_iter: Iterable[Dict], size: int = 2) -> Iterator[Dict]:
        """The rank's host batches (single or K-stacked) on its device,
        ``size`` ahead (``data/prefetch.py``)."""
        return _prefetch(data_iter, self.device, size)

    def barrier(self) -> None:
        """Wait on the host until every rank gets here."""
        all_reduce_raw(torch.zeros(1, device=self.device), self.world).item()


class _NetShards:
    """One network's sharded leaves: which of its leaves (``tree_leaves``
    order) are split, where each rank's piece of leaf j sits in the rank's
    flat shard (``offsets``), and the full-size buffers the step gathers
    the weights into (made once, leaves that require grad)."""

    def __init__(self, leaves: List[torch.Tensor], mask: List[bool], ranks: int):
        self.mask = mask
        self.ranks = ranks
        sharded = [p for p, s in zip(leaves, mask) if s]
        self.offsets, self.length = [], 0
        for p in sharded:
            self.offsets.append(self.length)
            self.length += p.numel() // ranks
        self.full = [torch.empty_like(p, memory_format=torch.contiguous_format).requires_grad_()
                     for p in sharded]

    def shard(self, tree: Dict, rank: int):
        """``tree`` (keyed like the network's parameters: the parameters
        or an optimizer slot) with each sharded leaf replaced by a view of
        one new flat tensor, the rank's shard; returns (tree, flat)."""
        leaves = tree_leaves(tree)
        pieces = [p.detach().reshape(self.ranks, -1)[rank]
                  for p, s in zip(leaves, self.mask) if s]
        if not pieces:
            return tree, None
        dtypes = {p.dtype for p in pieces}
        if len(dtypes) != 1:
            raise ValueError(f"sharded leaves of one tree have dtypes {sorted(map(str, dtypes))}")
        flat = torch.cat(pieces)
        views = iter(flat.split([p.numel() for p in pieces]))
        return tree_rebuild(tree, iter([next(views) if s else p
                                    for p, s in zip(leaves, self.mask)])), flat


class StateLayout:
    """A TrainState stored sharded (``DataParallel.shard_state``): the
    counterpart of JAX's ``NamedSharding`` per leaf and of
    ``_fsdp_gather_step``'s schedule (``mmdgan_tpu/parallel/mesh.py:
    174-299``).

    Each network's sharded parameters are views of one flat tensor, the
    rank's shard (its piece of every split leaf, leaf after leaf), and each
    optimizer slot's likewise; the state's other tensors are the replicated
    ones. ``copy_tree_``, ``checkpoint.restore_into`` and the optimizers
    write the views, so they write the flat shards the step's gather reads
    and a CUDA graph captured on the state stays valid.

    The step (``train/step.py``) calls ``gather`` at entry (one all-gather
    per network into the full-size buffers made here, once),
    ``reduce_grads`` on the full-size gradients (one reduce-scatter per
    network, and an average of the replicated leaves' gradients), then
    updates the state's leaves, shards included, elementwise."""

    def __init__(self, dp, axis_name: str):
        self.dp = dp
        self.axis_name = axis_name
        self.axis = dp if axis_name == dp.axis else dp.model
        self.nets: Dict[str, _NetShards] = {}
        self.flat: Dict[str, torch.Tensor] = {}

    @classmethod
    def shard(cls, ts: TrainState, dp, axis_name: str, min_size: int) -> TrainState:
        """The sharded TrainState on a new layout. It shares ``ts``'s
        replicated tensors and generator: go on with the returned state."""
        layout = cls(dp, axis_name)
        rank = layout.axis.rank
        params, opts = {}, {}
        for net, opt_name in (("gen", "opt_state_gen"), ("dis", "opt_state_dis")):
            leaves = tree_leaves(ts.params[net])
            ns = _NetShards(leaves, [dp._leaf_spec(p, min_size, axis_name) is not None
                                     for p in leaves], layout.axis.size)
            layout.nets[net] = ns
            params[net], layout.flat[net] = ns.shard(ts.params[net], rank)
            opt = getattr(ts, opt_name)
            slots = {}
            for name, tree in opt.slots.items():
                slots[name], layout.flat[f"{net}/{name}"] = ns.shard(tree, rank)
            opts[opt_name] = dataclasses.replace(opt, slots=slots)
        return dataclasses.replace(ts, params=params, layout=layout, **opts)

    @property
    def sharded_leaves(self) -> int:
        """How many parameter leaves are split (their slots are too)."""
        return sum(sum(ns.mask) for ns in self.nets.values())

    def gather(self, ts: TrainState) -> Dict[str, Dict]:
        """The whole parameters, ``{'gen': tree, 'dis': tree}``: the
        all-gathered weights in the full-size buffers, the replicated
        leaves themselves."""
        out = {}
        for net, ns in self.nets.items():
            if ns.length:
                gather_shards(self.flat[net], self.axis, ns.full, ns.offsets)
            full = iter(ns.full)
            out[net] = tree_rebuild(ts.params[net], iter(
                [next(full) if s else p for p, s in zip(tree_leaves(ts.params[net]), ns.mask)]))
        return out

    def reduce_grads(self, net: str, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Gradients of the whole leaves (this rank's, as the step computes
        them) as the gradients of the state's leaves: the rank's shard of
        the mesh average for a split leaf, the mesh average for a
        replicated one."""
        ns = self.nets[net]
        out = list(grads)
        rep = [i for i, s in enumerate(ns.mask) if not s]
        if rep:
            for i, g in zip(rep, average_flat([grads[i] for i in rep], self.dp)):
                out[i] = g
        split = [i for i, s in enumerate(ns.mask) if s]
        if split:
            shard = scatter_gradients([grads[i] for i in split], ns.offsets, ns.length,
                                      self.axis, self.dp)
            for i, g in zip(split, shard.split([grads[i].numel() // ns.ranks for i in split])):
                out[i] = g
        return out

    def global_norm(self, net: str, grads: List[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient from ``reduce_grads``' output."""
        ns = self.nets[net]
        sq = lambda gs: torch.stack([torch.sum(torch.square(g.float())) for g in gs]).sum()  # noqa: E731
        total = sq([g for g, s in zip(grads, ns.mask) if not s] or [grads[0].new_zeros(())])
        split = [g for g, s in zip(grads, ns.mask) if s]
        if split:
            total = total + all_reduce_raw(sq(split), self.axis)
        return torch.sqrt(total)

    def _whole(self, tree: Dict, key: str, net: str) -> Dict:
        ns, flat = self.nets[net], self.flat.get(key)
        if flat is None:
            return tree
        whole = all_gather_raw(flat, self.axis).view(ns.ranks, -1)
        leaves, offsets = tree_leaves(tree), iter(ns.offsets)
        out, full = [], iter(ns.full)
        for p, s in zip(leaves, ns.mask):
            if not s:
                out.append(p)
                continue
            shape, o = next(full).shape, next(offsets)
            n = p.numel()
            out.append(whole[:, o:o + n].reshape(shape).clone())
        return tree_rebuild(tree, iter(out))

    def gathered(self, ts: TrainState) -> TrainState:
        """The state's whole value, unsharded (a collective: every rank
        calls it): new parameter and slot tensors, the replicated tensors
        and the generator shared. What a checkpoint holds."""
        params = {net: self._whole(ts.params[net], net, net) for net in self.nets}
        opts = {}
        for net, opt_name in (("gen", "opt_state_gen"), ("dis", "opt_state_dis")):
            opt = getattr(ts, opt_name)
            opts[opt_name] = dataclasses.replace(opt, slots={
                name: self._whole(tree, f"{net}/{name}", net) for name, tree in opt.slots.items()})
        return dataclasses.replace(ts, params=params, layout=None, **opts)

    def local(self, whole: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """What a tensor of the state takes of a whole value: all of it,
        or, for a shard, the rank's piece of the flat leaf."""
        if tuple(dst.shape) == tuple(whole.shape):
            return whole
        if dst.dim() == 1 and dst.numel() * self.axis.size == whole.numel():
            return whole.reshape(self.axis.size, -1)[self.axis.rank]
        raise ValueError(f"{tuple(whole.shape)} is not a shard of {tuple(dst.shape)}")


def average_tower_grads(tower_grads):
    """Explicit per-tower gradient averaging (``SynTower.average_grads``,
    graph_func.py:61-158): the element-wise mean of gradient trees (dicts
    of tensors). The mesh step averages over ranks itself."""
    first = tower_grads[0]
    if isinstance(first, dict):
        return {k: average_tower_grads([g[k] for g in tower_grads]) for k in first}
    return sum(tower_grads) / float(len(tower_grads))
