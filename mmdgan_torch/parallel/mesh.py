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

The mesh is ``torch.distributed.device_mesh``'s, 1-D, axis ``data``:
NCCL for a ``cuda`` device, gloo for ``cpu``. The device is
``cuda:LOCAL_RANK`` unless the caller names one (``"cpu"``, or
``"cuda:0"`` for ranks sharing a card over gloo).

Deferred (ROADMAP A15b): the 2-D (data x model) mesh and ``fsdp=True``
state sharding (``mesh.py:47-66,174-299``); both raise.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist

from mmdgan_torch import DeviceLike
from mmdgan_torch.data.prefetch import prefetch as _prefetch
from mmdgan_torch.parallel.collectives import all_reduce_raw, broadcast_raw_

_DEFERRED = "is not ported yet (ROADMAP A15b)"


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


def make_mesh(axis: str = "data"):
    """A 1-D mesh over every rank of the (joined) process group: ``cuda``
    for an NCCL group, ``cpu`` for gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def make_mesh_2d(data: int, model: int, devices=None, axes=("data", "model")):
    """The (data x model) mesh (``mmdgan_tpu/parallel/mesh.py:47-66``)."""
    raise NotImplementedError(f"the 2-D (data x model) mesh {_DEFERRED}")


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
        self.mesh = mesh
        self.axis = mesh.mesh_dim_names[0]
        if mesh.ndim != 1:
            raise NotImplementedError(f"a mesh of {mesh.ndim} axes {_DEFERRED}")
        self.model_axis = None
        self.group = mesh.get_group(self.axis)
        self.backend = dist.get_backend(self.group)
        self.size = mesh.size()
        self.rank = mesh.get_local_rank(self.axis)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh needs a CUDA device, not {self.device}")
        self.barrier()

    @property
    def num_devices(self) -> int:
        return self.size

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
        process, ``docs/multihost.md``)."""
        n = self.process_count
        if global_batch_size % n:
            raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
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
        same model and optimizers)."""
        tensors = tree.tensors() if hasattr(tree, "tensors") else _tree_tensors(tree)
        for t in tensors:
            broadcast_raw_(t, self)
        rng = getattr(tree, "rng", None)
        if rng is not None:
            state = rng.get_state()
            rng.set_state(broadcast_raw_(
                state if self.backend == "gloo" else state.to(self.device), self).cpu())
        return tree

    def shard_state(self, tree, min_size: int = 2048, fsdp: bool = False):
        """``replicate``; ``fsdp=True`` (``mesh.py:174-242``) raises."""
        if fsdp:
            raise NotImplementedError(f"fsdp=True state sharding {_DEFERRED}")
        return self.replicate(tree)

    def ensure_placed(self, tree):
        """The state replicated from rank 0 (no other layout is ported)."""
        return self.replicate(tree)

    def compile_step(self, step_fn):
        """The step, which must have been built with this mesh
        (``build_train_step(..., dp=dp)``): PyTorch does not partition a
        step written for one device."""
        if getattr(step_fn, "dp", None) is not self:
            raise ValueError("the step was not built with this DataParallel: pass dp= to "
                             "its builder")
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
        all_reduce_raw(torch.zeros(1, device=self.device), self).item()


def average_tower_grads(tower_grads):
    """Explicit per-tower gradient averaging (``SynTower.average_grads``,
    graph_func.py:61-158): the element-wise mean of gradient trees (dicts
    of tensors). The mesh step averages over ranks itself."""
    first = tower_grads[0]
    if isinstance(first, dict):
        return {k: average_tower_grads([g[k] for g in tower_grads]) for k in first}
    return sum(tower_grads) / float(len(tower_grads))
