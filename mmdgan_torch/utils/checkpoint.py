"""Checkpoints of the whole TrainState (``mmdgan_tpu/utils/checkpoint.py:23-36``
and ``train/trainer.py:209-245``).

One file per step, ``ckpt-<step>.pt`` in the run's checkpoint folder,
written by ``torch.save`` of a dict of tensors: parameters, both
optimizer states (``count`` and each slot tree, float32 or bfloat16), SN
vectors and BN statistics, the
loss state, ``step`` and the z generator's state. That is the reference
Saver's coverage. A file is written under a temporary name and renamed,
so a reader sees all of it or nothing; the oldest are removed beyond
``max_to_keep``. ``restore_into`` writes a checkpoint into an existing
TrainState in place, so CUDA graphs captured on that state stay valid.
Under a mesh only rank 0 writes, behind a barrier, and every rank reads
the same file. A sharded state (``DataParallel.shard_state``) is written
whole, gathered by every rank first, and a checkpoint restores into a
state of either layout: a sharded one takes its rank's pieces, so a run
saved under fsdp resumes replicated and the other way round. Reading the
JAX package's orbax checkpoints is not ported.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from mmdgan_torch.train.state import TrainState, loss_state_leaves, tree_leaves

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


def list_ckpt_steps(ckpt_folder: str) -> List[int]:
    """Steps of the checkpoints in a folder, ascending."""
    if not os.path.isdir(ckpt_folder):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_folder)) if m)


def get_ckpt(ckpt_folder: str, ckpt_step: Optional[int] = None) -> Optional[int]:
    """The latest (or the pinned) checkpoint step in a folder; None when
    there is none (graph_func.py:399-416)."""
    steps = list_ckpt_steps(ckpt_folder)
    if ckpt_step is not None:
        return ckpt_step if ckpt_step in steps else None
    return steps[-1] if steps else None


def ckpt_path(ckpt_folder: str, step: int) -> str:
    return os.path.join(ckpt_folder, f"ckpt-{int(step)}.pt")


def _detached(tree: Dict) -> Dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach() for k, v in tree.items()}


def state_dict(ts: TrainState) -> Dict:
    opt = lambda s: {"count": s.count, **{k: _detached(v) for k, v in s.slots.items()}}
    return {"params": _detached(ts.params), "net_state": ts.net_state,
            "loss_state": loss_state_leaves(ts.loss_state),
            "opt_state_dis": opt(ts.opt_state_dis), "opt_state_gen": opt(ts.opt_state_gen),
            "step": ts.step, "rng": ts.rng.get_state()}


def save(ckpt_folder: str, ts: TrainState, step: int, max_to_keep: int = 2, dp=None) -> str:
    """Write ``ts`` as the checkpoint of ``step``; keep the newest
    ``max_to_keep``. Returns the file's path. With a mesh (``dp``) rank 0
    writes the replicated state and every rank waits for it; every rank
    first gathers a sharded state."""
    path = ckpt_path(ckpt_folder, step)
    if ts.layout is not None:
        ts = ts.layout.gathered(ts)
    if dp is None or dp.is_main:
        os.makedirs(ckpt_folder, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state_dict(ts), tmp)
        os.replace(tmp, path)
        for old in list_ckpt_steps(ckpt_folder)[:-max_to_keep]:
            os.remove(ckpt_path(ckpt_folder, old))
    if dp is not None:
        dp.barrier()
    return path


def restore_into(ts: TrainState, path: str) -> TrainState:
    """Write the checkpoint at ``path`` into ``ts``, every tensor in its
    own buffer and the generator's state; returns ``ts``."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    stored = tree_leaves(saved["params"]) + tree_leaves(saved["net_state"]) + saved["loss_state"]
    for name in ("opt_state_dis", "opt_state_gen"):
        opt = saved[name]
        stored += [opt["count"]] + [t for k in sorted(opt) if k != "count"
                                    for t in tree_leaves(opt[k])]
    stored.append(saved["step"])
    leaves = ts.tensors()
    if len(leaves) != len(stored):
        raise ValueError(f"{path} holds {len(stored)} tensors, the state {len(leaves)}")
    if ts.layout is not None:
        stored = [ts.layout.local(src, dst) for dst, src in zip(leaves, stored)]
    with torch.no_grad():
        for dst, src in zip(leaves, stored):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"{path}: {tuple(src.shape)} {src.dtype} does not fit "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
    ts.rng.set_state(saved["rng"])
    return ts
