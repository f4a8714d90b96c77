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
saved under fsdp resumes replicated and the other way round.

``print_tensor_in_ckpt`` and ``rollback`` inspect and evaluate a
checkpoint without a training loop (``mmdgan_tpu/utils/checkpoint.py:39-90``,
graph_func.py:419-443, 606-638). ``import_jax_state`` writes a JAX
``TrainState``, restored to numpy by a process that has orbax, as a
checkpoint the port's ``Agent`` resumes from; the package itself reads no
orbax files (README, "Importing checkpoints").
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from mmdgan_torch.ops.losses import LossState
from mmdgan_torch.train.optim import OptState, multi_opt_config
from mmdgan_torch.train.state import TrainState, loss_state_leaves, tree_leaves, tree_map

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


def _write(ckpt_folder: str, saved: Dict, step: int, max_to_keep: int) -> str:
    """``saved`` as ``ckpt-<step>.pt``, written under a temporary name and
    renamed; the oldest beyond ``max_to_keep`` removed."""
    path = ckpt_path(ckpt_folder, step)
    os.makedirs(ckpt_folder, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(saved, tmp)
    os.replace(tmp, path)
    for old in list_ckpt_steps(ckpt_folder)[:-max_to_keep]:
        os.remove(ckpt_path(ckpt_folder, old))
    return path


def save(ckpt_folder: str, ts: TrainState, step: int, max_to_keep: int = 2, dp=None) -> str:
    """Write ``ts`` as the checkpoint of ``step``; keep the newest
    ``max_to_keep``. Returns the file's path. With a mesh (``dp``) rank 0
    writes the replicated state and every rank waits for it; every rank
    first gathers a sharded state."""
    path = ckpt_path(ckpt_folder, step)
    if ts.layout is not None:
        ts = ts.layout.gathered(ts)
    if dp is None or dp.is_main:
        _write(ckpt_folder, state_dict(ts), step, max_to_keep)
    if dp is not None:
        dp.barrier()
    return path


def _set_rng(rng: torch.Generator, saved: Dict) -> None:
    """The generator's saved state; an imported checkpoint holds a seed
    instead (``import_jax_state``), which fits a generator on any device."""
    if "rng" in saved:
        rng.set_state(saved["rng"])
    else:
        rng.manual_seed(int(saved["rng_seed"]))


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
    _set_rng(ts.rng, saved)
    return ts


def _described(tree, prefix: str, out: Dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _described(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _described(v, f"{prefix}[{i}]", out)
    else:
        shape = getattr(tree, "shape", None)
        out[prefix] = (tuple(shape) if shape is not None else None,
                       str(getattr(tree, "dtype", type(tree).__name__)))


def print_tensor_in_ckpt(ckpt_folder: str, step: Optional[int] = None) -> Dict:
    """Print (and return) {path: (shape, dtype)} of everything stored in the
    latest (or the given step's) checkpoint of a folder
    (graph_func.py:419-443); {} when there is none."""
    step = get_ckpt(ckpt_folder, step)
    if step is None:
        print(f"No checkpoint found in {ckpt_folder}")
        return {}
    out: Dict = {}
    _described(torch.load(ckpt_path(ckpt_folder, step), map_location="cpu", weights_only=True),
               "", out)
    for path, (shape, dtype) in sorted(out.items()):
        print(f"{path}: shape={shape} dtype={dtype}")
    return out


def _fresh(ts: TrainState) -> TrainState:
    """A state of ``ts``'s structure, layout and device in buffers of its own."""
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)
    opt = lambda s: OptState(count=s.count.clone(),
                             slots={k: clone(v) for k, v in s.slots.items()})
    return dataclasses.replace(
        ts, params=clone(ts.params), net_state=clone(ts.net_state),
        loss_state=LossState(*(t.clone() for t in loss_state_leaves(ts.loss_state))),
        opt_state_dis=opt(ts.opt_state_dis), opt_state_gen=opt(ts.opt_state_gen),
        step=ts.step.clone(), rng=torch.Generator(ts.step.device))


def rollback(ts_or_model: Any, ckpt_folder: str, fn: Optional[Callable] = None,
             ckpt_step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore the latest (or ``ckpt_step``'s) checkpoint into a fresh state
    and evaluate ``fn(state)`` there (graph_func.py:606-638, restoring into
    a fresh graph to evaluate a var_list); returns ``(value, step)``, the
    state itself when ``fn`` is None.

    :param ts_or_model: a TrainState, whose structure, layout and device
        the fresh state takes, or an ``SNGan``, for a checkpoint of the
        default optimizers (Adam, float32 moments; ``multi_opt_config``) on
        the model's device; neither is changed
    """
    from mmdgan_torch.train.step import init_train_state

    step = get_ckpt(ckpt_folder, ckpt_step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_folder}")
    fresh = (_fresh(ts_or_model) if isinstance(ts_or_model, TrainState)
             else init_train_state(ts_or_model, 0, *multi_opt_config([0.0, 0.0]),
                                   device=ts_or_model.device))
    restored = restore_into(fresh, ckpt_path(ckpt_folder, step))
    return (fn(restored) if fn is not None else restored), step


def import_jax_state(model, jax_state: Any, ckpt_folder: str, step: Optional[int] = None,
                     optimizers: Optional[Tuple] = None) -> str:
    """Write the JAX package's ``TrainState``, as numpy trees, as the port's
    checkpoint ``ckpt-<step>.pt`` in ``ckpt_folder``; returns its path.

    The file loads on any device: its tensors are on the CPU, and it holds
    the seed 0 for the z generator in place of a generator state (JAX's key
    cannot be carried over), so a run on the card resumes from a file
    written on a machine without one.

    :param model: the port's ``SNGan`` of the same architecture (on any
        device; the CPU where JAX runs)
    :param jax_state: the JAX state after ``jax.device_get`` (an object or
        a dict with ``params``, ``net_state``, ``opt_state_dis``,
        ``opt_state_gen``, ``loss_state`` and ``step``), as JAX's
        ``rollback`` restores it
    :param step: the checkpoint's step; the state's own by default
    :param optimizers: the port's ``(opt_dis, opt_gen)`` the run resumes
        with, which say which slots to keep (``jax_params_to_torch``)
    """
    from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

    get = (jax_state.get if isinstance(jax_state, dict)
           else lambda name: getattr(jax_state, name))
    params, net_state, (opt_dis, opt_gen), loss_state = jax_params_to_torch(
        model, get("params"), get("net_state"), (get("opt_state_dis"), get("opt_state_gen")),
        device="cpu", loss_state=get("loss_state"), optimizers=optimizers)
    saved = int(get("step"))
    ts = TrainState(params=params, net_state=net_state, loss_state=loss_state,
                    opt_state_dis=opt_dis, opt_state_gen=opt_gen, step=saved,
                    rng=torch.Generator())
    out = state_dict(ts)
    del out["rng"]
    out["rng_seed"] = torch.tensor(0, dtype=torch.int64)
    return _write(ckpt_folder, out, saved if step is None else step, max_to_keep=1 << 30)
