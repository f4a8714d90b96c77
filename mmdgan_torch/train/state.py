"""TrainState: the complete training state (``mmdgan_tpu/train/state.py``),
plus the nested-dict helpers the step, the optimizer and the checkpoints
share."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List

import torch

from mmdgan_torch.ops.losses import LossState


def tree_leaves(tree: Dict) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (JAX's order), so two
    trees with the same keys line up whatever order they were built in."""
    out: List[torch.Tensor] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn: Callable, tree: Dict) -> Dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_rebuild(tree: Dict, leaves: Iterator) -> Dict:
    """``tree``'s structure with its leaves taken from ``leaves`` in
    ``tree_leaves`` order."""
    return {k: tree_rebuild(tree[k], leaves) if isinstance(tree[k], dict) else next(leaves)
            for k in sorted(tree)}


def copy_tree_(dst: Dict, src: Dict) -> None:
    """Write the leaves of ``src`` into those of ``dst`` in place (the two
    trees have the same keys), so a captured CUDA graph keeps reading and
    writing the same buffers."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if len(d) != len(s):
        raise ValueError(f"trees differ: {len(d)} leaves against {len(s)}")
    with torch.no_grad():
        torch._foreach_copy_(d, s)


def loss_state_leaves(loss_state: LossState) -> List[torch.Tensor]:
    return [getattr(loss_state, f.name) for f in dataclasses.fields(loss_state)]


@dataclasses.dataclass
class TrainState:
    """The step updates this object in place, every tensor in its own
    buffer: parameters and optimizer slots by the optimizer, SN/BN and loss
    state by ``copy_``, ``step`` by ``add_``. A CUDA graph captured on a
    TrainState therefore replays on it, and only on it. Parameters are
    made leaf tensors that require grad. ``step`` is a 0-d int32 tensor on
    the parameters' device (an int is converted); the host reads it only
    where it syncs. A state sharded over a mesh (``DataParallel.shard_state``)
    holds each split parameter and slot as the rank's flat piece of it,
    and its ``layout`` says which."""

    params: Dict[str, Any]        # {'gen': ..., 'dis': ...}
    net_state: Dict[str, Any]     # SN power vectors + BN statistics
    loss_state: LossState
    opt_state_dis: Any            # train.optim.OptState
    opt_state_gen: Any
    step: torch.Tensor
    rng: torch.Generator          # draws z when no code batch is given
    layout: Any = None            # a sharded state's parallel.mesh.StateLayout

    def __post_init__(self):
        leaves = tree_leaves(self.params)
        for p in leaves:
            p.requires_grad_(True)
        if not isinstance(self.step, torch.Tensor):
            self.step = torch.tensor(int(self.step), dtype=torch.int32, device=leaves[0].device)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state, in a fixed order."""
        out = tree_leaves(self.params) + tree_leaves(self.net_state)
        out += loss_state_leaves(self.loss_state)
        for opt in (self.opt_state_dis, self.opt_state_gen):
            out += opt.tensors()
        return out + [self.step]
