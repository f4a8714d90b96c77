"""TrainState: the complete training state (``mmdgan_tpu/train/state.py``),
plus the nested-dict helpers the step and the optimizer share."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

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


@dataclasses.dataclass
class TrainState:
    """The step updates this object in place (parameters and optimizer
    slots in their buffers, SN/BN state by replacement) and returns it.
    Parameters are made leaf tensors that require grad."""

    params: Dict[str, Any]        # {'gen': ..., 'dis': ...}
    net_state: Dict[str, Any]     # SN power vectors + BN statistics
    loss_state: LossState
    opt_state_dis: Any
    opt_state_gen: Any
    step: int
    rng: torch.Generator          # draws z when no code batch is given

    def __post_init__(self):
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
