"""Optimizers, ``adam`` only (``mmdgan_tpu/train/optim.py:61-62,132-151``).

``Adam`` applies optax's ``adam(lr, b1, b2, eps)`` update rule,

    mu  = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
    p  -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

in place on a list of tensors with PyTorch's multi-tensor ``_foreach``
ops. The slots are dicts keyed like the parameters, so the JAX bridge can
fill them. ``count`` (optax's int32 ``count``) is a 0-d tensor on the
parameters' device and the bias corrections are computed there, so the
update reads no host value and replays correctly from a CUDA graph.

``gated_update_`` is the update gated by a flag on the device
(``mmdgan_tpu/train/step.py:60-75``): inside a CUDA graph the flag is a
0-d tensor that a Python ``if`` would read on the host, so the update is
made in full and each tensor then selects its new or its old value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from mmdgan_torch.train.state import tree_leaves, tree_map


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor    # int32, 0-d, on the parameters' device
    mu: Dict
    nu: Dict


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        device = tree_leaves(params)[0].device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState) -> None:
        """One update of ``params`` (in the order of ``tree_leaves``) and
        ``state``, in place."""
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        grads = list(grads)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        state.count.add_(1)
        t = state.count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, t))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(params, mu_hat, denom, value=-self.lr)

    @torch.no_grad()
    def gated_update_(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
                      state: AdamState, do: torch.Tensor) -> None:
        """``update_`` where the 0-d bool tensor ``do`` is true; where it is
        false, parameters, moments and ``count`` keep their values bit for
        bit, as a skipped ``update_`` leaves them: the update runs in full,
        then each tensor selects its new or its old value."""
        tensors = list(params) + tree_leaves(state.mu) + tree_leaves(state.nu) + [state.count]
        old = [t.clone() for t in tensors]
        self.update_(params, grads, state)
        for new, prev in zip(tensors, old):
            new.copy_(torch.where(do, new, prev))


def multi_opt_config(lr_list: Sequence[float], optimizer: str = "adam") -> List[Adam]:
    """One optimizer per net (TTUR): index 0 discriminator, 1 generator."""
    if optimizer not in ("adam", "Adam"):
        raise NotImplementedError(f"optimizer {optimizer} is not ported yet")
    return [Adam(lr) for lr in lr_list]
