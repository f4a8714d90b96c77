"""Optimizers (``mmdgan_tpu/train/optim.py:19-151``): adam, adam_tf1, sgd,
momentum and rmsprop, each with float32 or bfloat16 slots.

Every optimizer updates a list of tensors in place with PyTorch's
multi-tensor ``_foreach`` ops, and keeps an ``OptState``: ``count`` (a 0-d
int32 tensor on the parameters' device) and a dict of slot trees keyed
like the parameters, so the JAX bridge and the checkpoints fill any of
them the same way. Whatever depends on the step (bias corrections, the
decayed learning rate) is computed on the device from ``count``: a value
read on the host would be frozen into a replayed CUDA graph.

The update rules, those of optax and of the JAX package:

- ``Adam``, optax's ``adam(lr, b1=0.5, b2=0.999, eps=1e-8)``:
  ``p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``;
- ``AdamTF1``, TF1's rule (``optim.py:70-99``):
  ``p -= lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps)``;
- ``SGD``, optax's ``sgd(schedule[, momentum=0.9])`` with
  ``exponential_decay(lr, decay_steps, 0.96, staircase=False)``: the
  schedule reads ``count`` before its increment, a non-positive
  ``decay_steps`` keeps ``lr``; momentum's trace is ``t = g + 0.9 t`` (not
  Nesterov), and the step is ``-lr(count) t``;
- ``RMSProp``, optax's ``rmsprop(lr, decay=0.9, eps=1e-10, momentum=0)``:
  ``nu = 0.9 nu + 0.1 g^2``, ``p -= lr g / sqrt(nu + eps)`` (eps inside the
  root). optax also keeps a trace of decay 0, which holds the last update
  and feeds none: the port has no such slot. Its ``count`` counts updates.

``bf16_slots`` (``with_bf16_slots``, ``optim.py:102-129``) stores the
float32 slots in bfloat16: each update computes in float32 from upcast
copies and writes the slots back rounded; ``count`` stays int32.

``gated_update_`` is the update gated by a flag on the device
(``mmdgan_tpu/train/step.py:60-75``): inside a CUDA graph the flag is a
0-d tensor that a Python ``if`` would read on the host, so the update is
made in full and each tensor then selects its new or its old value.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mmdgan_torch.train.state import tree_leaves, tree_map

LrLike = Union[float, torch.Tensor]


@dataclasses.dataclass
class OptState:
    """``count`` and the slot trees by name (``mu``/``nu`` of Adam, ``m``/``v``
    of AdamTF1, ``trace`` of momentum, ``nu`` of RMSProp); a slot reads as
    an attribute too (``state.mu``)."""

    count: torch.Tensor    # int32, 0-d, on the parameters' device
    slots: Dict[str, Dict]

    def __getattr__(self, name):
        try:
            return self.__dict__["slots"][name]
        except KeyError:
            raise AttributeError(name) from None

    def tensors(self) -> List[torch.Tensor]:
        """``count``, then every slot leaf, slots in sorted name order."""
        return [self.count] + [t for name in sorted(self.slots)
                               for t in tree_leaves(self.slots[name])]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    lr: float
    bf16_slots: bool = False
    slot_names: ClassVar[Tuple[str, ...]] = ()

    def init(self, params: Dict) -> OptState:
        dtype = torch.bfloat16 if self.bf16_slots else None
        zeros = lambda p: torch.zeros_like(p, dtype=dtype, requires_grad=False)
        device = tree_leaves(params)[0].device
        return OptState(count=torch.zeros((), dtype=torch.int32, device=device),
                        slots={name: tree_map(zeros, params) for name in self.slot_names})

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
                state: OptState) -> None:
        """One update of ``params`` (in the order of ``tree_leaves``) and
        ``state``, in place."""
        stored = {name: tree_leaves(state.slots[name]) for name in self.slot_names}
        # float32 slots are their own work tensors (.float() returns them)
        work = {name: [s.float() for s in leaves] for name, leaves in stored.items()}
        self._step(list(params), list(grads), work, state.count)
        if self.bf16_slots:
            for name, leaves in stored.items():
                torch._foreach_copy_(leaves, work[name])

    def _step(self, params, grads, slots, count) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def gated_update_(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
                      state: OptState, do: torch.Tensor) -> None:
        """``update_`` where the 0-d bool tensor ``do`` is true; where it is
        false, parameters, slots and ``count`` keep their values bit for
        bit, as a skipped ``update_`` leaves them: the update runs in full,
        then each tensor selects its new or its old value."""
        tensors = list(params) + state.tensors()
        old = [t.clone() for t in tensors]
        self.update_(params, grads, state)
        for new, prev in zip(tensors, old):
            new.copy_(torch.where(do, new, prev))


@dataclasses.dataclass(frozen=True)
class Adam(Optimizer):
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    slot_names: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def _step(self, params, grads, slots, count) -> None:
        mu, nu = slots["mu"], slots["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count.add_(1)
        t = count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, t))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(params, mu_hat, denom, value=-self.lr)


@dataclasses.dataclass(frozen=True)
class AdamTF1(Optimizer):
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    slot_names: ClassVar[Tuple[str, ...]] = ("m", "v")

    def _step(self, params, grads, slots, count) -> None:
        m, v = slots["m"], slots["v"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        count.add_(1)
        t = count.float()
        lr_t = self.lr * torch.sqrt(1.0 - torch.pow(self.b2, t)) / (1.0 - torch.pow(self.b1, t))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(m, denom)
        torch._foreach_mul_(step, -lr_t)
        torch._foreach_add_(params, step)


@dataclasses.dataclass(frozen=True)
class SGD(Optimizer):
    decay_steps: int = 0           # transition steps of the decay; <= 0: constant lr
    decay_rate: float = 0.96
    momentum: Optional[float] = None

    @property
    def slot_names(self) -> Tuple[str, ...]:
        return ("trace",) if self.momentum else ()

    def lr_at(self, count: torch.Tensor) -> LrLike:
        """The schedule at ``count`` (optax's ``exponential_decay``), on the
        device; a Python float when it is constant."""
        if self.decay_steps <= 0:
            return self.lr
        t = count.float()
        decayed = self.lr * torch.pow(self.decay_rate, t / self.decay_steps)
        return torch.where(t <= 0, torch.full_like(t, self.lr), decayed)

    def _step(self, params, grads, slots, count) -> None:
        lr = self.lr_at(count)    # read before the increment, as optax's
        updates = grads
        if self.momentum:
            updates = slots["trace"]
            torch._foreach_mul_(updates, self.momentum)
            torch._foreach_add_(updates, grads)
        count.add_(1)
        torch._foreach_add_(params, torch._foreach_mul(updates, -lr))


@dataclasses.dataclass(frozen=True)
class RMSProp(Optimizer):
    decay: float = 0.9
    eps: float = 1e-10
    slot_names: ClassVar[Tuple[str, ...]] = ("nu",)

    def _step(self, params, grads, slots, count) -> None:
        nu = slots["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.decay)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(scale, grads)
        torch._foreach_mul_(updates, -self.lr)
        count.add_(1)
        torch._foreach_add_(params, updates)


def opt_config(initial_lr: float, lr_decay_steps: Optional[int] = None, end_lr: float = 1e-7,
               optimizer: str = "adam", target_step: float = 1e5,
               bf16_moments: bool = False) -> Optimizer:
    """One optimizer (``optim.py:19-67``). SGD and momentum decay by 0.96
    per ``lr_decay_steps``, by default the steps that reach ``end_lr`` at
    ``target_step``."""
    if optimizer in ("SGD", "sgd", "Momentum", "momentum"):
        if lr_decay_steps is None:
            lr_decay_steps = int(np.round(
                target_step * np.log(0.96) / np.log(end_lr / initial_lr)))
        return SGD(initial_lr, bf16_moments, decay_steps=lr_decay_steps,
                   momentum=0.9 if optimizer in ("Momentum", "momentum") else None)
    if optimizer in ("Adam", "adam"):
        return Adam(initial_lr, bf16_moments)
    if optimizer == "adam_tf1":
        return AdamTF1(initial_lr, bf16_moments)
    if optimizer in ("RMSProp", "rmsprop"):
        return RMSProp(initial_lr, bf16_moments)
    raise ValueError(f"Optimizer {optimizer} not supported.")


def multi_opt_config(lr_list: Sequence[float], lr_decay_steps: Optional[int] = None,
                     end_lr: float = 1e-7, optimizer: Union[str, Sequence[str]] = "adam",
                     target_step: float = 1e5, bf16_moments: bool = False) -> List[Optimizer]:
    """One optimizer per net (TTUR, ``optim.py:132-151``): index 0
    discriminator, 1 generator."""
    if isinstance(optimizer, str):
        optimizer = [optimizer] * len(lr_list)
    elif len(optimizer) == 1:
        optimizer = list(optimizer) * len(lr_list)
    return [opt_config(lr, lr_decay_steps, end_lr, name, target_step, bf16_moments)
            for lr, name in zip(lr_list, optimizer)]
