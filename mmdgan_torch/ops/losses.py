"""GAN losses 'rep' and 'rmb' (``mmdgan_tpu/ops/losses.py:133-157,225-266,517-544``).

``GANLoss.apply(score_gen, score_data, loss_type, batch_size=...)`` returns
``(loss_gen, loss_dis, new_state, aux)`` like the JAX dispatcher, with the
kernel means in ``aux`` under ``e_kxx``/``e_kxy``/``e_kyy`` (and the
``*_b`` bounded means for 'rmb').

``use_fused_kernel`` (the counterpart of JAX's ``use_pallas``) routes both
losses through ``cuda_mmd.fused_kernel_means``: on CUDA tensors that is
the hand-written kernel, on CPU tensors its plain version. It defaults to
True: JAX's default-off rests on a TPU measurement that says nothing about
this card. With it off, the losses take the plain distance + kernel path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from mmdgan_torch.ops.cuda_mmd import (
    MEAN_KEYS,
    repulsive_mmd_g_bounded_fused,
    repulsive_mmd_g_fused,
)
from mmdgan_torch.ops.distance import get_squared_dist
from mmdgan_torch.ops.kernels import mmd_g, mmd_g_bounded


@dataclasses.dataclass
class LossState:
    """Persistent loss state. 'rep' and 'rmb' keep none; the fields are
    those of the JAX ``LossState`` so the step threads the same tree."""

    loss_average: torch.Tensor
    mix_prob: torch.Tensor
    ins_sigma: torch.Tensor

    @staticmethod
    def init(device="cpu") -> "LossState":
        z = lambda: torch.zeros((), dtype=torch.float32, device=device)
        return LossState(loss_average=z(), mix_prob=z(), ins_sigma=z())


@dataclasses.dataclass
class GANLoss:
    # weights for e_kxy and -e_kyy; w[0]-w[1] == 1; k_yy is the REAL data kernel
    repulsive_weights: Sequence[float] = (0.0, -1.0)
    use_fused_kernel: bool = True

    def _repulsive(self, s_gen, s_x, batch_size, aux):
        """'rep' — the paper's repulsive loss."""
        if self.use_fused_kernel:
            loss_gen, loss_dis, e = repulsive_mmd_g_fused(
                s_gen, s_x, sigma=1.0, repulsive_weights=tuple(self.repulsive_weights))
            aux.update(zip(MEAN_KEYS[:3], e[:3]))
        else:
            d_gg, d_gd, d_dd = get_squared_dist(s_gen, s_x, mode="xxxyyy")
            loss_gen, loss_dis, k_aux = mmd_g(
                d_gg, d_gd, d_dd, batch_size, sigma=1.0,
                custom_weights=self.repulsive_weights, with_aux=True)
            aux.update(k_aux)
        return loss_gen, loss_dis

    def _repulsive_bounded(self, s_gen, s_x, batch_size, aux):
        """'rmb' — repulsive loss with the bounded rbf kernel."""
        if self.use_fused_kernel:
            loss_gen, loss_dis, e = repulsive_mmd_g_bounded_fused(
                s_gen, s_x, sigma=1.0, repulsive_weights=tuple(self.repulsive_weights))
            aux.update(zip(MEAN_KEYS, e))
        else:
            d_gg, d_gd, d_dd = get_squared_dist(s_gen, s_x, mode="xxxyyy")
            loss_gen, loss_dis, k_aux = mmd_g_bounded(
                d_gg, d_gd, d_dd, batch_size, sigma=1.0, lower_bound=0.25,
                upper_bound=4.0, custom_weights=self.repulsive_weights, with_aux=True)
            aux.update(k_aux)
        return loss_gen, loss_dis

    def apply(
        self,
        score_gen: torch.Tensor,
        score_data: torch.Tensor,
        loss_type: str = "rep",
        batch_size: Optional[int] = None,
        state: Optional[LossState] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, LossState, Dict[str, torch.Tensor]]:
        if state is None:
            state = LossState.init(score_gen.device)
        assert batch_size is not None, "GANLoss: batch_size must be provided"
        assert score_gen.shape[0] == score_data.shape[0] == batch_size, (
            f"GANLoss: score shapes {score_gen.shape[0]}/{score_data.shape[0]} "
            f"do not match batch_size {batch_size}")
        aux: Dict[str, torch.Tensor] = {}
        if loss_type == "rep":
            lg, ld = self._repulsive(score_gen, score_data, batch_size, aux)
        elif loss_type == "rmb":
            lg, ld = self._repulsive_bounded(score_gen, score_data, batch_size, aux)
        else:
            raise NotImplementedError(f"loss {loss_type} is not ported yet.")
        return lg, ld, state, aux

    def __call__(self, *args, **kwargs):
        return self.apply(*args, **kwargs)


def gan_loss(score_gen, score_data, loss_type="rep", **kwargs):
    """Convenience wrapper constructing a default :class:`GANLoss`;
    ``rep_weights`` and ``use_fused_kernel`` configure it, the rest goes to
    :meth:`GANLoss.apply`."""
    hp = {}
    if "rep_weights" in kwargs:
        hp["repulsive_weights"] = kwargs.pop("rep_weights")
    if "use_fused_kernel" in kwargs:
        hp["use_fused_kernel"] = kwargs.pop("use_fused_kernel")
    return GANLoss(**hp).apply(score_gen, score_data, loss_type, **kwargs)
