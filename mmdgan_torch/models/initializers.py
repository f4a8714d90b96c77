"""Weight and bias initializers (``mmdgan_tpu/models/initializers.py:20-88``).

``mode='default'``: variance scaling per activation, relu 2.0 fan_in
normal, lrelu 2/1.01 fan_in normal, sigmoid 16 fan_avg uniform, else
xavier fan_avg uniform; ``'sn_paper'``: a normal of std 0.02;
``'pg_paper'``: a unit normal (a runtime multiplier rescales). Normals are
truncated at +-2 standard deviations. Draws come from an explicit
``torch.Generator``; the same seed does not give JAX's numbers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def fans(shape: Sequence[int]) -> Tuple[float, float]:
    """(fan_in, fan_out) of a port kernel.

    Dense kernels are ``[in, out]``. Conv kernels are ``[out, in, k, k]``
    and transposed-conv kernels ``[in, out, k, k]``; for both, fan_in is
    ``shape[1] * k * k``. For the transposed conv that is the JAX package's
    swapped fans (``initializers.py:40-41``), which follow TF's
    ``[k, k, out, in]`` layout of those kernels."""
    shape = list(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def truncated_normal(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    x = torch.empty(tuple(shape), dtype=torch.float32)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)


def weight_initializer(act_fun: str, init_w_scale: float = 1.0, mode: str = "default"):
    """Return ``init(generator, shape, fan=None) -> Tensor`` for a port
    kernel; ``fan`` overrides ``fans(shape)`` where the port's layout is not
    the one the fans follow (the separable conv's depthwise kernel)."""
    if mode not in ("default", "sn_paper", "pg_paper"):
        raise NotImplementedError(f"initializer {mode} not implemented")

    def init(generator: torch.Generator, shape: Sequence[int], fan=None) -> torch.Tensor:
        if mode == "sn_paper":
            return 0.02 * truncated_normal(generator, shape)
        if mode == "pg_paper":
            return truncated_normal(generator, shape)
        if init_w_scale == 0.0:
            return torch.zeros(tuple(shape), dtype=torch.float32)
        fan_in, fan_out = fans(shape) if fan is None else fan
        if act_fun == "relu":
            scale, fan, dist = 2.0 * init_w_scale, fan_in, "normal"
        elif act_fun == "lrelu":  # assume alpha = 0.1
            scale, fan, dist = 2.0 / 1.01 * init_w_scale, fan_in, "normal"
        elif act_fun == "sigmoid":
            scale, fan, dist = 16.0 * init_w_scale, (fan_in + fan_out) / 2.0, "uniform"
        else:  # xavier
            scale, fan, dist = 1.0 * init_w_scale, (fan_in + fan_out) / 2.0, "uniform"
        if dist == "normal":
            return float(np.sqrt(scale / fan)) * truncated_normal(generator, shape)
        limit = float(np.sqrt(3.0 * scale / fan))
        x = torch.empty(tuple(shape), dtype=torch.float32)
        return x.uniform_(-limit, limit, generator=generator)

    return init


def bias_initializer(init_b_scale: float = 0.0):
    """Zeros, or a tiny truncated normal (``models/ops.py:284-286`` uses 1e-5)."""

    def init(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        if init_b_scale == 0.0:
            return torch.zeros(tuple(shape), dtype=torch.float32)
        return init_b_scale * truncated_normal(generator, shape)

    return init
