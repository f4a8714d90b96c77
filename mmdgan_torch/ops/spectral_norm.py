"""Spectral normalization by power iteration on the layer operator (PICO),
for ops ``d``, ``c`` and ``tc`` (``mmdgan_tpu/ops/spectral_norm.py``).

The power vector lives in the smaller of the layer's input and output
spaces (``:147-156``), NCHW here: ``[1, C, H, W]`` for convolutions,
``[1, F]`` for dense layers. One iteration per call: sigma keeps its
gradient path to the kernel, the new vector is detached (``:190-240``).
The adjoint of a convolution is the explicit ``conv_transpose2d`` /
``conv2d`` pair with the same stride and padding.

Kernel layouts are the port's: dense ``[in, out]``, conv ``[out, in, k, k]``,
transposed conv ``[in, out, k, k]`` (``torch.nn.functional.conv_transpose2d``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPSI = 1e-10


@dataclasses.dataclass(frozen=True)
class SnDef:
    """Static description of the linear op to be normalized.

    input_shape / output_shape: per-example shapes without the batch dim,
    ``(C, H, W)`` for conv ops and ``(F,)`` for dense ops. ``padding`` is
    the symmetric torch padding of the conv (``models/ops.py`` resolves TF
    ``SAME`` to it)."""

    op: str
    input_shape: Tuple[int, ...] = ()
    output_shape: Tuple[int, ...] = ()
    strides: int = 1
    padding: int = 0


def use_u(sn: SnDef) -> bool:
    """True when the power vector lives in the input space."""
    return int(np.prod(sn.input_shape)) <= int(np.prod(sn.output_shape))


def x_shape(sn: SnDef) -> Tuple[int, ...]:
    return (1,) + tuple(sn.input_shape if use_u(sn) else sn.output_shape)


def _output_padding(sn: SnDef, kernel: torch.Tensor, space: Tuple[int, ...],
                    other: Tuple[int, ...]) -> int:
    """output_padding that makes a transposed conv from ``other`` land on
    ``space`` (0 for every cifar layer)."""
    k = kernel.shape[-1]
    return space[1] - ((other[1] - 1) * sn.strides - 2 * sn.padding + k)


def _operator_pair(sn: SnDef, kernel: torch.Tensor) -> Tuple[Callable, Callable]:
    """(F, F^T): the layer's map input -> output and its adjoint."""
    if sn.op == "d":
        return (lambda v: v @ kernel), (lambda y: y @ kernel.T)
    s, p = sn.strides, sn.padding
    if sn.op == "c":
        op_in = _output_padding(sn, kernel, sn.input_shape, sn.output_shape)
        return (lambda v: F.conv2d(v, kernel, stride=s, padding=p),
                lambda y: F.conv_transpose2d(y, kernel, stride=s, padding=p,
                                             output_padding=op_in))
    if sn.op == "tc":
        op_out = _output_padding(sn, kernel, sn.output_shape, sn.input_shape)
        return (lambda v: F.conv_transpose2d(v, kernel, stride=s, padding=p,
                                             output_padding=op_out),
                lambda y: F.conv2d(y, kernel, stride=s, padding=p))
    raise NotImplementedError(f"SpectralNorm: op {sn.op} not supported")


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + EPSI)


def spectral_norm_init(generator: torch.Generator, sn: SnDef) -> torch.Tensor:
    """The persistent power vector: a truncated normal at +-2, not
    normalized (as the reference's ``in_rand`` starts out)."""
    x = torch.empty(x_shape(sn), dtype=torch.float32)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)


def spectral_norm_apply(kernel: torch.Tensor, x_state: torch.Tensor,
                        sn: SnDef) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step; returns (sigma, new_x_state)."""
    if sn.op == "d" and 1 in kernel.shape:   # rank-1 closed form (:159-164)
        return torch.linalg.vector_norm(kernel), x_state
    fwd, adj = _operator_pair(sn, kernel)
    g, gt = (fwd, adj) if use_u(sn) else (adj, fwd)
    gx = g(x_state.detach())
    sigma = torch.linalg.vector_norm(gx)
    with torch.no_grad():
        x_new = _l2n(gt(gx / (sigma + EPSI)))
    return sigma, x_new
