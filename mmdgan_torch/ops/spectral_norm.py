"""Spectral normalization by power iteration on the layer operator (PICO),
for the plain ops ``d``, ``c``, ``tc`` and ``project`` and the conditional
ones ``cd``, ``dcd``, ``dck``, ``cck``, ``tcck``; and the PIM mode, power
iteration on the kernel reshaped to a matrix
(``mmdgan_tpu/ops/spectral_norm.py``).

The power vector lives in the smaller of the layer's input and output
spaces (``:147-156``), NCHW here: ``[1, C, H, W]`` for convolutions,
``[1, F]`` for dense layers; a conditional op keeps one vector per class
(``[num_class, ...]``, ``:127-129``) and one sigma per class (``:132-141``):
``[C, 1]`` for ``dck``, ``[C, 1, 1]`` for ``cd``/``dcd``, ``[C, 1, 1, 1]``
for ``cck``/``tcck``, which broadcasts against NCHW outputs once indexed
by label. One iteration per call: sigma keeps its gradient path to the
kernel, the new vector is detached (``:190-240``). The adjoints are
explicit (``ops/conv.py``'s ``Geometry.adjoint`` for convolutions).
Rank-1 kernels take closed forms (``:159-180``).

Kernel layouts are the port's: dense ``[in, out]``, conv ``[out, in, k, k]``,
transposed conv ``[in, out, k, k]``, the conditional scales ``[C, out]`` or
``[C, out, 1, 1]``; a conditional op's kernel is the pair (kernel,
c_kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from mmdgan_torch.ops.conv import Geometry

EPSI = 1e-10
CONDITIONAL = ("cd", "dcd", "dck", "cck", "tcck")


@dataclasses.dataclass(frozen=True)
class SnDef:
    """Static description of the linear op to be normalized.

    input_shape / output_shape: per-example shapes without the batch dim,
    ``(C, H, W)`` for conv ops and ``(F,)`` for dense ops (``(1, F)`` for
    ``dcd``). A conv op's stride, dilation and padding are its
    ``geometry`` (``ops/conv.py``)."""

    op: str
    input_shape: Tuple[int, ...] = ()
    output_shape: Tuple[int, ...] = ()
    num_class: int = 0
    geometry: Optional[Geometry] = None


def batched(sn: SnDef) -> int:
    """Leading dim of the power vector: 1, or num_class for conditional ops."""
    return sn.num_class if sn.op in CONDITIONAL else 1


def use_u(sn: SnDef) -> bool:
    """True when the power vector lives in the input space."""
    return int(np.prod(sn.input_shape)) <= int(np.prod(sn.output_shape))


def x_shape(sn: SnDef) -> Tuple[int, ...]:
    return (batched(sn),) + tuple(sn.input_shape if use_u(sn) else sn.output_shape)


def _operator_pair(sn: SnDef, kernel) -> Tuple[Callable, Callable]:
    """(F, F^T): the layer's map input -> output and its adjoint, batched
    over the power vector's leading dim."""
    op = sn.op
    if op == "d":
        return (lambda v: v @ kernel), (lambda y: y @ kernel.T)
    if op == "project":   # the [num_class, in] kernel as a map in -> num_class
        return (lambda v: v @ kernel.T), (lambda y: y @ kernel)
    if op in ("cd", "dcd"):
        w = kernel if op == "cd" else kernel[0][None] + kernel[1]
        return (lambda v: torch.einsum("cbn,cnm->cbm", v, w),
                lambda y: torch.einsum("cbm,cnm->cbn", y, w))
    if op == "dck":
        scale = 1.0 + kernel[1]
        return (lambda v: (v @ kernel[0]) * scale), (lambda y: (y * scale) @ kernel[0].T)
    geo = sn.geometry
    if op in ("c", "tc"):
        return (lambda v: geo.forward(v, kernel)), (lambda y: geo.adjoint(y, kernel))
    if op in ("cck", "tcck"):
        scale = 1.0 + kernel[1]
        return (lambda v: geo.forward(v, kernel[0]) * scale,
                lambda y: geo.adjoint(y * scale, kernel[0]))
    raise NotImplementedError(f"SpectralNorm: op {op} not supported")


def _norm(sn: SnDef, x: torch.Tensor) -> torch.Tensor:
    """Per-class or global l2 norm (math_func.py:639-651)."""
    if sn.op in ("cd", "dcd"):
        return torch.linalg.vector_norm(x, dim=2, keepdim=True)
    if sn.op == "dck":
        return torch.linalg.vector_norm(x, dim=1, keepdim=True)
    if sn.op in ("cck", "tcck"):
        return torch.sqrt(torch.sum(torch.square(x), dim=(1, 2, 3), keepdim=True))
    return torch.linalg.vector_norm(x)


def _l2n(sn: SnDef, x: torch.Tensor) -> torch.Tensor:
    return x / (_norm(sn, x) + EPSI)


def _closed_form(sn: SnDef, kernel) -> Optional[torch.Tensor]:
    """Rank-1 shortcuts (math_func.py:700-721)."""
    if sn.op in ("d", "project"):
        if 1 in kernel.shape:
            return torch.linalg.vector_norm(kernel)
    elif sn.op == "cd":
        if kernel.dim() == 2:
            return torch.linalg.vector_norm(kernel, dim=1, keepdim=True)
        if kernel.shape[1] == 1 or kernel.shape[2] == 1:
            return torch.sqrt(torch.sum(torch.square(kernel), dim=(1, 2), keepdim=True))
    elif sn.op == "dcd":
        if 1 in kernel[0].shape:
            cd = kernel[1] if kernel[1].dim() == 3 else kernel[1][:, :, None]
            comb = kernel[0][None] + cd
            return torch.sqrt(torch.sum(torch.square(comb), dim=(1, 2), keepdim=True))
    elif sn.op == "dck":
        if kernel[0].shape[1] == 1:
            return torch.linalg.vector_norm(kernel[0]) * torch.abs(kernel[1])
    return None


def spectral_norm_init(generator: torch.Generator, sn: SnDef) -> torch.Tensor:
    """The persistent power vector: a truncated normal at +-2, not
    normalized (as the reference's ``in_rand`` starts out)."""
    x = torch.empty(x_shape(sn), dtype=torch.float32)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)


def spectral_norm_apply(kernel, x_state: torch.Tensor,
                        sn: SnDef) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step; returns (sigma, new_x_state)."""
    closed = _closed_form(sn, kernel)
    if closed is not None:
        return closed, x_state
    fwd, adj = _operator_pair(sn, kernel)
    g, gt = (fwd, adj) if use_u(sn) else (adj, fwd)
    gx = g(x_state.detach())
    sigma = _norm(sn, gx)
    with torch.no_grad():
        x_new = _l2n(sn, gt(gx / (sigma + EPSI)))
    return sigma, x_new


def pim_matrix(kernel: torch.Tensor, op: str) -> torch.Tensor:
    """A conv kernel as the JAX package's matrix ``HWIO.reshape(-1, out)``:
    rows in (h, w, in) order, so the PIM power vector is JAX's as it is."""
    if op == "tc":   # [in, out, k, k], flipped
        hwio = torch.flip(kernel, (2, 3)).permute(2, 3, 0, 1)
    else:            # [out, in, k, k]
        hwio = kernel.permute(2, 3, 1, 0)
    return hwio.reshape(-1, hwio.shape[-1])


def _pim_def(num_in: int, num_out: int) -> SnDef:
    return SnDef(op="d", input_shape=(num_in,), output_shape=(num_out,))


def spectral_norm_pim_apply(kernel: torch.Tensor, x_state: torch.Tensor,
                            op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIM mode: power iteration on the kernel as a matrix
    (layer_func.py:811-814, the Miyato sn_paper approach)."""
    w = pim_matrix(kernel, op)
    return spectral_norm_apply(w, x_state, _pim_def(*w.shape))


def spectral_norm_pim_init(generator: torch.Generator, hwio_shape: Sequence[int]) -> torch.Tensor:
    """The PIM power vector of a kernel of JAX shape ``[k, k, in, out]``."""
    return spectral_norm_init(generator, _pim_def(int(np.prod(hwio_shape[:-1])),
                                                  int(hwio_shape[-1])))
