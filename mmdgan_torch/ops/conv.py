"""Convolutions with the JAX package's padding rules, and their adjoints
(``mmdgan_tpu/models/ops.py:72-84,365-382``; ``lax`` semantics). Shapes
are NCHW; memory is whatever the caller passes, NHWC (``channels_last``)
on the card under 16-bit compute (``models/ops.py`` ``nhwc_route``), and
the calls below keep it: torch's convs and ``F.pad`` return the layout of
their input.

A ``Geometry`` holds what ``lax.conv_general_dilated`` (op ``c``) or
``lax.conv_transpose`` (op ``tc``) makes of ``SAME`` / ``VALID`` padding,
a stride and a kernel dilation over one input size: the low and high pad
of each spatial axis. Where both axes pad symmetrically (every layer of
the repo's families) the convolution is one ``F.conv2d`` /
``F.conv_transpose2d`` call with torch's padding; an asymmetric ``SAME``
pads (``F.pad``) before an unpadded conv, and a transposed conv is cropped
or zero-extended after one (``F.pad`` with negative widths crops).

Kernel layouts are the port's: conv ``[out, in, k, k]``, transposed conv
``[in, out, k, k]`` (spatially flipped against the JAX package's HWIO).
The adjoints are the maps the spectral norm's power iteration needs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _conv_pads(size: int, ke: int, s: int, padding: str) -> Tuple[int, int]:
    """lax's pads of a conv over ``size`` with a dilated kernel ``ke``."""
    if str(padding).upper() == "VALID":
        return 0, 0
    total = max((math.ceil(size / s) - 1) * s + ke - size, 0)
    return total // 2, total - total // 2


def _conv_transpose_pads(ke: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax._conv_transpose_padding``: the pads of the conv over the
    stride-dilated input that a transposed conv is."""
    if str(padding).upper() == "SAME":
        pad_len = ke + s - 2
        lo = ke - 1 if s > ke - 1 else math.ceil(pad_len / 2)
    else:
        pad_len = ke + s - 2 + max(ke - s, 0)
        lo = ke - 1
    return lo, pad_len - lo


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One conv (``transpose=False``) or transposed conv over ``in_hw``:
    stride, dilation, kernel size, the lax pads ``((lo_h, hi_h), (lo_w,
    hi_w))``, and the output size."""

    transpose: bool
    kernel: int
    strides: int
    dilation: int
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]

    @classmethod
    def make(cls, op: str, in_hw, kernel: int, strides: int, dilation: int = 1,
             padding: str = "SAME") -> "Geometry":
        if str(padding).upper() not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding} not supported")
        ke = (kernel - 1) * dilation + 1
        transpose = op in ("tc", "tcck")
        pads, out = [], []
        for n in in_hw:
            if transpose:
                lo, hi = _conv_transpose_pads(ke, strides, padding)
                out.append((n - 1) * strides + 2 + lo + hi - ke)
            else:
                lo, hi = _conv_pads(n, ke, strides, padding)
                out.append((n + lo + hi - ke) // strides + 1)
            pads.append((lo, hi))
        return cls(transpose, kernel, strides, dilation, tuple(pads), tuple(in_hw), tuple(out))

    @property
    def ke(self) -> int:
        return (self.kernel - 1) * self.dilation + 1

    @property
    def symmetric(self) -> bool:
        return all(lo == hi for lo, hi in self.pads)

    def _crop(self) -> Tuple[int, int, int, int]:
        """F.pad widths (w_lo, w_hi, h_lo, h_hi) taking the full transposed
        conv (pads ke - 1) to lax's: negative crops, positive extends."""
        (lh, hh), (lw, hw) = self.pads
        k1 = self.ke - 1
        return (lw - k1, hw - k1, lh - k1, hh - k1)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        s, d = self.strides, self.dilation
        (lh, hh), (lw, hw) = self.pads
        if not self.transpose:
            if self.symmetric:
                return F.conv2d(x, w, stride=s, padding=(lh, lw), dilation=d)
            return F.conv2d(F.pad(x, (lw, hw, lh, hh)), w, stride=s, dilation=d)
        k1 = self.ke - 1
        if self.symmetric and lh <= k1 and lw <= k1:
            return F.conv_transpose2d(x, w, stride=s, padding=(k1 - lh, k1 - lw), dilation=d)
        return F.pad(F.conv_transpose2d(x, w, stride=s, dilation=d), self._crop())

    def adjoint(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The transpose of ``forward`` as a linear map of its input."""
        s, d = self.strides, self.dilation
        (lh, hh), (lw, hw) = self.pads
        if self.transpose:
            k1 = self.ke - 1
            if self.symmetric and lh <= k1 and lw <= k1:
                return F.conv2d(y, w, stride=s, padding=(k1 - lh, k1 - lw), dilation=d)
            return F.conv2d(F.pad(y, tuple(-c for c in self._crop())), w, stride=s, dilation=d)
        ho, wo = self.out_hw
        full = [(o - 1) * s + self.ke for o in (ho, wo)]
        padded = [n + lo + hi for n, (lo, hi) in zip(self.in_hw, self.pads)]
        if self.symmetric:
            extra = tuple(p - f for p, f in zip(padded, full))
            return F.conv_transpose2d(y, w, stride=s, padding=(lh, lw), output_padding=extra,
                                      dilation=d)
        out = F.conv_transpose2d(y, w, stride=s, dilation=d)
        return F.pad(out, (-lw, padded[1] - full[1] - hw, -lh, padded[0] - full[0] - hh))
