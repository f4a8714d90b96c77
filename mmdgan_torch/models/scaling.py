"""Image up- and down-sampling, NCHW (``mmdgan_tpu/models/scaling.py``):
periodic shuffling, the align-corners bilinear and bicubic resizes,
pooling and unpooling. Stateless and parameter-free.

Periodic shuffling keeps the JAX package's NHWC channel order (TF's
``depth_to_space``: output pixel (i, j) of a block reads channel
``(i * r + j) * C_out + c``), not ``torch.nn.functional.pixel_shuffle``'s
(``c * r * r + i * r + j``), so a bridged model computes the same images.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch.ops.conv import _conv_pads


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    n, c, h, w = x.shape
    c_out = c // (r * r)
    x = x.reshape(n, r, r, c_out, h, w).permute(0, 3, 4, 1, 5, 2)   # n c h i w j
    return x.reshape(n, c_out, h * r, w * r)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 3, 5, 1, 2, 4)   # n i j c h w
    return x.reshape(n, r * r * c, h // r, w // r)


def periodic_shuffling(x: torch.Tensor, scale_factor: int, scale_up: bool = True) -> torch.Tensor:
    """Sub-pixel conv shuffle (layer_func.py:197-244)."""
    return depth_to_space(x, scale_factor) if scale_up else space_to_depth(x, scale_factor)


def _pool_pads(x: torch.Tensor, k: int, s: int, padding: str):
    (lh, hh), (lw, hw) = (_conv_pads(n, k, s, padding) for n in x.shape[2:])
    return (lw, hw, lh, hh)


def max_pool(x: torch.Tensor, k: int, s: int, padding: str = "SAME") -> torch.Tensor:
    """``lax.reduce_window`` max: SAME pads with -inf."""
    return F.max_pool2d(F.pad(x, _pool_pads(x, k, s, padding), value=-float("inf")), k, s)


def avg_pool(x: torch.Tensor, k: int, s: int, padding: str = "SAME") -> torch.Tensor:
    """The window's sum over its cells inside the image (TF's avg_pool
    excludes the padding)."""
    pads = _pool_pads(x, k, s, padding)
    summed = F.avg_pool2d(F.pad(x, pads), k, s, divisor_override=1)
    if str(padding).upper() == "VALID":
        return summed / (k * k)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device), pads)
    return summed / F.avg_pool2d(ones, k, s, divisor_override=1)


def resize_matrix(n_in: int, n_out: int, kind: str) -> np.ndarray:
    """Interpolation matrix [n_out, n_in] with TF1 align_corners=True
    semantics: output i samples input coordinate i*(n_in-1)/(n_out-1);
    'cubic' is Keys' kernel with a=-0.75 (tf.image.resize_bicubic), its
    offset quantized to TF's 1024-entry table, edge taps clamped
    (``scaling.py:67-103``)."""
    W = np.zeros((n_out, n_in), np.float32)
    if n_out == 1:
        W[0, 0] = 1.0
        return W
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)

    def cubic(u, a=-0.75):
        u = abs(u)
        if u <= 1.0:
            return (a + 2) * u ** 3 - (a + 3) * u ** 2 + 1
        if u < 2.0:
            return a * u ** 3 - 5 * a * u ** 2 + 8 * a * u - 4 * a
        return 0.0

    for i, s in enumerate(src):
        j0 = int(np.floor(s))
        t = s - j0
        if kind == "linear":
            taps = ((j0, 1.0 - t), (j0 + 1, t))
        else:
            t = round(t * 1024.0) / 1024.0
            taps = tuple((j0 + dj, cubic(t - dj)) for dj in (-1, 0, 1, 2))
        for j, wgt in taps:
            if wgt != 0.0:
                W[i, min(max(j, 0), n_in - 1)] += wgt
    return W


class ImageScaling:
    """One scaling op from a design dict (layer_func.py:1041-1186).

    design keys: 'method' ('ps' | 'bil' | 'bic' | 'max' | 'avg' |
    'unpool'), 'factor' (positive up, negative down) or 'size' (target
    (h, w) when factor is None). ``input_shape`` is per-example (C, H, W)."""

    def __init__(self, design: dict, input_shape: Sequence[int], name: str = "scale"):
        self.method = design["method"]
        self.name = name
        self.input_shape = tuple(input_shape)
        fan_in, h, w = self.input_shape
        factor = design.get("factor", 2)
        new_h, new_w = design.get("size", (None, None))
        if factor is None:
            assert new_h / h == new_w / w, "height/width factors do not match."
            factor = int(new_h / h) if new_h > h else -int(h / new_h)
        elif factor > 0:
            new_h, new_w = int(h * factor), int(w * factor)
        elif factor < 0:
            new_h, new_w = int(-h / factor), int(-w / factor)
        else:
            raise ValueError(f"{name}: factor cannot be zero.")
        self.factor = factor
        if factor > 0 and self.method in ("avg", "max"):
            raise ValueError(f"{name}: {self.method} can only be used for downsampling")
        if factor < 0 and self.method == "unpool":
            raise ValueError(f"{name}: unpool can only be used for upsampling")
        if factor != 2 and self.method == "unpool":
            raise ValueError(f"{name}: unpool can only deal with factor = 2")
        if self.method not in ("ps", "bil", "bic", "max", "avg", "unpool"):
            raise NotImplementedError(f"{name}: method {self.method} not implemented.")
        fan_out = int(fan_in * h * w / new_h / new_w) if self.method == "ps" else fan_in
        self.output_shape = (fan_out, new_h, new_w)
        if self.method in ("bil", "bic"):
            kind = "linear" if self.method == "bil" else "cubic"
            self._mats = {None: (torch.from_numpy(resize_matrix(h, new_h, kind)),
                                 torch.from_numpy(resize_matrix(w, new_w, kind)))}

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "ps":
            return periodic_shuffling(x, abs(self.factor), self.factor > 0)
        if self.method in ("bil", "bic"):
            # two interpolation matmuls in float32 (align_corners=True, as
            # the reference's tf.image.resize_* calls, layer_func.py:1142)
            if x.device not in self._mats:   # copied once, outside any graph capture
                self._mats[x.device] = tuple(m.to(x.device) for m in self._mats[None])
            wh, ww = self._mats[x.device]
            y = torch.einsum("oh,nchw->ncow", wh, x.float())
            return torch.einsum("pw,ncow->ncop", ww, y).to(x.dtype)
        if self.method == "max":
            return max_pool(x, -self.factor, -self.factor, "SAME")
        if self.method == "avg":
            return avg_pool(x, -self.factor, -self.factor, "SAME")
        return periodic_shuffling(torch.cat([x] * 4, dim=1), 2, True)   # unpool

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)
