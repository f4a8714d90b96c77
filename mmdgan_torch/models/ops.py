"""ParametricOp: one parameterized operation from a design dict, cut to
``d``, ``c``, ``tc``, ``bias`` and ``bn`` (``mmdgan_tpu/models/ops.py``).

Shapes are per-example and channels-first: ``(C, H, W)`` or ``(F,)``.
Kernels: dense ``[in, out]``, conv ``[out, in, k, k]``, transposed conv
``[in, out, k, k]``. TF ``SAME`` padding is resolved once to torch's
symmetric padding; a layer whose ``SAME`` padding is asymmetric raises.

Spectral normalization (``w_nm='s'``) rescales the kernel by
``act_k / (sigma + EPSI)`` (``:342-347,444-450``). Mixed precision as in
the JAX package (``:350-414,529``): inputs and kernels are cast to
``compute_dtype`` before conv and matmul, and op outputs stay in it;
parameters, SN vectors and BN statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mmdgan_torch.models.initializers import bias_initializer, weight_initializer
from mmdgan_torch.ops.spectral_norm import (
    EPSI,
    SnDef,
    spectral_norm_apply,
    spectral_norm_init,
)

# tf.layers.batch_normalization defaults (layer_func.py:960-966)
BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def same_padding(op: str, size: int, kernel: int, strides: int) -> int:
    """Torch padding equal to TF/JAX ``SAME`` for a conv (``c``) or a
    ``lax.conv_transpose`` (``tc``) over a spatial size."""
    if op == "c":
        total = max((math.ceil(size / strides) - 1) * strides + kernel - size, 0)
        lo, hi = total // 2, total - total // 2
        pad = lo
    else:  # jax.lax.conv_transpose 'SAME' (lax._conv_transpose_padding)
        pad_len = kernel + strides - 2
        lo = kernel - 1 if strides > kernel - 1 else math.ceil(pad_len / 2)
        hi = pad_len - lo
        pad = kernel - 1 - lo
    if lo != hi:
        raise NotImplementedError(
            f"asymmetric SAME padding ({op}, size {size}, kernel {kernel}, "
            f"stride {strides}) is not ported")
    return pad


class ParametricOp:
    def __init__(
        self,
        design: dict,
        input_shape: Sequence[int],
        name: str = "kernel",
        scope_prefix: str = "",
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        self.design = dict(design)
        self.name = name
        self.name_in_err = scope_prefix + name
        self.input_shape = tuple(int(v) for v in input_shape)
        self.compute_dtype = compute_dtype
        self._infer_shapes()
        self._setup_spectral_norm()

    def _infer_shapes(self):
        d = self.design
        op = d["op"]
        ish = self.input_shape
        self.padding = 0
        if op == "d":
            assert len(ish) == 1, f"{self.name_in_err}: dense input must be 1-D, got {ish}"
            self.kernel_shape = (ish[0], d["out"])
            self.output_shape = (d["out"],)
        elif op in ("c", "tc"):
            c_in, h, w = ish
            k, s = d["kernel"], d["strides"]
            if d["dilation"] != 1 or str(d["padding"]).upper() != "SAME":
                raise NotImplementedError(
                    f"{self.name_in_err}: only dilation 1 and SAME padding are ported")
            pads = {same_padding(op, size, k, s) for size in (h, w)}
            if len(pads) != 1:
                raise NotImplementedError(f"{self.name_in_err}: H and W pad differently")
            self.padding = pads.pop()
            if op == "c":
                self.kernel_shape = (d["out"], c_in, k, k)
                self.output_shape = (d["out"], math.ceil(h / s), math.ceil(w / s))
            else:
                self.kernel_shape = (c_in, d["out"], k, k)
                self.output_shape = (d["out"], h * s, w * s)
        elif op in ("b", "bias"):
            self.kernel_shape = (ish[0],)
            self.output_shape = ish
        elif op == "bn":
            self.kernel_shape = None
            self.output_shape = ish
        else:
            raise NotImplementedError(f"{self.name_in_err}: op {op} is not ported")

    def _setup_spectral_norm(self):
        self.sn_def: Optional[SnDef] = None
        w_nm = self.design.get("w_nm")
        if w_nm in (None, False):
            return
        if w_nm != "s":
            raise NotImplementedError(f"{self.name_in_err}: w_nm {w_nm} not implemented")
        op = self.design["op"]
        if op not in ("d", "c", "tc"):
            raise NotImplementedError(
                f"{self.name_in_err}: spectral norm for {op} not implemented.")
        self.sn_def = SnDef(
            op=op, input_shape=self.input_shape, output_shape=self.output_shape,
            strides=self.design.get("strides", 1), padding=self.padding)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """Parameters and state on the CPU, drawn from ``generator``."""
        d = self.design
        op = d["op"]
        params: Dict[str, torch.Tensor] = {}
        state: Dict[str, torch.Tensor] = {}
        if op in ("d", "c", "tc"):
            scale = 1.0 if d.get("init_w_scale") is None else d["init_w_scale"]
            params["kernel"] = weight_initializer(d.get("act", "linear"), scale)(
                generator, self.kernel_shape)
        elif op in ("b", "bias"):
            params["bias"] = bias_initializer(1e-5)(generator, self.kernel_shape)
        elif op == "bn":
            c = self.input_shape[0]
            params["gamma"] = torch.ones(c)
            params["beta"] = torch.zeros(c)
            state["moving_mean"] = torch.zeros(c)
            state["moving_var"] = torch.ones(c)
        if self.sn_def is not None:
            state["sn_x"] = spectral_norm_init(generator, self.sn_def)
        return params, state

    def _multiplier(self, sigma):
        """act_k / sigma; a bool act_k (the template's False) means 1 / sigma."""
        act_k = self.design.get("act_k")
        if isinstance(act_k, (float, int)) and not isinstance(act_k, bool):
            return act_k / sigma
        return 1.0 / sigma

    def apply(self, params: Dict, state: Dict, x: torch.Tensor,
              train: bool = True) -> Tuple[torch.Tensor, Dict]:
        """Returns (output, new_state); x is ``[N, *input_shape]``."""
        d = self.design
        op = d["op"]
        assert tuple(x.shape[1:]) == self.input_shape, (
            f"{self.name_in_err}: input shape {tuple(x.shape[1:])} does not match "
            f"declared {self.input_shape}")
        new_state = dict(state)
        cd = self.compute_dtype

        kernel = params.get("kernel")
        if self.sn_def is not None:
            sigma, new_state["sn_x"] = spectral_norm_apply(kernel, state["sn_x"], self.sn_def)
            kernel = kernel * self._multiplier(sigma + EPSI)

        if op == "d":
            y = torch.matmul(x.to(cd), kernel.to(cd))
        elif op == "c":
            y = F.conv2d(x.to(cd), kernel.to(cd), stride=d["strides"], padding=self.padding)
        elif op == "tc":
            y = F.conv_transpose2d(x.to(cd), kernel.to(cd), stride=d["strides"],
                                   padding=self.padding)
        elif op in ("b", "bias"):
            b = params["bias"]
            y = x + (b if x.dim() == 2 else b.view(-1, 1, 1))
        else:
            y, new_state = self._batch_norm(params, state, new_state, x, train)
        return y.to(cd), new_state

    def _batch_norm(self, params, state, new_state, x, train):
        """BN by hand: biased batch variance, like tf.layers (and unlike
        ``nn.BatchNorm2d``, which stores the unbiased one)."""
        x = x.float()
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        view = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
        if train:
            mean = torch.mean(x, dim=dims)
            var = torch.var(x, dim=dims, correction=0)
            with torch.no_grad():
                new_state["moving_mean"] = (
                    BN_MOMENTUM * state["moving_mean"] + (1.0 - BN_MOMENTUM) * mean)
                new_state["moving_var"] = (
                    BN_MOMENTUM * state["moving_var"] + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = state["moving_mean"], state["moving_var"]
        y = (x - mean.view(view)) * torch.rsqrt(var + BN_EPS).view(view)
        return y * params["gamma"].view(view) + params["beta"].view(view), new_state
