"""ParametricOp: one parameterized operation from a design dict
(``mmdgan_tpu/models/ops.py``).

Op catalogue (layer_func.py:488-524):
  'i'   identity                    'k'    trainable scalar multiply
  'd'   dense                       'c'    conv
  'tc'  transpose conv              'sc'   separable conv
  'max' 'avg' 'sum'                 pooling
  'b'/'bias'  bias                  'cb'/'c_bias'  conditional bias
  'bcb' bias + conditional bias     'bn'   batch norm
  'cbn' conditional batch norm      'lrn'  local response normalization
  'project'  label projection       'dcd'  dense + conditional dense
  'dck' dense * (1+cond scale)      'cck'  conv * (1+cond scale)
  'tcck' transpose conv * (1+cond scale)

Shapes are per-example and channels-first: ``(C, H, W)`` or ``(F,)``.
Kernels: dense ``[in, out]``, conv ``[out, in, k, k]``, transposed conv
``[in, out, k, k]``, separable ``[C_in, 1, k, k]`` (depthwise) and
``[out, C_in, 1, 1]`` (pointwise); per-class tables ``[num_class, ch]``
over dense features and ``[num_class, ch, 1, 1]`` over images. TF's
``SAME`` / ``VALID`` padding and dilation are resolved once into an
``ops/conv.py`` ``Geometry``.

Conditional ops take labels ``[N]`` or ``[N, 1]`` (squeezed once, ``:435``)
and raise without them. Spectral normalization (``w_nm='s'``) rescales
the kernel of ``d``/``c``/``tc`` by ``act_k / (sigma + EPSI)``; a
conditional op scales its output by the per-class multiplier indexed by
label; ``project`` keeps its power vector but applies its kernel raw, as
the reference does (``:494-501``). Mixed precision as in the JAX package
(``:350-414,529``): inputs and kernels are cast to ``compute_dtype`` before
conv and matmul, gathers of float32 parameters promote locally, and op
outputs return to ``compute_dtype``; parameters, SN vectors and BN
statistics stay float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mmdgan_torch.models.initializers import bias_initializer, weight_initializer
from mmdgan_torch.models.scaling import avg_pool, max_pool
from mmdgan_torch.ops.conv import Geometry, conv_transpose_ps3
from mmdgan_torch.parallel.collectives import batch_moments
from mmdgan_torch.ops.spectral_norm import (
    EPSI,
    SnDef,
    spectral_norm_apply,
    spectral_norm_init,
    spectral_norm_pim_apply,
    spectral_norm_pim_init,
)

# The transposed conv's lowering (``mmdgan_tpu/models/ops.py:50-63``): a
# ``tc``/``tcck`` k=4/s2/SAME whose input is at least this tall runs as
# ``ops/conv.py`` ``conv_transpose_ps3`` (one 3x3/s1 conv to 4*Cout
# channels, then depth-to-space) instead of one ``F.conv_transpose2d``.
# JAX measured the direct route faster end to end on the TPU, hence inf.
# Read when an op is built and kept on it (``ParametricOp.tc_ps3``), so a
# captured graph and its replays take one route: set it before building a
# model to re-judge it (``tools/tc_study.py --e2e``).
TC_PS3_MIN_SIZE = float("inf")

# tf.layers.batch_normalization defaults (layer_func.py:960-966)
BN_MOMENTUM = 0.99
BN_EPS = 1e-3

CONDITIONAL_OPS = ("c_bias", "cb", "bcb", "cbn", "project", "dcd", "dck", "cck", "tcck")
_CONV_OPS = ("c", "tc", "cck", "tcck", "sc", "max", "avg", "sum")


def squeeze_labels(label: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``[N, 1]`` or ``[N]`` int labels as ``[N]`` int64 (None passes)."""
    if label is None:
        return None
    if label.dim() == 2:
        label = label[:, 0]
    return label.long()


class ParametricOp:
    def __init__(
        self,
        design: dict,
        input_shape: Sequence[int],
        name: str = "kernel",
        scope_prefix: str = "",
        num_class: int = 0,
        init_mode: str = "default",
        sn_mode: str = "pico",
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        self.design = dict(design)
        self.name = name
        self.name_in_err = scope_prefix + name
        self.input_shape = tuple(int(v) for v in input_shape)
        self.num_class = int(self.design.get("num_class", num_class))
        self.init_mode = init_mode
        self.sn_mode = sn_mode
        self.compute_dtype = compute_dtype
        self.geometry: Optional[Geometry] = None
        self._infer_shapes()
        self._setup_spectral_norm()
        d = self.design
        self.tc_ps3 = (d["op"] in ("tc", "tcck") and d["kernel"] == 4 and d["strides"] == 2
                       and d.get("dilation", 1) == 1
                       and str(d.get("padding", "SAME")).upper() == "SAME"
                       and self.input_shape[1] >= TC_PS3_MIN_SIZE)

    # static shape inference (layer_func.py:566-685) ----------------------
    def _infer_shapes(self):
        d = self.design
        op = d["op"]
        ish = self.input_shape
        nc = self.num_class
        if op in _CONV_OPS:
            c_in = ish[0]
            k, s = d["kernel"], d["strides"]
            conv_op = "tc" if op in ("tc", "tcck") else "c"
            dil = 1 if op in ("max", "avg", "sum") else d.get("dilation", 1)
            self.geometry = Geometry.make(conv_op, ish[1:], k, s, dil, d.get("padding", "SAME"))
            spatial = self.geometry.out_hw
        if op == "i":
            self.kernel_shape, self.output_shape = None, ish
        elif op == "k":
            self.kernel_shape, self.output_shape = (), ish
        elif op == "d":
            assert len(ish) == 1, f"{self.name_in_err}: dense input must be 1-D, got {ish}"
            self.kernel_shape, self.output_shape = (ish[0], d["out"]), (d["out"],)
        elif op in ("c", "cck"):
            conv = (d["out"], c_in, k, k)
            self.kernel_shape = conv if op == "c" else (conv, (nc, d["out"], 1, 1))
            self.output_shape = (d["out"],) + spatial
        elif op in ("tc", "tcck"):
            conv = (c_in, d["out"], k, k)
            self.kernel_shape = conv if op == "tc" else (conv, (nc, d["out"], 1, 1))
            self.output_shape = (d["out"],) + spatial
        elif op == "sc":
            self.kernel_shape = ((c_in, 1, k, k), (d["out"], c_in, 1, 1))
            self.output_shape = (d["out"],) + spatial
        elif op in ("max", "avg", "sum"):
            self.kernel_shape = (k,)
            self.output_shape = (d.get("out", c_in) or c_in,) + spatial
        elif op in ("b", "bias"):
            self.kernel_shape, self.output_shape = (ish[0],), ish
        elif op in ("bn", "lrn"):
            self.kernel_shape, self.output_shape = None, ish
        elif op in ("cbn", "c_bias", "cb", "bcb"):
            table = (nc, ish[0]) + (1, 1) * (len(ish) == 3)
            self.kernel_shape = ((ish[0],), table) if op == "bcb" else table
            self.output_shape = ish
        elif op == "project":
            assert len(ish) == 1
            self.kernel_shape, self.output_shape = (nc, ish[0]), (1,)
        elif op == "dcd":
            self.kernel_shape = ((ish[0], d["out"]), (nc, ish[0], d["out"]))
            self.output_shape = (d["out"],)
        elif op == "dck":
            self.kernel_shape = ((ish[0], d["out"]), (nc, d["out"]))
            self.output_shape = (d["out"],)
        else:
            raise ValueError(f"{self.name_in_err}: op {op} not supported")

    # spectral norm wiring (layer_func.py:785-826) -------------------------
    def _setup_spectral_norm(self):
        self.sn_def: Optional[SnDef] = None
        self.use_pim = False
        w_nm = self.design.get("w_nm")
        if w_nm in (None, False):
            return
        if w_nm != "s":
            raise NotImplementedError(f"{self.name_in_err}: w_nm {w_nm} not implemented")
        op = self.design["op"]
        ish, osh, nc = self.input_shape, self.output_shape, self.num_class
        if op == "project":
            self.sn_def = SnDef(op="project", input_shape=(ish[0],), output_shape=(nc,))
        elif op == "dcd":
            self.sn_def = SnDef(op="dcd", input_shape=(1, ish[0]), output_shape=(1, osh[0]),
                                num_class=nc)
        elif op in ("d", "dck"):
            self.sn_def = SnDef(op=op, input_shape=(ish[0],), output_shape=(osh[0],),
                                num_class=nc)
        elif op in ("c", "tc", "cck", "tcck"):
            if self.sn_mode in ("default", "pico", "PICO"):
                self.sn_def = SnDef(op=op, input_shape=ish, output_shape=osh, num_class=nc,
                                    geometry=self.geometry)
            elif self.sn_mode in ("sn_paper", "pim", "PIM"):
                assert op in ("c", "tc"), f"{self.name_in_err}: PIM mode only for plain convs"
                self.use_pim = True
            else:
                raise NotImplementedError(f"sn mode {self.sn_mode}")
        else:
            raise NotImplementedError(
                f"{self.name_in_err}: spectral norm for {op} not implemented.")

    # parameters and state (layer_func.py:709-783) -------------------------
    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """Parameters and state on the CPU, drawn from ``generator``."""
        d = self.design
        op = d["op"]
        ks = self.kernel_shape
        params: Dict[str, torch.Tensor] = {}
        state: Dict[str, torch.Tensor] = {}
        w_init = weight_initializer(d.get("act", "linear"),
                                    1.0 if d.get("init_w_scale") is None else d["init_w_scale"],
                                    mode=self.init_mode)
        tiny = bias_initializer(1e-5)   # the tiny non-zero bias (layer_func.py:741-747)
        if op in ("d", "c", "tc", "project"):
            params["kernel"] = w_init(generator, ks)
        elif op == "k":
            params["kernel"] = (torch.zeros(()) if d.get("init_w_scale") == 0.0
                                else torch.ones(()))
        elif op == "sc":
            c_in, k = self.input_shape[0], d["kernel"]
            # the JAX package's fans of its [k, k, C_in, 1] depthwise kernel
            params["depthwise_kernel"] = w_init(generator, ks[0], fan=(c_in * k * k, k * k))
            params["pointwise_kernel"] = w_init(generator, ks[1])
        elif op in ("b", "bias"):
            params["bias"] = tiny(generator, ks)
        elif op in ("c_bias", "cb"):
            params["c_bias"] = tiny(generator, ks)
        elif op == "bcb":
            params["bias"] = tiny(generator, ks[0])
            params["c_bias"] = torch.zeros(ks[1])
        elif op in ("bn", "cbn"):
            c = self.input_shape[0]
            if op == "cbn":
                params["scale"] = torch.ones(ks)
                params["offset"] = tiny(generator, ks)
            else:
                if d.get("bn_scale", True):
                    params["gamma"] = torch.ones(c)
                if d.get("bn_center", True):
                    params["beta"] = torch.zeros(c)
            state["moving_mean"] = torch.zeros(c)
            state["moving_var"] = torch.ones(c)
        elif op in ("dcd", "dck", "cck", "tcck"):
            params["kernel"] = w_init(generator, ks[0])
            params["c_kernel"] = torch.zeros(ks[1])
        if self.sn_def is not None:
            state["sn_x"] = spectral_norm_init(generator, self.sn_def)
        elif self.use_pim:
            c_out = self.output_shape[0]
            k = d["kernel"]
            state["sn_x"] = spectral_norm_pim_init(generator, (k, k, self.input_shape[0], c_out))
        return params, state

    # runtime multiplier act_k / sigma (layer_func.py:827-892) -------------
    def kernel_norm(self, params: Dict, state: Dict):
        """(sigma, new power vector), or (None, None) without SN."""
        if self.sn_def is None and not self.use_pim:
            return None, None
        op = self.design["op"]
        if self.use_pim:
            return spectral_norm_pim_apply(params["kernel"], state["sn_x"], op)
        kernel = ((params["kernel"], params["c_kernel"]) if op in ("dcd", "dck", "cck", "tcck")
                  else params["kernel"])
        sigma, x_new = spectral_norm_apply(kernel, state["sn_x"], self.sn_def)
        if op == "dcd" and sigma.dim() == 3:
            sigma = sigma[:, :, 0]   # [num_class, 1]
        return sigma, x_new

    def _multiplier(self, sigma):
        """act_k / sigma; a bool act_k (the template's False) means 1 / sigma."""
        act_k = self.design.get("act_k")
        if isinstance(act_k, (float, int)) and not isinstance(act_k, bool):
            return act_k / sigma
        return 1.0 / sigma

    def _conv(self, x, w):
        cd = self.compute_dtype
        if self.tc_ps3:
            return conv_transpose_ps3(x.to(cd), w.to(cd))
        return self.geometry.forward(x.to(cd), w.to(cd))

    def apply(self, params: Dict, state: Dict, x: torch.Tensor, train: bool = True,
              label: Optional[torch.Tensor] = None, dp=None) -> Tuple[torch.Tensor, Dict]:
        """Returns (output, new_state); x is ``[N, *input_shape]``. With a
        mesh (``dp``), train-mode BN takes its statistics over the global
        batch."""
        d = self.design
        op = d["op"]
        assert tuple(x.shape[1:]) == self.input_shape, (
            f"{self.name_in_err}: input shape {tuple(x.shape[1:])} does not match "
            f"declared {self.input_shape}")
        assert op not in CONDITIONAL_OPS or label is not None, (
            f"{self.name_in_err}: labels must be provided for op {op}")
        label = squeeze_labels(label)
        new_state = dict(state)
        cd = self.compute_dtype

        multiplier = None
        sigma, x_new = self.kernel_norm(params, state)
        if sigma is not None:
            new_state["sn_x"] = x_new
            multiplier = self._multiplier(sigma + EPSI)
        kernel = params.get("kernel")
        if multiplier is not None and op in ("d", "c", "tc"):
            kernel = kernel * multiplier

        if op == "i":
            y = x
        elif op == "k":
            if "bound" in d:   # clipped to keep its gradient from exploding
                kernel = torch.clamp(kernel, *d["bound"])
            y = x * kernel
        elif op == "d":
            y = torch.matmul(x.to(cd), kernel.to(cd))
        elif op in ("c", "tc"):
            y = self._conv(x, kernel)
        elif op == "sc":
            geo = self.geometry
            dw = params["depthwise_kernel"].to(cd)
            (lh, hh), (lw, hw) = geo.pads
            xp = x.to(cd) if geo.symmetric else F.pad(x.to(cd), (lw, hw, lh, hh))
            y = F.conv2d(xp, dw, stride=geo.strides, dilation=geo.dilation,
                         padding=(lh, lw) if geo.symmetric else 0, groups=self.input_shape[0])
            y = F.conv2d(y, params["pointwise_kernel"].to(cd))
        elif op == "max":
            y = max_pool(x, d["kernel"], d["strides"], d["padding"])
        elif op in ("avg", "sum"):
            # the reference's 'sum' is avg_pool * k^2 (layer_func.py:941-945)
            y = avg_pool(x, d["kernel"], d["strides"], d["padding"])
            if op == "sum":
                y = y * d["kernel"] ** 2
        elif op in ("b", "bias"):
            b = params["bias"]
            y = x + (b if x.dim() == 2 else b.view(-1, 1, 1))
        elif op in ("bn", "cbn"):
            y, new_state = self._batch_norm(params, state, new_state, x, train, label, dp)
        elif op == "lrn":
            # normalize by the RMS over channels (layer_func.py:462-477)
            y = x / torch.sqrt(torch.mean(torch.square(x), dim=1, keepdim=True) + EPSI)
        elif op == "project":
            y = torch.sum(kernel[label] * x, dim=1, keepdim=True)
        elif op in ("c_bias", "cb"):
            y = x + params["c_bias"][label]
        elif op == "bcb":
            b = params["bias"]
            y = x + (b if x.dim() == 2 else b.view(-1, 1, 1)) + params["c_bias"][label]
        elif op == "dcd":
            y = torch.matmul(x.to(cd), kernel.to(cd))
            y = y + torch.einsum("ni,nio->no", x.float(), params["c_kernel"][label])
        elif op in ("dck", "cck", "tcck"):
            y = torch.matmul(x.to(cd), kernel.to(cd)) if op == "dck" else self._conv(x, kernel)
            y = y * (1.0 + params["c_kernel"])[label]
        else:
            raise ValueError(f"{self.name_in_err}: op {op} not supported")
        if multiplier is not None and op in ("dcd", "dck", "cck", "tcck"):
            y = y * multiplier[label]
        return y.to(cd), new_state

    def _batch_norm(self, params, state, new_state, x, train, label, dp=None):
        """BN by hand: biased batch variance, like tf.layers (and unlike
        ``nn.BatchNorm2d``, which stores the unbiased one); ``cbn`` scales
        and offsets per class (layer_func.py:967-971). With a mesh the
        train-mode statistics are the global batch's (cross-replica sums,
        ``mmdgan_tpu/models/ops.py:536-552`` under XLA's partitioner), so
        the moving statistics are the same on every rank."""
        x = x.float()
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        view = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
        if train and dp is not None:
            mean, var = batch_moments(x, dims, dp)
        elif train:
            mean = torch.mean(x, dim=dims)
            var = torch.var(x, dim=dims, correction=0)
        if train:
            with torch.no_grad():
                new_state["moving_mean"] = (
                    BN_MOMENTUM * state["moving_mean"] + (1.0 - BN_MOMENTUM) * mean)
                new_state["moving_var"] = (
                    BN_MOMENTUM * state["moving_var"] + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = state["moving_mean"], state["moving_var"]
        y = (x - mean.view(view)) * torch.rsqrt(var + BN_EPS).view(view)
        if self.design["op"] == "cbn":
            return y * params["scale"][label] + params["offset"][label], new_state
        if "gamma" in params:
            y = y * params["gamma"].view(view)
        if "beta" in params:
            y = y + params["beta"].view(view)
        return y, new_state
