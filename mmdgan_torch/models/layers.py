"""Layer: ParametricOps and ImageScalings composed into one block
(``mmdgan_tpu/models/layers.py``; layer_func.py:1189-2108).

Block types (layer_func.py:2060-2068):
  'default' / 'project' / 'c_bias':
      upsampling - kernel - bias - BN - act - downsampling
      (+ the label-projection head for 'project', layer_func.py:1611-1685)
  'res' / 'res_i' / 'res_v1': two-conv residual block with a configurable
      shortcut (layer_func.py:1687-1842); ``act`` may be a per-index list
  'nl', 'nl_dist', 'nl_pool', 'nl_pool_dist': SAGAN-style self-attention
      with dot-product or distance logits (layer_func.py:1844-2041)

Labels ride beside the activations: ``apply(..., label=y)`` hands them to
every op, and conditional ops raise without them.

Reshape specs in the architecture dicts are channels-first, which is the
port's layout, so ``in_reshape``/``out_reshape`` apply as they stand. A
flatten therefore orders features C-major where the JAX package orders
them H-major; ``utils/jax_bridge.py`` permutes the dense kernels at those
boundaries. ``crelu`` doubles the channels (axis 1 in NCHW), and the
shape inference follows it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch.models.ops import ParametricOp
from mmdgan_torch.models.scaling import ImageScaling
from mmdgan_torch.ops.distance import get_batch_squared_dist
from mmdgan_torch.utils import spans


def update_layer_design(layer_design: dict) -> dict:
    """Normalize a layer design dict against the template
    (layer_func.py:1189-1275)."""
    template = {
        "name": None, "type": "default", "op": "c", "out": None, "bias": "b",
        "act": "linear", "act_nm": None, "act_k": False,
        "w_nm": None, "w_p": None,
        "kernel": 3, "strides": 1, "dilation": 1, "padding": "SAME", "scale": None,
        "in_reshape": None, "out_reshape": None, "aux": None,
    }
    template.update(layer_design)
    # batch norm replaces plain bias (layer_func.py:1241-1244)
    if template["act_nm"] in ("bn", "BN") and template["bias"] in ("b", "bias"):
        template["bias"] = None
    if template["act_nm"] in ("cbn", "CBN"):
        template["bias"] = None
    if template["op"] in ("tc",):  # tc is itself the upsampler
        template["scale"] = None
    if template["scale"] is not None:
        assert isinstance(template["scale"], (list, tuple)), \
            'Value for key "scale" must be list or tuple.'
    if template["w_nm"] is not None:
        assert not isinstance(template["w_nm"], (list, tuple)), \
            'Value for key "w_nm" must not be list or tuple.'
    if template["op"] in ("d", "dcd", "dck"):
        keys = ["name", "op", "type", "out", "bias", "act", "act_nm", "act_k",
                "w_nm", "w_p", "in_reshape", "out_reshape", "aux"]
    elif template["op"] in ("sc", "c", "tc", "avg", "max", "sum", "cck", "tcck"):
        keys = ["name", "op", "type", "out", "bias", "act", "act_nm", "act_k",
                "w_nm", "w_p", "kernel", "strides", "dilation", "padding", "scale",
                "in_reshape", "out_reshape", "aux"]
    elif template["op"] in ("i",):
        keys = ["name", "op", "act", "act_nm", "type", "in_reshape", "out_reshape"]
    else:
        raise ValueError("layer op {} not supported.".format(template["op"]))
    return {k: template[k] for k in keys}


ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "crelu": lambda x: torch.cat([F.relu(x), F.relu(-x)], dim=1),
    "elu": F.elu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "selu": F.selu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def apply_activation(x: torch.Tensor, act: str) -> torch.Tensor:
    try:
        return ACTIVATIONS[act](x)
    except KeyError:
        raise NotImplementedError(f"Activation {act} is not implemented.")


def activation_shape(shape: Tuple[int, ...], act: str) -> Tuple[int, ...]:
    """The shape after ``act``: crelu doubles the channels."""
    return (2 * shape[0],) + tuple(shape[1:]) if act == "crelu" else tuple(shape)


class Layer:
    """One block. Built when its per-example (channels-first) input shape
    is known: at construction when given, else by the Routine that links
    it."""

    def __init__(self, design: dict, input_shape: Optional[Sequence[int]] = None,
                 name_prefix: str = "", num_class: int = 0, init_mode: str = "default",
                 sn_mode: str = "pico", compute_dtype: torch.dtype = torch.bfloat16):
        self.design = update_layer_design(design)
        self.layer_scope = name_prefix + self.design["name"]
        self.num_class = num_class
        self.init_mode = init_mode
        self.sn_mode = sn_mode
        self.compute_dtype = compute_dtype
        if self.num_class < 2:
            assert self.design.get("type") not in ("project",), \
                f"{self.layer_scope}: cannot use projection for one class"
            assert self.design.get("act_nm") not in ("cbn", "CBN"), \
                f"{self.layer_scope}: cannot use cbn for one class"
        self.ops: Dict[str, Union[ParametricOp, ImageScaling]] = {}
        self.input_shape: Optional[Tuple[int, ...]] = None
        self.output_shape: Optional[Tuple[int, ...]] = None
        if input_shape is not None:
            self.build(input_shape)

    # op registration (layer_func.py:1397-1578) ----------------------------
    def _sub_design(self, target_keys, index=None, base=None):
        design = dict(base or {})
        for key in target_keys:
            if key in self.design:
                v = self.design[key]
                design[key] = v[index] if index is not None and isinstance(v, (list, tuple)) else v
        return design

    def _op(self, design, shape, name, kernel=False):
        op = ParametricOp(design, shape, name=name, scope_prefix=self.layer_scope + "/",
                          num_class=self.num_class,
                          init_mode=self.init_mode if kernel else "default",
                          sn_mode=self.sn_mode if kernel else "pico",
                          compute_dtype=self.compute_dtype)
        self.ops[name] = op
        return op.output_shape

    def _add_scaling(self, shape, name, scale_design=None):
        sd = scale_design if scale_design is not None else self.design["scale"]
        op = ImageScaling({"method": sd[0], "factor": sd[1]}, shape,
                          name=self.layer_scope + "/" + name)
        self.ops[name] = op
        return op.output_shape

    def _add_kernel(self, shape, name, index=None, op_design=None):
        design = {"op": self.design["op"] if op_design is None else op_design}
        design = self._sub_design({"out", "act", "act_k", "w_nm", "kernel", "strides",
                                   "dilation", "padding"}, index, base=design)
        return self._op(design, shape, name, kernel=True)

    def _add_scalar_kernel(self, shape, name, init_w_scale=None, bound=None):
        design = {"op": "k"}
        if init_w_scale is not None:
            design["init_w_scale"] = init_w_scale
        if bound is not None:
            design["bound"] = tuple(bound)
        return self._op(design, shape, name)

    def _add_projection(self, shape, name="project"):
        design = self._sub_design({"act_k", "w_nm"}, base={"op": "project", "act": "linear"})
        self._op(design, shape, name, kernel=True)

    def _add_bias(self, shape, name, op_design=None):
        if op_design is None:
            op_design = self.design.get("bias")
        if op_design in ("bias", "b") or op_design is None:
            design = {"op": "bias"}
        elif op_design in ("cb", "c_bias"):
            design = {"op": "c_bias"}
        elif op_design in ("bcb",):
            design = {"op": "bcb"}
        elif op_design is False:
            return shape
        else:
            raise NotImplementedError(
                f"{self.layer_scope}: bias option {op_design} not implemented.")
        return self._op(design, shape, name)

    def _add_bn(self, shape, name, scale=None):
        if self.design["act_nm"] in ("cbn", "CBN"):
            design = {"op": "cbn"}
        elif self.design["act_nm"] in ("b", "bn", "BN"):
            design = {"op": "bn"}
        else:
            raise NotImplementedError(
                f"{self.layer_scope}: {self.design['act_nm']} not implemented")
        if scale is not None:
            design["bn_scale"] = scale
        return self._op(design, shape, name)

    def _act_name(self, index=None) -> str:
        a = self.design["act"]
        return a if isinstance(a, str) else a[index]

    def _act(self, x, index=None):
        return apply_activation(x, self._act_name(index))

    def _has_bn(self) -> bool:
        return self.design["act_nm"] in ("bn", "BN", "cbn", "CBN")

    def _scale_dir(self) -> int:
        scale = self.design.get("scale")
        return 0 if scale is None else (1 if scale[1] > 0 else -1)

    # blocks ------------------------------------------------------------------
    def _build_default(self, shape):
        if self.design["type"] in ("project",):
            assert len(shape) == 1 and self.design["out"] == 1, (
                f"{self.layer_scope}: projection only applies to dense layer with one output")
            self._add_projection(shape, "project")
        if self._scale_dir() > 0:
            shape = self._add_scaling(shape, "upsampling")
        shape = self._add_kernel(shape, "kernel")
        if self.design.get("bias") is not None:
            shape = self._add_bias(shape, "bias")
        if self._has_bn():
            shape = self._add_bn(shape, "BN")
        shape = activation_shape(shape, self._act_name())
        if self._scale_dir() < 0:
            shape = self._add_scaling(shape, "downsampling")
        return shape

    def _build_res(self, shape):
        # res branch: BN_0 - act - up_0 - kernel_0 - bias_0 - BN_1 - act -
        #             kernel_1 - bias_1 - down_0
        # shortcut:   up_1 - kernel_sc - bias_sc - down_1
        t = self.design["type"]
        res = shape
        if t != "res_v1":
            if self._has_bn():
                res = self._add_bn(res, "BN_0")
            res = activation_shape(res, self._act_name(0))
        if self._scale_dir() > 0:
            res = self._add_scaling(res, "upsampling_0")
        res = self._add_kernel(res, "kernel_0", index=0)
        if self.design.get("bias") is not None:
            res = self._add_bias(res, "bias_0")
        if self._has_bn():
            res = self._add_bn(res, "BN_1")
        res = activation_shape(res, self._act_name(1 if not isinstance(self.design["act"], str)
                                                   else None))
        # the second conv of a tc res block is a 'c'
        res = self._add_kernel(res, "kernel_1", index=1,
                               op_design="c" if self.design["op"] == "tc" else None)
        if self.design.get("bias") is not None:
            res = self._add_bias(res, "bias_1")
        if self._scale_dir() < 0:
            res = self._add_scaling(res, "downsampling_0")

        sc = shape
        if t == "res":
            if self._scale_dir() > 0:
                sc = self._add_scaling(sc, "upsampling_1")
            sc = self._add_kernel(sc, "kernel_sc", index=2)
            if "bias" in self.design:   # a plain bias even when "bias" is None
                sc = self._add_bias(sc, "bias_sc")
            if self._scale_dir() < 0:
                sc = self._add_scaling(sc, "downsampling_1")
        elif t == "res_v1":   # wgan-gp's first D block: downsample-then-conv shortcut
            if self._scale_dir() > 0:
                raise ValueError(f"{self.layer_scope}: res_v1 is only used with downsampling.")
            if self._scale_dir() < 0:
                sc = self._add_scaling(sc, "downsampling_1")
            sc = self._add_kernel(sc, "kernel_sc", index=2)
            if "bias" in self.design:
                sc = self._add_bias(sc, "bias_sc")
        assert tuple(sc) == tuple(res), (
            f"{self.layer_scope}: resnet shape {res} and shortcut shape {sc} do not match.")
        return sc

    def _build_nonlocal(self, shape):
        f = self._add_bias(self._add_kernel(shape, "f_x", index=0), "bias_f")
        gh = (self._add_scaling(shape, "downsampling", ["max", -2])
              if self.design["type"] in ("nl_pool", "nl_pool_dist") else shape)
        g = self._add_kernel(gh, "g_x", index=1)
        h = self._add_kernel(gh, "h_x", index=2)
        assert f[0] == g[0], (f"{self.layer_scope}: f(x) channel {f[0]} does not match "
                              f"g(x) channel {g[0]}")
        assert g[1:] == h[1:], (f"{self.layer_scope}: g(x) size {g[1:]} does not match "
                                f"h(x) size {h[1:]}")
        att = (h[0], f[1], f[2])
        if self._has_bn():
            att = self._add_bn(att, "BN_1", scale=False)
        bound = [-1.0, 1.0] if self.design["w_nm"] == "s" else None
        att = self._add_scalar_kernel(att, "k_x", init_w_scale=0.0, bound=bound)
        assert tuple(shape) == tuple(att), (
            f"{self.layer_scope}: attention map shape {att} does not match input shape {shape}")
        return att

    def build(self, input_shape: Sequence[int]) -> None:
        if self.output_shape is not None:
            return
        self.input_shape = tuple(input_shape)
        shape = self.input_shape
        if self.design["in_reshape"] is not None:
            shape = tuple(self.design["in_reshape"])
        t = self.design["type"]
        if t in ("default", "project", "c_bias"):
            shape = self._build_default(shape)
        elif t in ("res", "res_i", "res_v1"):
            shape = self._build_res(shape)
        elif t in ("nl", "nl_dist", "nl_pool", "nl_pool_dist"):
            shape = self._build_nonlocal(shape)
        else:
            raise NotImplementedError(f"{self.layer_scope}: {t} is not implemented.")
        # block output before out_reshape (the bridge reads it to permute
        # flattened features)
        self.pre_out_reshape_shape: Tuple[int, ...] = tuple(shape)
        out = self.design["out_reshape"]
        self.output_shape = tuple(shape) if out is None else tuple(out)

    # init / apply ---------------------------------------------------------
    def init(self, generator: torch.Generator):
        params, state = {}, {}
        for name, op in self.ops.items():
            if isinstance(op, ImageScaling):
                continue
            p, s = op.init(generator)
            if p:
                params[name] = p
            if s:
                state[name] = s
        return params, state

    def apply(self, params: Dict, state: Dict, x: torch.Tensor, train: bool = True,
              label: Optional[torch.Tensor] = None, dp=None):
        """Returns (out, new_state); ``dp`` as ``Routine.apply``. Under a
        window's ``StageTimer`` the block hands it its map shapes, in and out."""
        timer = spans.stage_timer()
        if timer is not None:
            return timer.run((self.input_shape, self.pre_out_reshape_shape),
                             lambda p, v: self._apply(p, state, v, train, label, dp), params, x)
        return self._apply(params, state, x, train, label, dp)

    def _apply(self, params: Dict, state: Dict, x: torch.Tensor, train: bool,
               label: Optional[torch.Tensor], dp):
        assert tuple(x.shape[1:]) == self.input_shape, (
            f"{self.layer_scope}: input shape {tuple(x.shape[1:])} does not match "
            f"declared {self.input_shape}")
        if self.design["in_reshape"] is not None:
            x = x.reshape((x.shape[0],) + tuple(self.design["in_reshape"]))
        new_state: Dict[str, Dict] = {}

        def run(name, v):
            op = self.ops[name]
            if isinstance(op, ImageScaling):
                return op.apply(v)
            y, s = op.apply(params.get(name, {}), state.get(name, {}), v, train=train,
                            label=label, dp=dp)
            if s:
                new_state[name] = s
            return y

        t = self.design["type"]
        if t in ("default", "project", "c_bias"):
            y = run("upsampling", x) if "upsampling" in self.ops else x
            for name in ("kernel", "bias", "BN"):
                if name in self.ops:
                    y = run(name, y)
            y = self._act(y)
            if "downsampling" in self.ops:
                y = run("downsampling", y)
            if "project" in self.ops:
                y = y + run("project", x)
        elif t in ("res", "res_i", "res_v1"):
            res = x
            if t != "res_v1":
                if "BN_0" in self.ops:
                    res = run("BN_0", res)
                res = self._act(res, index=0)
            for name in ("upsampling_0", "kernel_0", "bias_0", "BN_1"):
                if name in self.ops:
                    res = run(name, res)
            res = self._act(res, index=None if isinstance(self.design["act"], str) else 1)
            for name in ("kernel_1", "bias_1", "downsampling_0"):
                if name in self.ops:
                    res = run(name, res)
            sc = x
            order = (("upsampling_1", "kernel_sc", "bias_sc", "downsampling_1") if t == "res"
                     else ("downsampling_1", "kernel_sc", "bias_sc") if t == "res_v1" else ())
            for name in order:
                if name in self.ops:
                    sc = run(name, sc)
            y = res + sc
        else:
            y = self._apply_nonlocal(run, x)
        if self.design["out_reshape"] is not None:
            y = y.reshape((y.shape[0],) + tuple(self.design["out_reshape"]))
        return y, new_state

    def _apply_nonlocal(self, run, x):
        """SAGAN-style attention (layer_func.py:1934-2041):
            m = softmax(f(x)' g(pool(x)));  o = m h(pool(x));
            y = k * BN(o) + x
        Positions flatten H-major in both layouts: (n, c, h*w) -> (n, h*w, c)."""
        att_f = run("bias_f", run("f_x", x))
        att_gh = run("downsampling", x) if "downsampling" in self.ops else x
        att_g = run("g_x", att_gh)
        att_h = run("h_x", att_gh)
        n, c2 = x.shape[0], att_f.shape[1]
        h1, w1 = att_f.shape[2:]
        c1 = att_h.shape[1]
        flat = lambda t: t.reshape(n, t.shape[1], -1).transpose(1, 2)   # noqa: E731
        # logits and softmax in float32; the map goes back to the
        # activation dtype for the second product
        f_flat, g_flat = flat(att_f).float(), flat(att_g).float()
        if self.design["type"] in ("nl_dist", "nl_pool_dist"):
            logits = -get_batch_squared_dist(f_flat, g_flat, axis=2, mode="xy") / float(c2)
        else:
            logits = torch.matmul(f_flat, g_flat.transpose(1, 2)) / np.sqrt(c2)
        att_map = torch.softmax(logits, dim=2).to(att_h.dtype)
        o = torch.matmul(att_map, flat(att_h))                 # [n, h1*w1, c1]
        o = o.transpose(1, 2).reshape(n, c1, h1, w1)
        if "BN_1" in self.ops:
            o = run("BN_1", o)
        return run("k_x", o) + x
