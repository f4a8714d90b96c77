"""Layer: the ``default`` block (kernel - bias - BN - activation) over
ParametricOps (``mmdgan_tpu/models/layers.py:39-107,242-258,392-470``).

Reshape specs in the architecture dicts are channels-first, which is the
port's layout, so ``in_reshape``/``out_reshape`` apply as they stand. A
flatten therefore orders features C-major where the JAX package orders
them H-major; ``utils/jax_bridge.py`` permutes the dense kernels at those
boundaries.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from mmdgan_torch.models.ops import ParametricOp


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
    if template["op"] in ("tc",):  # tc is itself the upsampler
        template["scale"] = None
    if template["op"] == "d":
        keys = ["name", "op", "type", "out", "bias", "act", "act_nm", "act_k",
                "w_nm", "w_p", "in_reshape", "out_reshape", "aux"]
    elif template["op"] in ("c", "tc"):
        keys = ["name", "op", "type", "out", "bias", "act", "act_nm", "act_k",
                "w_nm", "w_p", "kernel", "strides", "dilation", "padding", "scale",
                "in_reshape", "out_reshape", "aux"]
    else:
        raise ValueError("layer op {} not supported.".format(template["op"]))
    return {k: template[k] for k in keys}


ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "tanh": torch.tanh,
}


def apply_activation(x: torch.Tensor, act: str) -> torch.Tensor:
    try:
        return ACTIVATIONS[act](x)
    except KeyError:
        raise NotImplementedError(f"Activation {act} is not ported.")


class Layer:
    """One ``default`` block; ``input_shape`` is per-example, channels-first."""

    def __init__(self, design: dict, input_shape: Sequence[int], name_prefix: str = "",
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.design = update_layer_design(design)
        self.layer_scope = name_prefix + self.design["name"]
        self.input_shape = tuple(input_shape)
        if self.design["type"] != "default":
            raise NotImplementedError(f"{self.layer_scope}: block type "
                                      f"{self.design['type']} is not ported")
        if self.design.get("scale") is not None:
            raise NotImplementedError(f"{self.layer_scope}: image scaling is not ported")
        shape = self.input_shape
        if self.design["in_reshape"] is not None:
            shape = tuple(self.design["in_reshape"])
        prefix = self.layer_scope + "/"
        kernel_design = {k: self.design[k] for k in
                         ("op", "out", "act", "act_k", "w_nm", "kernel", "strides",
                          "dilation", "padding") if k in self.design}
        self.ops: Dict[str, ParametricOp] = {}
        self.ops["kernel"] = ParametricOp(kernel_design, shape, "kernel", prefix, compute_dtype)
        shape = self.ops["kernel"].output_shape
        bias = self.design.get("bias")
        if bias in ("b", "bias"):
            self.ops["bias"] = ParametricOp({"op": "bias"}, shape, "bias", prefix, compute_dtype)
        elif bias not in (None, False):
            raise NotImplementedError(f"{self.layer_scope}: bias option {bias} is not ported")
        if self.design["act_nm"] in ("bn", "BN"):
            self.ops["BN"] = ParametricOp({"op": "bn"}, shape, "BN", prefix, compute_dtype)
        elif self.design["act_nm"] is not None:
            raise NotImplementedError(
                f"{self.layer_scope}: {self.design['act_nm']} is not ported")
        # block output before out_reshape (the bridge reads it to permute
        # flattened features)
        self.pre_out_reshape_shape: Tuple[int, ...] = tuple(shape)
        out = self.design["out_reshape"]
        self.output_shape = tuple(shape) if out is None else tuple(out)

    def init(self, generator: torch.Generator):
        params, state = {}, {}
        for name, op in self.ops.items():
            p, s = op.init(generator)
            if p:
                params[name] = p
            if s:
                state[name] = s
        return params, state

    def apply(self, params: Dict, state: Dict, x: torch.Tensor, train: bool = True):
        """Returns (out, new_state)."""
        assert tuple(x.shape[1:]) == self.input_shape, (
            f"{self.layer_scope}: input shape {tuple(x.shape[1:])} does not match "
            f"declared {self.input_shape}")
        if self.design["in_reshape"] is not None:
            x = x.reshape((x.shape[0],) + tuple(self.design["in_reshape"]))
        new_state: Dict[str, Dict] = {}
        for name, op in self.ops.items():
            x, s = op.apply(params.get(name, {}), state.get(name, {}), x, train=train)
            if s:
                new_state[name] = s
        y = apply_activation(x, self.design["act"])
        if self.design["out_reshape"] is not None:
            y = y.reshape((y.shape[0],) + tuple(self.design["out_reshape"]))
        return y, new_state
