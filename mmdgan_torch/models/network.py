"""Net (layer list) and Routine (a sequential chain of its layers)
(``mmdgan_tpu/models/network.py:26-70,212-325``).

The JAX Routine wires a DAG; the port's main path needs only the chain,
so ``Routine`` links every layer of its ``Net`` in order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from mmdgan_torch.models.layers import Layer
from mmdgan_torch.ops.spectral_norm import spectral_norm_apply


class Net:
    """Compile an architecture list into Layers chained from ``input_shape``
    (per-example, channels-first).

    :param net_name: parameter scope name ('gen' / 'dis')
    """

    def __init__(self, net_design: Sequence[dict], input_shape: Sequence[int],
                 net_name: str = "net", compute_dtype: torch.dtype = torch.bfloat16):
        self.net_name = net_name
        self.layers: List[Layer] = []
        shape = tuple(input_shape)
        for design in net_design:
            layer = Layer(design, shape, name_prefix=net_name + "/",
                          compute_dtype=compute_dtype)
            self.layers.append(layer)
            shape = layer.output_shape
        self.num_layers = len(self.layers)


class Routine:
    """Run a Net's layers in sequence as one function of (params, state)."""

    def __init__(self, net: Net):
        self.net = net

    @property
    def output_shape(self) -> Tuple[int, ...]:
        return self.net.layers[-1].output_shape

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        params, state = {}, {}
        for layer in self.net.layers:
            p, s = layer.init(generator)
            if p:
                params[layer.layer_scope] = p
            if s:
                state[layer.layer_scope] = s
        return params, state

    def apply(self, params: Dict, state: Dict, x: torch.Tensor, train: bool = True):
        """Returns (output, new_state). The output is float32 whatever the
        compute dtype: scores feed the MMD Gram matrices, images the user."""
        new_state: Dict[str, Dict] = {}
        for layer in self.net.layers:
            scope = layer.layer_scope
            x, s = layer.apply(params.get(scope, {}), state.get(scope, {}), x, train=train)
            if s:
                new_state[scope] = s
        return x.float(), new_state

    @torch.no_grad()
    def kernel_norms(self, params: Dict, state: Dict) -> Dict[str, float]:
        """The spectral norm sigma of every SN op, one power iteration from
        its stored vector (the reference's ``kernel_norm`` summaries,
        layer_func.py:2153-2165; ``mmdgan_tpu/models/network.py:225``). A
        pure read: the state is not advanced."""
        out: Dict[str, float] = {}
        for layer in self.net.layers:
            scope = layer.layer_scope
            for op_name, op in layer.ops.items():
                s = state.get(scope, {}).get(op_name, {})
                if op.sn_def is None or "sn_x" not in s:
                    continue
                sigma, _ = spectral_norm_apply(params[scope][op_name]["kernel"], s["sn_x"],
                                               op.sn_def)
                out[f"{scope}/{op_name}"] = float(sigma)
        return out
