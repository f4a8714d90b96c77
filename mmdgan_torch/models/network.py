"""Net (layer list) and Routine (a small DAG of its layers)
(``mmdgan_tpu/models/network.py``; layer_func.py:2111-2531).

A Routine wires layers with ``add_input_layers``, ``link`` (1 -> N
broadcast, 1 -> N ``split``, N -> 1 ``concat``, N -> 1 ``sum``, N -> N
pairwise), ``seq_links`` and ``add_output_layers``, builds each layer when
its input shape is known, and runs them as one function of (params,
state). ``split`` and ``concat`` act on channels, axis 1 in NCHW. Labels
reach every layer. ``SNGan`` builds a chain with ``seq_links``, which runs
as a plain loop over its layers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mmdgan_torch.models.layers import Layer


class Net:
    """Compile an architecture list into unbuilt Layers.

    :param net_name: parameter scope name ('gen' / 'dis')
    :param num_class: number of data classes (0/1 = unconditional)
    """

    def __init__(self, net_design: Sequence[dict], net_name: str = "net", num_class: int = 0,
                 init_mode: str = "default", sn_mode: str = "pico",
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.net_name = net_name
        self.layers: List[Layer] = [
            Layer(design, name_prefix=net_name + "/", num_class=num_class,
                  init_mode=init_mode, sn_mode=sn_mode, compute_dtype=compute_dtype)
            for design in net_design]
        self.num_layers = len(self.layers)


class Routine:
    """Static DAG of a Net's layers (layer_func.py:2207-2495).

        r = Routine(net)
        r.add_input_layers([code_size], [0])     # per-example shape, channels-first
        r.seq_links(list(range(net.num_layers)))
        r.add_output_layers([net.num_layers - 1])
        out, new_state = r.apply(params, state, z, label=y)
    """

    def __init__(self, net: Net):
        self.net = net
        self.operations: List = []          # [in indices, handler, target(s), out indices]
        self.layer_indices: List[int] = []
        self.output_layer_indices: List[int] = []

    # build phase ----------------------------------------------------------
    def _claim(self, index: int, input_shape) -> None:
        if index in self.layer_indices:
            raise ValueError(f"Layer {index} has already been linked.")
        self.layer_indices.append(index)
        self.net.layers[index].build(input_shape)

    def _out(self, index: int) -> Tuple[int, ...]:
        shape = self.net.layers[index].output_shape
        if shape is None:
            raise RuntimeError(f"Input layer {index} has not been defined yet.")
        return shape

    def add_input_layers(self, input_shape: Sequence[int], out_layer_indices: Sequence[int]):
        """Entry layers on the routine's input (a per-example shape; a
        leading batch dim of a 2-D or 4-D spec is dropped)."""
        shape = tuple(input_shape)
        if len(shape) in (2, 4):
            shape = shape[1:]
        for index in out_layer_indices:
            self._claim(index, shape)
            self.operations.append([None, None, index, [index]])

    def link(self, in_layer_indices: Sequence[int], out_layer_indices: Sequence[int],
             input_fun: Optional[str] = None):
        """1 -> N None: broadcast; 1 -> N 'split': channel split; N -> 1
        'concat': channel concat; N -> 1 'sum': add; N -> N: pairwise
        (layer_func.py:2242-2347)."""
        ins, outs = list(in_layer_indices), list(out_layer_indices)
        shapes = [self._out(i) for i in ins]
        if len(ins) == len(outs):
            for i, o, shape in zip(ins, outs, shapes):
                self._claim(o, shape)
                self.operations.append([[i], None, o, [o]])
        elif len(ins) > 1 and len(outs) == 1:
            if input_fun == "concat":
                shape = (sum(s[0] for s in shapes),) + tuple(shapes[0][1:])
            elif input_fun == "sum":
                shape = shapes[0]
            else:
                raise ValueError(f"{ins}: input function {input_fun} is not supported.")
            self._claim(outs[0], shape)
            self.operations.append([ins, input_fun, outs[0], outs])
        elif len(ins) == 1 and len(outs) > 1:
            if input_fun == "split":
                shape = (shapes[0][0] // len(outs),) + tuple(shapes[0][1:])
                for o in outs:
                    self._claim(o, shape)
                self.operations.append([ins, "split", outs, outs])
            else:   # broadcast
                for o in outs:
                    self._claim(o, shapes[0])
                    self.operations.append([ins, None, o, [o]])
        else:
            raise ValueError(f"{ins}: input has {len(ins)} layers which do not match the "
                             f"output with {len(outs)} layers.")

    def seq_links(self, in_layer_indices: Sequence[int]):
        """Chain layers in order (layer_func.py:2349-2376)."""
        self._out(in_layer_indices[0])
        for a, b in zip(in_layer_indices[:-1], in_layer_indices[1:]):
            self._claim(b, self._out(a))
            self.operations.append([[a], None, b, [b]])

    def add_output_layers(self, in_layer_indices: Sequence[int]):
        for index in in_layer_indices:
            if index in self.output_layer_indices:
                raise ValueError(f"Layer {index} has already been added as output layer.")
            if self.net.layers[index].output_shape is None:
                raise RuntimeError(f"Output layer {index} has not been linked yet.")
            self.output_layer_indices.append(index)

    @property
    def output_shape(self):
        if len(self.output_layer_indices) == 1:
            return self.net.layers[self.output_layer_indices[0]].output_shape
        return {i: self.net.layers[i].output_shape for i in self.output_layer_indices}

    @property
    def layers(self) -> List[Layer]:
        """The claimed layers, in the order they were linked."""
        return [self.net.layers[i] for i in self.layer_indices]

    # run phase ------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        params, state = {}, {}
        for layer in self.layers:
            p, s = layer.init(generator)
            if p:
                params[layer.layer_scope] = p
            if s:
                state[layer.layer_scope] = s
        return params, state

    def apply(self, params: Dict, state: Dict, x: torch.Tensor, train: bool = True,
              label: Optional[torch.Tensor] = None, dp=None):
        """Returns (output, new_state): the output layer's tensor, or {index:
        tensor} for several. Outputs are float32 whatever the compute
        dtype: scores feed the MMD Gram matrices, images the user. ``dp``
        (a ``DataParallel``) makes train-mode BN statistics global."""
        if not self.output_layer_indices:
            raise RuntimeError("Output layer has not been defined.")
        new_state: Dict[str, Dict] = {}
        outs: Dict[int, torch.Tensor] = {}

        def run(index, inp):
            layer = self.net.layers[index]
            scope = layer.layer_scope
            y, s = layer.apply(params.get(scope, {}), state.get(scope, {}), inp, train=train,
                               label=label, dp=dp)
            if s:
                new_state[scope] = s
            return y

        for ins, handler, target, _ in self.operations:
            if ins is None:
                outs[target] = run(target, x)
            elif handler is None:
                outs[target] = run(target, outs[ins[0]])
            elif handler == "concat":
                outs[target] = run(target, torch.cat([outs[i] for i in ins], dim=1))
            elif handler == "sum":
                outs[target] = run(target, sum((outs[i] for i in ins[1:]), outs[ins[0]]))
            else:   # split
                for t, piece in zip(target, torch.chunk(outs[ins[0]], len(target), dim=1)):
                    outs[t] = run(t, piece)
        if len(self.output_layer_indices) == 1:
            return outs[self.output_layer_indices[0]].float(), new_state
        return {i: outs[i].float() for i in self.output_layer_indices}, new_state

    @torch.no_grad()
    def kernel_norms(self, params: Dict, state: Dict) -> Dict:
        """The spectral norm sigma of every SN op, one power iteration from
        its stored vector (the reference's ``kernel_norm`` summaries,
        layer_func.py:2153-2165; ``mmdgan_tpu/models/network.py:225``): a
        float, or per class a numpy array. A pure read: the state is not
        advanced."""
        out: Dict = {}
        for layer in self.layers:
            scope = layer.layer_scope
            for op_name, op in layer.ops.items():
                s = state.get(scope, {}).get(op_name, {})
                if getattr(op, "sn_def", None) is None and not getattr(op, "use_pim", False):
                    continue
                if "sn_x" not in s:
                    continue
                sigma, _ = op.kernel_norm(params[scope][op_name], s)
                arr = sigma.float().cpu().numpy()
                out[f"{scope}/{op_name}"] = arr.item() if arr.size == 1 else arr
        return out
