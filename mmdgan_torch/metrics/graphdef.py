"""GraphDef executor: run a frozen TensorFlow graph as PyTorch ops on the
device (``mmdgan_tpu/metrics/tf_graph_jax.py``).

The reference computes IS/FID by running the frozen
``inception_v1_2015_12_05`` graph in a TF session (graph_func.py:1616-1705).
Here the ``.pb`` is parsed once on the host by the port's own protobuf
reader (``metrics/graph_proto.py``; no TensorFlow), its constants go to the
device once, and each call runs the requested subgraph as torch ops on
NHWC tensors, the layout of the graph. Convolutions and products run with
TF32 off, as JAX pins ``Precision.HIGHEST``: metric graphs must match TF.

``SUPPORTED_OPS`` covers the classic frozen inception graphs and similar
frozen CNN classifiers: conv/pool/matmul (``SAME`` padded explicitly, so an
even size with stride 2 pads 0 before and 1 after, as TF does), the legacy
``BatchNormWithGlobalNormalization`` and the FusedBatchNorm family,
``LRN``, elementwise math, static shape ops (Reshape, Slice, Split,
StridedSlice with begin/end/shrink/new-axis masks, Transpose, Pack) and
``ResizeBilinear`` (legacy TF1, align_corners, half-pixel).

Unsupported ops are reported all at once at construction (one
``NotImplementedError`` listing every missing op type with an example
node). Only nodes reachable from the requested outputs are inventoried:
host preprocessing upstream of the input (DecodeJpeg, ...) is never
visited, as the reference feeds past it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.metrics import graph_proto
from mmdgan_torch.metrics.inception import resize_bilinear_tf1, same_pads
from mmdgan_torch.metrics.scores import resize_linear

#: every op ``_exec`` implements; the constructor checks the requested
#: subgraph against this set and reports ALL missing ops in one error.
SUPPORTED_OPS = frozenset({
    "Const", "Identity", "CheckNumerics", "StopGradient", "PreventGradient",
    "Placeholder", "PlaceholderWithDefault", "NoOp",
    "Conv2D", "DepthwiseConv2dNative", "BiasAdd", "MatMul",
    "MaxPool", "AvgPool", "LRN",
    "Relu", "Relu6", "Softmax", "Tanh", "Sigmoid",
    "Add", "AddV2", "Sub", "Mul", "RealDiv", "Maximum", "Minimum",
    "Rsqrt", "Sqrt", "Square", "Exp", "Log", "Neg", "Abs", "Floor", "Pow",
    "Mean", "Sum", "Max", "Min",
    "Concat", "ConcatV2", "Reshape", "Squeeze", "Shape", "ExpandDims",
    "Pad", "Pack", "StridedSlice", "Slice", "Split", "Transpose", "Fill",
    "Cast", "ResizeBilinear",
    "BatchNormWithGlobalNormalization", "FusedBatchNorm",
    "FusedBatchNormV2", "FusedBatchNormV3",
})

# Cast's DstT: the common TF dtype enums
_CAST = {1: torch.float32, 2: torch.float64, 3: torch.int32, 9: torch.int64,
         10: torch.bool, 14: torch.bfloat16}


def _split_name(tensor_name: str) -> Tuple[str, int]:
    if ":" in tensor_name:
        name, idx = tensor_name.rsplit(":", 1)
        return name, int(idx)
    return tensor_name, 0


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] linear interpolation with align_corners=True: output i
    samples input i*(n_in-1)/(n_out-1) (``models/scaling.py:67-102``)."""
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1:
        w[0, 0] = 1.0
        return w
    for i, s in enumerate(np.arange(n_out) * (n_in - 1) / (n_out - 1)):
        j0 = int(np.floor(s))
        t = s - j0
        for j, wgt in ((j0, 1.0 - t), (j0 + 1, t)):
            if wgt != 0.0:
                w[i, min(max(j, 0), n_in - 1)] += wgt
    return w


@contextlib.contextmanager
def _tf32_off():
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


class GraphDefModule:
    """A frozen GraphDef as a callable on ``device`` (``cuda`` unless
    ``"cpu"`` is passed).

    :param graph_def: a path to a ``.pb``, its bytes, a parsed
        ``graph_proto.GraphDef``, or any protobuf message with
        ``SerializeToString`` (a TensorFlow GraphDef)
    :param inputs: input tensor names (e.g. ['Mul:0'])
    :param outputs: output tensor names (e.g. ['logits:0', 'pool_3:0'])

    Usage::

        mod = GraphDefModule(pb_path, ['Mul:0'], ['logits:0', 'pool_3:0'])
        logits, pool3 = mod(images_nhwc)
    """

    def __init__(self, graph_def, inputs: Sequence[str], outputs: Sequence[str],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if isinstance(graph_def, str):
            with open(graph_def, "rb") as f:
                graph_def = f.read()
        if hasattr(graph_def, "SerializeToString"):
            graph_def = graph_def.SerializeToString()
        if isinstance(graph_def, (bytes, bytearray, memoryview)):
            graph_def = graph_proto.parse_graph_def(bytes(graph_def))
        self.input_names = [_split_name(n)[0] for n in inputs]
        self.output_refs = [_split_name(n) for n in outputs]
        self.nodes = graph_proto.nodes_by_name(graph_def)
        self._order = self._toposort()
        self._check_op_inventory()
        # constants of the subgraph, once: numpy for folding, torch on the device
        self.consts: Dict[str, np.ndarray] = {
            name: graph_proto.make_ndarray(self.nodes[name].attr["value"].tensor)
            for name in self._order if self.nodes[name].op == "Const"}
        self._device_consts = {name: torch.as_tensor(np.array(a), device=self.device)
                               for name, a in self.consts.items()}

    def _check_op_inventory(self) -> None:
        """One error listing EVERY unsupported op type in the requested
        subgraph, so a new frozen graph yields the whole work-list at once."""
        unsupported: Dict[str, List[str]] = {}
        for name in self._order:
            if name in self.input_names:
                continue
            op = self.nodes[name].op
            if op not in SUPPORTED_OPS:
                unsupported.setdefault(op, []).append(name)
        if unsupported:
            detail = "; ".join(f"{op} (x{len(nodes)}, e.g. '{nodes[0]}')"
                               for op, nodes in sorted(unsupported.items()))
            raise NotImplementedError(
                f"GraphDefModule: {len(unsupported)} unsupported op type(s) in the subgraph "
                f"feeding {[n for n, _ in self.output_refs]}: {detail}. Full inventory "
                "above: add handlers to GraphDefModule._exec and SUPPORTED_OPS.")

    # ------------------------------------------------------------------
    @staticmethod
    def _deps(node) -> List[str]:
        return [_split_name(i)[0] for i in node.input if not i.startswith("^")]

    def _toposort(self) -> List[str]:
        order: List[str] = []
        seen: Dict[str, int] = {}  # 0 = visiting, 1 = done

        def visit(name):
            state = seen.get(name)
            if state == 1:
                return
            if state == 0:
                raise ValueError(f"cycle at {name}")
            seen[name] = 0
            if name not in self.nodes:
                raise KeyError(f"graph references unknown node {name}")
            if name not in self.input_names:
                for dep in self._deps(self.nodes[name]):
                    visit(dep)
            seen[name] = 1
            order.append(name)

        for name, _ in self.output_refs:
            visit(name)
        return order

    # ------------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, *args) -> Tuple[torch.Tensor, ...]:
        values: Dict[str, Tuple] = {
            name: (torch.as_tensor(arg, device=self.device),)
            for name, arg in zip(self.input_names, args)}
        with _tf32_off():
            for name in self._order:
                if name not in values:
                    values[name] = self._exec(self.nodes[name], values)
        return tuple(values[name][idx] for name, idx in self.output_refs)

    # ------------------------------------------------------------------
    @staticmethod
    def _get(values, ref: str):
        name, idx = _split_name(ref)
        return values[name][idx]

    def _static(self, ref: str, values) -> np.ndarray:
        """A structural operand (axis, shape, paddings, ...) folded on the
        host from the GraphDef: Const/Identity chains, Shape of a tensor,
        Pack/StridedSlice and small integer arithmetic of those."""
        name, _ = _split_name(ref)
        node = self.nodes[name]
        op = node.op
        if op == "Const":
            return self.consts[name]
        raw = [i for i in node.input if not i.startswith("^")]
        if op in ("Identity", "CheckNumerics", "Cast"):
            return self._static(raw[0], values)
        if op == "Shape":
            return np.asarray(self._get(values, raw[0]).shape, np.int32)
        if op == "Pack":
            return np.stack([self._static(r, values) for r in raw], axis=node.attr["axis"].i)
        if op == "StridedSlice":
            x, b, e, s = (self._static(r, values) for r in raw[:4])
            return x[tuple(slice(int(bb), int(ee), int(ss)) for bb, ee, ss in zip(b, e, s))]
        if op in ("Add", "AddV2"):
            return self._static(raw[0], values) + self._static(raw[1], values)
        if op == "Sub":
            return self._static(raw[0], values) - self._static(raw[1], values)
        if op == "Mul":
            return self._static(raw[0], values) * self._static(raw[1], values)
        return self._get(values, ref).cpu().numpy()

    def _ints(self, ref: str, values) -> List[int]:
        return [int(v) for v in np.atleast_1d(self._static(ref, values))]

    @staticmethod
    def _window(node, key: str) -> Tuple[int, int]:
        v = list(node.attr[key].list.i)
        return int(v[1]), int(v[2])

    def _pool(self, op: str, x: torch.Tensor, node) -> torch.Tensor:
        k, s = self._window(node, "ksize"), self._window(node, "strides")
        pad = node.attr["padding"].s.decode()
        h = x.permute(0, 3, 1, 2)
        pads = same_pads(h.shape[2:], k, s) if pad == "SAME" else [0, 0, 0, 0]
        if op == "MaxPool":
            out = F.max_pool2d(F.pad(h, pads, value=float("-inf")), k, s)
        else:
            summed = F.avg_pool2d(F.pad(h, pads), k, s, divisor_override=1)
            if pad == "SAME":
                ones = torch.ones_like(h[:1, :1])
                counts = F.avg_pool2d(F.pad(ones, pads), k, s, divisor_override=1)
                out = summed / counts
            else:
                out = summed / float(k[0] * k[1])
        return out.permute(0, 2, 3, 1)

    def _conv(self, x: torch.Tensor, w: torch.Tensor, node, groups: int = 1) -> torch.Tensor:
        """``w`` OIHW; x NHWC."""
        s = self._window(node, "strides")
        h = x.permute(0, 3, 1, 2)
        if node.attr["padding"].s.decode() == "SAME":
            h = F.pad(h, same_pads(h.shape[2:], w.shape[2:], s))
        return F.conv2d(h, w, stride=s, groups=groups).permute(0, 2, 3, 1)

    def _strided_slice(self, x, node, raw, values):
        begin, end, strides = (self._ints(r, values) for r in raw[1:4])
        if node.attr["ellipsis_mask"].i:
            raise NotImplementedError(f"StridedSlice {node.name}: ellipsis mask")
        if any(st < 0 for st in strides):
            raise NotImplementedError(f"StridedSlice {node.name}: negative strides")
        bm, em = node.attr["begin_mask"].i, node.attr["end_mask"].i
        sm, nm = node.attr["shrink_axis_mask"].i, node.attr["new_axis_mask"].i
        slices = []
        for i, (b, e, st) in enumerate(zip(begin, end, strides)):
            if nm & (1 << i):
                slices.append(None)
            elif sm & (1 << i):
                slices.append(b)
            else:
                slices.append(slice(None if bm & (1 << i) else b,
                                    None if em & (1 << i) else e, st))
        return x[tuple(slices)]

    def _resize(self, x: torch.Tensor, node, raw, values) -> torch.Tensor:
        size = self._ints(raw[1], values)
        if node.attr["align_corners"].b:
            wh = torch.tensor(_resize_matrix(x.shape[1], size[0]), device=x.device)
            ww = torch.tensor(_resize_matrix(x.shape[2], size[1]), device=x.device)
            return torch.einsum("oh,nhwc,pw->nopc", wh, x, ww)
        if node.attr["half_pixel_centers"].b:
            return resize_linear(x, (size[0], size[1]))
        return resize_bilinear_tf1(x, (size[0], size[1]))

    def _exec(self, node, values) -> Tuple:
        op = node.op
        raw = [i for i in node.input if not i.startswith("^")]
        inp = [self._get(values, i) for i in raw]
        unary = {"Relu": torch.relu, "Tanh": torch.tanh, "Sigmoid": torch.sigmoid,
                 "Rsqrt": torch.rsqrt, "Sqrt": torch.sqrt, "Square": torch.square,
                 "Exp": torch.exp, "Log": torch.log, "Neg": torch.neg, "Abs": torch.abs,
                 "Floor": torch.floor}
        binary = {"Add": torch.add, "AddV2": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                  "RealDiv": torch.div, "Maximum": torch.maximum, "Minimum": torch.minimum,
                  "Pow": torch.pow, "BiasAdd": torch.add}

        if op == "Const":
            return (self._device_consts[node.name],)
        if op in ("Identity", "CheckNumerics", "StopGradient", "PreventGradient",
                  "PlaceholderWithDefault"):
            return (inp[0],)
        if op == "Placeholder":
            raise ValueError(f"Placeholder {node.name} was not provided as an input")
        if op == "NoOp":
            return ()
        if op in unary:
            return (unary[op](inp[0]),)
        if op in binary:
            return (binary[op](inp[0], inp[1]),)
        if op == "Relu6":
            return (torch.clamp(inp[0], 0.0, 6.0),)
        if op == "Softmax":
            return (torch.softmax(inp[0], dim=-1),)
        if op == "Conv2D":   # HWIO kernel
            return (self._conv(inp[0], inp[1].permute(3, 2, 0, 1), node),)
        if op == "DepthwiseConv2dNative":
            kh, kw, c, mult = inp[1].shape   # output channel c * mult + m
            w = inp[1].permute(2, 3, 0, 1).reshape(c * mult, 1, kh, kw)
            return (self._conv(inp[0], w, node, groups=c),)
        if op == "MatMul":
            a, b = inp
            a = a.T if node.attr["transpose_a"].b else a
            b = b.T if node.attr["transpose_b"].b else b
            return (a @ b,)
        if op in ("MaxPool", "AvgPool"):
            return (self._pool(op, inp[0], node),)
        if op == "LRN":
            # out = x / (bias + alpha * sum_{2r+1 channels} x^2) ** beta, with
            # the op registry's defaults for unset attributes
            x = inp[0]
            r = int(node.attr["depth_radius"].i) if "depth_radius" in node.attr else 5
            bias = node.attr["bias"].f if "bias" in node.attr else 1.0
            alpha = node.attr["alpha"].f if "alpha" in node.attr else 1.0
            beta = node.attr["beta"].f if "beta" in node.attr else 0.5
            sq_sum = F.pad(torch.square(x), (r, r)).unfold(-1, 2 * r + 1, 1).sum(-1)
            return (x / torch.pow(bias + alpha * sq_sum, beta),)
        if op == "Concat":    # the axis is input 0
            return (torch.cat(inp[1:], dim=int(self._static(raw[0], values))),)
        if op == "ConcatV2":  # the axis is the last input
            return (torch.cat(inp[:-1], dim=int(self._static(raw[-1], values))),)
        if op == "Reshape":
            return (inp[0].reshape(self._ints(raw[1], values)),)
        if op == "Squeeze":
            dims = list(node.attr["squeeze_dims"].list.i)
            return (inp[0].squeeze(tuple(dims)) if dims else inp[0].squeeze(),)
        if op == "Shape":
            return (torch.tensor(inp[0].shape, dtype=torch.int32, device=self.device),)
        if op in ("Mean", "Sum", "Max", "Min"):
            axes = tuple(self._ints(raw[1], values))
            keep = node.attr["keep_dims"].b
            fn = {"Mean": torch.mean, "Sum": torch.sum, "Max": torch.amax,
                  "Min": torch.amin}[op]
            return (fn(inp[0], dim=axes, keepdim=keep),)
        if op == "Pad":
            pads = self._static(raw[1], values)
            return (F.pad(inp[0], [int(v) for pair in pads[::-1] for v in pair]),)
        if op == "BatchNormWithGlobalNormalization":
            t, m, v, beta, gamma = inp
            inv = torch.rsqrt(v + node.attr["variance_epsilon"].f)
            if node.attr["scale_after_normalization"].b:
                inv = inv * gamma
            return (t * inv + (beta - m * inv),)
        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            t, gamma, beta, mean, var = inp
            inv = torch.rsqrt(var + node.attr["epsilon"].f) * gamma
            return (t * inv + (beta - mean * inv), mean, var, mean, var, mean)
        if op == "Cast":
            return (inp[0].to(_CAST.get(node.attr["DstT"].type, torch.float32)),)
        if op == "ExpandDims":
            return (inp[0].unsqueeze(int(self._static(raw[1], values))),)
        if op == "Pack":
            return (torch.stack(inp, dim=node.attr["axis"].i),)
        if op == "StridedSlice":
            return (self._strided_slice(inp[0], node, raw, values),)
        if op == "Slice":
            begin, size = self._ints(raw[1], values), self._ints(raw[2], values)
            x = inp[0]
            return (x[tuple(slice(b, x.shape[i] if s == -1 else b + s)
                            for i, (b, s) in enumerate(zip(begin, size)))],)
        if op == "Split":     # input 0 is the axis, 1 the value
            axis = int(self._static(raw[0], values))
            num = int(node.attr["num_split"].i)
            return tuple(torch.split(inp[1], inp[1].shape[axis] // num, dim=axis))
        if op == "Transpose":
            return (inp[0].permute(self._ints(raw[1], values)),)
        if op == "Fill":
            return (torch.full(self._ints(raw[0], values), inp[1].item(),
                               dtype=inp[1].dtype, device=self.device),)
        if op == "ResizeBilinear":
            return (self._resize(inp[0], node, raw, values),)
        raise NotImplementedError(f"GraphDefModule: op '{op}' (node {node.name}) not supported")


def run_frozen_graph(graph_def, inputs: Sequence[str], outputs: Sequence[str],
                     device: DeviceLike = None) -> GraphDefModule:
    """The executor of a frozen graph, ready to call."""
    return GraphDefModule(graph_def, inputs, outputs, device=device)
