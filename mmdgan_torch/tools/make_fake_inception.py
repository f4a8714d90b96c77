"""Synthesize a random-weight frozen graph with the shape of the
``inception_v1_2015_12_05`` graph: the counterpart of
``tools/make_fake_inception.py``, written without TensorFlow or the
``protobuf`` package (``metrics/graph_encode.py``).

The graph keeps the real one's tensor contract: images fed at ``Mul:0``
([N, 299, 299, 3]), ``logits:0`` ([N, 1008]) and ``pool_3:0``
([N, 1, 1, 2048]) out. It keeps the legacy op set too: Conv2D +
BatchNormWithGlobalNormalization + Relu, MaxPool/AvgPool, LRN, the legacy
``Concat`` and ``ConcatV2`` inception towers, Reshape/MatMul/BiasAdd/
Softmax, and ``versions.producer = 8`` (the legacy batch norm was removed
at GraphDef version 9). Channels are slimmed except pool_3's 2048 and the
1008 logits. ``build_graph_def(seed)`` draws the JAX tool's weights from
``RandomState(seed)`` in its order and returns the bytes of its
``SerializeToString(deterministic=True)``.

``debnwgn(seed)`` is the twin whose legacy batch norms are written as
their primitives, ``(t - m) * (gamma * rsqrt(v + eps)) + beta``, so that a
modern TensorFlow can run it.

    python -m mmdgan_torch.tools.make_fake_inception --out fake_inception_v1.pb

writes the graph and, beside it, its twin ``fake_inception_v1_tfexec.pb``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

from mmdgan_torch.metrics.graph_encode import DT_FLOAT, DT_INT32, Node, encode_graph_def

PRODUCER = 8   # pre-dates the legacy batch norm's removal (version 9)
F32, I32 = ("type", DT_FLOAT), ("type", DT_INT32)


def _attr(v):
    if isinstance(v, bool):
        return ("b", v)
    if isinstance(v, int):
        return ("i", v)
    if isinstance(v, float):
        return ("f", v)
    if isinstance(v, str):
        return ("s", v)
    if isinstance(v, (list, tuple)):
        return ("list", list(v))
    raise TypeError(v)


def graph_nodes(seed: int = 0) -> List[Node]:
    """The graph's nodes in the JAX tool's order, with its names and draws
    (``tools/make_fake_inception.py:41-177``)."""
    rng = np.random.RandomState(seed)
    nodes: List[Node] = []

    def node(name, op, inputs=(), **attrs):
        nodes.append(Node(name, op, list(inputs), {k: _attr(v) for k, v in attrs.items()}))
        return name

    def typed(name):
        for n in nodes:
            if n.name == name and "T" not in n.attr:
                n.attr["T"] = F32
        return name

    cid = [0]

    def const(arr, name=None):
        arr = np.asarray(arr)
        name = name or f"const_{cid[0]}"
        cid[0] += 1
        nodes.append(Node(name, "Const", [], {
            "dtype": I32 if arr.dtype == np.int32 else F32, "value": ("tensor", arr)}))
        return name

    def w(shape, scale=None):
        scale = scale or float(np.sqrt(2.0 / np.prod(shape[:-1])))
        return const(rng.randn(*shape).astype(np.float32) * scale)

    # feed point: the real graph's 'Mul' preprocessing node
    nodes.append(Node("input_images", "Placeholder", [], {"dtype": F32}))
    nodes.append(Node("mul_one", "Const", [], {"dtype": F32,
                                               "value": ("tensor", np.float32(1.0))}))
    typed(node("Mul", "Mul", ["input_images", "mul_one"]))

    def conv_bn(x, cin, cout, k, s, padding="SAME"):
        c = typed(node(f"conv_{cid[0]}", "Conv2D", [x, w([k, k, cin, cout])],
                       strides=[1, s, s, 1], padding=padding))
        bn = typed(node(
            f"bn_{cid[0]}", "BatchNormWithGlobalNormalization",
            [c,
             const(rng.randn(cout).astype(np.float32) * 0.1),
             const((rng.rand(cout) * 0.5 + 0.5).astype(np.float32)),
             const(rng.randn(cout).astype(np.float32) * 0.1),
             const((1.0 + rng.randn(cout) * 0.1).astype(np.float32))],
            variance_epsilon=1e-3, scale_after_normalization=True))
        return typed(node(f"relu_{cid[0]}", "Relu", [bn]))

    def pool(x, op, k, s, padding, name=None):
        return typed(node(name or f"{op.lower()}_{cid[0]}", op, [x],
                          ksize=[1, k, k, 1], strides=[1, s, s, 1], padding=padding))

    def tower(x, cin, c1, c3r, c3, cp, legacy):
        b1 = conv_bn(x, cin, c1, 1, 1)
        b2 = conv_bn(conv_bn(x, cin, c3r, 1, 1), c3r, c3, 3, 1)
        b3 = conv_bn(conv_bn(conv_bn(x, cin, c3r, 1, 1), c3r, c3, 3, 1), c3, c3, 3, 1)
        bp = conv_bn(pool(x, "AvgPool", 3, 1, "SAME"), cin, cp, 1, 1)
        if legacy:   # pre-V2 Concat: the axis is input 0
            cat = node(f"concat_{cid[0]}", "Concat", [const(np.int32(3)), b1, b2, b3, bp], N=4)
        else:
            cat = node(f"concatv2_{cid[0]}", "ConcatV2", [b1, b2, b3, bp, const(np.int32(3))],
                       N=4)
            nodes[-1].attr["Tidx"] = I32
        typed(cat)
        return cat, c1 + c3 + c3 + cp

    # stem: 299 -> 149 -> 74 -> 36 -> 17, with GoogLeNet's LRN
    y = conv_bn("Mul", 3, 16, 3, 2, "VALID")
    y = conv_bn(y, 16, 24, 3, 2, "VALID")
    y = pool(y, "MaxPool", 3, 2, "VALID")
    y = typed(node("lrn", "LRN", [y], depth_radius=5, bias=1.0, alpha=1e-4, beta=0.75))
    y = conv_bn(y, 24, 32, 1, 1)
    y = conv_bn(y, 32, 48, 3, 2, "VALID")

    y, ch = tower(y, 48, 24, 16, 24, 16, legacy=True)       # 17x17x88
    y = pool(y, "MaxPool", 3, 2, "VALID")                   # 8x8
    y, ch = tower(y, ch, 32, 24, 32, 24, legacy=False)      # 8x8x120
    y = conv_bn(y, ch, 2048, 1, 1)                          # 8x8x2048

    p3 = pool(y, "AvgPool", 8, 1, "VALID", name="pool_3")   # [N, 1, 1, 2048]
    flat = typed(node("flatten", "Reshape", [p3, const(np.asarray([-1, 2048], np.int32))]))
    nodes[-1].attr["Tshape"] = I32
    mm = typed(node("matmul", "MatMul", [flat, w([2048, 1008], 0.05)],
                    transpose_a=False, transpose_b=False))
    logits = typed(node("logits", "BiasAdd", [mm, const(np.zeros(1008, np.float32))]))
    typed(node("softmax", "Softmax", [logits]))
    return nodes


def debnwgn_nodes(nodes: List[Node]) -> List[Node]:
    """Every BatchNormWithGlobalNormalization node rewritten into its
    defining primitives (``tools/make_fake_inception.py:180-222``)."""
    out: List[Node] = []

    def prim(name, op, inputs):
        out.append(Node(name, op, list(inputs), {"T": F32}))
        return name

    for n in nodes:
        if n.op != "BatchNormWithGlobalNormalization":
            out.append(n)
            continue
        t, m, v, beta, gamma = n.input[:5]
        assert n.attr["scale_after_normalization"] == ("b", True)
        eps = np.float32(n.attr["variance_epsilon"][1])
        out.append(Node(f"{n.name}/eps", "Const", [], {"dtype": F32, "value": ("tensor", eps)}))
        veps = prim(f"{n.name}/veps", "Add", [v, f"{n.name}/eps"])
        rstd = prim(f"{n.name}/rstd", "Rsqrt", [veps])
        scale = prim(f"{n.name}/scale", "Mul", [gamma, rstd])
        centered = prim(f"{n.name}/centered", "Sub", [t, m])
        scaled = prim(f"{n.name}/scaled", "Mul", [centered, scale])
        prim(n.name, "Add", [scaled, beta])
    return out


def build_graph_def(seed: int = 0) -> bytes:
    """The serialized fake inception graph of ``seed``."""
    return encode_graph_def(graph_nodes(seed), PRODUCER)


def debnwgn(seed: int = 0) -> bytes:
    """The serialized twin of ``build_graph_def(seed)`` that TF can run."""
    return encode_graph_def(debnwgn_nodes(graph_nodes(seed)), PRODUCER)


def twin_path(pb: str) -> str:
    return os.path.splitext(pb)[0] + "_tfexec.pb"


def write(out: str, seed: int = 0) -> str:
    """Write the graph to ``out`` and its twin beside it; returns the twin's path."""
    nodes = graph_nodes(seed)
    with open(out, "wb") as f:
        f.write(encode_graph_def(nodes, PRODUCER))
    with open(twin_path(out), "wb") as f:
        f.write(encode_graph_def(debnwgn_nodes(nodes), PRODUCER))
    return twin_path(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="fake_inception_v1.pb")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    twin = write(args.out, args.seed)
    nodes = graph_nodes(args.seed)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB), {len(nodes)} nodes, "
          f"ops: {sorted({n.op for n in nodes})}")
    print(f"wrote TF-executable twin {twin} (BNWGN -> primitives)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
