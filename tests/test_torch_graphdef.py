"""The port's GraphDef executor (``mmdgan_torch/metrics/graphdef.py``, its
own protobuf reader, no TensorFlow) against TensorFlow and against the JAX
package's executor (``mmdgan_tpu/metrics/tf_graph_jax.py``) on the same
graphs: ``tools/make_fake_inception.build_graph_def`` (the frozen
inception's tensor contract and legacy op set), the op sets of
``tests/test_tf_graph_jax.py``, a hand-built legacy batch-norm node, and
the narrow fixture ``tests/data/narrow_inception.pb`` that ``chip_smoke.py``
runs on the card. Tolerance rtol 1e-4 / atol 1e-4 (float32 convolutions
summed in other orders).

``build_narrow_inception`` makes the fixture; a test holds the committed
bytes to what it makes. Regenerate with
``python tests/test_torch_graphdef.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmdgan_tpu.metrics.inception import (  # noqa: E402
    FrozenGraphClassifier as JaxFrozenClassifier,
)
from mmdgan_tpu.metrics.tf_graph_jax import GraphDefModule as JaxGraphDefModule  # noqa: E402
from mmdgan_torch.metrics import graph_proto  # noqa: E402
from mmdgan_torch.metrics.graphdef import GraphDefModule  # noqa: E402
from mmdgan_torch.metrics.inception import FrozenGraphClassifier  # noqa: E402
from test_tf_graph_jax import build_extended_ops_graph, build_frozen_cnn  # noqa: E402
from tools.make_fake_inception import build_graph_def, debnwgn  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "narrow_inception.pb")
FIXTURE_IO = (["Mul:0"], ["logits:0", "pool_3:0"])


def build_narrow_inception(seed: int = 0):
    """A narrow frozen classifier in proto form (producer 8, so the legacy
    ``BatchNormWithGlobalNormalization`` may appear), fed at 'Mul:0' with
    [N, 32, 32, 3], read at 'logits:0' [N, 10] and 'pool_3:0' [N, 1, 1, 64].
    Ops: Conv2D SAME stride 2 on even sizes (asymmetric pads) and VALID,
    the legacy batch norm and FusedBatchNormV3, Relu, MaxPool SAME stride
    2, LRN, AvgPool SAME and VALID, legacy Concat and ConcatV2 towers, a
    legacy (TF1) ResizeBilinear branch, Mean, Reshape, MatMul, Add,
    BiasAdd, Softmax."""
    from tensorflow.core.framework import attr_value_pb2, graph_pb2, types_pb2
    from tensorflow.python.framework import tensor_util

    rng = np.random.RandomState(seed)
    gd = graph_pb2.GraphDef()
    gd.versions.producer = 8
    f32 = attr_value_pb2.AttrValue(type=types_pb2.DT_FLOAT)
    i32 = attr_value_pb2.AttrValue(type=types_pb2.DT_INT32)
    count = [0]

    def node(name, op, inputs=(), typed=True, **attrs):
        n = gd.node.add()
        n.name, n.op = name, op
        n.input.extend(inputs)
        for k, v in sorted(attrs.items()):
            a = attr_value_pb2.AttrValue()
            if isinstance(v, bool):
                a.b = v
            elif isinstance(v, int):
                a.i = v
            elif isinstance(v, float):
                a.f = v
            elif isinstance(v, str):
                a.s = v.encode()
            else:
                a.list.i.extend(v)
            n.attr[k].CopyFrom(a)
        if typed:
            n.attr["T"].CopyFrom(f32)
        return name

    def const(arr):
        arr = np.asarray(arr)
        count[0] += 1
        n = gd.node.add()
        n.name, n.op = f"const_{count[0]}", "Const"
        n.attr["dtype"].CopyFrom(i32 if arr.dtype == np.int32 else f32)
        n.attr["value"].tensor.CopyFrom(tensor_util.make_tensor_proto(arr))
        return n.name

    def weight(shape):
        return const((rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(np.float32))

    def vec(c, lo=-0.1, hi=0.1):
        return const(rng.uniform(lo, hi, c).astype(np.float32))

    def conv_bn(x, cin, cout, k, s, padding="SAME", fused=False):
        count[0] += 1
        i = count[0]
        c = node(f"conv_{i}", "Conv2D", [x, weight([k, k, cin, cout])], strides=[1, s, s, 1],
                 padding=padding)
        if fused:
            bn = node(f"fbn_{i}", "FusedBatchNormV3",
                      [c, vec(cout, 0.8, 1.2), vec(cout), vec(cout), vec(cout, 0.5, 1.0)],
                      epsilon=1e-3, is_training=False, data_format="NHWC")
            gd.node[-1].attr["U"].CopyFrom(f32)
        else:
            bn = node(f"bn_{i}", "BatchNormWithGlobalNormalization",
                      [c, vec(cout), vec(cout, 0.5, 1.0), vec(cout), vec(cout, 0.8, 1.2)],
                      variance_epsilon=1e-3, scale_after_normalization=True)
        return node(f"relu_{i}", "Relu", [bn])

    def pool(x, op, k, s, padding, name=None):
        count[0] += 1
        return node(name or f"{op.lower()}_{count[0]}", op, [x], ksize=[1, k, k, 1],
                    strides=[1, s, s, 1], padding=padding)

    def tower(x, cin, width, legacy):
        b1 = conv_bn(x, cin, width, 1, 1)
        b2 = conv_bn(conv_bn(x, cin, width, 1, 1, fused=True), width, width, 3, 1)
        bp = conv_bn(pool(x, "AvgPool", 3, 1, "SAME"), cin, width, 1, 1)
        count[0] += 1
        if legacy:
            cat = node(f"concat_{count[0]}", "Concat", [const(np.int32(3)), b1, b2, bp], N=3)
        else:
            cat = node(f"concatv2_{count[0]}", "ConcatV2", [b1, b2, bp, const(np.int32(3))], N=3)
            gd.node[-1].attr["Tidx"].CopyFrom(i32)
        return cat, 3 * width

    n = gd.node.add()
    n.name, n.op = "input_images", "Placeholder"
    n.attr["dtype"].CopyFrom(f32)
    node("Mul", "Mul", ["input_images", const(np.float32(1.0))])
    y = conv_bn("Mul", 3, 16, 3, 2)                       # 32 -> 16, pads (0, 1)
    y = pool(y, "MaxPool", 3, 2, "SAME")                  # 16 -> 8, pads (0, 1)
    y = node("lrn", "LRN", [y], depth_radius=2, bias=1.0, alpha=1e-3, beta=0.75)
    y, ch = tower(y, 16, 8, legacy=True)                  # 8x8x24
    y, ch = tower(y, ch, 8, legacy=False)                 # 8x8x24
    y = conv_bn(y, ch, 64, 3, 1, padding="VALID")         # 6x6x64
    p3 = pool(y, "AvgPool", 6, 1, "VALID", name="pool_3")  # [N, 1, 1, 64]
    flat = node("flatten", "Reshape", [p3, const(np.asarray([-1, 64], np.int32))])
    gd.node[-1].attr["Tshape"].CopyFrom(i32)
    mm = node("matmul", "MatMul", [flat, weight([64, 10])], transpose_a=False,
              transpose_b=False)
    # a legacy TF1 resize branch (no half-pixel offset), averaged into the logits
    rs = node("resize", "ResizeBilinear", ["Mul", const(np.asarray([13, 11], np.int32))],
              align_corners=False, half_pixel_centers=False)
    rm = node("resize_mean", "Mean", [rs, const(np.asarray([1, 2], np.int32))], keep_dims=False)
    gd.node[-1].attr["Tidx"].CopyFrom(i32)
    side = node("side", "MatMul", [rm, weight([3, 10])], transpose_a=False, transpose_b=False)
    pre = node("pre_logits", "Add", [mm, side])
    logits = node("logits", "BiasAdd", [pre, vec(10)])
    node("softmax", "Softmax", [logits])
    return gd


def fixture_bytes() -> bytes:
    return build_narrow_inception().SerializeToString(deterministic=True)


def tf_run(gd, feeds, outputs):
    with tf.Graph().as_default() as g:
        outs = tf.graph_util.import_graph_def(gd, input_map={}, return_elements=outputs,
                                              name="")
        with tf.compat.v1.Session(graph=g) as sess:
            return sess.run(outs, feed_dict=feeds)


def check_three_ways(gd, tf_gd, inputs, outputs, x):
    """TF (on ``tf_gd``), the JAX executor and the port's (on ``gd``)."""
    want = tf_run(tf_gd, {inputs[0]: x}, outputs)
    jax_out = JaxGraphDefModule(gd, inputs, outputs)(x)
    got = GraphDefModule(gd, inputs, outputs, device="cpu")(x)
    for name, w, j, g in zip(outputs, want, jax_out, got):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"{name} vs TF")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL, err_msg=f"{name} vs JAX")
    return got


def test_fake_inception_matches_tf_and_jax(rng):
    """The frozen inception's contract: 'Mul:0' [N, 299, 299, 3] in,
    'logits:0' [N, 1008] and 'pool_3:0' [N, 1, 1, 2048] out, the legacy op
    set; TF runs the twin whose legacy batch norms are primitives."""
    gd = build_graph_def(0)
    x = rng.rand(2, 299, 299, 3).astype(np.float32) * 2 - 1
    logits, pool3 = check_three_ways(gd, debnwgn(gd), ["Mul:0"], ["logits:0", "pool_3:0"], x)
    assert logits.shape == (2, 1008) and pool3.shape == (2, 1, 1, 2048)


@pytest.mark.parametrize("builder,outputs", [
    (build_frozen_cnn, ["logits:0", "pool_3:0", "probs:0"]),
    (build_extended_ops_graph, ["out:0"]),
])
def test_op_sets_match_tf_and_jax(rng, builder, outputs):
    gd = builder()
    shape = (4, 16, 16, 3) if builder is build_frozen_cnn else (2, 8, 8, 6)
    check_three_ways(gd, gd, ["input:0"], outputs, rng.randn(*shape).astype(np.float32))


def test_narrow_fixture_matches_tf_and_jax(rng):
    gd = build_narrow_inception()
    x = rng.rand(3, 32, 32, 3).astype(np.float32) * 2 - 1
    logits, pool3 = check_three_ways(gd, debnwgn(gd), *FIXTURE_IO, x)
    assert logits.shape == (3, 10) and pool3.shape == (3, 1, 1, 64)
    ops = {n.op for n in gd.node}
    assert {"BatchNormWithGlobalNormalization", "FusedBatchNormV3", "LRN", "Concat",
            "ConcatV2", "ResizeBilinear", "MaxPool", "AvgPool"} <= ops


def test_committed_fixture_is_what_the_helper_makes():
    with open(FIXTURE, "rb") as f:
        committed = f.read()
    assert committed == fixture_bytes()
    assert len(committed) <= 1 << 20


def test_frozen_classifier_matches_jax_on_the_fixture(rng):
    """Both packages' FrozenGraphClassifier on the fixture's .pb path, fed
    at 32 (no resize)."""
    import mmdgan_tpu.metrics.inception as jax_inception

    imgs = rng.rand(5, 32, 32, 3).astype(np.float32) * 2 - 1
    orig = jax_inception.IMAGE_SIZE
    jax_inception.IMAGE_SIZE = 32
    try:
        jl, jp = JaxFrozenClassifier(FIXTURE, backend="jax")(imgs)
    finally:
        jax_inception.IMAGE_SIZE = orig
    tl, tp = FrozenGraphClassifier(FIXTURE, device="cpu", image_size=32)(imgs)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    np.testing.assert_allclose(tp.numpy(), jp, **TOL)
    # at another size the classifier resizes the TF1 way first
    tl, _ = FrozenGraphClassifier(FIXTURE, device="cpu", image_size=32)(imgs[:, :24, :24])
    assert tl.shape == (5, 10) and torch.isfinite(tl).all()


def test_serialized_bytes_and_batch_polymorphism(rng):
    gd = build_frozen_cnn()
    mod = GraphDefModule(gd.SerializeToString(), ["input:0"], ["logits:0"], device="cpu")
    assert mod(rng.randn(2, 16, 16, 3).astype(np.float32))[0].shape == (2, 5)
    assert mod(rng.randn(7, 16, 16, 3).astype(np.float32))[0].shape == (7, 5)


def test_unsupported_ops_reported_all_at_once():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 4], name="input")
        a = tf.math.cumsum(x, name="csum")
        b = tf.math.erf(a, name="erf")
        _ = tf.math.atan2(b, b, name="out")
    with pytest.raises(NotImplementedError) as ei:
        GraphDefModule(g.as_graph_def(), ["input:0"], ["out:0"], device="cpu")
    msg = str(ei.value)
    assert "Cumsum" in msg and "Erf" in msg and "Atan2" in msg
    assert "3 unsupported op type" in msg


def test_unreached_host_preprocessing_not_inventoried(rng):
    g = tf.Graph()
    with g.as_default():
        raw = tf.compat.v1.placeholder(tf.string, [], name="jpeg")
        img = tf.io.decode_jpeg(raw, name="decode")
        img = tf.cast(img, tf.float32)
        img = tf.expand_dims(img, 0, name="feed")
        _ = tf.nn.relu(img, name="out")
    mod = GraphDefModule(g.as_graph_def(), ["feed:0"], ["out:0"], device="cpu")
    x = rng.rand(1, 8, 8, 3).astype(np.float32) - 0.5
    np.testing.assert_allclose(mod(x)[0].numpy(), np.maximum(x, 0.0))


def test_legacy_batchnorm_node(rng):
    from tensorflow.core.framework import graph_pb2

    gd = graph_pb2.GraphDef()
    t = rng.randn(2, 4, 4, 3).astype(np.float32)
    m = rng.randn(3).astype(np.float32)
    v = (np.abs(rng.randn(3)) + 0.5).astype(np.float32)
    beta = rng.randn(3).astype(np.float32)
    gamma = (np.abs(rng.randn(3)) + 0.2).astype(np.float32)
    inp = gd.node.add()
    inp.name, inp.op = "input", "Placeholder"
    for name, val in [("m", m), ("v", v), ("beta", beta), ("gamma", gamma)]:
        c = gd.node.add()
        c.name, c.op = name, "Const"
        c.attr["value"].tensor.CopyFrom(tf.make_tensor_proto(val))
    bn = gd.node.add()
    bn.name, bn.op = "bn", "BatchNormWithGlobalNormalization"
    bn.input.extend(["input", "m", "v", "beta", "gamma"])
    bn.attr["variance_epsilon"].f = 1e-3
    bn.attr["scale_after_normalization"].b = True
    (out,) = GraphDefModule(gd, ["input:0"], ["bn:0"], device="cpu")(t)
    expect = (t - m) / np.sqrt(v + 1e-3) * gamma + beta
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-5)
    (jout,) = JaxGraphDefModule(gd, ["input:0"], ["bn:0"])(t)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5,
    np.asarray([-3, 0, 7, -2 ** 31], np.int32),
    np.asarray([[-2 ** 40, 5]], np.int64),
    np.asarray([True, False, True]),
    np.float32(2.5),
    np.asarray([1.5, -2.0], np.float64),
    np.asarray([0.5, -1.25, 3.0], np.float16),
])
def test_tensor_reader_matches_tf_make_ndarray(value):
    """``graph_proto`` reads TensorProtos as ``tf.make_ndarray``: content
    bytes, typed value lists, and a single value broadcast to the shape."""
    for proto in (tf.make_tensor_proto(value),
                  tf.make_tensor_proto(np.asarray(value).reshape(-1)[:1].repeat(1),
                                       shape=np.shape(value) or None)):
        want = tf.make_ndarray(proto)
        got = graph_proto.make_ndarray(graph_proto.parse_tensor(proto.SerializeToString()))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_attr_reader_matches_the_proto():
    from tensorflow.core.framework import attr_value_pb2

    a = attr_value_pb2.AttrValue()
    a.list.i.extend([1, -2, 3])
    a.list.f.extend([0.5, -1.5])
    got = graph_proto.parse_attr(a.SerializeToString())
    assert got.list.i == [1, -2, 3] and got.list.f == [0.5, -1.5]
    for field, v in (("i", -7), ("f", 0.25), ("b", True), ("s", b"SAME"), ("type", 3)):
        a = attr_value_pb2.AttrValue()
        setattr(a, field, v)
        assert getattr(graph_proto.parse_attr(a.SerializeToString()), field) == v


def test_executor_defaults_to_cuda():
    gd = build_frozen_cnn()
    if torch.cuda.is_available():
        assert GraphDefModule(gd, ["input:0"], ["logits:0"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphDefModule(gd, ["input:0"], ["logits:0"])


if __name__ == "__main__":
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "wb") as f:
        f.write(fixture_bytes())
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
