"""The port's fake inception graph (``mmdgan_torch/tools/make_fake_inception.py``)
and its GraphDef writer (``mmdgan_torch/metrics/graph_encode.py``) against
the JAX tool, which builds the graph with TensorFlow's protobuf classes.

- The port's bytes for seeds 0 and 1, and its ``debnwgn`` twin's, equal
  the JAX tool's ``SerializeToString(deterministic=True)`` byte for byte,
  and parse in TF to a GraphDef equal to JAX's.
- The writer's tensors and attributes equal ``tf.make_tensor_proto`` and
  ``AttrValue``'s serializations; a map's keys come out in protobuf's
  deterministic order.
- The graph run by the port's executor (``GraphDefModule``, CPU) equals TF
  running the twin at ``tests/test_torch_graphdef.py``'s tolerance.
- The port's and JAX's ``GenerativeModelMetric`` over the same numpy
  batches and the same fake ``.pb`` give the same IS and FID at rtol 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tensorflow.core.framework import attr_value_pb2, graph_pb2, node_def_pb2  # noqa: E402
from tensorflow.python.framework import tensor_util  # noqa: E402

from mmdgan_torch.metrics import graph_encode, graph_proto  # noqa: E402
from mmdgan_torch.metrics.graphdef import GraphDefModule  # noqa: E402
from mmdgan_torch.tools import make_fake_inception  # noqa: E402
from tools import make_fake_inception as jax_tool  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _two_blas_threads():
    """Two BLAS threads: the FID's 2048-wide SVDs thrash a host shared by
    six test workers (as in tests/test_torch_eval_cli.py)."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=2):
        yield


TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_graphdef.py


@pytest.fixture(scope="module")
def jax_graphs():
    return {seed: jax_tool.build_graph_def(seed) for seed in (0, 1)}


@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bytes_equal_the_jax_tools_deterministic_serialization(jax_graphs, seed, twin):
    want = jax_graphs[seed]
    if twin:
        want = jax_tool.debnwgn(want)
        got = make_fake_inception.debnwgn(seed)
    else:
        got = make_fake_inception.build_graph_def(seed)
    assert got == want.SerializeToString(deterministic=True)
    parsed = graph_pb2.GraphDef.FromString(got)
    assert parsed == want and parsed.versions.producer == 8


def test_the_graph_keeps_the_inception_contract():
    gd = graph_proto.parse_graph_def(make_fake_inception.build_graph_def(0))
    nodes = graph_proto.nodes_by_name(gd)
    assert nodes["Mul"].input == ["input_images", "mul_one"]
    assert {"BatchNormWithGlobalNormalization", "LRN", "Concat", "ConcatV2", "MaxPool",
            "AvgPool", "MatMul", "BiasAdd", "Softmax"} <= {n.op for n in gd.node}
    assert graph_proto.make_ndarray(nodes["const_91"].attr["value"].tensor) == 3


@pytest.mark.parametrize("value", [
    np.float32(1.0), np.int32(3), np.int32(-7), np.asarray([-1, 2048], np.int32),
    np.zeros(5, np.float32), np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 5.5,
])
def test_tensor_equals_make_tensor_proto(value):
    assert graph_encode.encode_tensor(value) == tensor_util.make_tensor_proto(
        value).SerializeToString(deterministic=True)


@pytest.mark.parametrize("kind,value,field", [
    ("list", [1, 2, 2, 1], "list"), ("list", [-1, 0], "list"), ("s", "SAME", "s"),
    ("s", "", "s"), ("i", 0, "i"), ("i", -4, "i"), ("f", 1e-3, "f"), ("f", 0.0, "f"),
    ("b", False, "b"), ("b", True, "b"), ("type", 3, "type"),
])
def test_attr_equals_the_proto(kind, value, field):
    a = attr_value_pb2.AttrValue()
    if field == "list":
        a.list.i.extend(value)
    else:
        setattr(a, field, value.encode() if field == "s" else value)
    assert graph_encode.encode_attr(kind, value) == a.SerializeToString(deterministic=True)


def test_node_map_order_equals_the_proto():
    keys = ["T", "Tidx", "N", "dtype", "data_format", "data", "a", "T2", "Ta"]
    node = node_def_pb2.NodeDef(name="n", op="Op", input=["a", "b:1"])
    for i, key in enumerate(keys):
        node.attr[key].i = i
    ours = graph_encode.Node("n", "Op", ["a", "b:1"], {k: ("i", i) for i, k in enumerate(keys)})
    assert graph_encode.encode_node(ours) == node.SerializeToString(deterministic=True)


def test_port_graph_on_the_port_executor_equals_tf_on_the_twin(rng):
    x = rng.rand(2, 299, 299, 3).astype(np.float32) * 2 - 1
    with tf.Graph().as_default() as g:
        outs = tf.graph_util.import_graph_def(
            graph_pb2.GraphDef.FromString(make_fake_inception.debnwgn(0)), input_map={},
            return_elements=["logits:0", "pool_3:0"], name="")
        with tf.compat.v1.Session(graph=g) as sess:
            want = sess.run(outs, feed_dict={"Mul:0": x})
    got = GraphDefModule(make_fake_inception.build_graph_def(0), ["Mul:0"],
                         ["logits:0", "pool_3:0"], device="cpu")(x)
    assert got[0].shape == (2, 1008) and got[1].shape == (2, 1, 1, 2048)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w, **TOL)


def test_cli_writes_the_graph_and_its_twin(tmp_path):
    out = tmp_path / "fake.pb"
    proc = subprocess.run([sys.executable, "-m", "mmdgan_torch.tools.make_fake_inception",
                           "--out", str(out), "--seed", "1"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == make_fake_inception.build_graph_def(1)
    assert (tmp_path / "fake_tfexec.pb").read_bytes() == make_fake_inception.debnwgn(1)
    assert "BatchNormWithGlobalNormalization" in proc.stdout


def test_generative_metric_matches_jax_on_the_fake_graph(tmp_path, rng):
    """IS(x), IS(g), FID(x, x) and FID(x, g) of both packages' metric with a
    FrozenGraphClassifier on the same fake .pb, over the same numpy batches
    (32x32, resized to 299 inside both)."""
    from mmdgan_tpu.metrics.inception import FrozenGraphClassifier as JaxClassifier
    from mmdgan_tpu.metrics.scores import GenerativeModelMetric as JaxMetric
    from mmdgan_torch.metrics.inception import FrozenGraphClassifier
    from mmdgan_torch.metrics.scores import GenerativeModelMetric

    pb = str(tmp_path / "fake.pb")
    make_fake_inception.write(pb, seed=0)
    real = [rng.rand(6, 32, 32, 3).astype(np.float32) * 2 - 1 for _ in range(2)]
    gen = [np.tanh(rng.randn(6, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    want = JaxMetric(classifier=JaxClassifier(pb, backend="jax")).inception_score_and_fid(
        iter(real), iter(gen), num_batch=2)
    seconds = {}
    got = GenerativeModelMetric(classifier=FrozenGraphClassifier(pb, device="cpu")
                                ).inception_score_and_fid(iter(real), iter(gen), num_batch=2,
                                                          seconds=seconds)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert set(seconds) == {"data", "generation", "classifier", "fid"}


@pytest.fixture
def rng():
    return np.random.RandomState(0)
