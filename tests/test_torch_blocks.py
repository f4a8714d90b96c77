"""The port's layer catalogue against the JAX package's: every block type
(``res``, ``res_i``, ``res_v1``, the four non-local blocks), every
scaling method, activation, pooling, ``sc``/``lrn``/``k``/``i`` op, the
VALID, dilated and asymmetric-SAME convolutions and transposed
convolutions (with their spectral norms), PIM mode, the Routine's links
(split, concat, sum, broadcast, pairwise), the rest of the distance
functions, and the host-side resize of the input pipeline.

Each case builds the same design on both sides at a small size, fills
the JAX parameters and state with seeded random numbers (the non-local
blocks' ``k_x`` non-zero, so the attention shows in the output), carries
them over with the bridge's per-op conversions and runs the same numpy
input (NHWC for JAX, NCHW here) in float32. Tolerances: outputs and new
state rtol 1e-4 / atol 1e-5; gradients of a random projection of the
output with respect to the input and every parameter rtol 1e-4 / atol
1e-4, whose atol is float32 summation-order noise on gradients of order
1-10 that sum over a whole image (the non-local blocks' softmax and
train-mode BN over 2 samples magnify it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.data.pipeline import ReadTFRecords as JaxReadTFRecords
from mmdgan_tpu.models.layers import ACTIVATIONS as JAX_ACTIVATIONS
from mmdgan_tpu.models.layers import Layer as JaxLayer
from mmdgan_tpu.models.layers import update_layer_design as jax_update_layer_design
from mmdgan_tpu.models.network import Net as JaxNet
from mmdgan_tpu.models.network import Routine as JaxRoutine
from mmdgan_tpu.models.ops import ParametricOp as JaxParametricOp
from mmdgan_tpu.models.scaling import ImageScaling as JaxImageScaling
from mmdgan_tpu.ops import distance as jdist
from mmdgan_torch.data.pipeline import ReadTFRecords
from mmdgan_torch.data.tfrecord import np_to_tfrecords
from mmdgan_torch.models.initializers import weight_initializer
from mmdgan_torch.models.layers import ACTIVATIONS, Layer, apply_activation
from mmdgan_torch.models.network import Net, Routine
from mmdgan_torch.models.ops import ParametricOp
from mmdgan_torch.models.scaling import ImageScaling
from mmdgan_torch.ops import distance as tdist
from mmdgan_torch.utils.jax_bridge import _param, _state

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the Routine test in float64: outputs (cast to float32 by both Routines)
# within two float32 ulps, gradients at float64 summation noise
F32_OUT_TOL = dict(rtol=2.5e-7, atol=1e-9)
X64_TOL = dict(rtol=1e-9, atol=1e-9)
N = 2


def chw(shape):
    return (shape[2], shape[0], shape[1]) if len(shape) == 3 else tuple(shape)


def to_nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def random_tree(tree, rng):
    """Seeded random values in the shapes of a JAX (params or state) tree."""
    def fill(path, a):
        name = str(path[-1].key)
        shape = np.shape(a)
        v = np.asarray(rng.randn(*shape), np.float32) * 0.5
        if name == "moving_var":
            v = np.abs(v) + 0.5
        if name == "kernel" and shape == ():   # the k op's scalar, inside its bound
            v = np.float32(0.7)
        return jnp.asarray(v)
    return jax.tree_util.tree_map_with_path(fill, tree)


def bridge_ops(ops, jtree, fn):
    """A JAX {op: {leaf: array}} tree in the port's layout, by op."""
    return {op_name: {name: torch.tensor(np.ascontiguousarray(
                fn(ops[op_name], name, np.asarray(a), None, None)), requires_grad=(fn is _param))
            for name, a in leaves.items()} for op_name, leaves in jtree.items()}


def build_pair(design, ish, num_class=0, sn_mode="pico"):
    jlayer = JaxLayer(jax_update_layer_design(design), input_shape=ish, name_prefix="t/",
                      num_class=num_class, sn_mode=sn_mode, compute_dtype=jnp.float32)
    jlayer.build()
    layer = Layer(design, chw(ish), name_prefix="t/", num_class=num_class, sn_mode=sn_mode,
                  compute_dtype=torch.float32)
    assert [la for la in layer.ops] == [la for la in jlayer.ops]
    assert layer.output_shape == chw(jlayer.output_shape)
    return jlayer, layer


def compare_layer(design, ish, seed=0, train=True, num_class=0, labels=None, sn_mode="pico"):
    """Forward, new state and gradients of one layer on both sides."""
    jlayer, layer = build_pair(design, ish, num_class, sn_mode)
    rng = np.random.RandomState(seed)
    jparams, jstate = jlayer.init(jax.random.PRNGKey(seed))
    jparams, jstate = random_tree(jparams, rng), random_tree(jstate, rng)
    x = rng.randn(N, *ish).astype(np.float32)
    y = None if labels is None else np.asarray(labels, np.int32)
    ct = rng.randn(N, *jlayer.output_shape).astype(np.float32)

    def jfwd(p, xx):
        out, s = jlayer.apply(p, jstate, {"x": xx, "y": None if y is None else jnp.asarray(y)},
                              train=train)
        return jnp.sum(out["x"] * ct), (out["x"], s)

    (_, (jout, jnew)), (jgp, jgx) = jax.value_and_grad(jfwd, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    params = bridge_ops(layer.ops, jparams, _param)
    state = bridge_ops(layer.ops, jstate, _state)
    xt = torch.tensor(to_nchw(x), requires_grad=True)
    out, new = layer.apply(params, state, xt, train=train,
                           label=None if y is None else torch.tensor(y))
    np.testing.assert_allclose(out.detach().numpy(), to_nchw(jout), **TOL)
    want_state = bridge_ops(layer.ops, jnew, _state)
    for op_name, leaves in want_state.items():
        for name, w in leaves.items():
            np.testing.assert_allclose(new[op_name][name].detach().numpy(), w.detach().numpy(),
                                       **TOL, err_msg=f"state {op_name}/{name}")
    leaves = [(o, n, t) for o, ls in params.items() for n, t in ls.items()]
    grads = torch.autograd.grad((out * torch.tensor(to_nchw(ct))).sum(),
                                [xt] + [t for _, _, t in leaves], allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), to_nchw(jgx), **GRAD_TOL, err_msg="d/dx")
    want_grads = bridge_ops(layer.ops, jgp, _param)
    for (o, n, _), g in zip(leaves, grads[1:]):
        w = want_grads[o][n].detach().numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"d/d {o}/{n}")
    return layer


def _sn(**kw):
    return {"w_nm": "s", "act_k": 1.3, **kw}


BLOCKS = {
    "res_bil_up": ({"name": "r", "type": "res", "out": 6, "act": "relu", "act_nm": "bn",
                    "kernel": [3, 3, 1], "strides": 1, "scale": ["bil", 2], **_sn()}, (4, 4, 3)),
    "res_i_act_list": ({"name": "r", "type": "res_i", "out": 4, "act": ["relu", "lrelu"],
                        "act_nm": "bn", "kernel": [3, 3]}, (4, 4, 4)),
    "res_v1_avg_down": ({"name": "r", "type": "res_v1", "out": 6, "act": "relu",
                         "kernel": [3, 3, 1], "scale": ["avg", -2], **_sn()}, (8, 8, 3)),
    "res_tc": ({"name": "r", "type": "res", "op": "tc", "out": 4, "act": "relu",
                "act_nm": "bn", "kernel": [4, 3, 4], "strides": [2, 1, 2], **_sn()}, (4, 4, 3)),
    "res_ps_down": ({"name": "r", "type": "res", "out": 4, "act": "elu", "kernel": [3, 3, 1],
                     "scale": ["ps", -2]}, (4, 4, 2)),
    **{t: ({"name": "nl", "type": t, "op": "c", "out": [2, 2, 8], "kernel": [1, 1, 1],
            "act": "linear", "act_nm": "bn", **_sn()}, (4, 4, 8))
       for t in ("nl", "nl_dist", "nl_pool", "nl_pool_dist")},
    "nl_no_sn": ({"name": "nl", "type": "nl_pool", "op": "c", "out": [2, 2, 8],
                  "kernel": [1, 1, 1], "act": "linear"}, (4, 4, 8)),
    **{f"scale_{m}_{f}": ({"name": "s", "op": "c", "out": 4, "act": "relu",
                           "scale": [m, f]}, (4, 4, 8))
       for m, f in (("ps", 2), ("ps", -2), ("bil", 2), ("bil", -2), ("bic", 2), ("bic", 3),
                    ("max", -2), ("avg", -2), ("unpool", 2))},
    "op_i_bn": ({"name": "i", "op": "i", "act": "lrelu", "act_nm": "bn"}, (4, 4, 3)),
    "op_sc_asym": ({"name": "sc", "op": "sc", "out": 5, "kernel": 3, "strides": 2,
                    "act": "relu"}, (6, 6, 3)),
    "op_sc_dilated": ({"name": "sc", "op": "sc", "out": 5, "kernel": 3, "dilation": 2,
                       "act": "linear"}, (6, 6, 3)),
    **{f"pool_{op}_{pad}": ({"name": "p", "op": op, "kernel": 3, "strides": 2, "padding": pad,
                             "act": "linear"}, (7, 7, 3))
       for op in ("max", "avg", "sum") for pad in ("SAME", "VALID")},
    "conv_valid": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "padding": "VALID",
                    **_sn()}, (6, 6, 3)),
    "conv_valid_s2": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "strides": 2,
                       "padding": "VALID", **_sn()}, (7, 7, 3)),
    "conv_dilated": ({"name": "c", "op": "c", "out": 4, "kernel": 3, "dilation": 2,
                      **_sn()}, (6, 6, 3)),
    "conv_asym_same": ({"name": "c", "op": "c", "out": 8, "kernel": 3, "strides": 2,
                        **_sn()}, (8, 8, 3)),
    "conv_asym_same_out_side": ({"name": "c", "op": "c", "out": 2, "kernel": 3, "strides": 2,
                                 **_sn()}, (8, 8, 3)),
    "tc_valid": ({"name": "t", "op": "tc", "out": 4, "kernel": 3, "padding": "VALID",
                  **_sn()}, (4, 4, 3)),
    "tc_asym_same_k3s2": ({"name": "t", "op": "tc", "out": 4, "kernel": 3, "strides": 2,
                           **_sn()}, (4, 4, 3)),
    "tc_asym_same_k2s3": ({"name": "t", "op": "tc", "out": 2, "kernel": 2, "strides": 3,
                           **_sn()}, (3, 3, 4)),
    "tc_dilated": ({"name": "t", "op": "tc", "out": 4, "kernel": 3, "dilation": 2,
                    **_sn()}, (4, 4, 3)),
    "dense_bn_lrelu": ({"name": "d", "op": "d", "out": 6, "act": "lrelu", "act_nm": "bn",
                        **_sn()}, (5,)),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax(case):
    design, ish = BLOCKS[case]
    compare_layer(design, ish, seed=sorted(BLOCKS).index(case))


@pytest.mark.parametrize("op,ish", [("c", (6, 6, 3)), ("tc", (4, 4, 3))])
def test_pim_mode_matches_jax(op, ish):
    """sn_mode='pim': power iteration on the kernel as JAX's HWIO matrix."""
    compare_layer({"name": "p", "op": op, "out": 5, "kernel": 4 if op == "tc" else 3,
                   "strides": 2 if op == "tc" else 1, **_sn()}, ish, sn_mode="pim")


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
def test_activation_matches_jax(act):
    """Every activation; crelu stacks on channels (axis 1 here, -1 in JAX)."""
    x = np.random.RandomState(3).randn(2, 4, 4, 3).astype(np.float32) * 2
    got = apply_activation(torch.tensor(to_nchw(x)), act).numpy()
    np.testing.assert_allclose(got, to_nchw(JAX_ACTIVATIONS[act](jnp.asarray(x))), **TOL)


def test_crelu_layer_doubles_channels():
    """A crelu layer's shape inference follows the doubled channels (the
    JAX layer declares the undoubled shape): its output equals JAX's
    linear layer followed by JAX's crelu, and a strided downsampling after
    it is built on 2C channels."""
    design = {"name": "c", "op": "c", "out": 3, "kernel": 3, "act": "linear",
              "scale": ["max", -2]}
    jlayer, _ = build_pair(design, (4, 4, 2))
    layer = Layer({**design, "act": "crelu"}, (2, 4, 4), name_prefix="t/",
                  compute_dtype=torch.float32)
    assert layer.output_shape == (6, 2, 2)
    rng = np.random.RandomState(5)
    jparams = random_tree(jlayer.init(jax.random.PRNGKey(0))[0], rng)
    x = rng.randn(N, 4, 4, 2).astype(np.float32)
    # JAX: kernel, bias, crelu, then the max pool
    h = jlayer.ops["bias"].apply(jparams["bias"], {}, jlayer.ops["kernel"].apply(
        jparams["kernel"], {}, jnp.asarray(x))[0])[0]
    want = JaxImageScaling({"method": "max", "factor": -2}, (4, 4, 6)).apply(
        JAX_ACTIVATIONS["crelu"](h))
    out, _ = layer.apply(bridge_ops(layer.ops, jparams, _param), {},
                         torch.tensor(to_nchw(x)))
    np.testing.assert_allclose(out.detach().numpy(), to_nchw(want), **TOL)


@pytest.mark.parametrize("design,ish", [
    ({"op": "k", "bound": (-0.5, 0.5)}, (4, 4, 3)),
    ({"op": "k"}, (5,)),
    ({"op": "lrn"}, (4, 4, 3)),
    ({"op": "lrn"}, (5,)),
    ({"op": "i"}, (3, 3, 2)),
], ids=["k_bound", "k_dense", "lrn_image", "lrn_dense", "i"])
def test_parameterless_and_scalar_ops_match_jax(design, ish):
    jop = JaxParametricOp(design, ish, compute_dtype=jnp.float32)
    op = ParametricOp(design, chw(ish), compute_dtype=torch.float32)
    assert op.output_shape == chw(jop.output_shape)
    jparams = {"kernel": jnp.asarray(np.float32(0.9))} if design["op"] == "k" else {}
    x = np.random.RandomState(1).randn(N, *ish).astype(np.float32)
    want, _ = jop.apply(jparams, {}, jnp.asarray(x))
    got, _ = op.apply({k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}, {},
                      torch.tensor(to_nchw(x)))
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)


def test_init_modes():
    """sn_paper draws a normal of std 0.02, pg_paper a unit normal, both
    truncated at 2 std; an unknown mode raises."""
    g = torch.Generator().manual_seed(0)
    for mode, std in (("sn_paper", 0.02), ("pg_paper", 1.0)):
        w = weight_initializer("relu", mode=mode)(g, (64, 64, 3, 3))
        assert abs(float(w.std()) / std - 0.88) < 0.03   # a +-2 std truncated normal
        assert float(w.abs().max()) <= 2 * std
    with pytest.raises(NotImplementedError):
        weight_initializer("relu", mode="svd")


LINKS = [
    {"name": "in", "out": 8, "op": "c", "kernel": 3, "act": "relu"},
    {"name": "a", "out": 4, "op": "c", "kernel": 3, "act": "relu"},
    {"name": "b", "out": 4, "op": "c", "kernel": 1, "act": "lrelu"},
    {"name": "cat", "out": 6, "op": "c", "kernel": 3, "act": "linear"},
    {"name": "p", "out": 6, "op": "c", "kernel": 1, "act": "linear"},
    {"name": "q", "out": 6, "op": "c", "kernel": 3, "act": "relu"},
    {"name": "sum", "out": 3, "op": "c", "kernel": 3, "act": "tanh"},
    {"name": "u", "out": 3, "op": "c", "kernel": 1, "act": "linear"},
    {"name": "v", "out": 2, "op": "c", "kernel": 1, "act": "linear"},
]


def _wire(r):
    """in -> split(a, b) -> concat -> cat -> broadcast(p, q) -> sum ->
    pairwise (sum, cat) -> (u, v); outputs u and v."""
    r.add_input_layers([3, 4, 4], [0])
    r.link([0], [1, 2], input_fun="split")
    r.link([1, 2], [3], input_fun="concat")
    r.link([3], [4, 5])
    r.link([4, 5, 3], [6], input_fun="sum")
    r.link([6, 3], [7, 8])
    r.add_output_layers([7, 8])


def test_routine_links_match_jax():
    """split/concat on channels, 1 -> N broadcast, N -> 1 sum, N -> N
    pairwise, two outputs: forward and gradients against JAX.

    Both sides compute in float64 (JAX inside a scoped ``enable_x64``) on
    the same seeded float32 numbers widened: nine stacked convs with relu
    put float32 pre-activations near 0, where the host's conv kernels (ISA,
    library, thread count) flip a relu and move a kernel gradient by up to
    5.5e-4. The Routines still return float32 outputs, so the outputs are
    held at float32's own resolution and the gradients, float64 below
    that cast, at ``X64_TOL``, both tighter than ``TOL``/``GRAD_TOL``."""
    with jax.enable_x64(True):
        jr = JaxRoutine(JaxNet(LINKS, net_name="t", compute_dtype=jnp.float64))
        _wire(jr)
        r = Routine(Net(LINKS, net_name="t", compute_dtype=torch.float64))
        _wire(r)
        assert r.output_shape == {7: (3, 4, 4), 8: (2, 4, 4)}
        rng = np.random.RandomState(0)
        jparams, _ = jr.init(jax.random.PRNGKey(0))
        jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                         random_tree(jparams, rng))
        x = rng.randn(N, 4, 4, 3).astype(np.float32).astype(np.float64)

        def jloss(p):
            out, _ = jr.apply(p, {}, {"x": jnp.asarray(x), "y": None})
            return jnp.sum(out[7]["x"] ** 2) + jnp.sum(out[8]["x"] * 3.0), out

        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
        assert {a.dtype for a in jax.tree_util.tree_leaves(jgrad)} == {jnp.dtype("float64")}
    layers = {la.layer_scope: la for la in r.layers}
    params = {s: bridge_ops(layers[s].ops, t, _param) for s, t in jparams.items()}
    out, _ = r.apply(params, {}, torch.tensor(to_nchw(x)))
    for i in (7, 8):
        np.testing.assert_allclose(out[i].detach().numpy(), to_nchw(jout[i]["x"]), **F32_OUT_TOL)
    loss = torch.sum(out[7] ** 2) + torch.sum(out[8] * 3.0)
    leaves = [(s, o, n, t) for s, ops in params.items() for o, ls in ops.items()
              for n, t in ls.items()]
    grads = torch.autograd.grad(loss, [t for *_, t in leaves])
    for (s, o, n, _), g in zip(leaves, grads):
        assert g.dtype == torch.float64
        want = _param(layers[s].ops[o], n, np.asarray(jgrad[s][o][n]), None, None)
        np.testing.assert_allclose(g.numpy(), want, **X64_TOL, err_msg=f"{s}/{o}/{n}")


def test_routine_dense_split_concat_like_jax():
    """tests/test_network.py's dense split/concat routine: 6 -> 8 -> two
    4-wide halves -> concat -> 2."""
    design = [{"name": "in", "out": 8, "op": "d", "act": "relu"},
              {"name": "a", "out": 4, "op": "d", "act": "relu"},
              {"name": "b", "out": 4, "op": "d", "act": "relu"},
              {"name": "out", "out": 2, "op": "d", "act": "linear"}]

    def wire(r):
        r.add_input_layers([6], [0])
        r.link([0], [1, 2], input_fun="split")
        r.link([1, 2], [3], input_fun="concat")
        r.add_output_layers([3])

    jr = JaxRoutine(JaxNet(design, net_name="t", compute_dtype=jnp.float32))
    r = Routine(Net(design, net_name="t", compute_dtype=torch.float32))
    wire(jr)
    wire(r)
    jparams = random_tree(jr.init(jax.random.PRNGKey(1))[0], np.random.RandomState(1))
    x = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    jout, _ = jr.apply(jparams, {}, jnp.asarray(x))
    layers = {la.layer_scope: la for la in r.layers}
    out, _ = r.apply({s: bridge_ops(layers[s].ops, t, _param) for s, t in jparams.items()},
                     {}, torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout["x"]), **TOL)
    with pytest.raises(ValueError, match="already been linked"):
        r.link([0], [1])


@pytest.mark.parametrize("method,factor,shape", [
    ("bil", 2, (2, 5, 7, 3)), ("bil", -2, (2, 8, 12, 3)), ("bic", 2, (2, 5, 7, 3)),
    ("bic", 3, (2, 4, 4, 2)), ("ps", 2, (2, 3, 3, 8)), ("ps", -2, (2, 4, 6, 3)),
    ("unpool", 2, (2, 3, 2, 2)), ("max", -2, (2, 5, 5, 2)), ("avg", -3, (2, 7, 8, 2)),
])
def test_image_scaling_matches_jax(method, factor, shape):
    """The align-corners resizes (the test_network.py cases), periodic
    shuffling in TF's channel order, unpooling and pooling."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jsc = JaxImageScaling({"method": method, "factor": factor}, shape[1:])
    sc = ImageScaling({"method": method, "factor": factor}, chw(shape[1:]))
    assert sc.output_shape == chw(jsc.output_shape)
    np.testing.assert_allclose(sc.apply(torch.tensor(to_nchw(x))).numpy(),
                               to_nchw(jsc.apply(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def np_pairwise(a, b):
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def test_squared_dist_ref_and_triplet_match_jax():
    rng = np.random.RandomState(0)
    x, y, z = (rng.randn(6, 3).astype(np.float32) for _ in range(3))
    for got, want in zip(tdist.get_squared_dist_ref(torch.tensor(x), torch.tensor(y)),
                         jdist.get_squared_dist_ref(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tdist.get_squared_dist_ref(torch.tensor(x)).numpy(),
                               np_pairwise(x, x), **TOL)
    got = tdist.squared_dist_triplet(*(torch.tensor(a) for a in (x, y, z)))
    want = jdist.squared_dist_triplet(x, y, z)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdist.get_dist_np(x, y), jdist.get_dist_np(x, y), rtol=1e-6)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("mode", ["xx", "xy", "xxxy", "xxxyyy"])
def test_batch_squared_dist_matches_jax(axis, mode):
    rng = np.random.RandomState(axis)
    xb, yb = rng.randn(3, 5, 7).astype(np.float32), rng.randn(3, 5, 7).astype(np.float32)
    y_j = None if mode == "xx" else jnp.asarray(yb)
    y_t = None if mode == "xx" else torch.tensor(yb)
    want = jdist.get_batch_squared_dist(jnp.asarray(xb), y_j, axis=axis, mode=mode)
    got = tdist.get_batch_squared_dist(torch.tensor(xb), y_t, axis=axis, mode=mode)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_pipeline_resize_matches_jax(tmp_path):
    """``shape2image(resize=...)``: the align-corners bilinear resize on
    the host, float batches only."""
    x = np.random.RandomState(0).randint(0, 256, (6, 3, 8, 8), np.uint8)
    np_to_tfrecords(x, None, str(tmp_path / "r"))
    kw = dict(batch_size=6, file_folder=str(tmp_path), buffer_size=1)
    got = ReadTFRecords("r", **kw).shape2image(3, 8, 8, resize=(12, 6)).load_all()["x"]
    want = JaxReadTFRecords("r", **kw).shape2image(3, 8, 8, resize=(12, 6)).load_all()["x"]
    assert got.shape == (6, 12, 6, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="resize"):
        ReadTFRecords("r", device_decode=True, **kw).shape2image(3, 8, 8, resize=(4, 4))


def test_tc_valid_strided_follows_lax():
    """A stride-2 VALID transposed conv: the port declares and computes
    ``lax.conv_transpose``'s output (10x10 from 4x4 at kernel 4), where
    the JAX layer declares 11x11 and raises (ROADMAP C5)."""
    design = {"op": "tc", "out": 3, "kernel": 4, "strides": 2, "dilation": 1, "padding": "VALID"}
    op = ParametricOp(design, (2, 4, 4), compute_dtype=torch.float32)
    assert op.output_shape == (3, 10, 10)
    rng = np.random.RandomState(0)
    w = rng.randn(4, 4, 2, 3).astype(np.float32)
    x = rng.randn(2, 4, 4, 2).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (2, 2), "VALID",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got, _ = op.apply({"kernel": torch.tensor(_param(op, "kernel", w, None, None).copy())}, {},
                      torch.tensor(to_nchw(x)))
    np.testing.assert_allclose(got.numpy(), to_nchw(want), **TOL)


GEOMETRIES = [("c", (8, 8), 3, 2, 2, "SAME"), ("c", (8, 8), 3, 2, 1, "SAME"),
              ("c", (7, 7), 3, 2, 1, "VALID"), ("c", (6, 6), 3, 1, 2, "SAME"),
              ("tc", (4, 4), 3, 2, 1, "SAME"), ("tc", (3, 3), 2, 3, 1, "SAME"),
              ("tc", (4, 4), 4, 2, 1, "VALID"), ("tc", (4, 4), 3, 1, 2, "SAME"),
              ("tc", (4, 4), 4, 2, 1, "SAME")]


@pytest.mark.parametrize("geo", GEOMETRIES, ids=[f"{g[0]}_k{g[2]}s{g[3]}d{g[4]}_{g[5]}"
                                                 for g in GEOMETRIES])
def test_conv_adjoint_is_the_transpose(geo):
    """<F v, y> = <v, F^T y> in float64 for every padding path of
    ``ops/conv.py`` (the adjoint the power iteration runs)."""
    from mmdgan_torch.ops.conv import Geometry

    op, hw, k, s, d, pad = geo
    g = Geometry.make(op, hw, k, s, d, pad)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((5, 3, k, k) if op == "c" else (3, 5, k, k), generator=gen,
                    dtype=torch.float64)
    v = torch.randn(2, 3, *hw, generator=gen, dtype=torch.float64)
    y = torch.randn(2, 5, *g.out_hw, generator=gen, dtype=torch.float64)
    fv = g.forward(v, w)
    assert tuple(fv.shape[2:]) == g.out_hw
    np.testing.assert_allclose(float((fv * y).sum()), float((v * g.adjoint(y, w)).sum()),
                               rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("c_in,c_out", [(2, 8), (8, 2)], ids=["input_side", "output_side"])
def test_strided_dilated_conv_sn_is_the_layers_operator_norm(c_in, c_out):
    """Spectral norm of a conv with stride 2 and dilation 2: the power
    iteration runs on the layer's own operator, so from the top singular
    vector of that map's explicit matrix (on the side the vector lives
    on) it returns the top singular value (ROADMAP C6: JAX drops the
    stride there)."""
    design = {"op": "c", "out": c_out, "kernel": 3, "strides": 2, "dilation": 2,
              "padding": "SAME", "w_nm": "s"}
    op = ParametricOp(design, (c_in, 8, 8), compute_dtype=torch.float32)
    params, state = op.init(torch.Generator().manual_seed(0))
    jac = torch.autograd.functional.jacobian(
        lambda v: op.geometry.forward(v, params["kernel"]), torch.zeros(1, c_in, 8, 8))
    u, svals, vh = torch.linalg.svd(jac.reshape(c_out * 16, c_in * 64).double())
    top = vh[0] if tuple(state["sn_x"].shape) == (1, c_in, 8, 8) else u[:, 0]
    state["sn_x"] = top.float().reshape(state["sn_x"].shape)
    sigma, _ = op.kernel_norm(params, state)
    np.testing.assert_allclose(float(sigma), float(svals[0]), rtol=1e-5)
