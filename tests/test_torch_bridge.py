"""The JAX -> port parameter bridge, one value test per op type: a JAX
Layer and the port's Layer of a small cifar-like architecture, float32,
fed the same numpy input with the bridged parameters and state.

Covers dense (``d``), conv 3x3/s1 and 4x4/s2 (``c``), transposed conv
4x4/s2 (``tc``), BN in train and eval mode, spectral norm with the vector
in the input and the output space, and both flatten permutations: the
columns and bias of a dense layer before an image ``out_reshape`` and the
rows of a dense layer after a flatten. Tolerance rtol 1e-5 / atol 1e-6:
the same float32 arithmetic summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
B = 4

ARCH = {
    "input": [(3, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 2 * 2, "op": "d", "act": "linear",
         "act_nm": None, "out_reshape": [8, 2, 2]},
        {"name": "l2_up", "out": 6, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3_up", "out": 4, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l4", "out": 3, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 4, "act": "lrelu", "act_k": 1.5, "w_nm": "s"},
        {"name": "l2_ds", "out": 8, "act": "lrelu", "act_k": 1.5, "w_nm": "s",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 8, "op": "c", "act": "lrelu", "act_k": 1.5, "w_nm": "s",
         "out_reshape": [4 * 4 * 8]},
        {"name": "l4_s", "out": 16, "op": "d", "act_k": 1.5, "bias": "b", "w_nm": "s"},
    ],
}

# (net, layer index, train, what it covers)
CASES = [
    ("gen", 0, True, "d + columns/bias permuted before out_reshape"),
    ("gen", 1, True, "tc 4x4/s2 + bn train"),
    ("gen", 1, False, "tc 4x4/s2 + bn eval"),
    ("gen", 3, True, "c 3x3/s1 tanh"),
    ("dis", 0, True, "c 3x3/s1 SN, vector in input space"),
    ("dis", 1, True, "c 4x4/s2 SN, vector in output space"),
    ("dis", 2, True, "c 3x3/s1 SN + flatten"),
    ("dis", 3, True, "d SN, rows permuted after the flatten"),
]


@pytest.fixture(scope="module")
def models():
    """Random float32 trees of the JAX model's shapes (from its init's
    abstract evaluation), with non-trivial BN parameters and statistics so
    train and eval mode both test something."""
    jmodel = JaxSNGan(ARCH, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[:2]
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("gamma", "moving_var"):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (0.3 * rng.randn(*leaf.shape)).astype(np.float32)

    params, state = jax.tree_util.tree_map_with_path(fill, shapes)
    model = SNGan(ARCH, compute_dtype=torch.float32, device="cpu")
    p_t, s_t = jax_params_to_torch(model, params, state)
    return jmodel, params, state, model, p_t, s_t


@pytest.mark.parametrize("case", CASES, ids=[c[3] for c in CASES])
def test_layer_matches_jax(models, case):
    net, idx, train, _ = case
    jmodel, params, state, model, p_t, s_t = models
    jlayer = (jmodel.Gen if net == "gen" else jmodel.Dis).net.layers[idx]
    layer = (model.Gen if net == "gen" else model.Dis).net.layers[idx]
    scope = jlayer.layer_scope
    rng = np.random.RandomState(idx)
    x = rng.randn(B, *jlayer.input_shape).astype(np.float32)

    jout, jstate = jlayer.apply(params[net].get(scope, {}), state[net].get(scope, {}),
                                {"x": jnp.asarray(x), "y": None}, train=train)
    jout = np.asarray(jout["x"])

    prev_flat = len(jlayer.input_shape) == 1 and idx > 0
    if x.ndim == 4:
        x_t = x.transpose(0, 3, 1, 2)
    elif prev_flat:   # JAX flattens (h, w, c); the port flattens (c, h, w)
        h, w, c = (jmodel.Dis if net == "dis" else jmodel.Gen).net.layers[idx - 1] \
            .pre_out_reshape_shape
        x_t = x.reshape(B, h, w, c).transpose(0, 3, 1, 2).reshape(B, -1)
    else:
        x_t = x
    out, new_state = layer.apply(p_t[net].get(scope, {}), s_t[net].get(scope, {}),
                                 torch.tensor(np.ascontiguousarray(x_t)), train=train)

    if jout.ndim == 4:
        jout = jout.transpose(0, 3, 1, 2)
    elif jlayer.design["out_reshape"] is not None:   # flattened here
        h, w, c = jlayer.pre_out_reshape_shape
        jout = jout.reshape(B, h, w, c).transpose(0, 3, 1, 2).reshape(B, -1)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)

    # the layer's new state (SN vector, BN statistics) through the bridge
    _, want = jax_params_to_torch(model, {}, {net: {scope: jax.device_get(jstate)}})
    want = want[net].get(scope, {})
    assert set(new_state) == set(want)
    for op_name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(new_state[op_name][k].numpy(), v.numpy(), **TOL)


def test_loss_state_bridged(models):
    """The JAX ``LossState`` comes across as the port's, beside the
    parameters, the state and the Adam slots."""
    from mmdgan_tpu.ops.losses import LossState as JaxLossState
    from mmdgan_torch.ops.losses import LossState

    _, params, state, model, _, _ = models
    jls = JaxLossState(loss_average=jnp.float32(0.25), mix_prob=jnp.float32(0.125),
                       ins_sigma=jnp.float32(0.5))
    *_, ls = jax_params_to_torch(model, params, state, loss_state=jax.device_get(jls))
    assert isinstance(ls, LossState)
    for name, want in (("loss_average", 0.25), ("mix_prob", 0.125), ("ins_sigma", 0.5)):
        v = getattr(ls, name)
        assert v.dtype == torch.float32 and v.shape == () and v.item() == want
    out = jax_params_to_torch(model, params, state)
    assert len(out) == 2
