"""The architecture families of the port (``mmdgan_torch/architectures.py``)
against the JAX package's (``experiments/architectures.py``): STL-10,
CelebA, LSUN and the hd family.

- Every family builds with JAX's layer names and per-layer shapes, and
  its parameter count equals JAX's leaf by leaf. The JAX side is shaped
  with ``jax.eval_shape`` of its init and the port's from its layers'
  declared shapes, so hd512 is never allocated; the declared shapes are
  checked against an allocated init on the small families.
- Bridged float32 forwards of G and D, train and eval mode, against JAX
  at rtol 1e-5 / atol 1e-5 on width-reduced variants that keep each
  topology (STL's dense-BN trunk on 6x6, CelebA's 10-layer D) and on
  hd16 / hd32 as they are, with random parameters and non-trivial BN
  statistics (``test_torch_bridge.py``'s fill). The atol is the float32
  drift of 5-10 layers summed in another order, which train-mode BN over
  8 samples magnifies, on outputs of order 0.1-1.
- The bridge's BN permutation: a dense layer with BN before an image
  reshape (STL's ``gen/l1``) after two JAX train steps.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import architectures as jax_arch
from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch import architectures
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.state import tree_leaves
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
B = 8

FAMILIES = {
    "stl": (architectures.stl_architecture, jax_arch.stl_architecture),
    "celeba": (architectures.celeba_architecture, jax_arch.celeba_architecture),
    "lsun": (architectures.lsun_architecture, jax_arch.lsun_architecture),
    **{f"hd{n}": (functools.partial(architectures.hd_architecture, n),
                  functools.partial(jax_arch.hd_architecture, n))
       for n in (16, 32, 128, 256, 512)},
}


def _chw(shape):
    return (shape[2], shape[0], shape[1]) if len(shape) == 3 else tuple(shape)


def _port_param_sizes(model: SNGan) -> dict:
    """{scope: {op: {leaf: numel}}} from the layers' declared shapes."""
    out = {}
    for net in (model.Gen, model.Dis):
        for layer in net.net.layers:
            ops = {}
            for name, op in layer.ops.items():
                if op.design["op"] == "bn":
                    c = op.input_shape[0]
                    ops[name] = {"gamma": c, "beta": c}
                else:
                    ops[name] = {"kernel" if name == "kernel" else "bias":
                                 int(np.prod(op.kernel_shape))}
            out[layer.layer_scope] = ops
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_builds_like_jax(family):
    port_fn, jax_fn = FAMILIES[family]
    assert port_fn() == jax_fn()
    model = SNGan(port_fn(), device="cpu")
    jmodel = JaxSNGan(jax_fn())
    for net, jnet in ((model.Gen, jmodel.Gen), (model.Dis, jmodel.Dis)):
        layers, jlayers = net.net.layers, jnet.net.layers
        assert [la.layer_scope for la in layers] == [la.layer_scope for la in jlayers]
        for la, jla in zip(layers, jlayers):
            assert la.input_shape == _chw(jla.input_shape), la.layer_scope
            assert la.output_shape == _chw(jla.output_shape), la.layer_scope
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[0]
    want = {scope: {op: {k: int(np.prod(v.shape)) for k, v in leaves.items()}
                    for op, leaves in ops.items()}
            for net in jparams.values() for scope, ops in net.items()}
    got = _port_param_sizes(model)
    assert got == want
    if family in ("hd16", "hd32"):   # the declared shapes are those init allocates
        params, _, _ = model.init(0)
        allocated = {scope: {op: {k: v.numel() for k, v in leaves.items()}
                             for op, leaves in ops.items()}
                     for net in params.values() for scope, ops in net.items()}
        assert allocated == got


def test_hd_total_parameters_and_refusals():
    """hd512 holds JAX's 58,302,803 parameters; the conditional variant
    builds with JAX's parameter count (cbn generator, dck head over 10
    classes); a size that is not a power of two raises."""
    model = SNGan(architectures.hd_architecture(512), device="cpu")
    total = sum(n for ops in _port_param_sizes(model).values()
                for leaves in ops.values() for n in leaves.values())
    jparams = jax.eval_shape(JaxSNGan(jax_arch.hd_architecture(512)).init,
                             jax.random.PRNGKey(0))[0]
    assert total == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams)) == 58302803
    arch = architectures.hd_architecture(64, conditional=True)
    assert arch == jax_arch.hd_architecture(64, conditional=True)
    cond = SNGan(arch, num_class=10, device="cpu")
    jcond = jax.eval_shape(JaxSNGan(arch, num_class=10).init, jax.random.PRNGKey(0))[0]
    params, _, _ = cond.init(0)
    assert (sum(t.numel() for t in tree_leaves(params))
            == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jcond)))
    with pytest.raises(ValueError, match="power of two"):
        architectures.hd_architecture(48)


def _narrow(arch: dict, div: int) -> dict:
    """``arch`` at 1/div of every hidden width (the image channels, the
    score size and the reshapes follow)."""
    arch = copy.deepcopy(arch)
    for net in ("generator", "discriminator"):
        for layer in arch[net][:-1]:
            reshape = layer.get("out_reshape")
            if net == "generator" and reshape is not None:   # the dense trunk
                c, h, w = reshape
                layer.update(out=c // div * h * w, out_reshape=[c // div, h, w])
            else:
                layer["out"] //= div
                if reshape is not None:   # D's flatten
                    layer["out_reshape"] = [reshape[0] // div]
    return arch


NARROW = {
    "stl": _narrow(architectures.stl_architecture(), 8),
    "celeba": _narrow(architectures.celeba_architecture(), 16),
    "hd16": architectures.hd_architecture(16),
    "hd32": architectures.hd_architecture(32),
}


def _fill(shapes, seed=0):
    """Random float32 trees of the given shapes, BN gamma and moving
    variance in [0.5, 2] (``test_torch_bridge.py``)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("gamma", "moving_var"):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (0.3 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("family", sorted(NARROW))
def test_narrow_forward_matches_jax(family, train):
    arch = NARROW[family]
    jmodel = JaxSNGan(arch, compute_dtype=jnp.float32)
    params, state = _fill(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[:2])
    model = SNGan(arch, compute_dtype=torch.float32, device="cpu")
    p_t, s_t = jax_params_to_torch(model, params, state)
    rng = np.random.RandomState(1)
    z = rng.randn(B, model.code_size).astype(np.float32)
    c, h, w = arch["input"][0]
    x = rng.uniform(-1, 1, (B, h, w, c)).astype(np.float32)

    jg, jg_state = jmodel.Gen.apply(params["gen"], state["gen"], {"x": jnp.asarray(z), "y": None},
                                    train=train)
    g, g_state = model.Gen.apply(p_t["gen"], s_t["gen"], torch.tensor(z), train=train)
    np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(jg["x"]), **TOL)
    jd, jd_state = jmodel.Dis.apply(params["dis"], state["dis"], {"x": jnp.asarray(x), "y": None},
                                    train=train)
    d, d_state = model.Dis.apply(p_t["dis"], s_t["dis"], torch.tensor(x).permute(0, 3, 1, 2),
                                 train=train)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd["x"]), **TOL)
    # the new SN vectors and BN statistics, through the bridge
    _, want = jax_params_to_torch(model, {}, jax.device_get({"gen": jg_state, "dis": jd_state}))
    for got_t, want_t in zip(tree_leaves({"gen": g_state, "dis": d_state}), tree_leaves(want)):
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), **TOL)


def test_bridge_permutes_bn_before_an_image_reshape():
    """STL's generator trunk is a dense layer with BN on its flat features,
    reshaped to an image after the activation; the JAX package orders
    those features (h, w, c), the port (c, h, w). After two JAX train steps
    (gamma, beta and the moving statistics no longer their init values of
    1, 0, 0, 1) the bridged generator gives JAX's images in train mode
    (batch statistics, gamma and beta) and in eval mode (the moving
    statistics)."""
    arch = NARROW["stl"]
    jmodel = JaxSNGan(arch, compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-3, 5e-3], optimizer="adam")
    jts = jax.jit(lambda key: jax_init_train_state(jmodel, key, jopt_d, jopt_g))(
        jax.random.PRNGKey(0))
    step = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    on = jnp.asarray(True)
    data = np.random.RandomState(2).uniform(-1, 1, (2, B, 48, 48, 3)).astype(np.float32)
    for i in range(2):
        jts, _ = step(jts, {"x": jnp.asarray(data[i]), "y": None}, on, on)
    jts = jax.device_get(jts)
    bn = jts.params["gen"]["gen/l1"]["BN"]
    assert np.abs(bn["gamma"] - 1).max() > 1e-3 and np.abs(bn["beta"]).max() > 1e-3

    model = SNGan(arch, compute_dtype=torch.float32, device="cpu")
    p_t, s_t = jax_params_to_torch(model, jts.params, jts.net_state)
    z = np.random.RandomState(3).randn(B, model.code_size).astype(np.float32)
    for train in (True, False):
        jg, _ = jmodel.Gen.apply(jts.params["gen"], jts.net_state["gen"],
                                 {"x": jnp.asarray(z), "y": None}, train=train)
        g, _ = model.Gen.apply(p_t["gen"], s_t["gen"], torch.tensor(z), train=train)
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jg["x"]),
                                   **TOL, err_msg="train" if train else "eval")
