"""The port's class-conditional models against the JAX package's: each
conditional op (cbn, c_bias, bcb, project, dcd, dck, cck, tcck) with its
per-class spectral norm, the conditional models of
``tests/test_conditional.py`` on bridged parameters, one bridged
conditional train step, the bridge's conditional parameters across a
flatten and an image reshape, the conditional CIFAR and hd families, and
same-class sampling: the host tables bitwise equal to JAX's, the device
sampler's properties, and a resumed same-class run equal to a straight
one.

Tolerances: op and model outputs, new state and sigmas rtol 1e-4 / atol
1e-5 in float32; gradients rtol 1e-4 / atol 1e-4 (float32 summation-order
noise on gradients that sum over an image and a batch). The train step
takes ``test_torch_step.py``'s: losses rtol 1e-5 / atol 1e-6, gradient
norms rtol 1e-4, state rtol 1e-4 / atol 1e-6, the score layer's bias held
to two Adam steps (it has no true gradient).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import architectures as jax_arch
from mmdgan_tpu.models.ops import ParametricOp as JaxParametricOp
from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import class_schedule as jax_class_schedule
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_tpu.train.step import same_class_tables as jax_same_class_tables
from mmdgan_torch import architectures
from mmdgan_torch.models.ops import ParametricOp
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.train.step import (
    build_device_data_step,
    build_train_step,
    class_epoch_slots,
    class_schedule,
    init_train_state,
    same_class_tables,
)
from mmdgan_torch.train.trainer import Agent
from mmdgan_torch.utils.jax_bridge import _param, _state, jax_params_to_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
C = 4           # classes
B = 8


def chw(shape):
    return (shape[2], shape[0], shape[1]) if len(shape) == 3 else tuple(shape)


def to_nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def random_tree(tree, rng, scale=0.5):
    def fill(path, a):
        name = str(path[-1].key)
        v = np.asarray(rng.randn(*np.shape(a)), np.float32) * scale
        if name == "moving_var":
            v = np.abs(v) + 0.5
        if name == "scale":
            v = 1.0 + v
        return jnp.asarray(v)
    return jax.tree_util.tree_map_with_path(fill, tree)


def bridge_op(op, tree, fn, grad=False):
    return {name: torch.tensor(np.ascontiguousarray(fn(op, name, np.asarray(a), None, None)),
                               requires_grad=grad)
            for name, a in tree.items()}


def _sn(**kw):
    return {"w_nm": "s", "act_k": 1.3, **kw}


OPS = {
    "cbn_image": ({"op": "cbn"}, (4, 4, 3)),
    "cbn_dense": ({"op": "cbn"}, (6,)),
    "c_bias_image": ({"op": "c_bias"}, (4, 4, 3)),
    "cb_dense": ({"op": "cb"}, (6,)),
    "bcb_image": ({"op": "bcb"}, (4, 4, 3)),
    "bcb_dense": ({"op": "bcb"}, (6,)),
    "project": ({"op": "project", **_sn()}, (6,)),
    "project_wide": ({"op": "project", **_sn()}, (2,)),
    "dcd": ({"op": "dcd", "out": 5, **_sn()}, (6,)),
    "dcd_rank1": ({"op": "dcd", "out": 1, **_sn()}, (6,)),
    "dck": ({"op": "dck", "out": 5, **_sn()}, (6,)),
    "dck_out_side": ({"op": "dck", "out": 3, **_sn()}, (7,)),
    "dck_rank1": ({"op": "dck", "out": 1, **_sn()}, (6,)),
    "cck": ({"op": "cck", "out": 4, "kernel": 3, "strides": 1, "dilation": 1,
             "padding": "SAME", **_sn()}, (4, 4, 3)),
    "cck_asym_same": ({"op": "cck", "out": 2, "kernel": 3, "strides": 2, "dilation": 1,
                       "padding": "SAME", **_sn()}, (6, 6, 3)),
    "tcck": ({"op": "tcck", "out": 3, "kernel": 4, "strides": 2, "dilation": 1,
              "padding": "SAME", **_sn()}, (3, 3, 4)),
    "tcck_out_side": ({"op": "tcck", "out": 1, "kernel": 4, "strides": 2, "dilation": 1,
                       "padding": "SAME", **_sn()}, (3, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_conditional_op_matches_jax(case):
    """Forward (train mode), new state, the per-class sigma and the
    gradients of a random projection of the output, labels [N, 1]."""
    design, ish = OPS[case]
    jop = JaxParametricOp(design, ish, num_class=C, compute_dtype=jnp.float32)
    op = ParametricOp(design, chw(ish), num_class=C, compute_dtype=torch.float32)
    assert op.output_shape == chw(jop.output_shape)
    rng = np.random.RandomState(sorted(OPS).index(case))
    jparams, jstate = jop.init(jax.random.PRNGKey(0))
    jparams, jstate = random_tree(jparams, rng), random_tree(jstate, rng)
    x = rng.randn(5, *ish).astype(np.float32)
    y = rng.randint(0, C, (5, 1)).astype(np.int32)
    ct = rng.randn(5, *jop.output_shape).astype(np.float32)

    def jfwd(p, xx):
        out, s = jop.apply(p, jstate, xx, train=True, label=jnp.asarray(y))
        return jnp.sum(out * ct), (out, s)

    (_, (jout, jnew)), (jgp, jgx) = jax.value_and_grad(jfwd, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    params = bridge_op(op, jparams, _param, grad=True)
    state = bridge_op(op, jstate, _state)
    xt = torch.tensor(to_nchw(x), requires_grad=True)
    out, new = op.apply(params, state, xt, train=True, label=torch.tensor(y))
    np.testing.assert_allclose(out.detach().numpy(), to_nchw(jout), **TOL)
    for name, w in bridge_op(op, jnew, _state).items():
        np.testing.assert_allclose(new[name].numpy(), w.numpy(), **TOL, err_msg=name)
    if op.sn_def is not None:
        jsigma, _ = jop._kernel_norm(jparams, jstate)
        sigma, _ = op.kernel_norm(params, state)
        assert tuple(sigma.shape) == tuple(np.shape(jsigma))
        np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma), **TOL)
    names = list(params)
    grads = torch.autograd.grad((out * torch.tensor(to_nchw(ct))).sum(),
                                [xt] + [params[n] for n in names], allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), to_nchw(jgx), **GRAD_TOL)
    want = bridge_op(op, jgp, _param)
    for n, g in zip(names, grads[1:]):
        w = want[n].numpy()
        np.testing.assert_allclose(np.zeros_like(w) if g is None else g.numpy(), w, **GRAD_TOL,
                                   err_msg=n)


def test_conditional_op_without_labels_raises():
    op = ParametricOp({"op": "cbn"}, (3, 4, 4), num_class=C, compute_dtype=torch.float32)
    params, state = op.init(torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError, match="labels must be provided"):
        op.apply(params, state, torch.zeros(2, 3, 4, 4))


COND_ARCH = {    # tests/test_conditional.py: cbn generator, projection discriminator
    "input": [(1, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "linear",
         "act_nm": None, "out_reshape": [8, 4, 4]},
        {"name": "l2", "out": 4, "op": "tc", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 1, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 3, "strides": 2, "out_reshape": [4 * 4 * 8]},
        {"name": "l2", "out": 1, "op": "d", "w_nm": "s", "type": "project"},
    ],
}

DCD_ARCH = {     # dcd trunk before an image reshape, cck, dck head
    "input": [(1, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "dcd", "act": "linear",
         "act_nm": None, "out_reshape": [8, 4, 4]},
        {"name": "l2", "out": 4, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 1, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "cck", "act": "lrelu", "act_k": 1.3,
         "w_nm": "s", "kernel": 3, "strides": 2, "out_reshape": [4 * 4 * 8]},
        {"name": "l2", "out": 4, "op": "dck", "w_nm": "s"},
    ],
}

CBN_TRUNK_ARCH = {   # cbn on a dense trunk before an image reshape, every conditional op
    "input": [(2, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "relu", "act_nm": "cbn",
         "out_reshape": [8, 4, 4]},
        {"name": "l2", "out": 4, "op": "tcck", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2, "w_nm": "s"},
        {"name": "l3", "out": 2, "act": "tanh", "bias": "bcb"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "cck", "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2, "bias": "c_bias", "out_reshape": [4 * 4 * 8]},
        {"name": "l2", "out": 6, "op": "dcd", "act": "lrelu", "w_nm": "s", "bias": "bcb"},
        {"name": "l3", "out": 1, "op": "d", "w_nm": "s", "type": "project"},
    ],
}
ARCHS = {"cond": COND_ARCH, "dcd": DCD_ARCH, "cbn_trunk": CBN_TRUNK_ARCH}


def _bridged_pair(arch, seed=0):
    """A JAX model with seeded random parameters and state, and the port's
    model holding them through ``jax_params_to_torch``."""
    jmodel = JaxSNGan(arch, num_class=C, loss_type="rep", compute_dtype=jnp.float32)
    params, state, _ = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params, state = random_tree(params, rng, 0.3), random_tree(state, rng)
    model = SNGan(arch, num_class=C, loss_type="rep", compute_dtype=torch.float32, device="cpu")
    tparams, tstate = jax_params_to_torch(model, jax.device_get(params), jax.device_get(state))
    return jmodel, params, state, model, tparams, tstate


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_conditional_model_matches_jax(arch):
    """Generation per class (code_y an int, [N] and [N, 1]) and scores of
    labelled batches (a dict, and a raw array with ``labels=``), eval and
    train mode, on bridged parameters; the scores depend on the label."""
    jmodel, params, state, model, tparams, tstate = _bridged_pair(ARCHS[arch])
    rng = np.random.RandomState(1)
    c, h, w = ARCHS[arch]["input"][0]
    z = rng.randn(6, 16).astype(np.float32)
    y = rng.randint(0, C, (6,)).astype(np.int32)
    for code_y in (2, y, y[:, None]):
        jcode = jmodel.sample_codes(jax.random.PRNGKey(0), 6, z,
                                    code_y if isinstance(code_y, int) else jnp.asarray(code_y))
        code = model.sample_codes(None, 6, z, code_y)
        np.testing.assert_array_equal(code["y"].numpy(), np.asarray(jcode["y"]))
        np.testing.assert_allclose(model.generate(tparams, tstate, code_batch=code).numpy(),
                                   np.asarray(jmodel.generate(params, state, code_batch=jcode)),
                                   **TOL)
    got = model.generate(tparams, tstate, None, labels=torch.tensor(y), clip=False,
                         code_batch={"x": z, "y": y})
    assert got.shape == (6, h, w, c)
    x = rng.randn(6, h, w, c).astype(np.float32)
    for train in (False, True):
        want = jmodel.discriminate(
            params, state, {"x": jnp.asarray(x), "y": jnp.asarray(y)[:, None]}, train=train)
        np.testing.assert_allclose(
            model.discriminate(tparams, tstate, {"x": x, "y": y[:, None]}, train=train).detach(),
            np.asarray(want), **TOL)
    s_raw = model.discriminate(tparams, tstate, x, labels=y)
    np.testing.assert_allclose(s_raw, model.discriminate(tparams, tstate, {"x": x, "y": y}))
    s0 = model.discriminate(tparams, tstate, x, labels=np.zeros(6, np.int32))
    s1 = model.discriminate(tparams, tstate, x, labels=np.ones(6, np.int32))
    assert not np.allclose(s0.numpy(), s1.numpy())


def test_generate_labels_kwarg():
    """generate(labels=...): an int with batch_size, or [N] / [N, 1]
    labels that set the batch (tests/test_conditional.py)."""
    model = SNGan(COND_ARCH, num_class=C, loss_type="hinge", compute_dtype=torch.float32,
                  device="cpu")
    params, state, _ = model.init(0)
    assert model.generate(params, state, torch.Generator().manual_seed(0), 5,
                          labels=3).shape == (5, 8, 8, 1)
    y = torch.tensor([0, 1, 2, 3])
    a = model.generate(params, state, torch.Generator().manual_seed(1), labels=y)
    b = model.generate(params, state, torch.Generator().manual_seed(1), 4, labels=y[:, None])
    assert a.shape == (4, 8, 8, 1)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    code = model.sample_codes(torch.Generator().manual_seed(2), 6, code_y=2)
    np.testing.assert_array_equal(code["y"].numpy().ravel(), [2] * 6)


def test_bridge_carries_adam_slots_and_conditional_state():
    """Two JAX steps of the cbn-trunk model (every conditional op, a cbn
    on a dense trunk before an image reshape), bridged with its Adam
    slots: every leaf arrives, and the bridged model computes JAX's
    images and scores in eval mode."""
    jmodel = JaxSNGan(CBN_TRUNK_ARCH, num_class=C, loss_type="rep", compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-3, 5e-3], optimizer="adam")
    jts = jax_init_train_state(jmodel, jax.random.PRNGKey(0), jopt_d, jopt_g)
    jstep = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    rng = np.random.RandomState(3)
    on = jnp.asarray(True)
    for _ in range(2):
        jts, _ = jstep(jts, {"x": jnp.asarray(rng.randn(B, 8, 8, 2).clip(-1, 1), jnp.float32),
                             "y": jnp.asarray(rng.randint(0, C, (B, 1)), jnp.int32)}, on, on)
    jts = jax.device_get(jts)
    model = SNGan(CBN_TRUNK_ARCH, num_class=C, loss_type="rep", compute_dtype=torch.float32,
                  device="cpu")
    params, state, (od, og) = jax_params_to_torch(model, jts.params, jts.net_state,
                                                  (jts.opt_state_dis, jts.opt_state_gen))
    assert len(tree_leaves(params)) == len(jax.tree.leaves(jts.params))
    assert len(tree_leaves(state)) == len(jax.tree.leaves(jts.net_state))
    for ost, jst in ((od, jts.opt_state_dis), (og, jts.opt_state_gen)):
        assert len(tree_leaves(ost.slots)) == 2 * len(tree_leaves(params[
            "dis" if ost is od else "gen"]))
    z = rng.randn(6, 16).astype(np.float32)
    y = rng.randint(0, C, (6, 1)).astype(np.int32)
    want = jmodel.generate(jts.params, jts.net_state, code_batch={"x": z, "y": jnp.asarray(y)})
    got = model.generate(params, state, code_batch={"x": z, "y": y})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = rng.randn(6, 8, 8, 2).astype(np.float32)
    np.testing.assert_allclose(
        model.discriminate(params, state, {"x": x, "y": y}).numpy(),
        np.asarray(jmodel.discriminate(jts.params, jts.net_state, {"x": x, "y": y})), **TOL)


STEP_ARCH = {     # a narrow conditional cifar-like model: cbn generator, cck, dck head
    "input": [(3, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 16 * 2 * 2, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [16, 2, 2]},
        {"name": "l2_up", "out": 8, "op": "tc", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2},
        {"name": "l3_up", "out": 4, "op": "tc", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2},
        {"name": "l4", "out": 3, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "act": "lrelu", "act_k": 1.3, "w_nm": "s"},
        {"name": "l2_ds", "out": 16, "op": "cck", "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 16, "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2, "out_reshape": [16 * 2 * 2]},
        {"name": "l4_s", "out": 8, "op": "dck", "act_k": 1.3, "bias": "b", "w_nm": "s"},
    ],
}


def _replayed_codes(rng_key, code_size):
    """JAX's z and code labels of a step from its state key
    (train/step.py:92-93, models/sngan.py:182-190)."""
    _, rng_step = jax.random.split(rng_key)
    rng_code, _, _ = jax.random.split(rng_step, 3)
    rng_x, rng_y = jax.random.split(rng_code)
    return (np.asarray(jax.random.normal(rng_x, (B, code_size))),
            np.asarray(jax.random.randint(rng_y, (B, 1), 0, C)))


@pytest.mark.parametrize("same_class", [False, True], ids=["drawn_labels", "same_class"])
def test_conditional_rep_step_matches_jax(same_class):
    """Two JAX rep steps from init, the state bridged, then three steps on
    each side on the same labelled data and the same z (and code labels:
    JAX's draw, or the data's under sample_same_class): losses, kernel
    means, gradient norms, parameters, SN vectors, BN statistics and Adam
    moments after each step."""
    jmodel = JaxSNGan(STEP_ARCH, num_class=C, loss_type="rep", compute_dtype=jnp.float32)
    jmodel.sample_same_class = same_class
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jts = jax_init_train_state(jmodel, jax.random.PRNGKey(0), jopt_d, jopt_g)
    jstep = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    on = jnp.asarray(True)
    rng = np.random.RandomState(1)
    data = rng.randn(5, B, 8, 8, 3).clip(-1, 1).astype(np.float32)
    labels = rng.randint(0, C, (5, B, 1)).astype(np.int32)
    for i in range(2):
        jts, _ = jstep(jts, {"x": jnp.asarray(data[i]), "y": jnp.asarray(labels[i])}, on, on)

    model = SNGan(STEP_ARCH, num_class=C, loss_type="rep", compute_dtype=torch.float32,
                  device="cpu")
    model.sample_same_class = same_class
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])

    def bridged(jts):
        jts = jax.device_get(jts)
        return jax_params_to_torch(model, jts.params, jts.net_state,
                                   (jts.opt_state_dis, jts.opt_state_gen),
                                   loss_state=jts.loss_state)

    params, net_state, (od, og), loss_state = bridged(jts)
    ts = TrainState(params=params, net_state=net_state, loss_state=loss_state,
                    opt_state_dis=od, opt_state_gen=og, step=2, rng=torch.Generator())
    step = build_train_step(model, opt_d, opt_g, device="cpu")
    for i in range(2, 5):
        z, zy = _replayed_codes(jts.rng, 16)
        jts, jm = jstep(jts, {"x": jnp.asarray(data[i]), "y": jnp.asarray(labels[i])}, on, on)
        code = {"x": z} if same_class else {"x": z, "y": zy}
        ts, m = step(ts, {"x": data[i], "y": labels[i]}, code_batch=code)
        assert set(m) == set(jm)
        for k in jm:
            tol = dict(rtol=1e-4) if k.startswith("grad_norm") else LOSS_TOL
            np.testing.assert_allclose(m[k].item(), float(jm[k]), **tol, err_msg=k)
        params, net_state, (od, og), _ = bridged(jts)
        got_b = ts.params["dis"]["dis/l4_s"]["bias"]["bias"].detach()
        want_b = params["dis"]["dis/l4_s"]["bias"]["bias"]
        assert float((got_b - want_b).abs().max()) <= 2 * 2 * opt_d.lr
        got_b.copy_(want_b)
        for name, got, want in (("params", ts.params, params),
                                ("net_state", ts.net_state, net_state),
                                ("mu_dis", ts.opt_state_dis.mu, od.mu),
                                ("nu_dis", ts.opt_state_dis.nu, od.nu),
                                ("mu_gen", ts.opt_state_gen.mu, og.mu),
                                ("nu_gen", ts.opt_state_gen.nu, og.nu)):
            got, want = tree_leaves(got), tree_leaves(want)
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **STATE_TOL,
                                           err_msg=f"{name} after step {i}")


def _family_sizes(model) -> dict:
    """{scope: {op: {leaf: numel}}} from the layers' declared shapes."""
    leaf_shapes = {
        "bn": lambda op: {"gamma": (op.input_shape[0],), "beta": (op.input_shape[0],)},
        "cbn": lambda op: {"scale": op.kernel_shape, "offset": op.kernel_shape},
        "bias": lambda op: {"bias": op.kernel_shape},
        "dck": lambda op: {"kernel": op.kernel_shape[0], "c_kernel": op.kernel_shape[1]},
    }
    out = {}
    for net in (model.Gen, model.Dis):
        for layer in net.layers:
            out[layer.layer_scope] = {
                name: {k: int(np.prod(s)) for k, s in
                       leaf_shapes.get(op.design["op"], lambda o: {"kernel": o.kernel_shape})(
                           op).items()}
                for name, op in layer.ops.items()}
    return out


FAMILIES = {
    "cifar": (functools.partial(architectures.cifar_architecture, conditional=True),
              functools.partial(jax_arch.cifar_architecture, conditional=True)),
    **{f"hd{n}": (functools.partial(architectures.hd_architecture, n, conditional=True),
                  functools.partial(jax_arch.hd_architecture, n, conditional=True))
       for n in (32, 128, 512)},
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_conditional_family_builds_like_jax(family):
    """The conditional CIFAR and hd families at full width, ten classes:
    layer names and shapes, and parameter sizes leaf by leaf, against
    ``jax.eval_shape`` of JAX's init (hd512 is never allocated)."""
    port_fn, jax_fn = FAMILIES[family]
    assert port_fn() == jax_fn()
    model = SNGan(port_fn(), num_class=10, device="cpu")
    jmodel = JaxSNGan(jax_fn(), num_class=10)
    for net, jnet in ((model.Gen, jmodel.Gen), (model.Dis, jmodel.Dis)):
        assert [la.layer_scope for la in net.layers] == [la.layer_scope for la in jnet.net.layers]
        for la, jla in zip(net.layers, jnet.net.layers):
            assert la.input_shape == chw(jla.input_shape), la.layer_scope
            assert la.output_shape == chw(jla.output_shape), la.layer_scope
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[0]
    want = {scope: {op: {k: int(np.prod(v.shape)) for k, v in leaves.items()}
                    for op, leaves in ops.items()}
            for net in jparams.values() for scope, ops in net.items()}
    assert _family_sizes(model) == want
    if family == "cifar":
        params, _, _ = model.init(0)
        assert {scope: {op: {k: v.numel() for k, v in leaves.items()}
                        for op, leaves in ops.items()}
                for net in params.values() for scope, ops in net.items()} == want


def test_same_class_tables_and_schedule_equal_jax():
    """Host tables and class schedule bitwise equal to JAX's, on an
    unbalanced label set."""
    y = np.random.RandomState(0).choice(5, size=301, p=[0.1, 0.3, 0.2, 0.25, 0.15])
    for got, want in zip(same_class_tables(y, 5), jax_same_class_tables(y[:, None], 5)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for seed in (0, 7):
        got, want = class_schedule(10, 500, seed), jax_class_schedule(10, 500, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


TINY = {
    "input": [(1, 4, 4)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 4 * 2 * 2, "op": "d", "act": "linear", "out_reshape": [4, 2, 2]},
        {"name": "l2", "out": 1, "op": "tc", "act": "tanh", "act_nm": None, "kernel": 4,
         "strides": 2, "bias": "c_bias"},
    ],
    "discriminator": [
        {"name": "l1", "out": 4, "act": "lrelu", "w_nm": "s", "kernel": 4, "strides": 2,
         "out_reshape": [4 * 2 * 2]},
        {"name": "l2", "out": 4, "op": "dck", "w_nm": "s"},
    ],
}


def _labelled_data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n, 4, 4, 1)).astype(np.uint8)
    y = rng.randint(0, C, (n, 1)).astype(np.int32)
    return x, y


def _device_fn(sampling, same_class, y, num_steps=2):
    model = SNGan(TINY, num_class=C, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    table, counts = same_class_tables(y, C) if same_class else (None, None)
    return build_device_data_step(model, opt_d, opt_g, num_steps, B, same_class=same_class,
                                  class_table=table, class_counts=counts, sampling=sampling,
                                  sampler_seed=3, device="cpu")


def test_uniform_same_class_sampler_properties():
    """Every batch is one class with its rows' labels; each class is drawn
    about 1/C of the time; the slots cover the class."""
    x, y = _labelled_data()
    for data_y in (torch.tensor(y), None):
        sample = _device_fn("uniform", True, y).sampler(torch.tensor(x), data_y)
        rng = torch.Generator().manual_seed(0)
        classes, seen = [], {c: set() for c in range(C)}
        for t in range(400):
            batch = sample(rng, torch.tensor(t))
            c = int(batch["y"][0, 0])
            assert batch["x"].shape == (B, 4, 4, 1) and batch["y"].shape == (B, 1)
            assert (batch["y"] == c).all()
            rows = [int(np.nonzero((x == r.numpy()).all(axis=(1, 2, 3)))[0][0])
                    for r in batch["x"]] if t < 40 else []
            assert all(y[r, 0] == c for r in rows)
            seen[c].update(rows)
            classes.append(c)
        freq = np.bincount(classes, minlength=C) / len(classes)
        assert np.all(np.abs(freq - 1.0 / C) < 0.08), freq
        assert all(len(s) > 3 for s in seen.values())


def test_scheduled_same_class_sampler_walks_class_epochs():
    """Under shuffled_epochs each step takes the schedule's class; a
    class-epoch's batches are distinct rows of that class (without
    replacement) and every epoch's permutation is a pure function of
    (seed, class, class-epoch)."""
    x, y = _labelled_data(n=200)
    table, counts = same_class_tables(y, C)
    sched = class_schedule(C, 64, 3)
    sample = _device_fn("shuffled_epochs", True, y).sampler(torch.tensor(x), torch.tensor(y))
    used = {}
    for t in range(64):
        c, k = sched[t]
        batch = sample(None, torch.tensor(t), torch.tensor(sched[t]))
        assert (batch["y"] == int(c)).all()
        dpe = counts[c] // B
        rows = [int(np.nonzero((x == r.numpy()).all(axis=(1, 2, 3)))[0][0]) for r in batch["x"]]
        epoch_rows = used.setdefault((int(c), int(k) // dpe), set())
        assert len(set(rows)) == B and not epoch_rows & set(rows)
        epoch_rows.update(rows)
    for c in range(C):
        a = class_epoch_slots(3, torch.tensor(c), torch.tensor(1), torch.tensor(int(counts[c])),
                              table.shape[1])
        b = class_epoch_slots(3, torch.tensor(c), torch.tensor(1), torch.tensor(int(counts[c])),
                              table.shape[1])
        assert torch.equal(a, b)
        assert sorted(a[:counts[c]].tolist()) == list(range(counts[c]))
        other = class_epoch_slots(3, torch.tensor(c), torch.tensor(2),
                                  torch.tensor(int(counts[c])), table.shape[1])
        assert not torch.equal(a[:counts[c]], other[:counts[c]])


@pytest.mark.parametrize("sampling", ["uniform", "shuffled_epochs"])
def test_labelled_sampler_takes_the_rows_labels(sampling):
    x, y = _labelled_data()
    sample = _device_fn(sampling, False, y).sampler(torch.tensor(x), torch.tensor(y))
    batch = sample(torch.Generator().manual_seed(0), torch.tensor(3))
    for xr, yr in zip(batch["x"].numpy(), batch["y"].numpy()):
        r = np.nonzero((x == xr).all(axis=(1, 2, 3)))[0]
        assert yr[0] in y[r, 0]


def test_same_class_needs_tables_and_enough_rows():
    x, y = _labelled_data()
    model = SNGan(TINY, num_class=C, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    with pytest.raises(ValueError, match="same_class_tables"):
        build_device_data_step(model, opt_d, opt_g, 2, B, same_class=True, device="cpu")
    table, counts = same_class_tables(y, C)
    with pytest.raises(ValueError, match="batch_size rows"):
        build_device_data_step(model, opt_d, opt_g, 2, 64, same_class=True, class_table=table,
                               class_counts=counts, sampling="shuffled_epochs", device="cpu")


def _same_class_runs(tmp_path, sampling):
    x, y = _labelled_data()
    data = {"x": x, "y": y}

    def run(name, steps, load=False, save=True):
        model = SNGan(TINY, num_class=C, compute_dtype=torch.float32, device="cpu")
        model.sample_same_class = True
        opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
        ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
        agent = Agent(name, "t", output_dir=str(tmp_path), load_ckpt=load, do_save=save,
                      print_loss=False, use_tensorboard=False, query_step=100)
        return agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=steps,
                                       step_per_epoch=12, batch_size=B, steps_per_call=2,
                                       sample_same_class=True, sampling=sampling, seed=1,
                                       sampling_seed=0)

    return run


def test_same_class_agent_resume_equals_straight(tmp_path):
    """``Agent.train_device_data(sample_same_class=True,
    sampling='shuffled_epochs')``: 6 steps straight against 3 + checkpoint
    + restore by a new Agent + 3, bitwise (a K=2 window and a remainder
    step on each side): the class schedule and the class-epoch
    permutations are regenerated from the step the resumed run starts at."""
    run = _same_class_runs(tmp_path, "shuffled_epochs")
    straight = run("straight", 6, save=False)
    run("halves", 3)
    resumed = run("halves", 3, load=True, save=False)
    assert int(resumed.step) == int(straight.step) == 6
    for a, b in zip(straight.tensors(), resumed.tensors()):
        assert torch.equal(a, b)


def test_same_class_agent_uniform_runs(tmp_path):
    """Uniform same-class sampling through the Agent: the run ends at its
    step with finite state (its indices come from a generator seeded per
    call, as JAX's key, so a resume is not a replay)."""
    ts = _same_class_runs(tmp_path, "uniform")("uniform", 5, save=False)
    assert int(ts.step) == 5
    assert all(torch.isfinite(t.float()).all() for t in ts.tensors())


def test_cifar_cli_conditional_on_device_dataset(tmp_path):
    """``--num-class 4 --sample-same-class --device-dataset --sampling
    shuffled_epochs`` over a labelled tfrecord on the CPU: the conditional
    CIFAR model trains from the device-resident labelled dataset."""
    from mmdgan_torch.data.tfrecord import np_to_tfrecords
    from mmdgan_torch.experiments.cifar import main as cifar_main

    rng = np.random.RandomState(0)
    np_to_tfrecords(rng.randint(0, 256, (64, 3, 32, 32), np.uint8), rng.randint(0, C, 64),
                    str(tmp_path / "cifar"))
    cifar_main(["--device", "cpu", "--out-dir", str(tmp_path), "--data-dir", str(tmp_path),
                "--num-class", str(C), "--sample-same-class", "--device-dataset",
                "--sampling", "shuffled_epochs", "--debug-mode", "true", "--debug-step", "2",
                "--batch-size", "8", "--chunks", "1", "--skip-metrics", "--skip-sampling",
                "--compute-dtype", "float32", "--steps-per-call", "2"])
    ckpts = os.listdir(tmp_path / "cifar_ckpt" / os.listdir(tmp_path / "cifar_ckpt")[0])
    assert any(f.startswith("ckpt-2") for f in ckpts)


def test_conditional_hd_family_trains():
    """``hd_architecture(16, conditional=True)`` trains: two float32 rep
    steps on labelled batches, finite losses, the cbn and dck parameters
    moved."""
    model = SNGan(architectures.hd_architecture(16, conditional=True), num_class=C,
                  compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    before = {k: v.clone() for k, v in ts.params["gen"]["gen/l2_up"]["BN"].items()}
    step = build_train_step(model, opt_d, opt_g, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(2):
        ts, m = step(ts, {"x": rng.randn(4, 16, 16, 3).clip(-1, 1).astype(np.float32),
                          "y": rng.randint(0, C, (4, 1))})
    assert np.isfinite(m["loss_gen"].item()) and np.isfinite(m["loss_dis"].item())
    assert all(not torch.equal(v, ts.params["gen"]["gen/l2_up"]["BN"][k])
               for k, v in before.items())
    assert set(ts.params["gen"]["gen/l2_up"]["BN"]) == {"scale", "offset"}
