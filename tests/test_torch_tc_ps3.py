"""The transposed conv's periodic-shuffle (ps3) lowering and its gate in the
port (``mmdgan_torch/ops/conv.py`` ``conv_transpose_ps3``,
``mmdgan_torch/models/ops.py`` ``TC_PS3_MIN_SIZE``) against the JAX
package's ``ParametricOp._conv_t_ps3`` and ``TC_PS3_MIN_SIZE``
(``mmdgan_tpu/models/ops.py:50-63,368-414``).

The kernel crosses over through the bridge's ``tc`` mapping (HWIO to
``[in, out, k, k]``, spatially flipped), and its gradient back through the
inverse map. Tolerances are JAX's own for the lowering
(``tests/test_network.py:245-275``): 2e-5 on the forward, 2e-4 on the
(x, w) VJP. The lowering is held to JAX's in float64 on both sides
(``jax.enable_x64``): the kernel gradient sums 32,768
products, and in float32 the CPU's convolutions round it by up to 1.2e-3
(torch, either route) and 1.3e-3 (JAX's direct route) against float64, so
there the tolerance would measure float32 accumulation, not the taps and
the channel order. The gate tests run float32. The gate is flipped by
monkeypatching both packages' module constant before anything is built;
nothing of the JAX package is edited.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from experiments import architectures as jax_arch
from mmdgan_tpu.models import ops as jax_ops
from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch import architectures
from mmdgan_torch.models import ops
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops.conv import Geometry, conv_transpose_ps3
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.train.step import build_train_step
from mmdgan_torch.utils.jax_bridge import _conv_t as bridge_tc_kernel
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
VJP_TOL = dict(rtol=2e-4, atol=2e-4)


def _hwio_grad(g: torch.Tensor) -> np.ndarray:
    """The gradient of a port ``tc`` kernel as the gradient of JAX's HWIO
    kernel: the bridge's map is a permutation, so its inverse."""
    return g.detach().flip(2, 3).permute(2, 3, 0, 1).numpy()


@pytest.mark.parametrize("h,cin,cout", [(64, 64, 32), (64, 8, 3)])
def test_ps3_matches_jax_and_the_direct_route(h, cin, cout):
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, h, cin)
    w = rng.randn(4, 4, cin, cout) * 0.1
    ct = rng.randn(2, 2 * h, 2 * h, cout)

    with jax.enable_x64(True):
        want, vjp = jax.vjp(jax_ops.ParametricOp._conv_t_ps3, jnp.asarray(x), jnp.asarray(w))
        gx_want, gw_want = vjp(jnp.asarray(ct))
        assert want.dtype == gw_want.dtype == jnp.float64

    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    wt = torch.tensor(np.ascontiguousarray(bridge_tc_kernel(w))).requires_grad_(True)
    ctt = torch.tensor(ct).permute(0, 3, 1, 2)
    geo = Geometry.make("tc", (h, h), 4, 2, 1, "SAME")
    for route in (conv_transpose_ps3, geo.forward):
        got = route(xt, wt)
        assert got.shape == (2, cout, 2 * h, 2 * h)
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   **FWD_TOL, err_msg=route.__name__)
        gx, gw = torch.autograd.grad(got, (xt, wt), ctt)
        np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), np.asarray(gx_want), **VJP_TOL)
        np.testing.assert_allclose(_hwio_grad(gw), np.asarray(gw_want), **VJP_TOL)
    # and against torch's own transposed conv, which the direct route is
    direct = F.conv_transpose2d(xt, wt, stride=2, padding=1)
    np.testing.assert_allclose(conv_transpose_ps3(xt, wt).detach().numpy(),
                               direct.detach().numpy(), **FWD_TOL)


def _tc_design(w_nm):
    return {"op": "tc", "out": 32, "kernel": 4, "strides": 2, "dilation": 1, "padding": "SAME",
            "w_nm": w_nm, "act_k": 1.5}


def test_default_gate_is_inf_and_routes_directly():
    assert ops.TC_PS3_MIN_SIZE == float("inf") == jax_ops.TC_PS3_MIN_SIZE
    op = ops.ParametricOp(_tc_design(None), (16, 256, 256), compute_dtype=torch.float32)
    assert not op.tc_ps3


@pytest.mark.parametrize("w_nm", [None, "s"])
def test_gate_at_64_routes_tc_through_ps3(monkeypatch, w_nm):
    """With both gates at 64 before the ops are built, the port's ``tc``
    runs ``conv_transpose_ps3`` and equals its direct route (an op built at
    the default gate) and JAX's op at its gate of 64; a gate flipped after
    an op is built does not change its route. With spectral norm, the new
    power vector and so the multiplier come from the direct operator on
    both routes."""
    direct_op = ops.ParametricOp(_tc_design(w_nm), (16, 64, 64), compute_dtype=torch.float32)
    monkeypatch.setattr(ops, "TC_PS3_MIN_SIZE", 64)
    monkeypatch.setattr(jax_ops, "TC_PS3_MIN_SIZE", 64)
    assert not direct_op.tc_ps3
    op = ops.ParametricOp(_tc_design(w_nm), (16, 64, 64), compute_dtype=torch.float32)
    assert op.tc_ps3
    assert not ops.ParametricOp(_tc_design(w_nm), (16, 32, 32)).tc_ps3
    calls = []

    def counted(x, w):
        calls.append(tuple(x.shape))
        return conv_transpose_ps3(x, w)

    monkeypatch.setattr(ops, "conv_transpose_ps3", counted)

    jop = jax_ops.ParametricOp(_tc_design(w_nm), (64, 64, 16), compute_dtype=jnp.float32)
    jparams, jstate = jop.init(jax.random.PRNGKey(0))
    jparams, jstate = jax.device_get((jparams, jstate))
    x = np.random.RandomState(1).randn(2, 64, 64, 16).astype(np.float32)
    want, _ = jop.apply(jparams, jstate, jnp.asarray(x), train=True)

    params = {"kernel": torch.tensor(np.ascontiguousarray(bridge_tc_kernel(jparams["kernel"])))}
    state = ({} if w_nm is None else
             {"sn_x": torch.tensor(np.asarray(jstate["sn_x"])).permute(0, 3, 1, 2).contiguous()})
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous()
    got, new_state = op.apply(params, state, xt)
    assert calls == [(2, 16, 64, 64)]
    ref, ref_state = direct_op.apply(params, state, xt)
    assert calls == [(2, 16, 64, 64)]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **FWD_TOL)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **FWD_TOL)
    for key in new_state:
        assert torch.equal(new_state[key], ref_state[key])


def _narrow(arch: dict, div: int) -> dict:
    """``arch`` at 1/div of every hidden width (``test_torch_families.py``)."""
    arch = copy.deepcopy(arch)
    for net in ("generator", "discriminator"):
        for layer in arch[net][:-1]:
            reshape = layer.get("out_reshape")
            if net == "generator" and reshape is not None:
                c, h, w = reshape
                layer.update(out=c // div * h * w, out_reshape=[c // div, h, w])
            else:
                layer["out"] //= div
                if reshape is not None:
                    layer["out_reshape"] = [reshape[0] // div]
    return arch


def _replayed_z(rng_key, code_size, batch):
    """The z of JAX's step from its key (``test_torch_step.py``)."""
    _, rng_step = jax.random.split(rng_key)
    rng_code, _, _ = jax.random.split(rng_step, 3)
    rng_x, _ = jax.random.split(rng_code)
    return np.asarray(jax.random.normal(rng_x, (batch, code_size)))


def test_narrow_hd128_step_with_gate_at_64_matches_jax(monkeypatch):
    """hd128 at 1/16 of its widths, float32, both gates at 64: the last
    transposed conv (64x64 -> 128x128) takes ps3 on both sides. After one
    JAX step from init (step 0 is degenerate) the state is bridged and
    each side takes one more step on the same data and z: the losses
    (rtol 1e-5), both nets' parameters and the generator's BN statistics
    (rtol 1e-4) agree. An Adam step moves an element by about lr whatever
    its gradient's size, so where a gradient element nearly cancels (a
    bias of D's last conv) float32 rounding moves it by up to a percent of
    lr: parameters take atol 2% of their net's lr, the BN statistics 1e-6.
    The score layer's bias, whose true gradient is 0, is left out
    (``test_torch_step.py``)."""
    monkeypatch.setattr(ops, "TC_PS3_MIN_SIZE", 64)
    monkeypatch.setattr(jax_ops, "TC_PS3_MIN_SIZE", 64)
    b = 4
    arch = _narrow(architectures.hd_architecture(128), 16)
    assert arch == _narrow(jax_arch.hd_architecture(128), 16)
    jmodel = JaxSNGan(arch, compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jts = jax.jit(lambda k: jax_init_train_state(jmodel, k, jopt_d, jopt_g))(jax.random.PRNGKey(0))
    jstep = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    on = jnp.asarray(True)
    data = np.random.RandomState(1).uniform(-1, 1, (2, b, 128, 128, 3)).astype(np.float32)
    jts, _ = jstep(jts, {"x": jnp.asarray(data[0]), "y": None}, on, on)

    model = SNGan(arch, compute_dtype=torch.float32, device="cpu")
    tcs = [op for layer in model.Gen.net.layers for op in layer.ops.values()
           if op.design["op"] == "tc"]
    assert [op.tc_ps3 for op in tcs] == [False] * (len(tcs) - 1) + [True]
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    host = jax.device_get(jts)
    params, net_state, (od, og) = jax_params_to_torch(
        model, host.params, host.net_state, (host.opt_state_dis, host.opt_state_gen))
    *_, loss_state = jax_params_to_torch(model, {}, {}, loss_state=host.loss_state)
    ts = TrainState(params=params, net_state=net_state, loss_state=loss_state,
                    opt_state_dis=od, opt_state_gen=og, step=1, rng=torch.Generator())
    step = build_train_step(model, opt_d, opt_g, device="cpu")

    z = _replayed_z(jts.rng, model.code_size, b)
    jts, jm = jstep(jts, {"x": jnp.asarray(data[1]), "y": None}, on, on)
    ts, m = step(ts, {"x": data[1]}, code_batch={"x": z})
    for key in ("loss_gen", "loss_dis"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    want_params, want_state, _ = jax_params_to_torch(
        model, jax.device_get(jts.params), jax.device_get(jts.net_state),
        (jax.device_get(jts.opt_state_dis), jax.device_get(jts.opt_state_gen)))
    score = f"dis/{arch['discriminator'][-1]['name']}"
    del ts.params["dis"][score]["bias"], want_params["dis"][score]["bias"]
    for net, lr in (("gen", opt_g.lr), ("dis", opt_d.lr)):
        got, want = tree_leaves(ts.params[net]), tree_leaves(want_params[net])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-4, atol=0.02 * lr,
                                       err_msg=f"{net} params")
    for g, w in zip(tree_leaves(ts.net_state["gen"]), tree_leaves(want_state["gen"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg="gen state")
