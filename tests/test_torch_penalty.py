"""The port's gradient penalties and Jacobian scale against the JAX
package's, on a narrow float32 discriminator bridged from JAX
(``tests/test_torch_bridge.py``'s layer kinds: 3x3 and 4x4 stride-2 SN
convs, a flatten, an SN dense score layer).

For ``gradient_penalty`` (wasserstein), ``mmd_gradient_penalty`` (rep_gp,
rmb_gp, and the fixed_g_gp / fixed_t_gp witnesses the JAX model computes
before its dispatcher rejects the names) and ``mmd_gradient_scale``, with
the same images and interpolation weights ``uni``: the value, and its
gradient with respect to every discriminator parameter (and, for the
witness penalties, to the two score matrices) against ``jax.grad`` of the
JAX function. That gradient is second order: it differentiates an input
gradient (a Jacobian for the scale) through the spectral norm, the convs
and the lrelu.

Tolerances: values rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-5 of
the largest entry of the tensor, for entries that cancel to ~0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_torch.models.sngan import SNGan, jacobian_squared_frobenius_norm
from mmdgan_torch.train.state import tree_leaves
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)

B, IMG, D = 8, 8, 16
ARCH = {
    "input": [(3, IMG, IMG)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [8, 4, 4]},
        {"name": "l2_up", "out": 3, "op": "tc", "act": "tanh", "kernel": 4, "strides": 2},
    ],
    "discriminator": [
        {"name": "l1", "out": 4, "act": "lrelu", "act_k": 1.5, "w_nm": "s"},
        {"name": "l2_ds", "out": 8, "act": "lrelu", "act_k": 1.5, "w_nm": "s",
         "kernel": 4, "strides": 2},
        {"name": "l3_ds", "out": 8, "op": "c", "act": "lrelu", "act_k": 1.5, "w_nm": "s",
         "kernel": 4, "strides": 2, "out_reshape": [2 * 2 * 8]},
        {"name": "l4_s", "out": D, "op": "d", "act_k": 1.5, "bias": "b", "w_nm": "s"},
    ],
}
VAL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def setup():
    """Both models, random D parameters and normalized SN vectors (in JAX
    layout and bridged), images, generated images, scores and ``uni``."""
    jmodel = JaxSNGan(ARCH, compute_dtype=jnp.float32)
    params, state, _ = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        name = path[-1].key
        a = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "sn_x":
            return a / np.linalg.norm(a)
        return 0.3 * a

    params = jax.tree_util.tree_map_with_path(fill, jax.device_get(params))
    state = jax.tree_util.tree_map_with_path(fill, jax.device_get(state))
    model = SNGan(ARCH, compute_dtype=torch.float32, device="cpu")
    p_t, s_t = jax_params_to_torch(model, params, state)
    x = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    x_gen = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    s_x = (0.5 * rng.randn(B, D)).astype(np.float32)
    s_gen = (0.5 * rng.randn(B, D)).astype(np.float32)
    uni = rng.uniform(0, 1, (B, 1, 1, 1)).astype(np.float32)
    return jmodel, params, state, model, p_t, s_t, x, x_gen, s_x, s_gen, uni


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _penalties(kind):
    """(JAX fn(params_d, s_x, s_gen), port fn(params_d, s_x, s_gen)) with
    everything else bound."""
    def jax_fn(jmodel, state, x, x_gen, uni):
        if kind == "wasserstein":
            return lambda p, sx, sg: jmodel.gradient_penalty(
                p, state, None, jnp.asarray(x), jnp.asarray(x_gen), uni=jnp.asarray(uni))
        if kind == "scale":
            return lambda p, sx, sg: jmodel.mmd_gradient_scale(p, state, jnp.asarray(x))
        return lambda p, sx, sg: jmodel.mmd_gradient_penalty(
            p, state, None, jnp.asarray(x), jnp.asarray(x_gen), sx, sg, mode=kind,
            uni=jnp.asarray(uni))

    def port_fn(model, state, x, x_gen, uni):
        if kind == "wasserstein":
            return lambda p, sx, sg: model.gradient_penalty(
                p, state, _nchw(x), _nchw(x_gen), uni=torch.tensor(uni))
        if kind == "scale":
            return lambda p, sx, sg: model.mmd_gradient_scale(p, state, _nchw(x))
        return lambda p, sx, sg: model.mmd_gradient_penalty(
            p, state, _nchw(x), _nchw(x_gen), sx, sg, mode=kind, uni=torch.tensor(uni))

    return jax_fn, port_fn


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("kind", ["wasserstein", "rep_gp", "rmb_gp", "fixed_g_gp",
                                  "fixed_t_gp", "scale"])
def test_penalty_and_its_second_order_gradient_match_jax(setup, kind):
    jmodel, params, state, model, p_t, s_t, x, x_gen, s_x, s_gen, uni = setup
    jax_fn, port_fn = _penalties(kind)
    jf = jax_fn(jmodel, state, x, x_gen, uni)
    want, (g_params, g_sx, g_sgen) = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        params["dis"], jnp.asarray(s_x), jnp.asarray(s_gen))

    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(p_t["dis"])]
    it = iter(leaves)
    params_d = {scope: {op: {name: next(it) for name in sorted(ops[op])}
                        for op in sorted(ops)} for scope, ops in sorted(p_t["dis"].items())}
    sx, sg = torch.tensor(s_x, requires_grad=True), torch.tensor(s_gen, requires_grad=True)
    got = port_fn(model, s_t, x, x_gen, uni)(params_d, sx, sg)
    np.testing.assert_allclose(got.item(), float(want), **VAL)

    grads = torch.autograd.grad(got, leaves + [sx, sg], allow_unused=True)
    want_params, _ = jax_params_to_torch(model, {"dis": jax.device_get(g_params)}, {})
    assert len(tree_leaves(want_params["dis"])) == len(leaves)
    for i, (g, w) in enumerate(zip(grads, tree_leaves(want_params["dis"]))):
        # the score layer's bias does not reach an input gradient: no path
        # in torch, a zero gradient in JAX
        g = torch.zeros_like(w) if g is None else g
        _close(g.numpy(), w.numpy(), f"{kind}: d/d parameter {i}")
    if kind in ("wasserstein", "scale"):
        assert grads[-2] is None and grads[-1] is None
    else:
        _close(grads[-2].numpy(), g_sx, f"{kind}: d/d s_x")
        _close(grads[-1].numpy(), g_sgen, f"{kind}: d/d s_gen")


def test_jacobian_norm_matches_autograd_jacobian():
    """sum_j ||d y_j / d x||^2 per sample equals the squared Frobenius norm
    of each sample's full Jacobian (``torch.autograd.functional``)."""
    torch.manual_seed(0)
    w = torch.randn(12, 5)
    fwd = lambda x: torch.tanh(x.reshape(x.shape[0], -1) @ w)
    x = torch.randn(3, 2, 2, 3)
    got = jacobian_squared_frobenius_norm(fwd, x)
    for n in range(3):
        jac = torch.autograd.functional.jacobian(lambda v: fwd(v[None])[0], x[n])
        torch.testing.assert_close(got[n], (jac ** 2).sum(), rtol=1e-6, atol=1e-7)


def test_discriminate_matches_jax(setup):
    """``discriminate`` scores an NHWC batch (dict or array, float or
    uint8) in eval mode, as JAX's does."""
    jmodel, params, state, model, p_t, s_t, x, *_ = setup
    want = np.asarray(jmodel.discriminate(params, state, jnp.asarray(x)))
    for batch in (x, {"x": x}):
        got = model.discriminate(p_t, s_t, batch)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    u8 = np.random.RandomState(1).randint(0, 256, x.shape).astype(np.uint8)
    np.testing.assert_allclose(model.discriminate(p_t, s_t, u8).detach().numpy(),
                               np.asarray(jmodel.discriminate(params, state, jnp.asarray(u8))),
                               rtol=1e-5, atol=1e-6)
