"""The port's loss dispatcher against the JAX package's, every name under
every alias, on the same numpy scores (float32).

Each case compares loss_gen, loss_dis, every aux key, the new LossState and
the gradients of ``loss_gen + 0.5 loss_dis`` with respect to both score
matrices. Draws are injected: omega is pinned through a scalar
``omega_range`` (as ``tests/test_loss_golden.py`` pins it), and the coin's
uniforms and the instance-noise normals are JAX's own, made from the key
as the JAX dispatcher splits it and passed through ``draws``. The loss
state is a non-trivial one, so that the coin mixes and the noise is on.

Tolerances: aux values rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 /
atol 1e-7 (those of ``tests/test_pallas_mmd.py``; the gradient atol covers
entries that cancel to ~0). The losses take atol 5e-6: they sum up to 15
kernel means (five sigmas or alphas, three means each), and JAX's float32
sums of the B(B-1) = 506 kernel values of a mean at B=23 are off float64's
by up to 2.8e-7 each (the port's by 5e-8). Histogram counts must be equal. The repulsive family
runs with ``use_fused_kernel`` on and off; on the CPU, on runs the kernels'
plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.ops.losses import GANLoss as JaxGANLoss
from mmdgan_tpu.ops.losses import LossState as JaxLossState
from mmdgan_tpu.ops.losses import gan_loss as jax_gan_loss
from mmdgan_torch.ops.losses import (
    LOSS_TYPES,
    REPULSIVE,
    REPULSIVE_BOUNDED,
    GANLoss,
    LossState,
    fixed_bin_histogram,
    gan_loss,
)

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=5e-6)
GRAD = dict(rtol=1e-4, atol=1e-7)
# tests/test_losses.py:13-19, and the aliases the dispatcher takes
ALL_LOSSES = [
    "logistic", "hinge", "wasserstein",
    "mmd_g", "fixed_g", "mgb", "mmd_t", "fixed_t", "cramer",
    "mmd_g_mix", "fixed_g_mix", "sgm",
    "rand_g", "rgb", "rand_g_mix", "sym_rg_mix", "sym_rg",
    "instance_noise",
    "rep", "rep_gp", "rep_ds", "rmb", "rmb_gp", "rmb_ds",
    "test",
]
ALIASES = ["", "ins_noise", "sym_rand_g", "rep_mmd_g", "rep_b", "rep_mmd_b"]
FUSABLE = set(REPULSIVE) | set(REPULSIVE_BOUNDED)
CASES = [(name, fused) for name in ALL_LOSSES + ALIASES
         for fused in ((True, False) if name in FUSABLE else (False,))]
OMEGA = 0.4
STATE = (0.5, 0.3, 0.4)   # loss_average, mix_prob, ins_sigma
SHAPES = [(8, 4), (23, 16)]


def _scores(b, d, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, d) * rng.uniform(0.3, 1.0, (b, 1))).astype(np.float32)
            for _ in range(2)]


def _jax_draws(loss_type, key, b, d):
    """The coin's uniforms and the noise normals the JAX dispatcher makes
    from ``key`` (``losses.py:122,326,375-378``); omega is pinned."""
    if loss_type in ("mmd_g_mix", "fixed_g_mix", "sgm"):
        return {"coin": jax.random.uniform(key, [b])}
    if loss_type in ("rand_g_mix", "sym_rg_mix"):
        return {"coin": jax.random.uniform(jax.random.split(key)[1], [b])}
    if loss_type in ("instance_noise", "ins_noise"):
        rng_g, rng_x, _ = jax.random.split(key, 3)
        return {"noise": (jax.random.normal(rng_g, (b, d)), jax.random.normal(rng_x, (b, d)))}
    return {}


def _to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(_to_torch(t) for t in tree)
    return torch.tensor(np.asarray(tree))


def _kwargs(loss_type, b, d):
    kw = {"batch_size": b, "d": d}
    if loss_type in ("wasserstein", "rep_gp", "rmb_gp"):
        kw["dis_penalty"] = 0.1
    if loss_type in ("rep_ds", "rmb_ds"):
        kw["dis_scale"] = 0.5
    return kw


@pytest.mark.parametrize("b,d", SHAPES)
@pytest.mark.parametrize("loss_type,fused", CASES)
def test_loss_matches_jax(loss_type, fused, b, d):
    sg, sx = _scores(b, d, seed=b + d)
    key = jax.random.PRNGKey(b)
    kw = _kwargs(loss_type, b, d)
    jloss = JaxGANLoss(omega_range=OMEGA, summary_histograms=True)
    jstate = JaxLossState(*(jnp.float32(v) for v in STATE))

    def jax_fn(p, q):
        pen = None if "dis_penalty" not in kw else jnp.float32(kw["dis_penalty"])
        scale = None if "dis_scale" not in kw else jnp.float32(kw["dis_scale"])
        lg, ld, st, aux = jloss.apply(p, q, loss_type, batch_size=b, d=d, dis_penalty=pen,
                                      dis_scale=scale, rng=key, state=jstate)
        return lg + 0.5 * ld, (lg, ld, st, aux)

    (_, (jlg, jld, jst, jaux)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(sg), jnp.asarray(sx))

    loss = GANLoss(omega_range=OMEGA, summary_histograms=True, use_fused_kernel=fused)
    a, c = torch.tensor(sg, requires_grad=True), torch.tensor(sx, requires_grad=True)
    state = LossState(*(torch.tensor(v, dtype=torch.float32) for v in STATE))
    draws = {k: _to_torch(v) for k, v in _jax_draws(loss_type, key, b, d).items()}
    if "coin" in draws:   # the coin mixes some rows
        assert not bool((draws["coin"] > STATE[1]).all())
    lg, ld, st, aux = loss.apply(a, c, loss_type, state=state, draws=draws,
                                 **{k: torch.tensor(v) if isinstance(v, float) else v
                                    for k, v in kw.items()})

    np.testing.assert_allclose(lg.item(), float(jlg), **LOSS, err_msg="loss_gen")
    np.testing.assert_allclose(ld.item(), float(jld), **LOSS, err_msg="loss_dis")
    assert set(aux) == set(jaux)
    for k in aux:
        if k.startswith("hist/"):
            np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]), err_msg=k)
        else:
            np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **VAL, err_msg=k)
    for name in ("loss_average", "mix_prob", "ins_sigma"):
        np.testing.assert_allclose(float(getattr(st, name)), float(getattr(jst, name)), **VAL,
                                   err_msg=name)

    total = lg + 0.5 * ld
    if loss_type == "test":
        assert not total.requires_grad
        assert all(not np.asarray(g).any() for g in jgrads)
        return
    grads = torch.autograd.grad(total, (a, c))
    for name, g, jg in zip(("s_gen", "s_x"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD, err_msg=f"grad {name}")


def test_every_dispatcher_name_is_covered():
    assert set(LOSS_TYPES) == set(ALL_LOSSES + ALIASES)


@pytest.mark.parametrize("loss_type", ["fixed_g_gp", "fixed_t_gp", "no_such_loss"])
def test_unknown_names_raise_on_both_sides(loss_type):
    """``SNGan`` computes a penalty for fixed_g_gp / fixed_t_gp, but the JAX
    dispatcher rejects both names; the port does the same."""
    sg, sx = _scores(8, 4, seed=0)
    with pytest.raises(NotImplementedError):
        jax_gan_loss(jnp.asarray(sg), jnp.asarray(sx), loss_type, batch_size=8, d=4,
                     dis_penalty=jnp.float32(0.1))
    with pytest.raises(NotImplementedError):
        gan_loss(torch.tensor(sg), torch.tensor(sx), loss_type, batch_size=8, d=4,
                 dis_penalty=torch.tensor(0.1))


def test_drawing_losses_take_their_draws_from_the_generator():
    """Without ``draws``, the same generator state gives the same losses,
    and another state other draws; the draws come in the documented order
    (noise for gen, noise for data, omega, coin)."""
    sg, sx = (torch.tensor(s) for s in _scores(8, 4, seed=3))
    state = LossState(*(torch.tensor(v) for v in STATE))
    loss = GANLoss()
    for loss_type in ("rand_g_mix", "instance_noise", "mmd_g_mix"):
        run = lambda seed: loss.apply(sg, sx, loss_type, batch_size=8, d=4, state=state,
                                      generator=torch.Generator().manual_seed(seed))
        same, again, other = run(0), run(0), run(1)
        assert torch.equal(same[1], again[1]) and torch.equal(same[3]["state/mix_prob"],
                                                              again[3]["state/mix_prob"])
        assert not torch.equal(same[1], other[1]), loss_type
    g = torch.Generator().manual_seed(5)
    drawn = loss.draw("instance_noise", sg, g)
    g.manual_seed(5)
    want = [torch.randn(8, 4, generator=g), torch.randn(8, 4, generator=g),
            0.05 + 0.8 * torch.rand((), generator=g)]
    assert torch.equal(drawn["noise"][0], want[0]) and torch.equal(drawn["noise"][1], want[1])
    assert torch.equal(drawn["omega"], want[2])
    assert loss.draw("rep", sg, g) == {}


def test_fixed_bin_histogram_edges_and_clipping():
    x = torch.tensor([-100.0, 0.0, 0.2499, 0.25, 15.99, 16.0, 100.0])
    counts = fixed_bin_histogram(x, 0.0, 16.0)
    assert counts.shape == (64,) and counts.dtype == torch.float32
    assert counts.sum() == 7 and counts[0] == 3 and counts[1] == 1 and counts[63] == 3


@pytest.mark.parametrize("loss_type", ["rmb", "rmb_gp", "rmb_ds", "rep"])
@pytest.mark.parametrize("weights", [[1.0, 0.0], [2.0, 1.0]])
def test_non_repulsive_weights_take_the_plain_path(loss_type, weights):
    """At the default flag, the bounded loss with weights outside the
    kernel's repulsive direction (w0 > 0 or w1 > 0) trains as in JAX, on
    the plain path; 'rep' keeps the kernel means for any w0 - w1 = 1. The
    scores sit apart (data shifted by 1.5), so neither loss cancels."""
    rng = np.random.RandomState(11)
    sg = (rng.randn(16, 8) * 0.5).astype(np.float32)
    sx = (rng.randn(16, 8) * 0.5 + 1.5).astype(np.float32)
    kw = _kwargs(loss_type, 16, 8)
    jkw = {k: jnp.float32(v) for k, v in kw.items() if k in ("dis_penalty", "dis_scale")}
    jlg, jld, _, jaux = jax_gan_loss(jnp.asarray(sg), jnp.asarray(sx), loss_type,
                                     batch_size=16, rep_weights=weights, **jkw)
    loss = GANLoss(repulsive_weights=weights)
    assert loss.use_fused_kernel
    assert loss.fused_rmb is False and loss.fused_rep is True
    a, c = torch.tensor(sg, requires_grad=True), torch.tensor(sx, requires_grad=True)
    lg, ld, _, aux = loss.apply(a, c, loss_type, **{k: torch.tensor(v) if isinstance(v, float)
                                                     else v for k, v in kw.items()})
    assert abs(float(jld)) > 1e-2 and abs(float(jlg)) > 1e-2
    np.testing.assert_allclose(lg.item(), float(jlg), **LOSS, err_msg="loss_gen")
    np.testing.assert_allclose(ld.item(), float(jld), **LOSS, err_msg="loss_dis")
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **VAL, err_msg=k)
    jgrads = jax.grad(lambda p, q: jax_gan_loss(p, q, loss_type, batch_size=16,
                                                rep_weights=weights, **jkw)[1],
                      argnums=(0, 1))(jnp.asarray(sg), jnp.asarray(sx))
    for g, jg in zip(torch.autograd.grad(ld, (a, c)), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)
