"""The port's distance modes, mixed slices and MMD kernel catalogue
(``mmdgan_torch/ops/{distance,kernels}.py``) against the JAX package's, on
the same seeded numpy scores at float32.

Each case is one expression over a module pair (``distance``, ``kernels``)
that both packages provide, so the same code runs on both sides. Kernel
means and the Newton-solved ``beta`` are compared at rtol 1e-5 / atol 1e-6.
Distances take atol 1e-5, as ``tests/test_torch_mmd.py`` holds them (they
are differences of O(10) norms). Losses and witness vectors take atol 1e-5:
they are differences of up to 15 float32 means of up to B(B-1) = 506
kernel values of magnitude up to ~5 (Cramér), each mean rounded by ~1e-6
in a sum order the two frameworks do not share.

The gradient of a fixed random projection of all outputs, with respect to
both score matrices, is compared at rtol 1e-4 (``tests/test_pallas_mmd.py``)
with an atol of 1e-4 of the gradient's largest entry: an entry is a sum of
B terms that may cancel to ~0.

``mmd_t`` and the t witness take logs of distances: they also run on
scores with near-duplicate gen rows, whose distances run from exactly 0
to ~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.ops import distance as jdist
from mmdgan_tpu.ops import kernels as jker
from mmdgan_torch.ops import distance as tdist
from mmdgan_torch.ops import kernels as tker

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
DIST = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(8, 4), (23, 16)]
SIGMAS = [1.0, float(np.sqrt(2.0)), 2.0, float(np.sqrt(8.0)), 4.0]
ALPHAS = [0.2, 0.5, 1.0, 2.0, 5.0]


def _mask(b, seed):
    """A [b] boolean mix vector with both values present."""
    m = np.random.RandomState(seed).rand(b) > 0.5
    m[0], m[1] = True, False
    return m


def _d3(D, sg, sx):
    return D.get_squared_dist(sg, sx, mode="xxxyyy")


# name -> (fn(D, K, sg, sx, b, d, mask), tolerance of the values)
CASES = {
    # ---- distance.py ----
    "dist_xx": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(sg, mode="xx"), DIST),
    "dist_y_none": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(sg), DIST),
    "dist_xy": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(sg, sx, mode="xy"), DIST),
    "dist_xxxy": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(sg, sx, mode="xxxy"), DIST),
    "dist_xxxyyy": (lambda D, K, sg, sx, b, d, m: _d3(D, sg, sx), DIST),
    "dist_scale_z_score": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(
        sg, sx, scale=sx[0] ** 2 + 0.5, z_score=True, mode="xxxyyy"), DIST),
    "dist_z_score_xx": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(
        sg, z_score=True), DIST),
    "dist_full_2b": (lambda D, K, sg, sx, b, d, m: D.get_squared_dist(
        _cat(sg, sx)), DIST),
    "slice_blocks": (lambda D, K, sg, sx, b, d, m: D.slice_pairwise_distance(
        D.get_squared_dist(_cat(sg, sx)), batch_size=b), DIST),
    "slice_mixed": (lambda D, K, sg, sx, b, d, m: D.slice_pairwise_distance(
        D.get_squared_dist(_cat(sg, sx)), indices=m), DIST),
    "mat_slice_rows": (lambda D, K, sg, sx, b, d, m: D.mat_slice(
        D.get_squared_dist(_cat(sg, sx)), _concat_mask(m)), DIST),
    # ---- kernels.py ----
    "mmd_g": (lambda D, K, sg, sx, b, d, m: K.mmd_g(*_d3(D, sg, sx), b, sigma=1.5,
                                                    with_aux=True), VAL),
    "mmd_g_var_target": (lambda D, K, sg, sx, b, d, m: K.mmd_g(
        *_d3(D, sg, sx), b, sigma=1.5, var_target=1.2, with_aux=True), VAL),
    "mmd_g_mgb_bounds": (lambda D, K, sg, sx, b, d, m: K.mmd_g(
        *_d3(D, sg, sx), b, sigma=1.0, upper_bound=4, lower_bound=0.25, with_aux=True), VAL),
    "mmd_g_repulsive": (lambda D, K, sg, sx, b, d, m: K.mmd_g(
        *_d3(D, sg, sx), b, custom_weights=[0.5, -0.5], with_aux=True), VAL),
    "mmd_g_bounded_var_target": (lambda D, K, sg, sx, b, d, m: K.mmd_g_bounded(
        *_d3(D, sg, sx), b, var_target=0.8, custom_weights=[-0.5, -1.5], with_aux=True), VAL),
    "mmd_g_bounded_mmd_g_direction": (lambda D, K, sg, sx, b, d, m: K.mmd_g_bounded(
        *_d3(D, sg, sx), b, custom_weights=[1.5, 0.5], with_aux=True), VAL),
    "mixture_mmd_g": (lambda D, K, sg, sx, b, d, m: K.mixture_mmd_g(
        *_d3(D, sg, sx), b, sigma=SIGMAS, with_aux=True), VAL),
    "mixture_mmd_g_plain": (lambda D, K, sg, sx, b, d, m: K.mixture_mmd_g(
        *_d3(D, sg, sx), b, sigma=SIGMAS[:2]), VAL),
    "mixture_mmd_g_var_targets": (lambda D, K, sg, sx, b, d, m: K.mixture_mmd_g(
        *_d3(D, sg, sx), b, sigma=SIGMAS[:3], var_targets=[1.0, 1.5, 2.0], with_aux=True), VAL),
    "mmd_t": (lambda D, K, sg, sx, b, d, m: K.mmd_t(*_d3(D, sg, sx), b, alpha=0.5,
                                                    with_aux=True), VAL),
    "mmd_t_var_target": (lambda D, K, sg, sx, b, d, m: K.mmd_t(
        *_d3(D, sg, sx), b, alpha=2.0, beta=1.5, var_target=1.1, with_aux=True), VAL),
    "mixture_mmd_t": (lambda D, K, sg, sx, b, d, m: K.mixture_mmd_t(
        *_d3(D, sg, sx), b, alpha=ALPHAS, with_aux=True), VAL),
    "mixture_mmd_t_var_targets": (lambda D, K, sg, sx, b, d, m: K.mixture_mmd_t(
        *_d3(D, sg, sx), b, alpha=ALPHAS[:2], var_targets=[1.0, 0.5]), VAL),
    "cramer": (lambda D, K, sg, sx, b, d, m: K.cramer(*_d3(D, sg, sx), b, with_aux=True), VAL),
    "witness_g": (lambda D, K, sg, sx, b, d, m: K.witness_g(
        D.get_squared_dist(sg, sx, mode="xy"),
        D.get_squared_dist(sg, _flip(sx) * 0.5, mode="xy"), sigma=1.0), VAL),
    "witness_mix_g": (lambda D, K, sg, sx, b, d, m: K.witness_mix_g(
        D.get_squared_dist(sg, sx, mode="xy"), D.get_squared_dist(sg, sg, mode="xy"),
        sigma=SIGMAS), VAL),
    "witness_t": (lambda D, K, sg, sx, b, d, m: K.witness_t(
        D.get_squared_dist(sg, sx, mode="xy"), D.get_squared_dist(sg, sg, mode="xy"),
        alpha=0.5, beta=2.0), VAL),
    "witness_mix_t": (lambda D, K, sg, sx, b, d, m: K.witness_mix_t(
        D.get_squared_dist(sg, sx, mode="xy"), D.get_squared_dist(sg, sg, mode="xy"),
        alpha=[0.25, 0.5, 0.9, 2.0, 25.0]), VAL),
    "mmd_g_xn": (lambda D, K, sg, sx, b, d, m: K.mmd_g_xn(b, d, 1.5, sg, y_mu=0.25,
                                                          y_var=2.0), VAL),
    "mixture_g_xn": (lambda D, K, sg, sx, b, d, m: K.mixture_g_xn(
        b, d, SIGMAS, sx, dist_xx=D.get_squared_dist(sx, mode="xx")), VAL),
    "rand_mmd_g": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g(
        D.get_squared_dist(_cat(sg, sx)), b, omega=0.4, max_iter=3), VAL),
    "rand_mmd_g_xy": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xy(
        *_d3(D, sg, sx), b, omega=0.4, max_iter=3, with_aux=True), VAL),
    "rand_mmd_g_xy_no_batch": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xy(
        *_d3(D, sg, sx), None, omega=0.3, max_iter=2, with_aux=True), VAL),
    "rand_mmd_g_xy_yx": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xy(
        *_d3(D, sg, sx), b, dist_yx=D.get_squared_dist(sx, sg, mode="xy") * 1.1, omega=0.4,
        max_iter=3, with_aux=True), VAL),
    "rand_mmd_g_xy_bounded": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xy_bounded(
        *_d3(D, sg, sx), b, omega=0.4, max_iter=3, with_aux=True), VAL),
    "rand_mmd_g_xy_bounded_yx": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xy_bounded(
        *_d3(D, sg, sx), b, dist_yx=D.get_squared_dist(sx, sg, mode="xy"), omega=0.6,
        max_iter=3, with_aux=True), VAL),
    "rand_mmd_g_xn": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xn(
        sx, 1.0, b, d, omega=0.4, max_iter=3, with_aux=True), VAL),
    "rand_mmd_g_xn_shifted": (lambda D, K, sg, sx, b, d, m: K.rand_mmd_g_xn(
        sg, 1.0, b, d, y_mu=-0.5, dist_xx=D.get_squared_dist(sg, mode="xx"), omega=0.4,
        max_iter=3, with_aux=True), VAL),
}
NEAR_DUPLICATE = ["mmd_t", "mixture_mmd_t", "witness_t", "witness_mix_t", "mmd_g"]


def _cat(a, b):
    return torch.cat([a, b], 0) if isinstance(a, torch.Tensor) else jnp.concatenate([a, b], 0)


def _flip(a):
    return torch.flip(a, [0]) if isinstance(a, torch.Tensor) else a[::-1]


def _concat_mask(m):
    return torch.cat([m, ~m]) if isinstance(m, torch.Tensor) else jnp.concatenate([m, ~m])


def _leaves(out):
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _tolerances(out, tol):
    """``tol`` for every leaf outside the aux dict (distances, losses,
    witness vectors) of a kernel case: LOSS; aux values: VAL."""
    if tol is DIST:
        return [DIST] * len(_leaves(out))
    parts = out if isinstance(out, tuple) else (out,)
    return [t for p in parts for t in ([VAL] * len(_leaves(p)) if isinstance(p, dict)
                                       else [LOSS] * len(_leaves(p)))]


def _projection(leaves, xp):
    """A fixed random projection of every output onto one scalar."""
    total = 0.0
    for i, leaf in enumerate(leaves):
        w = np.asarray(np.random.RandomState(100 + i).randn(*np.shape(leaf)), np.float32)
        total = total + xp.sum(leaf * (torch.tensor(w) if xp is torch else jnp.asarray(w)))
    return total


def _inputs(kind, b, d):
    rng = np.random.RandomState(b * 31 + d)
    if kind == "ordinary":
        return [(rng.randn(b, d) * rng.uniform(0.3, 1.0, (b, 1))).astype(np.float32)
                for _ in range(2)]
    # gen rows 1e-4 apart around the origin, two of them equal: distances
    # from 0 (exactly) to ~1e-7, formed without cancellation, so the two
    # codes clamp the same pairs
    sg = (1e-4 * rng.randn(b, d)).astype(np.float32)
    sg[1] = sg[0]
    sx = (rng.randn(b, d) * 0.5).astype(np.float32)
    return [sg, sx]


PARAMS = [(name, kind) for name in CASES for kind in ("ordinary", "near_duplicate")
          if kind == "ordinary" or name in NEAR_DUPLICATE]


@pytest.mark.parametrize("b,d", SHAPES)
@pytest.mark.parametrize("name,kind", PARAMS)
def test_function_matches_jax(name, kind, b, d):
    fn, tol = CASES[name]
    sg, sx = _inputs(kind, b, d)
    mask = _mask(b, seed=d)

    def jax_fn(p, q):
        return _projection(_leaves(fn(jdist, jker, p, q, b, d, jnp.asarray(mask))), jnp)

    jtree = fn(jdist, jker, jnp.asarray(sg), jnp.asarray(sx), b, d, jnp.asarray(mask))
    jout = _leaves(jtree)
    jgrads = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(sg), jnp.asarray(sx))

    a, c = torch.tensor(sg, requires_grad=True), torch.tensor(sx, requires_grad=True)
    out = _leaves(fn(tdist, tker, a, c, b, d, torch.tensor(mask)))
    assert len(out) == len(jout)
    for i, (o, r, t) in enumerate(zip(out, jout, _tolerances(jtree, tol))):
        o = o.detach().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
        np.testing.assert_allclose(o, np.asarray(r), **t, err_msg=f"output {i}")
    grads = torch.autograd.grad(_projection(out, torch), (a, c), allow_unused=True)
    for which, g, jg in zip(("s_gen", "s_x"), grads, jgrads):
        g = np.zeros(jg.shape, np.float32) if g is None else g.numpy()
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max(),
                                   err_msg=f"grad {which}")


def test_mixed_slice_is_the_boolean_selection():
    """The mixed slices equal what boolean masks select (``t[mask]``, the
    reference's ``boolean_mask``), without ever asking the host."""
    b = 7
    pair = torch.arange(4 * b * b, dtype=torch.float32).reshape(2 * b, 2 * b)
    m = torch.tensor(_mask(b, seed=3))
    g1, g1g2, g2 = tdist.slice_pairwise_distance(pair, indices=m)
    r1, r2 = torch.cat([m, ~m]), torch.cat([~m, m])
    assert torch.equal(g1, pair[r1][:, r1])
    assert torch.equal(g1g2, pair[r1][:, r2])
    assert torch.equal(g2, pair[r2][:, r2])
    g1, g1g2, g2 = tdist.slice_pairwise_distance(pair, batch_size=b)
    assert torch.equal(g1g2, pair[:b, b:])
