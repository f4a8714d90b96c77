"""The port's distances, MMD kernels, kernel means and losses against the
JAX package on the same numpy scores.

Tolerances: rtol 1e-5 / atol 1e-6 on values and rtol 1e-4 on gradients,
those of tests/test_pallas_mmd.py. Both sides compute in float32 but sum
in other orders (and the JAX fused means run the Pallas kernel in
interpret mode), so they agree to a few ulps of the sums, not bitwise.
The kernel means are O(0.1) here and held at rtol 1e-5; the losses are
differences of them (e_kxx + e_kyy - 2 e_kxy ~ 4e-3), so their rounding
error is that of the means, which the atol 1e-6 covers.

The backward's closed form (``kernel_means_backward_reference``, the
function the backward kernel computes) is held against ``jax.vjp`` of
JAX's ``fused_kernel_means`` at the gradient tolerance plus
``kernel_means_backward_atol``: the gradient jumps where a raw distance
crosses 0 (the clamp) or a bound, and two codes that round a raw distance
differently may keep or drop such a pair. On ordinary scores no pair lies
within rounding of a threshold and that term is 0; on the saturated input
(near-duplicate gen rows, whose raw gen-gen distances sit at 0 up to
rounding) it bounds the sum of those pairs' terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.ops import distance as jdist
from mmdgan_tpu.ops import kernels as jker
from mmdgan_tpu.ops.losses import gan_loss as jax_gan_loss
from mmdgan_tpu.ops.pallas_mmd import fused_kernel_means as jax_fused_kernel_means
from mmdgan_torch.ops import cuda_mmd
from mmdgan_torch.ops.cuda_mmd import (
    fused_kernel_means,
    kernel_means_backward_atol,
    kernel_means_backward_cuda,
    kernel_means_backward_reference,
    kernel_means_cuda,
    kernel_means_reference,
    raw_distances,
    repulsive_mmd_g_bounded_fused,
)
from mmdgan_torch.ops.distance import get_squared_dist
from mmdgan_torch.ops.kernels import mmd_g, mmd_g_bounded
from mmdgan_torch.ops.losses import gan_loss

torch.set_num_threads(1)

SHAPES = [(64, 16), (23, 5), (256, 16)]
VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-8)
# d(loss)/d(means) of the losses the train step differentiates, with the
# repulsive weights (0, -1): loss_gen = e_kxx + e_kyy - 2 e_kxy (rep and
# rmb), rep's loss_dis = -e_kxx + e_kyy, rmb's loss_dis = -e_kxx_b + e_kyy_b
COTANGENTS = {
    "random": np.random.RandomState(3).randn(6).astype(np.float32),
    "loss_gen": np.array([1, -2, 1, 0, 0, 0], np.float32),
    "rep_loss_dis": np.array([-1, 0, 1, 0, 0, 0], np.float32),
    "rmb_loss_dis": np.array([0, 0, 0, -1, 0, 1], np.float32),
}


def scores(b, d, seed=0):
    """Score pairs whose distances straddle both rmb bounds (0.25, 4.0):
    per-row scales spread the pairwise distances over [~0, ~10]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        scale = rng.uniform(0.05, 0.5, (b, 1)) * np.sqrt(16.0 / d)
        out.append((rng.randn(b, d) * scale).astype(np.float32))
    return out


def saturated_scores(b, d, seed=0):
    """The saturated regime (e_kxx near 1): gen rows that are one row plus
    noise at 1e-4 of its scale, so their raw distances sit at 0 up to
    rounding and many come out negative; data rows as in ``scores``."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1, d) * 0.25
    sg = (base + 2.5e-5 * rng.randn(b, d)).astype(np.float32)
    sx = (rng.randn(b, d) * rng.uniform(0.05, 0.5, (b, 1))).astype(np.float32)
    return sg, sx


INPUTS = {"ordinary": scores, "saturated": saturated_scores}


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("b,d", SHAPES)
def test_squared_dist_matches_jax(b, d):
    sg, sx = scores(b, d)
    for mode in ("xxxyyy", "xy"):
        ours = get_squared_dist(_t(sg), _t(sx), mode=mode)
        ref = jdist.get_squared_dist(jnp.asarray(sg), jnp.asarray(sx), mode=mode)
        ours = ours if isinstance(ours, tuple) else (ours,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("b,d", SHAPES)
def test_mmd_kernels_match_jax(b, d, bounded):
    sg, sx = scores(b, d, seed=1)
    w = [0.0, -1.0]
    ours = get_squared_dist(_t(sg), _t(sx))
    ref = jdist.get_squared_dist(jnp.asarray(sg), jnp.asarray(sx))
    if bounded:
        o = mmd_g_bounded(*ours, b, custom_weights=w, with_aux=True)
        r = jker.mmd_g_bounded(*ref, b, custom_weights=w, with_aux=True)
    else:
        o = mmd_g(*ours, b, custom_weights=w, with_aux=True)
        r = jker.mmd_g(*ref, b, custom_weights=w, with_aux=True)
    for i in range(2):
        np.testing.assert_allclose(o[i].item(), float(r[i]), **VAL)
    assert set(o[2]) == set(r[2])
    for k in o[2]:
        np.testing.assert_allclose(float(o[2][k]), float(r[2][k]), **VAL)


@pytest.mark.parametrize("b,d", SHAPES)
def test_kernel_means_match_jax_fused(b, d):
    """The plain means, and the fused entry on CPU tensors, against JAX's
    fused_kernel_means (Pallas in interpret mode): values and the gradient
    of a random projection of the six means."""
    sg, sx = scores(b, d, seed=2)
    ct = np.random.RandomState(3).randn(6).astype(np.float32)

    ref, vjp = jax.vjp(lambda a, c: jax_fused_kernel_means(a, c, 1.0),
                       jnp.asarray(sg), jnp.asarray(sx))
    ref_grads = vjp(jnp.asarray(ct))

    for fn in (kernel_means_reference, fused_kernel_means):
        a, c = _t(sg, True), _t(sx, True)
        e = fn(a, c, 1.0)
        np.testing.assert_allclose(e.detach().numpy(), np.asarray(ref), **VAL)
        grads = torch.autograd.grad(e, (a, c), torch.tensor(ct))
        for g, rg in zip(grads, ref_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(rg), **GRAD)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("loss_type", ["rep", "rmb"])
def test_gan_loss_matches_jax(loss_type, fused):
    """Both GANLoss paths against JAX's fused and plain paths. The JAX
    fused path surfaces no kernel means, so aux is held against JAX's
    plain path, whose keys the port's fused path reuses."""
    b, d = 64, 16
    sg, sx = scores(b, d, seed=4)
    a, c = _t(sg, True), _t(sx, True)
    lg, ld, _, aux = gan_loss(a, c, loss_type, batch_size=b, use_fused_kernel=fused)
    jlg, jld, _, _ = jax_gan_loss(jnp.asarray(sg), jnp.asarray(sx), loss_type,
                                  batch_size=b, use_pallas=fused)
    _, _, _, jaux = jax_gan_loss(jnp.asarray(sg), jnp.asarray(sx), loss_type, batch_size=b)
    np.testing.assert_allclose(lg.item(), float(jlg), **VAL)
    np.testing.assert_allclose(ld.item(), float(jld), **VAL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **VAL)

    def jax_total(p, q):
        g, dl, _, _ = jax_gan_loss(p, q, loss_type, batch_size=b, use_pallas=fused)
        return g + 0.5 * dl

    ref_grads = jax.grad(jax_total, argnums=(0, 1))(jnp.asarray(sg), jnp.asarray(sx))
    grads = torch.autograd.grad(lg + 0.5 * ld, (a, c))
    for g, rg in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), **GRAD)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """The CUDA wrapper takes CUDA tensors only: a CPU tensor raises
    before any build or launch, and the launch count stays put."""
    sg, sx = scores(8, 4)
    before = kernel_means_cuda.launches
    with pytest.raises(ValueError, match="not CUDA"):
        kernel_means_cuda(_t(sg), _t(sx))
    assert kernel_means_cuda.launches == before


def test_fused_rmb_asserts_its_specialization():
    sg, sx = scores(8, 4)
    with pytest.raises(AssertionError):
        repulsive_mmd_g_bounded_fused(_t(sg), _t(sx), lower_bound=0.5)
    with pytest.raises(AssertionError):
        repulsive_mmd_g_bounded_fused(_t(sg), _t(sx), repulsive_weights=(1.0, 0.0))


def assert_grads_close(got, want, atols, what):
    for name, g, w, extra in zip(("g_gen", "g_x"), got, want, atols):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] + extra, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("ct_name", sorted(COTANGENTS))
@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("b,d", SHAPES)
def test_backward_reference_matches_jax_vjp(b, d, kind, ct_name):
    sg, sx = INPUTS[kind](b, d, seed=5)
    ct = COTANGENTS[ct_name]
    _, vjp = jax.vjp(lambda a, c: jax_fused_kernel_means(a, c, 1.0),
                     jnp.asarray(sg), jnp.asarray(sx))
    want = vjp(jnp.asarray(ct))
    args = (_t(sg), _t(sx), _t(ct))
    got = kernel_means_backward_reference(*args)
    assert_grads_close([g.numpy() for g in got], want, kernel_means_backward_atol(*args),
                       f"{kind} {(b, d)} ct={ct_name}")


@pytest.mark.parametrize("b,d", SHAPES)
def test_saturated_input_reaches_the_clamp(b, d):
    """The saturated input has negative raw gen-gen distances off the
    diagonal, so the comparisons above exercise the clamp's mask; the
    ordinary input has none, and no pair within rounding of a threshold."""
    ct = _t(COTANGENTS["random"])
    sat = [_t(s) for s in saturated_scores(b, d, seed=5)]
    r_gg = raw_distances(*sat)[0]
    assert int((r_gg < 0).sum()) > b
    assert kernel_means_backward_atol(*sat, ct)[0] > 0
    ordinary = [_t(s) for s in scores(b, d, seed=5)]
    assert int((raw_distances(*ordinary)[0] < 0).sum()) == 0
    assert kernel_means_backward_atol(*ordinary, ct) == (0.0, 0.0)


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("b,d", SHAPES)
def test_fused_cpu_backward_is_the_closed_form(b, d, kind, monkeypatch):
    """On CPU tensors ``fused_kernel_means``' gradient is
    ``kernel_means_backward_reference`` (called once per backward), and it
    matches autograd through ``kernel_means_reference``."""
    calls = []
    closed_form = cuda_mmd.kernel_means_backward_reference

    def counted(*args):
        calls.append(1)
        return closed_form(*args)

    monkeypatch.setattr(cuda_mmd, "kernel_means_backward_reference", counted)
    sg, sx = INPUTS[kind](b, d, seed=6)
    ct = _t(COTANGENTS["random"])
    a, c = _t(sg, True), _t(sx, True)
    got = torch.autograd.grad(fused_kernel_means(a, c, 1.0), (a, c), ct)
    assert len(calls) == 1
    want = torch.autograd.grad(kernel_means_reference(a, c, 1.0), (a, c), ct)
    assert_grads_close([g.numpy() for g in got], [w.numpy() for w in want],
                       kernel_means_backward_atol(a.detach(), c.detach(), ct),
                       f"{kind} {(b, d)}")


def test_backward_wrapper_refuses_what_it_cannot_take(monkeypatch):
    """The backward kernel's wrapper takes CUDA tensors and a contiguous
    float32 [6] cotangent only: anything else raises before the library is
    built or loaded, and the launch count stays put."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(cuda_mmd, "_library", no_build)
    sg, sx = (_t(s) for s in scores(8, 4))
    before = kernel_means_backward_cuda.launches
    with pytest.raises(ValueError, match="not CUDA"):
        kernel_means_backward_cuda(sg, sx, torch.ones(6))
    for ct in (torch.ones(6, dtype=torch.float64), torch.ones(5), torch.ones(12)[::2],
               torch.ones(1, 6)):
        with pytest.raises(ValueError, match="ct must be"):
            kernel_means_backward_cuda(sg, sx, ct)
    assert kernel_means_backward_cuda.launches == before
