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

import re
from pathlib import Path

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
    LOWER_BOUND as LOWER,
    UPPER_BOUND as UPPER,
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
# the backward's closed form also at the widths of the backward kernel's
# chunked design: d = 256, and a ragged (100, 37) across every tile and
# chunk edge
BACKWARD_SHAPES = SHAPES + [(64, 256), (100, 37)]
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
@pytest.mark.parametrize("b,d", BACKWARD_SHAPES)
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


# The backward kernel's schedule, as ``csrc/kernel_means.cu`` maps its
# blocks (``kernel_means_bwd``, ``strip``) and sizes its clusters
# (``backward_ranks``): the tests below hold its algebra and its coverage.
# The ragged (100, 37) and the smallest input (2, 1) cross every tile edge.
GEOMETRY_SHAPES = [(2, 1), (23, 5), (64, 16), (100, 37), (256, 16), (64, 256), (40, 300)]


def backward_pieces(tiles):
    """The pieces in block order: ``(pair, row tile, column tile, row strip,
    column strip)``, pair 0 gen-gen, 1 gen-data, 2 data-data, each strip its
    ``(side, row tile, slot)`` (side 0 gen, 1 data), the column strip None
    on a symmetric matrix's diagonal tile (its rows hold both ends)."""
    upper = [(r, c) for r in range(tiles) for c in range(r, tiles)]
    full = [(r, c) for r in range(tiles) for c in range(tiles)]
    for pair, pieces in ((0, upper), (1, full), (2, upper)):
        for r, c in pieces:
            row = (1 if pair == 2 else 0, r, c if pair == 0 else tiles + c)
            col = None
            if pair == 1 or r != c:
                col = (0 if pair == 0 else 1, c, tiles + r if pair == 2 else r)
            yield pair, r, c, row, col


def backward_ranks(pieces, dim, fit):
    """``(ranks, chunks per rank)`` of a piece on a card that holds ``fit``
    blocks of the kernel at once: as many ranks as the 32-feature chunks of
    d allow, up to 8, while pieces x ranks blocks fit; at least one."""
    chunks = -(-dim // 32)
    cap = max(1, min(8, chunks, fit // pieces))
    per_rank = -(-chunks // cap)
    return -(-chunks // per_rank), per_rank


@pytest.mark.parametrize("b,d", GEOMETRY_SHAPES)
def test_backward_pieces_cover_every_tile_once(b, d):
    """One cluster per piece: every (row tile, column tile) of gen-data
    once, every tile of gen-gen and data-data once as a piece or as the
    mirror of an upper piece, and every (side, row tile, slot) strip written
    by exactly one piece; 2t strips per (side, row tile), as the ticket
    counts, in the wrapper's scratch. The ranks of a cluster split the
    chunks of d, none empty, and the grid fits a card that holds ``fit``
    blocks at once where it can."""
    t = -(-b // 32)
    pieces = list(backward_pieces(t))
    assert len(pieces) == t * (t + 1) + t * t
    covered = {0: [], 1: [], 2: []}
    strips = []
    for pair, r, c, row, col in pieces:
        covered[pair].append((r, c))
        if pair != 1 and r != c:
            covered[pair].append((c, r))
        strips += [row] + ([col] if col is not None else [])
        assert (col is None) == (pair != 1 and r == c)
    tiles = sorted((r, c) for r in range(t) for c in range(t))
    assert all(sorted(v) == tiles for v in covered.values())
    assert sorted(strips) == sorted((s, r, k) for s in range(2) for r in range(t)
                                    for k in range(2 * t))
    assert cuda_mmd.backward_scratch_floats(b, d) == len(strips) * 32 * d
    chunks = -(-d // 32)
    for fit in (1, 264, 10 ** 6):   # no room, an H100 at 2 blocks an SM, room for all
        ranks, per = backward_ranks(len(pieces), d, fit)
        assert 1 <= ranks <= 8 and (ranks - 1) * per < chunks <= ranks * per
        assert ranks == 1 or len(pieces) * ranks <= fit


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("b,d", GEOMETRY_SHAPES)
def test_backward_pieces_assemble_the_closed_form(b, d, kind):
    """The kernel's algebra on its schedule, in float64: each piece's
    coefficient tile w gives its row strip sum_c w_rc (own_r - partner_c)
    and its column strip sum_r w_rc (partner_c - own_r); the strips of each
    (side, row tile), added in slot order, are the closed form's gradient."""
    sg, sx = (s.astype(np.float64) for s in INPUTS[kind](b, d, seed=7))
    ct = COTANGENTS["random"].astype(np.float64)
    scale = -1.0 / (2.0 * b * (b - 1))
    t = -(-b // 32)
    pad = lambda s: np.concatenate([s, np.zeros((32 * t - b, d))])
    scores_ = {0: pad(sg), 1: pad(sx)}
    strips = {}
    for pair, r, c, row, col in backward_pieces(t):
        own = scores_[1 if pair == 2 else 0][32 * r:32 * r + 32]
        part = scores_[0 if pair == 0 else 1][32 * c:32 * c + 32]
        raw = ((own * own).sum(1)[:, None] + (part * part).sum(1)[None, :]) - 2.0 * own @ part.T
        i, j = np.arange(32 * r, 32 * r + 32)[:, None], np.arange(32 * c, 32 * c + 32)[None, :]
        keep = (i < b) & (j < b) & (i != j) & (raw >= 0)
        if pair == 1:
            coef = 2.0 * (ct[1] + ct[4]) * scale
        elif pair == 0:
            coef = 4.0 * (ct[0] + ct[3] * (raw >= LOWER)) * scale
        else:
            coef = 4.0 * (ct[2] + ct[5] * (raw <= UPPER)) * scale
        w = np.where(keep, coef * np.exp(-np.maximum(raw, 0) / 2.0), 0.0)
        strips[row] = w.sum(1)[:, None] * own - w @ part
        if col is not None:
            strips[col] = w.sum(0)[:, None] * part - w.T @ own
    got = [np.concatenate([sum(strips[(side, r, k)] for k in range(2 * t)) for r in range(t)])[:b]
           for side in range(2)]
    want = kernel_means_backward_reference(*(torch.tensor(a) for a in (sg, sx, ct)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-10, atol=1e-15)


def test_backward_geometry_mirrors_the_source():
    """``BACKWARD_MAX_BATCH`` and the tile are the source's kMaxTiles and
    kTile, a cluster is at most the portable 8 blocks, and the static shared
    memory of a block (46,344 bytes: a ring of kStages chunks of both
    strips, the coefficient tile and its transpose, the norms) stays under
    the 48 KiB a block may declare statically, far under the 232,448 it may
    use."""
    src = (Path(cuda_mmd.__file__).parents[1] / "csrc" / cuda_mmd.SOURCE).read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTile"] == 32 and const["kChunk"] == 32 and const["kThreads"] == 256
    assert cuda_mmd.BACKWARD_MAX_BATCH == const["kMaxTiles"] * const["kTile"]
    assert const["kMaxRanks"] == 8
    ld = const["kChunk"] + 4   # kLd
    tile = const["kTile"]
    shared = 4 * (2 * const["kStages"] * tile * ld + 2 * tile * ld + 2 * tile) + 8
    assert shared == 46344 <= 48 * 1024 < 232448
    # on an H100 (132 SMs, 2 blocks an SM): (64, 256)'s 10 pieces take 8
    # ranks of one chunk, (256, 256)'s 136 pieces fill the card with one
    assert backward_ranks(10, 256, 264) == (8, 1)
    assert backward_ranks(136, 256, 264) == (1, 8)
    assert backward_ranks(10, 1000, 264) == (8, 4)
    assert backward_ranks(36, 37, 264) == (2, 1)
    assert backward_ranks(10, 16, 264) == (1, 1)


def test_backward_wrapper_raises_above_its_bound_before_loading(monkeypatch):
    """Above ``BACKWARD_MAX_BATCH`` rows the wrapper raises, naming the
    bound, before the library is built or loaded; the launch count stays."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(cuda_mmd, "_library", no_build)
    # stand in for the CUDA checks, which a CPU tensor fails first
    monkeypatch.setattr(cuda_mmd, "_check_scores", lambda who, a, c: tuple(a.shape))
    big = cuda_mmd.BACKWARD_MAX_BATCH + 1
    sg = torch.zeros(big, 2)
    before = kernel_means_backward_cuda.launches
    with pytest.raises(ValueError, match=f"B = {big} is above the kernel's 4096"):
        kernel_means_backward_cuda(sg, sg, torch.ones(6))
    assert kernel_means_backward_cuda.launches == before
    assert cuda_mmd.backward_scratch_floats(cuda_mmd.BACKWARD_MAX_BATCH, 2) == 4 * 128 ** 2 * 32 * 2
