"""The port's metrics against the JAX package's on the same numpy inputs:
FID/IS math, MS-SSIM, the TF1 resize and the MS-SSIM score's resize, SWD
with JAX's draws passed in, the random-feature classifier with JAX's
weights, and ``GenerativeModelMetric`` end to end; then the port's own
versions of ``tests/test_metrics.py:21-122``.

Tolerances: FID/IS rtol 1e-6 (the same float64 numpy); MS-SSIM atol 1e-5
(float32 convolutions summed in another order); the TF1 resize atol 1e-6;
the MS-SSIM score's resize atol 1e-3 on the 0-255 scale; SWD rtol 1e-5;
the classifier rtol 1e-4 / atol 1e-5; scores of bridged classifiers rtol
1e-5 (covariances of full rank, so the float32 classifier outputs move the
FID little).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.metrics import fid as jax_fid
from mmdgan_tpu.metrics.inception import RandomFeatureClassifier as JaxRandomFeatures
from mmdgan_tpu.metrics.inception import resize_bilinear_tf1 as jax_resize_tf1
from mmdgan_tpu.metrics.msssim import ms_ssim as jax_ms_ssim
from mmdgan_tpu.metrics.scores import GenerativeModelMetric as JaxMetric
from mmdgan_tpu.metrics.swd import laplacian_pyramid as jax_pyramid
from mmdgan_tpu.metrics.swd import sliced_wasserstein_distance as jax_swd
from mmdgan_torch.metrics import fid
from mmdgan_torch.metrics.inception import (
    InceptionClassifier,
    RandomFeatureClassifier,
    pad_same,
    resize_bilinear_tf1,
)
from mmdgan_torch.metrics.msssim import ms_ssim
from mmdgan_torch.metrics.scores import GenerativeModelMetric, resize_linear
from mmdgan_torch.metrics.swd import laplacian_pyramid, sliced_wasserstein_distance
from mmdgan_torch.utils.jax_bridge import jax_random_classifier_to_torch

torch.set_num_threads(2)


def jax_classifier_weights(clf):
    """The weights the JAX classifier's ``_build`` drew, from its closure."""
    clf._build()
    fwd = clf._fn.__wrapped__
    cells = dict(zip(fwd.__code__.co_freevars, fwd.__closure__))
    as_np = lambda a: np.asarray(a, np.float32)
    return ([as_np(k) for k in cells["kernels"].cell_contents],
            as_np(cells["w_pool"].cell_contents), as_np(cells["w_log"].cell_contents))


def bridged_classifiers(pool_dim=2048, num_logits=1001):
    jclf = JaxRandomFeatures(seed=0, pool_dim=pool_dim, num_logits=num_logits)
    return jclf, jax_random_classifier_to_torch(*jax_classifier_weights(jclf), device="cpu")


def images(rng, n, size, c=3):
    return (rng.rand(n, size, size, c).astype(np.float32) * 2 - 1)


# ----------------------------------------------------------------------
# against JAX
# ----------------------------------------------------------------------
def test_fid_and_is_math_match_jax(rng):
    x, y = rng.randn(300, 12), rng.randn(200, 12) * 1.3 + 0.2
    for name in ("mean_cov_np",):
        for a, b in zip(getattr(fid, name)(x), getattr(jax_fid, name)(x)):
            np.testing.assert_allclose(a, b, rtol=1e-6)
    m = x.T @ x
    np.testing.assert_allclose(fid.sqrt_sym_mat_np(m), jax_fid.sqrt_sym_mat_np(m), rtol=1e-6,
                               atol=1e-12)
    c1, c2 = np.cov(x.T), np.cov(y.T)
    np.testing.assert_allclose(fid.trace_sqrt_product_np(c1, c2),
                               jax_fid.trace_sqrt_product_np(c1, c2), rtol=1e-6)
    np.testing.assert_allclose(fid.fid_from_activations(x, y),
                               jax_fid.fid_from_activations(x, y), rtol=1e-6)
    stats = list(jax_fid.mean_cov_np(y))
    np.testing.assert_allclose(fid.fid_from_activations(x, stats),
                               jax_fid.fid_from_activations(x, stats), rtol=1e-6)
    logits = rng.randn(100, 10) * 3
    np.testing.assert_allclose(fid.inception_score_from_logits(logits),
                               jax_fid.inception_score_from_logits(logits), rtol=1e-6)


@pytest.mark.parametrize("size,channels", [(180, 3), (177, 1)])
def test_ms_ssim_matches_jax(rng, size, channels):
    """An even size (180: 90, 45, then the odd 45 padded) and an odd one."""
    x = (rng.rand(2, size, size, channels) * 255).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape) * 30, 0, 255).astype(np.float32)
    got = ms_ssim(x, y, max_val=255.0, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ms_ssim(x, y, max_val=255.0)), atol=1e-5)


@pytest.mark.parametrize("size,out", [((16, 16), (37, 29)), ((40, 33), (17, 21))])
def test_resize_bilinear_tf1_matches_jax(rng, size, out):
    x = rng.rand(2, *size, 3).astype(np.float32)
    got = resize_bilinear_tf1(torch.tensor(x), out).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize_tf1(x, out)), atol=1e-6)


@pytest.mark.parametrize("size", [32, 512])
def test_ms_ssim_score_resize_matches_jax(rng, size):
    """The score's resize: 32 -> 256 upsamples (bilinear, half-pixel), 512
    -> 256 shrinks (jax.image.resize's antialiased triangle filter); then
    the scores."""
    x = (images(rng, 2, size) + 1.0) * 128.5
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 256, 256, 3), "linear"))
    np.testing.assert_allclose(resize_linear(torch.tensor(x), 256).numpy(), want, atol=1e-3)
    xs, ys = [images(rng, 2, size)], [images(rng, 2, size)]
    got = GenerativeModelMetric.ms_ssim_score(iter(xs), iter(ys), num_batch=1, device="cpu")
    np.testing.assert_allclose(got, JaxMetric.ms_ssim_score(iter(xs), iter(ys), num_batch=1),
                               atol=1e-5)


def _jax_swd_draws(key, pyr, patch, num_patches, num_dirs):
    """JAX's draws of ``sliced_wasserstein_distance`` per level, made from
    ``key`` as it splits it (``swd.py:52-55,70,98``)."""
    draws = []
    for level in pyr:
        key, k1, k2, k3 = jax.random.split(key, 4)
        n, h, w, c = level.shape

        def index(k):
            a, b, d = jax.random.split(k, 3)
            return tuple(torch.tensor(np.asarray(jax.random.randint(kk, (num_patches,), 0, hi)))
                         for kk, hi in ((a, n), (b, h - patch + 1), (d, w - patch + 1)))

        dirs = jax.random.normal(k3, (patch * patch * c, num_dirs))
        draws.append((index(k1), index(k2), torch.tensor(np.asarray(dirs))))
    return draws


def test_swd_matches_jax_on_its_draws(rng):
    x, y = images(rng, 6, 32), images(rng, 6, 32) * 0.7
    for lj, lt in zip(jax_pyramid(jnp.asarray(x), 3), laplacian_pyramid(torch.tensor(x), 3)):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6)
    key = jax.random.PRNGKey(3)
    kw = dict(num_levels=3, patch=7, num_patches=256, num_dirs=32)
    want = jax_swd(x, y, key=key, **kw)
    draws = _jax_swd_draws(key, jax_pyramid(jnp.asarray(x), 3), 7, 256, 32)
    got = sliced_wasserstein_distance(x, y, draws=draws, device="cpu", **kw)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the port's own draws: deterministic per generator state, finite
    own = [sliced_wasserstein_distance(x, y, generator=torch.Generator().manual_seed(1),
                                       device="cpu", **kw) for _ in range(2)]
    assert own[0] == own[1] and np.isfinite(own[0]).all()


@pytest.mark.parametrize("size", [32, 299])
def test_random_feature_classifier_matches_jax(rng, size):
    """JAX's weights through the port: at 32 the stride-2 SAME convs pad
    0 before and 1 after, at 299 one each side."""
    jclf, clf = bridged_classifiers()
    x = images(rng, 3, size)
    jl, jp = jclf(x)
    tl, tp = clf(x)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-4, atol=1e-5)


def test_pad_same_is_asymmetric_on_even_sizes():
    x = torch.zeros(1, 1, 32, 31)
    assert pad_same(x, 3, 2).shape == (1, 1, 33, 33)   # 32: (0, 1); 31: (1, 1)
    padded = pad_same(torch.ones(1, 1, 4, 4), 3, 2)[0, 0]
    assert padded.sum() == 16 and padded[4].sum() == 0 and padded[:, 4].sum() == 0


def test_generative_model_metric_matches_jax(rng):
    """IS/FID of the JAX metric and the port's with the same classifier
    weights on the same batches (64 pool dims, 128 samples: full rank)."""
    jclf, clf = bridged_classifiers(pool_dim=64, num_logits=10)
    real = [images(rng, 32, 16) * 0.5 for _ in range(4)]
    gen = [images(rng, 32, 16) * 0.5 + 0.3 for _ in range(4)]
    want = JaxMetric(classifier=jclf).inception_score_and_fid(iter(real), iter(gen), 4)
    seconds = {}
    got = GenerativeModelMetric(classifier=clf).inception_score_and_fid(
        iter(real), iter(gen), 4, seconds=seconds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(seconds) == {"data", "generation", "classifier", "fid"}


def test_intra_fid_matches_jax(tmp_path, rng):
    jclf, clf = bridged_classifiers(pool_dim=32, num_logits=10)
    ref = [images(rng, 32, 16) for _ in range(3)]
    gen = [images(rng, 32, 16) * 0.8 for _ in range(3)]
    path = GenerativeModelMetric(classifier=clf).save_ref_stats(iter(ref), 3,
                                                               str(tmp_path / "s.npz"))
    jpath = JaxMetric(classifier=jclf).save_ref_stats(iter(ref), 3, str(tmp_path / "j.npz"))
    for k in ("mean", "cov"):
        np.testing.assert_allclose(np.load(path)[k], np.load(jpath)[k], rtol=1e-4, atol=1e-7)
    got = GenerativeModelMetric(classifier=clf).intra_fid(path, iter(gen), num_batch=3)
    want = JaxMetric(classifier=jclf).intra_fid(jpath, iter(gen), num_batch=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_inception_classifier_raises_for_a_given_graph_that_does_not_load(tmp_path):
    """No fallback hides the device path: a given .pb that fails raises; no
    .pb gives the random features, with the warning."""
    bad = tmp_path / "broken.pb"
    bad.write_bytes(b"\x0a\x05not a graph")
    with pytest.raises(Exception):
        InceptionClassifier(pb_path=str(bad), device="cpu")
    with pytest.raises(FileNotFoundError):
        InceptionClassifier(pb_path=str(tmp_path / "missing.pb"), device="cpu")
    with pytest.warns(UserWarning, match="comparable only between runs of this package"):
        clf = InceptionClassifier(device="cpu")
    assert isinstance(clf, RandomFeatureClassifier) and clf.device.type == "cpu"


def test_classifiers_default_to_cuda():
    if torch.cuda.is_available():
        assert RandomFeatureClassifier().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RandomFeatureClassifier()


# ----------------------------------------------------------------------
# the port's own versions of tests/test_metrics.py
# ----------------------------------------------------------------------
def test_sqrt_sym_mat(rng):
    a = rng.randn(6, 6)
    m = a @ a.T
    r = fid.sqrt_sym_mat_np(m)
    np.testing.assert_allclose(r @ r, m, rtol=1e-5, atol=1e-6)


def test_trace_sqrt_product_vs_scipy(rng):
    from scipy import linalg

    a, b = rng.randn(8, 8), rng.randn(8, 8)
    c1, c2 = a @ a.T, b @ b.T
    expect = np.real(np.trace(linalg.sqrtm(c1 @ c2)))
    np.testing.assert_allclose(fid.trace_sqrt_product_np(c1, c2), expect, rtol=1e-4)


def test_fid_zero_for_identical_and_gaussians(rng):
    x = rng.randn(500, 16)
    assert abs(fid.fid_from_activations(x, x)) < 1e-6
    x = rng.randn(20000, 4)
    y = rng.randn(20000, 4) + np.array([1.0, 0, 0, 0])
    np.testing.assert_allclose(fid.fid_from_activations(x, y), 1.0, atol=0.1)


def test_inception_score_bounds():
    np.testing.assert_allclose(fid.inception_score_from_logits(np.zeros((100, 10))), 1.0,
                               atol=1e-6)
    logits = np.eye(10)[np.arange(100) % 10] * 50.0
    np.testing.assert_allclose(fid.inception_score_from_logits(logits), 10.0, rtol=1e-3)


def test_ms_ssim_identical_is_one_and_noise_lowers_it(rng):
    x = (rng.rand(2, 176, 176, 1) * 255).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape) * 40, 0, 255).astype(np.float32)
    np.testing.assert_allclose(ms_ssim(x, x, device="cpu").numpy(), 1.0, atol=1e-4)
    assert float(ms_ssim(x, y, device="cpu").mean()) < float(ms_ssim(x, x, device="cpu").mean())


def test_random_feature_classifier_is_deterministic(rng):
    imgs = images(rng, 7, 32)
    logits, pool3 = RandomFeatureClassifier(seed=0, device="cpu")(imgs)
    assert logits.shape == (7, 1001) and pool3.shape == (7, 2048)
    again, _ = RandomFeatureClassifier(seed=0, device="cpu")(torch.tensor(imgs))
    assert torch.equal(logits, again)
    gray, _ = RandomFeatureClassifier(seed=0, device="cpu")(imgs[..., :1])
    assert gray.shape == (7, 1001)


def test_generative_model_metric_end_to_end(rng):
    # 256 pool features: the 2048-wide SVDs cost minutes on a loaded host
    metric = GenerativeModelMetric(classifier=RandomFeatureClassifier(
        seed=0, pool_dim=256, device="cpu"))

    def batches(shift):
        while True:
            yield images(rng, 64, 16) * 0.5 + shift

    inc_x, inc_y, fid_xx, fid_xy = metric.inception_score_and_fid(
        batches(0.0), batches(0.3), num_batch=4)
    assert np.isfinite([inc_x, inc_y, fid_xx, fid_xy]).all()
    assert fid_xx < fid_xy


def test_ref_stats_and_intra_fid(tmp_path, rng):
    metric = GenerativeModelMetric(classifier=RandomFeatureClassifier(
        seed=0, pool_dim=256, device="cpu"))

    def batches():
        while True:
            yield images(rng, 32, 16)

    path = metric.save_ref_stats(batches(), 4, str(tmp_path / "stats.npz"))
    value = metric.intra_fid(path, batches(), num_batch=4)
    assert np.isfinite(value) and value < 50
