"""The port's ``SimData`` against the JAX package's, and the learning test
of ``tests/test_integration.py`` on the port.

Draws are bitwise equal (both draw from ``RandomState(seed)`` in one
order); ``log_prob`` and ``prob`` equal to rtol 1e-6 (the same float64
formulas). ``test_rep_gan_fits_gaussian`` is the counterpart of
``test_integration.py::test_rep_gan_fits_gaussian`` with its recipe
(the dense ARCH, SimData 'normal' mu [0.5, -0.3] std [0.4, 0.2], batch
128, Adam [2e-3, 1e-3], 800 steps) and its asserts: the MMD to the target
below 0.7 of its start, the generated mean within 0.25 of mu.
"""

import time

import numpy as np
import pytest
import torch

from mmdgan_tpu.data.simdata import SimData as JaxSimData
from mmdgan_torch.data.simdata import SimData
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops.distance import get_squared_dist
from mmdgan_torch.ops.kernels import mixture_mmd_g
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.step import build_multi_step, init_train_state

torch.set_num_threads(1)

CASES = {
    "normal": dict(method="normal", mu=[0.5, -0.3], std_or_cov=[0.4, 0.2]),
    "normal_cov": dict(method="gaussian", mu=[0.1, 0.2, 0.3],
                       std_or_cov=[[1.0, 0.2, 0.0], [0.2, 0.5, 0.1], [0.0, 0.1, 0.3]]),
    "gm": dict(method="gm", probs=[1, 2, 3], mu=[[0, 0], [1, 1], [-1, 2]],
               std_or_cov=[[0.1, 0.2], [0.3, 0.1], [0.2, 0.2]]),
    "gm_cov": dict(method="gaussian_mixture", probs=[0.5, 0.5], mu=[[0, 0], [2, 2]],
                   std_or_cov=[[[0.1, 0.0], [0.0, 0.2]], [[0.3, 0.1], [0.1, 0.3]]]),
    "shell": dict(method="shell"),
    "shell2": dict(method="shell2"),
    "star": dict(method="star"),
    "uniform": dict(method="uniform", low=-1.0, high=2.0, x_dof=3),
    "shell_projected": dict(method="shell", x_dof=5, z_dof=2),
    "uniform_projected": dict(method="uni", x_dof=6, z_dof=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_draws_and_densities_match_jax(case):
    got, want = SimData(batch_size=32, seed=4, **CASES[case]), JaxSimData(
        batch_size=32, seed=4, **CASES[case])
    if want.w is not None:
        np.testing.assert_array_equal(got.w, want.w)
    for n in (None, 7, 100):
        a, b = got.next_batch(n), want.next_batch(n)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got(5), want(5))
    if got.w is None:   # densities live in the unprojected space
        x = np.concatenate([got(50), np.random.RandomState(1).randn(10, got(1).shape[1]) * 3])
        np.testing.assert_allclose(got.log_prob(x), want.log_prob(x), rtol=1e-6)
        np.testing.assert_allclose(got.prob(x), want.prob(x), rtol=1e-6, atol=1e-300)


def test_unknown_method_raises():
    with pytest.raises(NotImplementedError):
        SimData("spiral")


# 2-D data as 1x1 'images' with 2 channels (tests/test_integration.py:17-36)
ARCH = {
    "input": [(2, 1, 1)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 32, "op": "d", "act": "relu", "act_nm": None,
         "in_reshape": [8]},
        {"name": "l2", "out": 32, "op": "d", "act": "relu"},
        {"name": "l3", "out": 2, "op": "d", "act": "linear", "out_reshape": [2, 1, 1]},
    ],
    "discriminator": [
        {"name": "l1", "out": 32, "op": "d", "act": "lrelu", "w_nm": "s", "act_k": 2.0,
         "in_reshape": [2]},
        {"name": "l2", "out": 32, "op": "d", "act": "lrelu", "w_nm": "s", "act_k": 2.0},
        {"name": "l3", "out": 8, "op": "d", "w_nm": "s", "act_k": 2.0},
    ],
}


def mmd_to_target(samples: torch.Tensor, target: torch.Tensor) -> float:
    d_gg, d_gt, d_tt = get_squared_dist(samples, target, mode="xxxyyy")
    return float(mixture_mmd_g(d_gg, d_gt, d_tt, samples.shape[0], sigma=[0.1, 0.5, 1.0]))


def fit_gaussian(device="cpu", steps=800, k=16):
    """The recipe of ``test_rep_gan_fits_gaussian`` on the port, ``k`` steps
    per window; returns (mmd before, mmd after, generated mean, seconds)."""
    sim = SimData("normal", mu=[0.5, -0.3], std_or_cov=[0.4, 0.2], batch_size=128, seed=1)
    model = SNGan(ARCH, loss_type="rep", compute_dtype=torch.float32, device=device)
    opt_d, opt_g = multi_opt_config([2e-3, 1e-3])
    ts = init_train_state(model, 0, opt_d, opt_g, device=device)
    step = build_multi_step(model, opt_d, opt_g, k, device=device)

    def gen_samples(n=256):
        x = model.generate(ts.params, ts.net_state, torch.Generator(device).manual_seed(123),
                           n, clip=False)
        return x.reshape(n, 2)

    target = torch.tensor(sim(512), device=device)
    before = mmd_to_target(gen_samples(), target)
    start = time.perf_counter()
    for _ in range(steps // k):
        ts, _ = step(ts, {"x": np.stack([sim(128).reshape(128, 1, 1, 2) for _ in range(k)])})
    samples = gen_samples()
    return (before, mmd_to_target(samples, target), samples.mean(0).cpu().numpy(),
            time.perf_counter() - start)


def test_rep_gan_fits_gaussian():
    before, after, mean, seconds = fit_gaussian()
    assert np.isfinite(after)
    assert after < 0.7 * before, (before, after)
    np.testing.assert_allclose(mean, [0.5, -0.3], atol=0.25)
    print(f"800 steps in {seconds:.1f} s on the CPU; MMD {before:.4f} -> {after:.4f}")
