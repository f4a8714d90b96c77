"""The port's accumulated step (``build_grad_accum_step``) against the JAX
package's, against the port's fused step, inside the device-data window
and inside the ``Agent``'s K-step windows.

JAX parity: a tiny model with BN in the generator, float32 on both
sides, from the JAX state after two fused 'rmb' steps (step 0 is
degenerate) bridged over; one accumulated step on each side at M in
{1, 2, 4} for every loss whose step the accumulation changes (the
penalised ones in ``test_torch_accum_penalty.py``). The port
is fed JAX's z and the penalty's interpolation weights, replayed from
the key splits of ``mmdgan_tpu/train/step.py:231-242,291``. The score
layer has no bias: its true gradient is 0, and Adam would turn two
frameworks' rounding noise into different steps of the learning rate
(``test_torch_step.py`` says more). Tolerances: losses rtol 1e-5 /
atol 1e-6; parameters, BN statistics, SN vectors and Adam moments rtol
1e-4 / atol 1e-6.

Port against port: on a BN-free model the accumulated step equals the
fused one up to summation order (BN normalises each micro-batch by its
own statistics, so with BN the two differ by design).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_grad_accum_step as jax_build_grad_accum_step
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.train.step import (
    build_device_data_step,
    build_grad_accum_step,
    build_train_step,
    init_train_state,
)
from mmdgan_torch.train.trainer import Agent
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
B = 16

# test_train.py's tiny model: BN in G; 4x4 stride-2 convs (the port takes
# symmetric SAME padding only); no score bias
BN_ARCH = {
    "input": [(1, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "linear",
         "act_nm": None, "out_reshape": [8, 4, 4]},
        {"name": "l2", "out": 4, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 1, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2, "out_reshape": [4 * 4 * 8]},
        {"name": "l2", "out": 4, "op": "d", "w_nm": "s", "bias": None},
    ],
}
BN_FREE_ARCH = copy.deepcopy(BN_ARCH)
BN_FREE_ARCH["generator"][1]["act_nm"] = None


@functools.lru_cache(maxsize=1)
def _jax_start():
    """The JAX state after two fused 'rmb' steps from PRNGKey(0)."""
    jmodel = JaxSNGan(BN_ARCH, loss_type="rmb", compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jts = jax.jit(lambda key: jax_init_train_state(jmodel, key, jopt_d, jopt_g))(
        jax.random.PRNGKey(0))
    step = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    on = jnp.asarray(True)
    warm = np.random.RandomState(1).randn(2, B, 8, 8, 1).clip(-1, 1).astype(np.float32)
    for i in range(2):
        jts, _ = step(jts, {"x": jnp.asarray(warm[i]), "y": None}, on, on)
    return jts


def _replayed_draws(jts, code_size):
    """JAX's z and penalty weights of the step from ``jts``: its key splits."""
    _, rng_step = jax.random.split(jts.rng)
    rng_code, _, rng_gp = jax.random.split(rng_step, 3)
    z = jax.random.normal(jax.random.split(rng_code)[0], (B, code_size))
    return np.array(z), np.array(jax.random.uniform(rng_gp, (B, 1, 1, 1)))


def _bridged_state(model, jts):
    jts = jax.device_get(jts)
    params, net_state, (od, og), loss_state = jax_params_to_torch(
        model, jts.params, jts.net_state, (jts.opt_state_dis, jts.opt_state_gen),
        loss_state=jts.loss_state)
    return TrainState(params=params, net_state=net_state, loss_state=loss_state,
                      opt_state_dis=od, opt_state_gen=og, step=int(jts.step),
                      rng=torch.Generator())


def check_against_jax(loss_type: str, micro: int) -> None:
    """One accumulated step on each side from the bridged JAX state."""
    jts = _jax_start()
    jmodel = JaxSNGan(BN_ARCH, loss_type=loss_type, compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jstep = jax.jit(jax_build_grad_accum_step(jmodel, jopt_d, jopt_g, micro))
    model = SNGan(BN_ARCH, loss_type=loss_type, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = _bridged_state(model, jts)
    step = build_grad_accum_step(model, opt_d, opt_g, micro, device="cpu")

    x = np.random.RandomState(2).randn(B, 8, 8, 1).clip(-1, 1).astype(np.float32)
    z, uni = _replayed_draws(jts, model.code_size)
    on = jnp.asarray(True)
    jts, jm = jstep(jts, {"x": jnp.asarray(x), "y": None}, on, on)
    ts, m = step(ts, {"x": x}, code_batch={"x": z}, uni=uni)

    assert set(m) == set(jm)
    for k in jm:
        tol = dict(rtol=1e-4) if k.startswith("grad_norm") else LOSS_TOL
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **tol, err_msg=k)
    want = _bridged_state(model, jts)
    for name in ("params", "net_state"):
        for g, w in zip(tree_leaves(getattr(ts, name)), tree_leaves(getattr(want, name))):
            np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), **STATE_TOL,
                                       err_msg=name)
    for net in ("dis", "gen"):
        got, exp = getattr(ts, f"opt_state_{net}"), getattr(want, f"opt_state_{net}")
        for g, w in zip(tree_leaves(got.mu) + tree_leaves(got.nu),
                        tree_leaves(exp.mu) + tree_leaves(exp.nu)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **STATE_TOL, err_msg=net)
        assert int(got.count) == int(exp.count) == 3
    assert int(ts.step) == int(jts.step) == 3


@pytest.mark.parametrize("micro", [1, 2, 4])
@pytest.mark.parametrize("loss_type", ["rep", "rmb", "wasserstein"])
def test_accum_step_matches_jax(loss_type, micro):
    check_against_jax(loss_type, micro)


def _run(arch, loss_type, micro, steps=3):
    """``steps`` port steps from the state of seed 0 on seeded batches; the
    fused step when ``micro`` is None."""
    model = SNGan(arch, loss_type=loss_type, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    step = (build_train_step(model, opt_d, opt_g, device="cpu") if micro is None else
            build_grad_accum_step(model, opt_d, opt_g, micro, device="cpu"))
    x = np.random.RandomState(0).randn(steps, B, 8, 8, 1).clip(-1, 1).astype(np.float32)
    for k in range(steps):
        ts, m = step(ts, {"x": x[k]})
    return ts, m


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("loss_type", ["rep", "rmb_gp", "wasserstein", "rmb_ds", "mmd_g_mix"])
def test_accum_equals_fused_without_bn(loss_type, micro):
    """Three steps, the draws (z, the loss's coin, the penalty's weights)
    made inside both steps from the state's generator in the same order."""
    (ts_a, m_a), (ts_f, m_f) = _run(BN_FREE_ARCH, loss_type, micro), _run(BN_FREE_ARCH,
                                                                          loss_type, None)
    assert list(m_a) == list(m_f)
    for k in m_f:
        np.testing.assert_allclose(m_a[k].numpy(), m_f[k].numpy(), **LOSS_TOL, err_msg=k)
    for a, f in zip(ts_a.tensors(), ts_f.tensors()):
        np.testing.assert_allclose(a.detach().numpy(), f.detach().numpy(), **STATE_TOL)
    assert torch.equal(ts_a.rng.get_state(), ts_f.rng.get_state())


def test_accum_with_bn_normalises_each_micro_batch():
    """With BN the micro-batches are normalised apart: at M=1 the step is
    the fused one; at M=4 the moving mean still takes the batch's mean
    (the average of the micro means) and the moving variance the average
    of the micro variances, which is below the batch's."""
    (ts1, m1), (ts4, _), (tsf, mf) = (_run(BN_ARCH, "rep", 1, 1), _run(BN_ARCH, "rep", 4, 1),
                                      _run(BN_ARCH, "rep", None, 1))
    np.testing.assert_allclose(m1["loss_gen"].numpy(), mf["loss_gen"].numpy(), **LOSS_TOL)
    bn = lambda ts: ts.net_state["gen"]["gen/l2"]["BN"]
    np.testing.assert_allclose(bn(ts4)["moving_mean"].numpy(), bn(tsf)["moving_mean"].numpy(),
                               rtol=1e-5, atol=1e-7)
    var4, var = bn(ts4)["moving_var"], bn(tsf)["moving_var"]
    assert (var - var4 > 1e-6).all(), (var - var4)


def test_accum_refuses_a_batch_that_does_not_split():
    model = SNGan(BN_FREE_ARCH, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        build_grad_accum_step(model, opt_d, opt_g, 3, device="cpu")(
            ts, {"x": np.zeros((B, 8, 8, 1), np.float32)})
    with pytest.raises(ValueError, match="micro_batches"):
        build_grad_accum_step(model, opt_d, opt_g, 0, device="cpu")


@pytest.mark.parametrize("sampling", ["uniform", "shuffled_epochs"])
def test_device_data_step_micro_batches_equals_fused(sampling):
    """``build_device_data_step(micro_batches=2)`` against ``micro_batches=1``
    on a BN-free model (``test_train.py:878-911``): the sampler sits outside
    the step, so both windows gather the same batches and draw the same z."""
    data = torch.tensor(np.random.RandomState(0).randint(0, 256, (64, 8, 8, 1), np.uint8))

    def run(micro):
        model = SNGan(BN_FREE_ARCH, compute_dtype=torch.float32, device="cpu")
        opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
        ts = init_train_state(model, 3, opt_d, opt_g, device="cpu")
        fn = build_device_data_step(model, opt_d, opt_g, 3, B, sampling=sampling,
                                    micro_batches=micro, device="cpu")
        ts, m = fn(ts, data, None, torch.Generator().manual_seed(5))
        return m["loss_gen"].numpy(), [p.detach().numpy() for p in tree_leaves(ts.params)]

    (lg1, p1), (lg2, p2) = run(1), run(2)
    np.testing.assert_allclose(lg2, lg1, rtol=1e-4)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_accum_step_in_agent_windows(tmp_path):
    """The accumulated step in ``Agent.train``'s K=4 windows
    (``test_train.py:850-876``): 8 steps, finite parameters."""
    model = SNGan(BN_FREE_ARCH, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    rng = np.random.RandomState(0)

    def batches():
        while True:
            yield {"x": rng.randn(B, 8, 8, 1).astype(np.float32), "y": None}

    agent = Agent("accumscan", "t", output_dir=str(tmp_path), do_save=False,
                  use_tensorboard=False, query_step=100)
    ts = agent.train(build_grad_accum_step(model, opt_d, opt_g, 2, device="cpu"), ts,
                     batches(), max_step=8, step_per_epoch=4, steps_per_call=4)
    assert int(ts.step) == 8 and int(ts.opt_state_dis.count) == 8
    assert all(torch.isfinite(p).all() for p in tree_leaves(ts.params))
