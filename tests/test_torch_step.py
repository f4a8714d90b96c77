"""The port's train step against the JAX package's, plus the port's
import isolation, its device rule and one full-width step on the CPU.

Parity: a narrow cifar-like architecture (the same layer kinds at 1/8 of
the channels, 16x16 images, B=8), float32 on both sides, the JAX side at
``use_pallas=True`` (Pallas in interpret mode). The JAX state after two
JAX steps (past the degenerate step 0, where every D layer is scaled
towards zero by the unnormalized initial power vectors) is bridged over;
then both sides run three steps on the same data and the same z, JAX's
own draw replayed from its key splits (``train/step.py:92-93``,
``models/sngan.py:182-184``) and fed to the port through ``code_batch``.

Tolerances: losses and kernel means rtol 1e-5 / atol 1e-6 (the losses are
differences of O(1) means, so their error is the means' absolute one);
gradient norms rtol 1e-4; parameters, SN vectors, BN statistics and Adam
moments rtol 1e-4 / atol 1e-6, the float32 drift of three steps of two
frameworks summing in different orders.

One parameter is held to a bound instead: the bias of the score layer
(``dis/l8_s``). The MMD losses depend on the scores only through their
pairwise distances, which a common shift leaves unchanged, so its true
gradient is 0; both sides compute ~1e-9 of rounding noise, and Adam
turns that noise into steps of about the learning rate in either
direction. Its Adam moments stay within the atol like the others.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.ops.pallas_mmd import fused_kernel_means as jax_fused_kernel_means
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch.architectures import cifar_architecture
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops.cuda_mmd import MEAN_KEYS
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.train.step import build_multi_step, build_train_step, init_train_state
from mmdgan_torch.ops.losses import LossState
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
B, IMG = 8, 16
ACT_K = float(np.power(64.0, 0.125))


def _d(name, out, **kw):
    return {"name": name, "out": out, "act": "lrelu", "act_k": ACT_K, "w_nm": "s", **kw}


NARROW = {
    "input": [(3, IMG, IMG)],
    "code": [(128, "linear")],
    "generator": [
        {"name": "l1", "out": 64 * 2 * 2, "op": "d", "act": "linear",
         "act_nm": None, "out_reshape": [64, 2, 2]},
        {"name": "l2_up", "out": 32, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3_up", "out": 16, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l4_up", "out": 8, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l5_t16", "out": 3, "act": "tanh"},
    ],
    "discriminator": [
        _d("l1_f16", 8), _d("l2_ds", 16, kernel=4, strides=2), _d("l3", 16),
        _d("l4_ds", 32, kernel=4, strides=2), _d("l5", 32),
        _d("l6_ds", 64, kernel=4, strides=2),
        _d("l7", 64, op="c", out_reshape=[2 * 2 * 64]),
        {"name": "l8_s", "out": 16, "op": "d", "act_k": ACT_K, "bias": "b", "w_nm": "s"},
    ],
}


@functools.lru_cache(maxsize=1)
def _jax_means_fn():
    """JAX's kernel means at a state, for a given batch and z: the JAX
    step at use_pallas=True does not surface them. The loss type does not
    enter, so one compile serves both parametrizations."""
    jmodel = JaxSNGan(NARROW, compute_dtype=jnp.float32, use_pallas=True)

    def means(params, net_state, x, z):
        gen_out, _, _ = jmodel.gen_stage(params["gen"], net_state, None, {"x": x},
                                         train=True, code_batch={"x": z, "y": None})
        dis_in = {"x": jnp.concatenate([x, gen_out["x"]], axis=0), "y": None}
        out, _ = jmodel.Dis.apply(params["dis"], net_state["dis"], dis_in, train=True)
        s_x, s_gen = jnp.split(out["x"], 2, axis=0)
        return jax_fused_kernel_means(s_gen, s_x, 1.0)

    return jax.jit(means)


@functools.lru_cache(maxsize=1)
def _jax_initial_state():
    """The JAX TrainState at PRNGKey(0); the loss type does not enter."""
    jmodel = JaxSNGan(NARROW, compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    return jax.jit(lambda k: jax_init_train_state(jmodel, k, jopt_d, jopt_g))(
        jax.random.PRNGKey(0))


def _replayed_z(rng_key, code_size):
    _, rng_step = jax.random.split(rng_key)
    rng_code, _, _ = jax.random.split(rng_step, 3)
    rng_x, _ = jax.random.split(rng_code)
    return jax.random.normal(rng_x, (B, code_size))


def _bridged(model, jts):
    jts = jax.device_get(jts)
    params, net_state, (opt_d, opt_g) = jax_params_to_torch(
        model, jts.params, jts.net_state, (jts.opt_state_dis, jts.opt_state_gen))
    return params, net_state, opt_d, opt_g


def _three_steps(loss_type, use_pallas):
    """Two JAX steps from init, the state bridged (the loss state too),
    then three steps on each side on the same data and z, compared after
    each step."""
    jmodel = JaxSNGan(NARROW, loss_type=loss_type, compute_dtype=jnp.float32,
                      use_pallas=use_pallas)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jts = _jax_initial_state()
    jstep = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    jmeans = _jax_means_fn() if use_pallas else None
    on = jnp.asarray(True)
    data = np.random.RandomState(1).randn(5, B, IMG, IMG, 3).clip(-1, 1).astype(np.float32)
    for i in range(2):
        jts, _ = jstep(jts, {"x": jnp.asarray(data[i]), "y": None}, on, on)

    model = SNGan(NARROW, loss_type=loss_type, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    params, net_state, od_state, og_state = _bridged(model, jts)
    *_, loss_state = jax_params_to_torch(model, {}, {}, loss_state=jax.device_get(jts.loss_state))
    ts = TrainState(params=params, net_state=net_state, loss_state=loss_state,
                    opt_state_dis=od_state, opt_state_gen=og_state, step=2,
                    rng=torch.Generator())
    step = build_train_step(model, opt_d, opt_g, device="cpu")

    for i in range(2, 5):
        x = jnp.asarray(data[i])
        z = _replayed_z(jts.rng, model.code_size)
        want_means = np.asarray(jmeans(jts.params, jts.net_state, x, z)) if use_pallas else None
        jts, jm = jstep(jts, {"x": x, "y": None}, on, on)
        ts, m = step(ts, {"x": data[i]}, code_batch={"x": np.asarray(z)})

        if use_pallas:   # JAX's Pallas path surfaces no kernel means
            keys = ("loss_gen", "loss_dis", "s_x_mean", "s_gen_mean", "x_gen_abs_mean",
                    "grad_norm_dis", "grad_norm_gen")
            means = MEAN_KEYS if loss_type == "rmb" else MEAN_KEYS[:3]
            for j, k in enumerate(means):
                np.testing.assert_allclose(m[k].item(), want_means[j], **LOSS_TOL, err_msg=k)
        else:
            keys = tuple(jm)
            assert set(m) == set(jm)
        for k in keys:
            tol = dict(rtol=1e-4) if k.startswith("grad_norm") else LOSS_TOL
            np.testing.assert_allclose(m[k].item(), float(jm[k]), **tol, err_msg=k)

        params, net_state, od_state, og_state = _bridged(model, jts)
        # the shift-invariant score bias: one noise-driven Adam step per
        # side since the two were last made equal
        got_b = ts.params["dis"]["dis/l8_s"]["bias"]["bias"].detach()
        want_b = params["dis"]["dis/l8_s"]["bias"]["bias"]
        assert float((got_b - want_b).abs().max()) <= 2 * 2 * opt_d.lr
        got_b.copy_(want_b)   # nothing else depends on it
        for name, got, want in (("params", ts.params, params),
                                ("net_state", ts.net_state, net_state),
                                ("mu_dis", ts.opt_state_dis.mu, od_state.mu),
                                ("nu_dis", ts.opt_state_dis.nu, od_state.nu),
                                ("mu_gen", ts.opt_state_gen.mu, og_state.mu),
                                ("nu_gen", ts.opt_state_gen.nu, og_state.nu)):
            got, want = tree_leaves(got), tree_leaves(want)
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **STATE_TOL,
                                           err_msg=f"{name} after step {i}")
        for name in ("loss_average", "mix_prob", "ins_sigma"):
            np.testing.assert_allclose(getattr(ts.loss_state, name).item(),
                                       float(getattr(jts.loss_state, name)), **LOSS_TOL)
        assert int(ts.opt_state_dis.count) == int(od_state.count) == i + 1
        assert int(ts.opt_state_gen.count) == int(og_state.count) == i + 1
        assert int(ts.step) == i + 1


@pytest.mark.parametrize("loss_type", ["rep", "rmb"])
def test_step_matches_jax_over_three_steps(loss_type):
    _three_steps(loss_type, use_pallas=True)


@pytest.mark.parametrize("loss_type", ["hinge", "mmd_t", "cramer", "mgb", "rep_ds", "rmb_ds"])
def test_step_matches_jax_over_three_steps_drawless_losses(loss_type):
    """The losses that draw nothing inside the loss, the JAX side on its
    plain path (every aux key in its metrics): every metric the JAX step
    returns, the state after each step, with rep_ds / rmb_ds taking their
    Jacobian scale (second order) on both sides."""
    _three_steps(loss_type, use_pallas=False)


@pytest.mark.parametrize("loss_type", ["rep_gp", "wasserstein", "rand_g", "mmd_g_mix",
                                       "instance_noise"])
def test_drawing_losses_run_a_window(loss_type):
    """The losses that draw (omega, the coin, the noise, the penalty's
    interpolation weights) from the state's generator: a K=3 window with
    ``capture=False`` from init ends finite, with the loss state moved
    where the loss has one."""
    model = SNGan(NARROW, loss_type=loss_type, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    multi = build_multi_step(model, opt_d, opt_g, 3, device="cpu", capture=False)
    x = np.random.RandomState(3).randn(3, B, IMG, IMG, 3).clip(-1, 1).astype(np.float32)
    ts, m = multi(ts, {"x": x})
    for k, v in m.items():
        assert v.shape[0] == 3 and torch.isfinite(v).all(), k
    assert all(torch.isfinite(t.float()).all() for t in ts.tensors())
    if loss_type in ("mmd_g_mix", "instance_noise"):
        assert float(ts.loss_state.loss_average) != 0.0
        assert torch.equal(m["state/loss_average"][-1], ts.loss_state.loss_average)
    if loss_type in ("rep_gp", "wasserstein"):
        assert (m["dis_penalty"] > 0).all()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without loading jax, optax, mmdgan_tpu, experiments or the
    JAX package's tools."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmdgan_torch\n"
        "for m in pkgutil.walk_packages(mmdgan_torch.__path__, 'mmdgan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'mmdgan_tpu', 'experiments', 'tools'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('mmdgan_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 27


def test_chip_smoke_phase_selection_and_no_gpu_exit():
    """``chip_smoke.py --phases``: every phase by default, phase 3 always
    (the kernels line needs it), unknown phases refused; without a GPU the
    script exits non-zero and prints no result."""
    import chip_smoke

    assert chip_smoke.parse_phases([]) == set(range(3, 18))
    assert chip_smoke.parse_phases(["--phases", "3,16"]) == {3, 16}
    assert chip_smoke.parse_phases(["--phases", "15"]) == {3, 15}
    assert chip_smoke.parse_phases(["--phases", "17"]) == {3, 17}
    for bad in (["--phases", "2,16"], ["--phases", "18"], ["--phase", "3"]):
        with pytest.raises(SystemExit):
            chip_smoke.parse_phases(bad)
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "3,16"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "is_available" in out.stderr


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SNGan(NARROW)
    model = SNGan(NARROW, device="cpu")
    for build in (lambda d: build_train_step(model, opt_d, opt_g, device=d),
                  lambda d: build_multi_step(model, opt_d, opt_g, 2, device=d),
                  lambda d: init_train_state(model, 0, opt_d, opt_g, device=d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
        build("cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_width_cifar_step_on_cpu(dtype):
    """The full cifar architecture (9,795,667 parameters) through two port
    steps at B=4 on the CPU: finite losses and kernel means, and every
    parameter tensor changed by the second step (the first is degenerate)."""
    model = SNGan(cifar_architecture(), loss_type="rmb", device="cpu",
                  compute_dtype=getattr(torch, dtype))
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    assert sum(p.numel() for p in tree_leaves(ts.params)) == 9795667
    multi = build_multi_step(model, opt_d, opt_g, 2, device="cpu")
    x = np.random.RandomState(0).randn(2, 4, 32, 32, 3).clip(-1, 1).astype(np.float32)
    before = [p.detach().clone() for p in tree_leaves(ts.params)]
    ts, m = multi(ts, {"x": x})
    for k, v in m.items():
        assert v.shape == (2,) and torch.isfinite(v).all(), k
    assert int(ts.step) == 2 and int(ts.opt_state_dis.count) == 2
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(ts.params)))
    images = model.generate(ts.params, ts.net_state, torch.Generator().manual_seed(0), 3)
    assert images.shape == (3, 32, 32, 3) and images.abs().max() <= 1.0


@pytest.mark.parametrize("do_dis,do_gen", [(False, True), (True, False)])
def test_gated_update_leaves_the_other_net_untouched(do_dis, do_gen):
    """A gated-off net keeps its parameters and Adam slots bit for bit
    (``train/step.py:60-74``); SN and BN state move every step. The batch
    is uint8, decoded on the device to [-1, 1]."""
    model = SNGan(NARROW, device="cpu", compute_dtype=torch.float32)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    step = build_train_step(model, opt_d, opt_g, device="cpu")
    x = np.random.RandomState(2).randint(0, 256, (2, B, IMG, IMG, 3)).astype(np.uint8)
    ts, _ = step(ts, {"x": x[0]})   # move past the degenerate step 0
    snap = lambda t: [v.detach().clone() for v in tree_leaves(t)]
    before = {net: (snap(ts.params[net]), snap(getattr(ts, f"opt_state_{net}").mu))
              for net in ("dis", "gen")}
    sn_before = snap(ts.net_state)
    ts, m = step(ts, {"x": x[1]}, do_dis=do_dis, do_gen=do_gen)
    assert torch.isfinite(m["loss_dis"])
    for net, on in (("dis", do_dis), ("gen", do_gen)):
        params, mu = snap(ts.params[net]), snap(getattr(ts, f"opt_state_{net}").mu)
        same = all(torch.equal(a, b) for a, b in zip(before[net][0] + before[net][1],
                                                      params + mu))
        assert same != on, net
        assert int(getattr(ts, f"opt_state_{net}").count) == (2 if on else 1)
    assert not all(torch.equal(a, b) for a, b in zip(sn_before, snap(ts.net_state)))
