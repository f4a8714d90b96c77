"""The JAX-checkpoint import (``utils/checkpoint.py`` ``import_jax_state``)
and the port's checkpoint inspection (``print_tensor_in_ckpt``,
``rollback``).

The import's recipe, end to end: a JAX ``Agent`` writes an orbax
checkpoint (a narrow float32 rep model after two steps, past the
degenerate step 0); JAX's ``rollback`` restores it and ``jax.device_get``
makes it numpy; ``import_jax_state`` writes ``ckpt-2.pt``; a port ``Agent``
restores it into a state of its own; then both sides run four more steps
on the same data and JAX's z (replayed from its key, as in
``test_torch_step.py``). The bounds are ``test_torch_step.py``'s: losses
rtol 1e-5 / atol 1e-6, gradient norms rtol 1e-4, parameters, SN/BN state
and Adam moments rtol 1e-4 / atol 1e-6; the score layer's bias, whose true
gradient is 0, within 2 x 2 x lr per step of each side (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_tpu.train.trainer import Agent as JaxAgent
from mmdgan_tpu.utils.checkpoint import rollback as jax_rollback
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import tree_leaves
from mmdgan_torch.train.step import build_train_step, init_train_state
from mmdgan_torch.train.trainer import Agent
from mmdgan_torch.utils import checkpoint
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
B, IMG, STEPS = 8, 16, 4
ACT_K = float(np.power(64.0, 0.125))


def _d(name, out, **kw):
    return {"name": name, "out": out, "act": "lrelu", "act_k": ACT_K, "w_nm": "s", **kw}


NARROW = {   # test_torch_step.py's: the CIFAR layer kinds at 1/8 of the channels, 16x16
    "input": [(3, IMG, IMG)],
    "code": [(128, "linear")],
    "generator": [
        {"name": "l1", "out": 64 * 2 * 2, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [64, 2, 2]},
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
BIAS = ("dis", "dis/l8_s", "bias", "bias")


def _replayed_z(rng_key, code_size):
    _, rng_step = jax.random.split(rng_key)
    rng_code, _, _ = jax.random.split(rng_step, 3)
    rng_x, _ = jax.random.split(rng_code)
    return jax.random.normal(rng_x, (B, code_size))


def _bias(params):
    net, scope, op, name = BIAS
    return params[net][scope][op][name]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX steps, the orbax checkpoint a JAX Agent writes, and the state
    JAX's rollback restores from it, as numpy."""
    out = tmp_path_factory.mktemp("jax_run")
    jmodel = JaxSNGan(NARROW, loss_type="rep", compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jts = jax.jit(lambda k: jax_init_train_state(jmodel, k, jopt_d, jopt_g))(
        jax.random.PRNGKey(0))
    jstep = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    data = np.random.RandomState(1).randn(2 + STEPS, B, IMG, IMG, 3).clip(-1, 1).astype(
        np.float32)
    on = jnp.asarray(True)
    for i in range(2):
        jts, _ = jstep(jts, {"x": jnp.asarray(data[i]), "y": None}, on, on)
    agent = JaxAgent("jaxrun", "rep", output_dir=str(out), use_tensorboard=False,
                     handle_preemption=False)
    agent.save(jts)
    agent._ckpt_manager().wait_until_finished()
    restored, step = jax_rollback(jts, agent.ckpt_folder)
    host = jax.device_get(restored)
    return dict(jmodel=jmodel, jstep=jstep, jts=jts, host=host, step=step, data=data,
                out=out)


def test_import_resumes_and_matches_jax(jax_run, tmp_path):
    host, data = jax_run["host"], jax_run["data"]
    assert jax_run["step"] == 2 and int(host.step) == 2
    model = SNGan(NARROW, loss_type="rep", compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    agent = Agent("port", "rep", output_dir=str(tmp_path), use_tensorboard=False,
                  handle_preemption=False)
    path = checkpoint.import_jax_state(model, host, agent.ckpt_folder)
    assert path.endswith("ckpt-2.pt") and checkpoint.get_ckpt(agent.ckpt_folder) == 2

    saved = torch.load(path, weights_only=True)
    assert "rng" not in saved and int(saved["rng_seed"]) == 0   # fits a generator anywhere
    ts = agent.restore(init_train_state(model, 5, opt_d, opt_g, device="cpu"))
    assert int(ts.step) == 2 and ts.rng.initial_seed() == 0
    want_p, want_s, (want_od, want_og), want_l = jax_params_to_torch(
        model, host.params, host.net_state, (host.opt_state_dis, host.opt_state_gen),
        loss_state=host.loss_state)
    for got, want in ((ts.params, want_p), (ts.net_state, want_s), (ts.opt_state_dis.mu,
                      want_od.mu), (ts.opt_state_gen.nu, want_og.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g.detach(), w)
    assert int(ts.opt_state_dis.count) == int(ts.opt_state_gen.count) == 2
    for name in ("loss_average", "mix_prob", "ins_sigma"):
        assert torch.equal(getattr(ts.loss_state, name), getattr(want_l, name))

    step = build_train_step(model, opt_d, opt_g, device="cpu")
    jts, jstep, on = jax_run["jts"], jax_run["jstep"], jnp.asarray(True)
    for i in range(2, 2 + STEPS):
        z = _replayed_z(jts.rng, model.code_size)
        jts, jm = jstep(jts, {"x": jnp.asarray(data[i]), "y": None}, on, on)
        ts, m = step(ts, {"x": data[i]}, code_batch={"x": np.asarray(z)})
        for k in ("loss_gen", "loss_dis", "x_gen_abs_mean", "grad_norm_dis", "grad_norm_gen"):
            tol = dict(rtol=1e-4) if k.startswith("grad_norm") else LOSS_TOL
            np.testing.assert_allclose(m[k].item(), float(jm[k]), **tol,
                                       err_msg=f"{k} at step {i}")

    host = jax.device_get(jts)
    params, net_state, (od, og) = jax_params_to_torch(
        model, host.params, host.net_state, (host.opt_state_dis, host.opt_state_gen))
    got_b = _bias(ts.params).detach()
    assert float((got_b - _bias(params)).abs().max()) <= 2 * 2 * opt_d.lr * STEPS
    got_b.copy_(_bias(params))   # nothing else depends on it
    for name, got, want in (("params", ts.params, params), ("net_state", ts.net_state, net_state),
                            ("mu_dis", ts.opt_state_dis.mu, od.mu),
                            ("nu_dis", ts.opt_state_dis.nu, od.nu),
                            ("mu_gen", ts.opt_state_gen.mu, og.mu),
                            ("nu_gen", ts.opt_state_gen.nu, og.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **STATE_TOL, err_msg=name)
    assert int(ts.step) == int(host.step) == 2 + STEPS


def _port_checkpoints(tmp_path):
    model = SNGan(NARROW, loss_type="rep", compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    step = build_train_step(model, opt_d, opt_g, device="cpu")
    data = np.random.RandomState(2).randn(3, B, IMG, IMG, 3).clip(-1, 1).astype(np.float32)
    folder = str(tmp_path / "ckpt")
    for i in range(3):
        ts, _ = step(ts, {"x": data[i]})
        checkpoint.save(folder, ts, i + 1, max_to_keep=5)
    return model, ts, folder


def test_print_tensor_in_ckpt(tmp_path, capsys):
    model, ts, folder = _port_checkpoints(tmp_path)
    got = checkpoint.print_tensor_in_ckpt(folder)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == len(got)
    saved = checkpoint.state_dict(ts)
    assert got["params/gen/gen/l1/kernel/kernel"] == ((128, 256), "torch.float32")
    assert got["opt_state_dis/mu/dis/l8_s/bias/bias"] == ((16,), "torch.float32")
    assert got["step"] == ((), "torch.int32")
    assert len([k for k in got if k.startswith("params/")]) == len(tree_leaves(saved["params"]))
    assert "params/gen/gen/l1/kernel/kernel: shape=(128, 256) dtype=torch.float32" in printed
    assert checkpoint.print_tensor_in_ckpt(folder, step=1).keys() == got.keys()
    assert checkpoint.print_tensor_in_ckpt(str(tmp_path / "none")) == {}


def test_rollback(tmp_path):
    """rollback into a fresh state of the template's structure evaluates fn
    there and leaves the template alone; from a model, it loads the file's
    own state; a pinned step, and no checkpoint, as JAX's."""
    model, ts, folder = _port_checkpoints(tmp_path)
    before = [t.detach().clone() for t in ts.tensors()]
    value, step = checkpoint.rollback(ts, folder, fn=lambda s: (int(s.step), s))
    assert step == 3 and value[0] == 3
    restored = value[1]
    assert restored is not ts
    assert all(torch.equal(a, b.detach()) for a, b in zip(before, restored.tensors()))
    g = lambda s: model.generate(s.params, s.net_state, torch.Generator().manual_seed(1), 4)
    assert torch.equal(checkpoint.rollback(ts, folder, fn=g)[0], g(ts))

    early, step = checkpoint.rollback(ts, folder, ckpt_step=1)
    assert step == 1 and int(early.step) == 1
    assert all(torch.equal(a, b.detach()) for a, b in zip(before, ts.tensors()))
    assert not torch.equal(tree_leaves(early.params)[0], tree_leaves(ts.params)[0])

    from_model, step = checkpoint.rollback(model, folder)
    assert step == 3
    assert all(torch.equal(a, b.detach()) for a, b in zip(before, from_model.tensors()))
    assert torch.equal(from_model.rng.get_state(), ts.rng.get_state())
    with pytest.raises(FileNotFoundError):
        checkpoint.rollback(ts, str(tmp_path / "none"))
