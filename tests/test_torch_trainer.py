"""The port's training runtime: the K-step windows and the device-data
step against the JAX package's, checkpoints, the ``Agent`` loop (the
single-device cases of ``tests/test_trainer.py``, ported) and the cifar CLI.

Parity (``test_device_data_window_matches_jax``): the narrow architecture
and the tolerances of ``test_torch_step.py``, float32 on both sides, the
JAX side through its plain kernel means (``use_pallas=False``). From the
JAX state after two steps, a K=3 ``shuffled_epochs`` window runs on both
sides over the same uint8 dataset, the port fed JAX's z replayed from its
key splits. The score layer's bias has zero true gradient, so it is
bounded, not compared, and the score means are compared through their
shift-free difference (``test_torch_step.py`` says why).
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_device_data_step as jax_build_device_data_step
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch.data.synthetic import synthetic_image_batches
from mmdgan_torch.experiments.cifar import main as cifar_main
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops.losses import LossState
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.train.step import (
    build_device_data_step,
    build_multi_step,
    build_train_step,
    graph_steps,
    init_train_state,
)
from mmdgan_torch.train.trainer import Agent
from mmdgan_torch.utils import checkpoint, spans
from test_torch_mmd import VAL
from test_torch_step import B, IMG, LOSS_TOL, NARROW, STATE_TOL, _bridged, _replayed_z

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_trainer.py's tiny model, with a 4x4 stride-2 first D layer: the
# port takes symmetric SAME padding only
ARCH = {
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
        {"name": "l2", "out": 4, "op": "d", "w_nm": "s"},
    ],
}


def setup(seed=0, loss="rep"):
    model = SNGan(ARCH, loss_type=loss, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, seed, opt_d, opt_g, device="cpu")
    return model, opt_d, opt_g, ts, build_train_step(model, opt_d, opt_g, device="cpu")


def agent(tmp_path, name, sub="run", **kw):
    kw.setdefault("use_tensorboard", False)
    return Agent(name, sub, output_dir=str(tmp_path), **kw)


def images(n=64, seed=0):
    return {"x": np.random.RandomState(seed).randint(0, 256, size=(n, 8, 8, 1), dtype=np.uint8),
            "y": None}


def assert_states_equal(a: TrainState, b: TrainState):
    for i, (x, y) in enumerate(zip(a.tensors(), b.tensors())):
        assert torch.equal(x, y), f"tensor {i} differs"
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


# ----------------------------------------------------------------------
# the device-data window against JAX
# ----------------------------------------------------------------------
def test_device_data_window_matches_jax():
    k_steps, n_rows = 3, 4 * B   # 4 batches per epoch: the window wraps to row 0
    jmodel = JaxSNGan(NARROW, compute_dtype=jnp.float32)
    jopt_d, jopt_g = jax_multi_opt_config([5e-4, 2e-4], optimizer="adam")
    jts = jax.jit(lambda key: jax_init_train_state(jmodel, key, jopt_d, jopt_g))(
        jax.random.PRNGKey(0))
    jstep = jax.jit(jax_build_train_step(jmodel, jopt_d, jopt_g))
    on = jnp.asarray(True)
    warm = np.random.RandomState(1).randn(2, B, IMG, IMG, 3).clip(-1, 1).astype(np.float32)
    for i in range(2):
        jts, _ = jstep(jts, {"x": jnp.asarray(warm[i]), "y": None}, on, on)
    data = np.random.RandomState(2).randint(0, 256, (n_rows, IMG, IMG, 3), dtype=np.uint8)

    model = SNGan(NARROW, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    params, net_state, od_state, og_state = _bridged(model, jts)
    ts = TrainState(params=params, net_state=net_state, loss_state=LossState.init(),
                    opt_state_dis=od_state, opt_state_gen=og_state, step=2,
                    rng=torch.Generator())
    keys, zs = jts.rng, []
    for _ in range(k_steps):   # the step's own key chain (train/step.py:92)
        zs.append(np.asarray(_replayed_z(keys, model.code_size)))
        keys = jax.random.split(keys)[0]

    jfn = jax.jit(jax_build_device_data_step(jmodel, jopt_d, jopt_g, k_steps, B,
                                             sampling="shuffled_epochs"))
    jts, _, jm = jfn(jts, jnp.asarray(data), None, jax.random.PRNGKey(5), on, on)
    fn = build_device_data_step(model, opt_d, opt_g, k_steps, B, sampling="shuffled_epochs",
                                device="cpu")
    ts, m = fn(ts, torch.tensor(data), None, torch.Generator(), code_batches={"x": np.stack(zs)})

    jm = {k: np.asarray(v) for k, v in jm.items()}
    for k in ("loss_gen", "loss_dis", "x_gen_abs_mean", "e_kxx", "e_kxy", "e_kyy"):
        assert m[k].shape == (k_steps,)
        np.testing.assert_allclose(m[k].numpy(), jm[k], **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose((m["s_x_mean"] - m["s_gen_mean"]).numpy(),
                               jm["s_x_mean"] - jm["s_gen_mean"], **LOSS_TOL)
    for k in ("grad_norm_dis", "grad_norm_gen"):
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-4, err_msg=k)

    params, net_state, od_state, og_state = _bridged(model, jts)
    got_b = ts.params["dis"]["dis/l8_s"]["bias"]["bias"].detach()
    want_b = params["dis"]["dis/l8_s"]["bias"]["bias"]
    assert float((got_b - want_b).abs().max()) <= 2 * k_steps * opt_d.lr
    got_b.copy_(want_b)
    for name, got, want in (("params", ts.params, params), ("net_state", ts.net_state, net_state),
                            ("mu_dis", ts.opt_state_dis.mu, od_state.mu),
                            ("nu_dis", ts.opt_state_dis.nu, od_state.nu),
                            ("mu_gen", ts.opt_state_gen.mu, og_state.mu),
                            ("nu_gen", ts.opt_state_gen.nu, og_state.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **STATE_TOL, err_msg=name)
    assert int(ts.step) == int(jts.step) == 2 + k_steps
    assert int(ts.opt_state_dis.count) == int(od_state.count) == 2 + k_steps


# ----------------------------------------------------------------------
# windows and checkpoints
# ----------------------------------------------------------------------
def test_window_with_code_batches_equals_single_steps():
    """A K=3 window fed K-stacked z equals three single steps fed the same
    z, bitwise (the same operations in the same order on the CPU)."""
    model, opt_d, opt_g, ts_a, step = setup()
    _, _, _, ts_b, _ = setup()
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (3, 16, 8, 8, 1)).astype(np.uint8)
    z = rng.randn(3, 16, 16).astype(np.float32)
    ts_a, m = build_multi_step(model, opt_d, opt_g, 3, device="cpu")(
        ts_a, {"x": x}, code_batches={"x": z})
    for k in range(3):
        ts_b, mk = step(ts_b, {"x": x[k]}, code_batch={"x": z[k]})
        for key in mk:
            assert torch.equal(m[key][k], mk[key]), key
    assert_states_equal(ts_a, ts_b)
    assert int(ts_a.step) == 3 and int(ts_a.opt_state_gen.count) == 3


def test_window_checks_its_inputs():
    model, opt_d, opt_g, ts, step = setup()
    multi = graph_steps(step, 2)
    with pytest.raises(ValueError, match="expected 2 stacked batches"):
        multi(ts, {"x": np.zeros((3, 16, 8, 8, 1), np.float32)})
    with pytest.raises(ValueError, match="capture=True needs a state on CUDA"):
        graph_steps(step, 2, capture=True)(ts, {"x": np.zeros((2, 16, 8, 8, 1), np.float32)})


def test_checkpoint_round_trip_is_bitwise_and_keeps_two(tmp_path):
    model, opt_d, opt_g, ts, step = setup()
    data = synthetic_image_batches(16, 8, 8, 1, seed=4)
    for _ in range(3):
        ts, _ = step(ts, next(data))
        checkpoint.save(str(tmp_path), ts, int(ts.step), max_to_keep=2)
    assert checkpoint.list_ckpt_steps(str(tmp_path)) == [2, 3]
    assert checkpoint.get_ckpt(str(tmp_path)) == 3
    assert checkpoint.get_ckpt(str(tmp_path), 1) is None
    _, _, _, fresh, _ = setup(seed=9)
    fresh.rng.manual_seed(1234)
    checkpoint.restore_into(fresh, checkpoint.ckpt_path(str(tmp_path), 3))
    assert_states_equal(fresh, ts)
    assert int(fresh.step) == 3 and int(fresh.opt_state_dis.count) == 3
    # the restored generator continues the same z stream
    assert torch.equal(torch.randn(4, generator=fresh.rng), torch.randn(4, generator=ts.rng))


# ----------------------------------------------------------------------
# the Agent (tests/test_trainer.py, single device)
# ----------------------------------------------------------------------
def test_agent_train_and_resume(tmp_path):
    model, _, _, ts, step = setup()
    a = agent(tmp_path, "t", query_step=5, nan_check_step=5)
    ts = a.train(step, ts, synthetic_image_batches(16, 8, 8, 1), max_step=10, step_per_epoch=100)
    assert int(ts.step) == 10
    recs = [json.loads(line) for line in open(glob.glob(str(tmp_path / "t_log/run/metrics.jsonl"))[0])]
    assert any(r["step"] == 10 for r in recs)
    _, _, _, ts2, _ = setup(seed=999)
    a2 = agent(tmp_path, "t", query_step=5, load_ckpt=True)
    ts2 = a2.train(step, ts2, synthetic_image_batches(16, 8, 8, 1), max_step=5, step_per_epoch=100)
    assert int(ts2.step) == 15


@pytest.mark.parametrize("blowup", ["nan", "bound"])
def test_agent_divergence_guard(tmp_path, blowup):
    """NaN raises; a loss above 30000 stops early. Both checkpoint."""
    model, _, _, ts, step = setup()
    factor = float("nan") if blowup == "nan" else 1e9

    def bad_step(ts, batch, do_dis, do_gen):
        ts, metrics = step(ts, batch, do_dis, do_gen)
        metrics["loss_gen"] = (metrics["loss_gen"].abs() + 1.0) * factor
        return ts, metrics

    a = agent(tmp_path, "div", sub=blowup, nan_check_step=1)
    data = synthetic_image_batches(16, 8, 8, 1)
    if blowup == "nan":
        with pytest.raises(FloatingPointError):
            a.train(bad_step, ts, data, max_step=3, step_per_epoch=10)
    else:
        with pytest.warns(UserWarning, match="diverged"):
            ts = a.train(bad_step, ts, data, max_step=3, step_per_epoch=10)
        assert int(ts.step) == 1
    assert checkpoint.list_ckpt_steps(a.ckpt_folder) == [1]


def test_agent_debug_modes(tmp_path, capsys):
    model, _, _, ts, step = setup()
    data = synthetic_image_batches(16, 8, 8, 1)
    a = agent(tmp_path, "t", sub="dbg", debug_mode=None, do_save=False)
    assert int(a.train(step, ts, data, max_step=100, step_per_epoch=10,
                       model_description="model layout").step) == 0
    assert "model layout" in capsys.readouterr().out
    a = agent(tmp_path, "t", sub="dbg2", debug_mode=True, debug_step=3, do_save=False)
    assert int(a.train(step, ts, data, max_step=100, step_per_epoch=10).step) == 3


@pytest.mark.parametrize("schedule", [[1, 2], "dynamic"])
def test_agent_imbalanced_single_steps(tmp_path, schedule):
    """Four host-fed single steps, then ten steps with ``steps_per_call=4``:
    two windows whose flags come from the device, and two remainder steps
    flagged by the host. Below step 1000 'dynamic' updates D every step."""
    model, _, _, ts, step = setup()
    a = agent(tmp_path, "imb", do_save=False, imbalanced_update=schedule, query_step=100)
    ts = a.train(step, ts, synthetic_image_batches(16, 8, 8, 1), max_step=4, step_per_epoch=10)
    assert int(ts.step) == 4
    if schedule == [1, 2]:
        assert int(ts.opt_state_dis.count) == 4 and int(ts.opt_state_gen.count) == 2
    ts = a.train(step, ts, synthetic_image_batches(16, 8, 8, 1), max_step=10, step_per_epoch=10,
                 steps_per_call=4)
    assert int(ts.step) == 14 and int(ts.opt_state_dis.count) == 14
    assert int(ts.opt_state_gen.count) == (7 if schedule == [1, 2] else 14)


def test_agent_multi_step_path_with_remainder(tmp_path):
    """K=8 windows and the remainder: 2 windows + 6 single steps = 22."""
    model, _, _, ts, step = setup()
    a = agent(tmp_path, "ms", query_step=8, nan_check_step=8, do_save=False)
    ts = a.train(step, ts, synthetic_image_batches(16, 8, 8, 1), max_step=22,
                 step_per_epoch=100, steps_per_call=8)
    assert int(ts.step) == 22


@pytest.mark.parametrize("sampling", ["uniform", "shuffled_epochs"])
def test_train_device_data(tmp_path, sampling):
    model, opt_d, opt_g, ts, _ = setup()
    a = agent(tmp_path, "devdata", sub=sampling, query_step=8)
    data = images(256)
    kw = dict(step_per_epoch=4, batch_size=16, steps_per_call=8, sampling=sampling)
    ts = a.train_device_data(model, opt_d, opt_g, ts, data, max_step=16, **kw)
    assert int(ts.step) == 16
    # a remainder window, then a max_step below one window
    ts = a.train_device_data(model, opt_d, opt_g, ts, data, max_step=11, **kw)
    assert int(ts.step) == 27
    ts = a.train_device_data(model, opt_d, opt_g, ts, data, max_step=3, **kw)
    assert int(ts.step) == 30
    assert checkpoint.list_ckpt_steps(a.ckpt_folder) == [27, 30]
    np.testing.assert_array_equal(data["x"], images(256)["x"])   # the host copy untouched


def _spans_call(a, path, model, opt_d, opt_g, ts, step, max_step):
    """One Agent call of K = 4 windows: host-fed (``_train_multi``) or
    over device data."""
    if path == "host":
        return a.train(step, ts, synthetic_image_batches(16, 8, 8, 1), max_step=max_step,
                       step_per_epoch=100, steps_per_call=4)
    return a.train_device_data(model, opt_d, opt_g, ts, images(256), max_step=max_step,
                               step_per_epoch=16, batch_size=16, steps_per_call=4)


@pytest.mark.parametrize("path", ["host", "device"])
def test_agent_call_spans_under_a_profiler(tmp_path, path):
    """Two K = 4 windows and two remainder steps: untraced nothing is
    recorded; under a profiler the call is the root, and its feed waits
    (host-fed), its upload (device data), its guard and report are its
    children."""
    model, opt_d, opt_g, ts, step = setup()
    spans.clear()
    a = agent(tmp_path, "spans", sub=path, query_step=8, do_save=False, print_loss=False)
    ts = _spans_call(a, path, model, opt_d, opt_g, ts, step, 10)
    assert spans.records() == [] and not spans.tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        ts = _spans_call(a, path, model, opt_d, opt_g, ts, step, 10)
    assert int(ts.step) == 20
    recs = spans.records()
    spans.clear()
    call = [r for r in recs if r.name == "agent.call"]
    assert len(call) == 1 and call[0].parent is None
    assert all(r.parent == r.root == call[0].id for r in recs if r is not call[0])
    counts = {n: sum(r.name == n for r in recs) for n in {r.name for r in recs}}
    # the guard and report come at the last window; the remainder takes one feed
    expected = {"agent.call": 1, "agent.guard": 1, "agent.report": 1}
    expected.update({"agent.feed_wait": 3} if path == "host" else {"agent.upload": 1})
    assert counts == expected


@pytest.mark.parametrize("path,max_step,windows", [("host", 16, 2), ("device", 8, 2)])
def test_do_trace_profiles_the_last_windows(tmp_path, path, max_step, windows):
    """``do_trace`` profiles the last 2 windows, or every window of a call
    of fewer than 3, into trace.json (the spans among its events) and
    spans.json."""
    model, opt_d, opt_g, ts, step = setup()
    spans.clear()
    a = agent(tmp_path, "trace", sub=path, query_step=4, do_save=False, print_loss=False,
              do_trace=True)
    ts = _spans_call(a, path, model, opt_d, opt_g, ts, step, max_step)
    assert int(ts.step) == max_step and not spans.tracing()
    with open(os.path.join(a.summary_folder, "spans.json")) as f:
        saved = json.load(f)
    with open(os.path.join(a.summary_folder, "trace.json")) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    spans.clear()
    names = [r["name"] for r in saved["records"]]
    assert names.count("agent.guard") == windows and names.count("agent.report") == windows
    assert names.count("agent.feed_wait") == (windows if path == "host" else 0)
    assert "agent.call" not in names      # the call began before the profiler
    assert set(names) <= events
    # the only counters: the traced windows' convs, on the CPU's NCHW route, and
    # their blocks' bias, cast and activation, on the CPU's plain route
    counted = saved["counters"]
    assert sorted(counted) == ["fuse.bias_act_plain", "layout.nchw_conv"], counted
    assert counted["layout.nchw_conv"] > 0 and counted["fuse.bias_act_plain"] > 0


def test_train_device_data_shuffled_resume_bitwise(tmp_path):
    """8 + restore + 8 steps across three epoch boundaries (4 batches per
    epoch) equal 16 straight steps, bitwise, port against port."""
    data = images(64)
    kw = dict(step_per_epoch=4, batch_size=16, steps_per_call=4, sampling="shuffled_epochs")
    model, opt_d, opt_g, ts, _ = setup()
    ts_a = agent(tmp_path, "shufA", query_step=100, do_save=False).train_device_data(
        model, opt_d, opt_g, ts, data, max_step=16, **kw)
    model, opt_d, opt_g, ts, _ = setup()
    agent(tmp_path, "shufB", query_step=100).train_device_data(
        model, opt_d, opt_g, ts, data, max_step=8, **kw)
    _, _, _, fresh, _ = setup(seed=99)
    ts_b = agent(tmp_path, "shufB", query_step=100, do_save=False, load_ckpt=True
                 ).train_device_data(model, opt_d, opt_g, fresh, data, max_step=8, **kw)
    assert int(ts_b.step) == 16
    assert_states_equal(ts_a, ts_b)


def test_train_device_data_sampling_seed_fixed_across_chunks(tmp_path):
    """Chunks that vary ``seed`` keep ``sampling_seed``: 8 + 8 steps with
    seed 0 then 1 (a boundary mid-epoch, 3 batches per epoch) equal 16
    straight steps with seed 0."""
    data = images(48)
    kw = dict(step_per_epoch=3, batch_size=16, steps_per_call=4, sampling="shuffled_epochs")
    model, opt_d, opt_g, ts, _ = setup()
    ts_a = agent(tmp_path, "chunkA", query_step=100, do_save=False).train_device_data(
        model, opt_d, opt_g, ts, data, max_step=16, seed=0, **kw)
    model, opt_d, opt_g, ts, _ = setup()
    b = agent(tmp_path, "chunkB", query_step=100, do_save=False)
    ts = b.train_device_data(model, opt_d, opt_g, ts, data, max_step=8, seed=0,
                             sampling_seed=0, **kw)
    ts = b.train_device_data(model, opt_d, opt_g, ts, data, max_step=8, seed=1,
                             sampling_seed=0, **kw)
    assert_states_equal(ts_a, ts)


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_loss_internals_in_metrics_log(tmp_path, steps_per_call):
    """The JSONL alone carries the kernel means, the gradient norms and
    (param_hist_step) per-variable parameter histograms."""
    model, _, _, ts, step = setup()
    a = agent(tmp_path, "obs", sub=f"k{steps_per_call}", query_step=4, nan_check_step=4,
              param_hist_step=8)
    a.train(step, ts, synthetic_image_batches(16, 8, 8, 1), max_step=8, step_per_epoch=100,
            steps_per_call=steps_per_call)
    recs = [json.loads(line) for line in open(os.path.join(a.summary_folder, "metrics.jsonl"))]
    scalars = [r for r in recs if "hist" not in r]
    assert any(r["step"] == 8 and "e_kxx" in r and "e_kyy" in r and "grad_norm_dis" in r
               for r in scalars)
    tags = {r["hist"] for r in recs if "hist" in r}
    assert "params/dis/l1/kernel/kernel" in tags


_WORKER = """
import sys, numpy as np, torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.step import init_train_state
from mmdgan_torch.train.trainer import Agent
sys.path.insert(0, {tests!r})
from test_torch_trainer import ARCH, images
model = SNGan(ARCH, device="cpu")
opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
agent = Agent("preempt", "t", output_dir={out!r}, query_step=64, use_tensorboard=False)
ts = agent.train_device_data(model, opt_d, opt_g, ts, images(), max_step=200000,
                             step_per_epoch=4, batch_size=16, steps_per_call=8)
print("FINAL", int(ts.step), flush=True)
"""


def test_sigterm_preemption_checkpoints(tmp_path):
    """SIGTERM during training stops at a window boundary with a
    checkpoint; a fresh Agent resumes from it."""
    code = _WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"), out=str(tmp_path))
    proc = subprocess.Popen([sys.executable, "-u", "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            if "global step" in line:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-3000:]
    assert "SIGTERM received" in out, out[-3000:]
    stopped_at = int([ln for ln in out.splitlines() if ln.startswith("FINAL")][0].split()[1])
    assert 0 < stopped_at < 200000 and stopped_at % 8 == 0
    model, opt_d, opt_g, ts, _ = setup()
    ts = agent(tmp_path, "preempt", sub="t", query_step=64, do_save=False, load_ckpt=True
               ).train_device_data(model, opt_d, opt_g, ts, images(), max_step=8,
                                   step_per_epoch=4, batch_size=16, steps_per_call=8)
    assert int(ts.step) == stopped_at + 8


# ----------------------------------------------------------------------
# the cifar CLI
# ----------------------------------------------------------------------
def test_cifar_cli_debug_run_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "mmdgan_torch.experiments.cifar", "--device", "cpu",
         "--synthetic-data", "--debug-mode", "true", "--debug-step", "2",
         "--compute-dtype", "float32", "--skip-sampling", "--skip-metrics",
         "--chunks", "1", "--batch-size", "8", "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads([ln for ln in out.stdout.splitlines() if "train_steps_per_sec" in ln][0])
    assert line["metric"] == "train_steps_per_sec_cifar" and line["value"] > 0
    run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    assert os.path.isfile(tmp_path / "cifar_ckpt" / run / "ckpt-2.pt")
    recs = [json.loads(ln) for ln in open(tmp_path / "cifar_log" / run / "metrics.jsonl")]
    assert any("sigma/dis/l8_s/kernel" in r for r in recs)


def test_run_name_drops_the_repulsive_weights_for_other_losses():
    """``experiments/runner.py:152-157``: rep and rmb runs carry the
    repulsive weights in their folder name, other losses do not."""
    from mmdgan_torch.experiments.runner import run_name
    lr, k = [5e-4, 2e-4], float(np.power(64.0, 0.125))
    assert run_name("rep", lr, k, [0.0, -1.0]) == "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    assert run_name("rmb", lr, k, [0.5, -0.5]) == "sngan_rmb_5e-04_2e-04_k1.68_0.5_-0.5"
    assert run_name("rep_gp", lr, k, [0.0, -1.0]) == "sngan_rep_gp_5e-04_2e-04_k1.68"
    assert run_name("mmd_g", [1e-4, 1e-4], 1.0, [0.0, -1.0]) == "sngan_mmd_g_1e-04_1e-04_k1"


def test_cifar_cli_other_loss_with_histograms(tmp_path):
    """The CLI takes a stateful loss and ``--summary-histograms``: two graphed
    (here eager) steps of the full cifar model at B=4 on the CPU; the log
    holds the loss state and the hist/* counts over their fixed ranges."""
    cifar_main(["--device", "cpu", "--synthetic-data", "--debug-mode", "true",
                "--debug-step", "2", "--steps-per-call", "2", "--query-step", "2",
                "--compute-dtype", "float32", "--skip-sampling", "--skip-metrics",
                "--chunks", "1", "--batch-size", "4", "--out-dir", str(tmp_path),
                "--loss", "mmd_g_mix", "--summary-histograms"])
    run = "sngan_mmd_g_mix_5e-04_2e-04_k1.68"
    assert os.path.isfile(tmp_path / "cifar_ckpt" / run / "ckpt-2.pt")
    recs = [json.loads(ln) for ln in open(tmp_path / "cifar_log" / run / "metrics.jsonl")]
    assert any(r.get("step") == 2 and "state/loss_average" in r and "mix/sigma_0/e_kxx" in r
               for r in recs)
    hists = {r["hist"]: r for r in recs if r.get("hist", "").startswith("hist/")}
    assert set(hists) == {"hist/d_xx", "hist/d_xy", "hist/d_yy", "hist/score_gen",
                          "hist/score_x"}
    assert (hists["hist/d_xy"]["lo"], hists["hist/d_xy"]["hi"]) == (0.0, 16.0)
    assert sum(hists["hist/d_xy"]["counts"]) == 16 and sum(hists["hist/score_x"]["counts"]) == 64


# the eval path (A14) and --bf16-moments (A7) run now (tests/test_torch_eval.py,
# tests/test_torch_optim.py); the other cases keep their ids
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--skip-sampling", "--skip-metrics", "--use-pallas"], "B1", id="flags1-B1"),
    pytest.param(["--skip-sampling", "--skip-metrics", "--compilation-cache"], None,
                 id="flags2-A16"),
])
def test_cifar_cli_refuses_unported_flags(tmp_path, monkeypatch, capsys, flags, item):
    """No flag of the JAX CLI refuses. ``--use-pallas`` (B1) routes the
    repulsive loss through the kernel pair, as JAX's routes it through its
    Pallas kernel (``experiments/runner.py:186``): two synthetic float32
    steps with the flag build ``fused_rep`` on, without it off, and the
    losses logged at each step agree at ``VAL``, the tolerance at which
    ``test_torch_mmd.py::test_gan_loss_matches_jax`` holds the kernel
    pair's plain version against the plain means. ``--compilation-cache``
    (A16) is ported: a two-step synthetic run takes it and prints the
    cache's directory, as the JAX CLI does (``experiments/runner.py:141-145``)."""
    if item is not None:
        from mmdgan_torch.models import sngan

        built = []

        class Recorded(sngan.SNGan):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                built.append(self)

        monkeypatch.setattr(sngan, "SNGan", Recorded)
        logged = []
        for extra in ([], flags[-1:]):
            out = tmp_path / str(len(extra))
            cifar_main(["--device", "cpu", "--out-dir", str(out), *flags[:-1], *extra,
                        "--synthetic-data", "--debug-mode", "true", "--debug-step", "2",
                        "--steps-per-call", "1", "--query-step", "1",
                        "--compute-dtype", "float32", "--chunks", "1", "--batch-size", "4"])
            run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
            recs = [json.loads(ln) for ln in open(out / "cifar_log" / run / "metrics.jsonl")]
            logged.append({r["step"]: (r["loss_gen"], r["loss_dis"])
                           for r in recs if "loss_gen" in r})
        assert [m.loss_hp.fused_rep for m in built] == [False, True]
        assert sorted(logged[0]) == sorted(logged[1]) == [1, 2]
        for step, (loss_gen, loss_dis) in logged[1].items():
            np.testing.assert_allclose(loss_gen, logged[0][step][0], **VAL, err_msg=str(step))
            np.testing.assert_allclose(loss_dis, logged[0][step][1], **VAL, err_msg=str(step))
        return
    from mmdgan_torch.ops import _build

    for name in (_build.CACHE_ENV, _build.CACHE_MIN_SECONDS_ENV, "TORCHINDUCTOR_CACHE_DIR",
                 "TRITON_CACHE_DIR"):
        monkeypatch.setenv(name, "")   # the CLI sets them; restored after the test
    cache = tmp_path / "cache"
    cifar_main(["--device", "cpu", "--out-dir", str(tmp_path), *flags, str(cache),
                "--synthetic-data", "--debug-mode", "true", "--debug-step", "2",
                "--compute-dtype", "float32", "--chunks", "1", "--batch-size", "8"])
    assert f"Compilation cache: {cache}" in capsys.readouterr().out
    assert cache.is_dir() and os.environ[_build.CACHE_ENV] == str(cache)


# --num-class and --sample-same-class run now (the conditional models and
# same-class sampling, tests/test_torch_conditional.py)
@pytest.mark.parametrize("flags", [
    pytest.param(["--num-class", "4"], id="num-class"),
    pytest.param(["--num-class", "4", "--sample-same-class"], id="sample-same-class"),
])
def test_cifar_cli_trains_the_conditional_model(tmp_path, flags):
    """``--num-class 4`` trains the conditional CIFAR model (cbn generator,
    dck head) on synthetic labelled batches through K=2 windows and writes
    its sprite; its checkpoint holds the per-class parameters."""
    cifar_main(["--device", "cpu", "--out-dir", str(tmp_path), "--synthetic-data",
                "--debug-mode", "true", "--debug-step", "4", "--steps-per-call", "2",
                "--batch-size", "8", "--chunks", "1", "--skip-metrics", "--compute-dtype",
                "float32", *flags])
    run = os.listdir(tmp_path / "cifar_ckpt")[0]
    ckpt = torch.load(tmp_path / "cifar_ckpt" / run / "ckpt-4.pt", weights_only=False)
    flat = str(ckpt)
    assert "c_kernel" in flat and "offset" in flat
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "cifar_log" / run))


@pytest.mark.parametrize("flags,dis_count,gen_count", [
    (["--micro-batches", "2"], 4, 4),
    (["--imbalanced-update", "1,2"], 4, 2),
])
def test_cifar_cli_runs_accumulation_and_imbalanced_windows(tmp_path, flags, dis_count,
                                                            gen_count):
    """``--micro-batches`` (the accumulated step) and ``--imbalanced-update``
    inside ``--steps-per-call`` windows, host-fed: four steps of the full
    cifar model at B=4 on the CPU, two windows of two; the checkpoint holds
    the Adam counts of the schedule."""
    cifar_main(["--device", "cpu", "--synthetic-data", "--debug-mode", "true",
                "--debug-step", "4", "--steps-per-call", "2", "--query-step", "2",
                "--compute-dtype", "float32", "--skip-sampling", "--skip-metrics",
                "--chunks", "1", "--batch-size", "4", "--out-dir", str(tmp_path), *flags])
    run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    saved = torch.load(tmp_path / "cifar_ckpt" / run / "ckpt-4.pt", weights_only=False)
    counts = {net: int(saved["opt_state_" + net]["count"]) for net in ("dis", "gen")}
    assert counts == {"dis": dis_count, "gen": gen_count}
