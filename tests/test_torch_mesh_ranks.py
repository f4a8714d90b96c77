"""The port's mesh at 2 and 4 gloo ranks against the JAX package's
``DataParallel`` at 2 and 4 of the 8 virtual CPU devices, and against the
port's own mesh of one rank.

Both sides train the narrow models of ``tests/test_parallel.py`` (a BN
generator variant of ``PLAIN_ARCH``; ``COND_ARCH``'s cbn generator and
projection head) in float32 from the JAX state of ``PRNGKey(7)``, bridged
over, with SGD at 1e-2 on a global batch of 16, the way ``_run_steps``
(``tests/test_parallel.py:55-70``) runs them: two steps of rep (BN), of
the conditional model (code labels = data labels), of rmb_gp (the
witness penalty's double backward through the collectives), of rmb_ds
(the Jacobian scale), two accumulated steps at M=2 (the micro-major
shard, BN per micro-batch) and one [1, 5] imbalanced window of 6 steps.
JAX's z and penalty weights reach the port replayed from its key
(``code_batch=``/``uni=``). Every rank is a subprocess
(``tests/torch_mesh_worker.py``, one thread, a ``file://`` store in the
test's temporary folder); the three groups of 1, 2 and 4 ranks run side
by side.

Tolerances: port against JAX at the same N, losses rtol 1e-4 / atol
1e-6 and parameters, SN vectors and BN statistics rtol 1e-3 / atol 1e-6;
port N ranks against port 1 rank, JAX's own mesh bounds
(``tests/test_parallel.py:83-96``): losses rtol 2e-4 / atol 1e-5,
parameters rtol 2e-3 / atol 1e-6. The replicas of every rank end bitwise
equal, the generator's state included.
"""

import copy
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
from mmdgan_tpu.parallel.mesh import DataParallel as JaxDataParallel
from mmdgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_grad_accum_step as jax_build_grad_accum_step
from mmdgan_tpu.train.step import build_imbalanced_multi_step as jax_build_imbalanced_multi_step
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.utils import checkpoint
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
B, STEPS, WINDOW = 16, 2, 6
RANKS = (2, 4)
JAX_LOSS_TOL, JAX_STATE_TOL = dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-3, atol=1e-6)
MESH_LOSS_TOL, MESH_STATE_TOL = dict(rtol=2e-4, atol=1e-5), dict(rtol=2e-3, atol=1e-6)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")

COND_ARCH = {
    "input": [(1, 8, 8)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 8, "op": "d", "act": "tanh",
         "act_nm": "cbn", "out_reshape": [1, 8, 8]}],
    "discriminator": [
        {"name": "l1", "out": 4, "op": "d", "act": "lrelu", "w_nm": "s",
         "act_k": 1.3, "in_reshape": [8 * 8]},
        {"name": "l2", "out": 1, "op": "d", "type": "project",
         "w_nm": "s", "act_k": 1.0}],
}
PLAIN_ARCH = {
    "input": [(1, 8, 8)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 8, "op": "d", "act": "tanh",
         "act_nm": None, "out_reshape": [1, 8, 8]}],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "d", "act": "lrelu", "w_nm": "s",
         "act_k": 1.3, "in_reshape": [8 * 8]},
        {"name": "l2", "out": 4, "op": "d", "w_nm": "s"}],
}
BN_ARCH = copy.deepcopy(PLAIN_ARCH)
BN_ARCH["generator"][0]["act_nm"] = "bn"

# name: (arch, loss, num_class, micro-batches, imbalanced schedule)
CASES = {
    "rep_bn": (BN_ARCH, "rep", 0, 1, None),
    "conditional": (COND_ARCH, "rep", 3, 1, None),
    "rmb_gp": (BN_ARCH, "rmb_gp", 0, 1, None),
    "rmb_ds": (BN_ARCH, "rmb_ds", 0, 1, None),
    "accum_m2": (BN_ARCH, "rep", 0, 2, None),
    "imbalanced_1_5": (BN_ARCH, "rep", 0, 1, [1, 5]),
}


def _jax_model(name):
    arch, loss, num_class, _, _ = CASES[name]
    model = JaxSNGan(arch, num_class=num_class, loss_type=loss, compute_dtype=jnp.float32)
    model.sample_same_class = num_class >= 2
    return model


def _port_model(name):
    arch, loss, num_class, _, _ = CASES[name]
    model = SNGan(arch, num_class=num_class, loss_type=loss, compute_dtype=torch.float32,
                  device="cpu")
    model.sample_same_class = num_class >= 2
    return model


def _steps(name):
    return WINDOW if CASES[name][4] is not None else STEPS


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """The JAX start state and the global batches of a case, each with
    JAX's z and penalty weights replayed from the state's key."""
    model = _jax_model(name)
    opt_d, opt_g = jax_multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    jts = jax.device_get(jax_init_train_state(model, jax.random.PRNGKey(7), opt_d, opt_g))
    num_class = CASES[name][2]
    data = np.random.RandomState(0)
    rng, batches = jts.rng, []
    for _ in range(_steps(name)):
        rng, rng_step = jax.random.split(rng)
        rng_code, _, rng_gp = jax.random.split(rng_step, 3)
        z = jax.random.normal(jax.random.split(rng_code)[0], (B, model.code_size))
        batches.append({
            "x": data.randn(B, 8, 8, 1).astype(np.float32),
            "y": (data.randint(0, num_class, (B, 1)).astype(np.int32) if num_class else None),
            "z": np.array(z),
            "uni": (np.array(jax.random.uniform(rng_gp, (B, 1, 1, 1)))
                    if CASES[name][1] == "rmb_gp" else None)})
    return jts, batches


def _bridged(name, jts) -> TrainState:
    model = _port_model(name)
    opts = multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    params, net_state, (od, og), loss_state = jax_params_to_torch(
        model, jts.params, jts.net_state, (jts.opt_state_dis, jts.opt_state_gen),
        loss_state=jts.loss_state, optimizers=opts)
    return TrainState(params=params, net_state=net_state, loss_state=loss_state,
                      opt_state_dis=od, opt_state_gen=og, step=int(jts.step),
                      rng=torch.Generator())


@functools.lru_cache(maxsize=None)
def _jax_run(name, n):
    """JAX's DataParallel over ``n`` devices: (losses [steps, 2], the final
    state bridged to the port, the do_dis flags of a window or None)."""
    model = _jax_model(name)
    opt_d, opt_g = jax_multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    jts, batches = _inputs(name)
    dp = JaxDataParallel(jax_make_mesh(jax.devices()[:n]))
    ts = dp.replicate(jts)
    micro, imbalanced = CASES[name][3], CASES[name][4]
    on = jnp.asarray(True)
    do_dis = None
    if imbalanced is not None:
        fn = jax.jit(jax_build_imbalanced_multi_step(model, opt_d, opt_g, len(batches),
                                                     imbalanced))
        stacked = {"x": np.stack([b["x"] for b in batches]), "y": None}
        ts, _, _, m = fn(ts, dp.shard_multi_batch(stacked), jax.random.PRNGKey(3),
                         jnp.zeros(()))
        losses = np.stack([np.asarray(m["loss_gen"]), np.asarray(m["loss_dis"])], 1)
        do_dis = np.asarray(m["do_dis"])
    else:
        step = dp.compile_step(jax_build_train_step(model, opt_d, opt_g) if micro == 1 else
                               jax_build_grad_accum_step(model, opt_d, opt_g, micro))
        losses = []
        for b in batches:
            ts, m = step(ts, dp.shard_batch({"x": b["x"], "y": b["y"]}), on, on)
            losses.append([float(m["loss_gen"]), float(m["loss_dis"])])
        losses = np.asarray(losses)
    return losses, _bridged(name, jax.device_get(ts)), do_dis


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case on port meshes of 1, 2 and 4 gloo ranks; returns a
    loader ``(name, ranks, rank) -> the rank's saved result``."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases = []
    for name, (_, _, num_class, micro, imbalanced) in CASES.items():
        jts, batches = _inputs(name)
        ckpt = str(tmp / f"{name}.pt")
        torch.save(checkpoint.state_dict(_bridged(name, jts)), ckpt)
        cases.append({"name": name, "arch": CASES[name][0], "loss_type": CASES[name][1],
                      "num_class": num_class, "same_class": num_class >= 2, "micro": micro,
                      "imbalanced": imbalanced, "ckpt": ckpt, "batches": batches})
    torch.save(cases, tmp / "cases.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    try:
        for n in (1,) + RANKS:
            out = tmp / f"ranks{n}"
            out.mkdir()
            for rank in range(n):
                procs.append((n, rank, subprocess.Popen(
                    [sys.executable, WORKER, str(tmp / "cases.pt"), str(out), str(rank), str(n),
                     str(tmp / f"store{n}")], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
        for n, rank, proc in procs:
            log, _ = proc.communicate(timeout=400)
            assert proc.returncode == 0, f"rank {rank} of {n} exited {proc.returncode}:\n{log}"
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return lambda name, n, rank: torch.load(tmp / f"ranks{n}" / f"{name}_{rank}.pt",
                                            weights_only=False)


def _state_leaves(ts_tensors, name):
    """The params, SN vectors and BN statistics among a state's tensors."""
    template = _bridged(name, _inputs(name)[0])
    n = len(tree_leaves(template.params)) + len(tree_leaves(template.net_state))
    return ts_tensors[:n]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax_data_parallel(port_runs, name, n):
    """Port N ranks against JAX's DataParallel at N devices."""
    losses, want, do_dis = _jax_run(name, n)
    got = port_runs(name, n, 0)
    np.testing.assert_allclose(got["losses"].numpy(), losses, **JAX_LOSS_TOL,
                               err_msg=f"{name} at {n} ranks: losses")
    if do_dis is not None:
        np.testing.assert_array_equal(got["do_dis"].numpy(), do_dis)
    want_leaves = tree_leaves(want.params) + tree_leaves(want.net_state)
    for i, (g, w) in enumerate(zip(_state_leaves(got["tensors"], name), want_leaves)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), **JAX_STATE_TOL,
                                   err_msg=f"{name} at {n} ranks: state tensor {i}")
    assert int(got["tensors"][-1]) == int(want.step) == _steps(name)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_one_rank(port_runs, name, n):
    """Port N ranks against the port's mesh of one rank (the global batch
    on one process), within JAX's own mesh bounds."""
    one, got = port_runs(name, 1, 0), port_runs(name, n, 0)
    np.testing.assert_allclose(got["losses"].numpy(), one["losses"].numpy(), **MESH_LOSS_TOL)
    for i, (g, w) in enumerate(zip(_state_leaves(got["tensors"], name),
                                   _state_leaves(one["tensors"], name))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **MESH_STATE_TOL,
                                   err_msg=f"{name}: state tensor {i}, {n} ranks vs 1")


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", list(CASES))
def test_replicas_are_bitwise_identical(port_runs, name, n):
    """Every rank ends with the same state bit for bit: parameters, SN
    vectors, BN statistics, optimizer slots, loss state, step and the
    generator."""
    ranks = [port_runs(name, n, r) for r in range(n)]
    for r in ranks[1:]:
        differ = [i for i, (a, b) in enumerate(zip(ranks[0]["tensors"], r["tensors"]))
                  if not torch.equal(a, b)]
        assert not differ, f"{name}: tensors {differ} differ between ranks"
        assert torch.equal(ranks[0]["rng"], r["rng"])
        assert torch.equal(ranks[0]["losses"], r["losses"])
