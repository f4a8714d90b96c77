"""The port's sharded state (``DataParallel.shard_state``: fsdp over the
data axis of a 1-D mesh, the model axis of a 2-D mesh) at 2 and 4 gloo
ranks, against the JAX package's ``test_mesh_equality_fsdp_data_axis``
and ``test_mesh_equality_model_parallel_2d`` runs
(``tests/test_parallel.py:457-507,650-704``) on its virtual CPU devices,
and against the port's mesh of one rank.

Both sides train JAX's ``CONV_ARCH`` (a BN generator with a transposed
conv, an SN conv discriminator) with rep in float32 from the JAX state of
``PRNGKey(7)``, bridged over, two steps of SGD at 1e-2 on a global batch
of 16, JAX's z replayed from its key. The port's layouts: fsdp at 2 and
4 ranks, 2-D meshes (1, 2) and (2, 2); JAX's: fsdp at 2 and 4 devices,
``make_mesh_2d`` at the same shapes. Every rank is a subprocess
(``tests/torch_mesh_worker.py``); the groups of 1, 2 and 4 ranks run side
by side. ``min_size=1``, as in JAX's tests, so the rule splits every leaf
whose elements divide over the axis.

Tolerances: port against JAX, losses rtol 1e-4 / atol 1e-6 and
parameters, SN vectors and BN statistics rtol 1e-3 / atol 1e-6; port
sharded against port one rank, JAX's own mesh bounds: losses rtol 2e-4 /
atol 1e-5, parameters rtol 2e-3 / atol 1e-6. The gathered states of all
ranks are bitwise equal.
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
from mmdgan_tpu.parallel.mesh import DataParallel as JaxDataParallel
from mmdgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmdgan_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import build_train_step as jax_build_train_step
from mmdgan_tpu.train.step import init_train_state as jax_init_train_state
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.state import TrainState, tree_leaves
from mmdgan_torch.train.step import init_train_state
from mmdgan_torch.utils import checkpoint
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
B, STEPS = 16, 2
JAX_LOSS_TOL, JAX_STATE_TOL = dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-3, atol=1e-6)
MESH_LOSS_TOL, MESH_STATE_TOL = dict(rtol=2e-4, atol=1e-5), dict(rtol=2e-3, atol=1e-6)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")

CONV_ARCH = {
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
         "kernel": 3, "strides": 2, "out_reshape": [4 * 4 * 8]},
        {"name": "l2", "out": 4, "op": "d", "w_nm": "s"},
    ],
}

# name: (ranks, port layout, JAX mesh: ('fsdp', n) or ('2d', data, model))
LAYOUTS = {
    "fsdp2": (2, "fsdp", ("fsdp", 2)),
    "fsdp4": (4, "fsdp", ("fsdp", 4)),
    "2d_1x2": (2, [1, 2], ("2d", 1, 2)),
    "2d_2x2": (4, [2, 2], ("2d", 2, 2)),
}
AGENT = ("fsdp2", "2d_2x2")


@functools.lru_cache(maxsize=None)
def _inputs():
    """The JAX start state and the global batches, with JAX's z replayed
    from the state's key."""
    model = JaxSNGan(CONV_ARCH, num_class=0, loss_type="rep", compute_dtype=jnp.float32)
    opt_d, opt_g = jax_multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    jts = jax.device_get(jax_init_train_state(model, jax.random.PRNGKey(7), opt_d, opt_g))
    data = np.random.RandomState(0)
    rng, batches = jts.rng, []
    for _ in range(STEPS):
        rng, rng_step = jax.random.split(rng)
        rng_code = jax.random.split(rng_step, 3)[0]
        z = jax.random.normal(jax.random.split(rng_code)[0], (B, model.code_size))
        batches.append({"x": data.randn(B, 8, 8, 1).astype(np.float32), "y": None,
                        "z": np.array(z), "uni": None})
    return jts, batches


def _port_model():
    return SNGan(CONV_ARCH, num_class=0, loss_type="rep", compute_dtype=torch.float32,
                 device="cpu")


def _bridged(jts) -> TrainState:
    opts = multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    params, net_state, (od, og), loss_state = jax_params_to_torch(
        _port_model(), jts.params, jts.net_state, (jts.opt_state_dis, jts.opt_state_gen),
        loss_state=jts.loss_state, optimizers=opts)
    return TrainState(params=params, net_state=net_state, loss_state=loss_state,
                      opt_state_dis=od, opt_state_gen=og, step=int(jts.step),
                      rng=torch.Generator())


@functools.lru_cache(maxsize=None)
def _jax_run(mesh):
    """JAX's run on the sharded layout of ``mesh``: (losses [steps, 2], the
    final state bridged to the port, how many parameter leaves it split)."""
    model = JaxSNGan(CONV_ARCH, num_class=0, loss_type="rep", compute_dtype=jnp.float32)
    opt_d, opt_g = jax_multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    jts, batches = _inputs()
    if mesh[0] == "fsdp":
        dp = JaxDataParallel(jax_make_mesh(jax.devices()[:mesh[1]]))
        ts = dp.shard_state(jts, min_size=1, fsdp=True)
        step = dp.compile_step(jax_build_train_step(model, opt_d, opt_g), out_state_like=ts)
    else:
        dp = JaxDataParallel(jax_make_mesh_2d(mesh[1], mesh[2]))
        ts = dp.shard_state(jts, min_size=1)
        step = dp.compile_step(jax_build_train_step(model, opt_d, opt_g))
    split = sum(any(ax is not None for ax in leaf.sharding.spec)
                for leaf in jax.tree.leaves(ts.params))
    on = jnp.asarray(True)
    losses = []
    for b in batches:
        ts, m = step(ts, dp.shard_batch({"x": b["x"], "y": None}), on, on)
        losses.append([float(m["loss_gen"]), float(m["loss_dis"])])
    return np.asarray(losses), _bridged(jax.device_get(ts)), split


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's runs: one rank replicated, and every layout of LAYOUTS in
    its group of ranks; returns a loader ``(name, rank) -> result``."""
    tmp = tmp_path_factory.mktemp("fsdp")
    jts, batches = _inputs()
    ckpt = str(tmp / "start.pt")
    torch.save(checkpoint.state_dict(_bridged(jts)), ckpt)
    base = {"arch": CONV_ARCH, "loss_type": "rep", "num_class": 0, "same_class": False,
            "micro": 1, "imbalanced": None, "ckpt": ckpt, "batches": batches, "min_size": 1}
    groups = {1: [dict(base, name="one")]}
    for name, (ranks, layout, _) in LAYOUTS.items():
        groups.setdefault(ranks, []).append(dict(
            base, name=name, layout=layout,
            agent_dir=str(tmp / "agent") if name in AGENT else None))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    try:
        for n, cases in groups.items():
            torch.save(cases, tmp / f"cases{n}.pt")
            for rank in range(n):
                procs.append((n, rank, subprocess.Popen(
                    [sys.executable, WORKER, str(tmp / f"cases{n}.pt"), str(tmp), str(rank),
                     str(n), str(tmp / f"store{n}")], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
        for n, rank, proc in procs:
            log, _ = proc.communicate(timeout=400)
            assert proc.returncode == 0, f"rank {rank} of {n} exited {proc.returncode}:\n{log}"
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return lambda name, rank: torch.load(tmp / f"{name}_{rank}.pt", weights_only=False)


def _state_leaves(tensors):
    """The params, SN vectors and BN statistics among a state's tensors."""
    template = _bridged(_inputs()[0])
    return tensors[:len(tree_leaves(template.params)) + len(tree_leaves(template.net_state))]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_state_matches_jax(port_runs, name):
    """The port's sharded run against JAX's on the same layout; both split
    at least 4 parameter leaves."""
    losses, want, jax_split = _jax_run(LAYOUTS[name][2])
    got = port_runs(name, 0)
    assert got["sharded"] >= 4 and jax_split >= 4, (got["sharded"], jax_split)
    np.testing.assert_allclose(got["losses"].numpy(), losses, **JAX_LOSS_TOL,
                               err_msg=f"{name}: losses")
    want_leaves = tree_leaves(want.params) + tree_leaves(want.net_state)
    for i, (g, w) in enumerate(zip(_state_leaves(got["tensors"]), want_leaves)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), **JAX_STATE_TOL,
                                   err_msg=f"{name}: state tensor {i}")
    assert int(got["tensors"][-1]) == int(want.step) == STEPS


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_state_matches_one_rank(port_runs, name):
    """The port's sharded run against its mesh of one rank, replicated,
    within JAX's mesh bounds; the gathered state of every rank is the same
    bit for bit, the generator's included."""
    one, got = port_runs("one", 0), port_runs(name, 0)
    np.testing.assert_allclose(got["losses"].numpy(), one["losses"].numpy(), **MESH_LOSS_TOL)
    for i, (g, w) in enumerate(zip(_state_leaves(got["tensors"]),
                                   _state_leaves(one["tensors"]))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **MESH_STATE_TOL,
                                   err_msg=f"{name}: state tensor {i} against one rank")
    for rank in range(1, LAYOUTS[name][0]):
        other = port_runs(name, rank)
        differ = [i for i, (a, b) in enumerate(zip(got["tensors"], other["tensors"]))
                  if not torch.equal(a, b)]
        assert not differ, f"{name}: tensors {differ} differ between ranks 0 and {rank}"
        assert torch.equal(got["rng"], other["rng"]) and torch.equal(got["losses"],
                                                                      other["losses"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_state_bytes_follow_the_rule(port_runs, name):
    """A rank keeps 1/N of every split parameter and slot (N the ranks of
    the axis it is split over) and the rest whole: the bytes summed from
    the rank's tensors."""
    ranks, layout, _ = LAYOUTS[name]
    n = ranks if layout == "fsdp" else layout[1]
    ts = _bridged(_inputs()[0])
    leaves = tree_leaves(ts.params)
    slots = [t for o in (ts.opt_state_dis, ts.opt_state_gen) for t in o.tensors()[1:]]
    want = sum(t.numel() * t.element_size() // (n if t.numel() % n == 0 else 1)
               for t in leaves + slots)
    whole = sum(t.numel() * t.element_size() for t in leaves + slots)
    for rank in range(ranks):
        assert port_runs(name, rank)["bytes"] == want < whole


@pytest.mark.parametrize("name", AGENT)
def test_agent_keeps_the_layout_and_checkpoints_restore_either_way(port_runs, name):
    """``Agent.train(dp=)`` in K=2 windows keeps the sharded state it is
    given (the same object, as many leaves split); its checkpoint, written
    whole, restores into a replicated state bitwise equal to the sharded
    state gathered, and the replicated start checkpoint restores into a
    freshly sharded state bitwise."""
    got = port_runs(name, 0)
    assert got["agent_kept_layout"] and got["agent_step"] == STEPS + 4
    assert got["restored_sharded_bitwise"]
    path = checkpoint.ckpt_path(got["agent_ckpt"], STEPS + 4)
    opt_d, opt_g = multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    restored = checkpoint.restore_into(init_train_state(_port_model(), 0, opt_d, opt_g,
                                                        device="cpu"), path)
    for i, (a, b) in enumerate(zip(restored.tensors(), got["agent_tensors"])):
        assert torch.equal(a, b), f"{name}: tensor {i}"


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group of this process (a file:// store), left after
    the test."""
    from mmdgan_torch.parallel.mesh import DataParallel, init_distributed

    init_distributed("gloo", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        yield DataParallel(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def _one_rank_run(dp, fsdp, optimizer, bf16, kind):
    """Two windows of 2 steps of ``kind`` on CONV_ARCH's state of seed 0,
    sharded over the one rank (``min_size=1``: every leaf split) or not;
    returns the whole end state's tensors and the last metrics."""
    from mmdgan_torch.train.step import (build_device_data_step, build_grad_accum_step,
                                         build_imbalanced_multi_step, build_multi_step,
                                         graph_steps)

    model = _port_model()
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3], optimizer=optimizer, bf16_moments=bf16)
    ts = init_train_state(model, 0, opt_d, opt_g, device="cpu")
    if fsdp:
        ts = dp.shard_state(ts, min_size=1, fsdp=True)
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(2, B, 8, 8, 1).astype(np.float32))
    codes = {"x": torch.tensor(rng.randn(2, B, 16).astype(np.float32))}
    if kind == "fused":
        window = build_multi_step(model, opt_d, opt_g, 2, device="cpu", dp=dp)
        run = lambda ts: window(ts, {"x": x}, code_batches=codes)  # noqa: E731
    elif kind == "accum":
        window = graph_steps(build_grad_accum_step(model, opt_d, opt_g, 2, device="cpu", dp=dp), 2)
        run = lambda ts: window(ts, {"x": x}, code_batches=codes)  # noqa: E731
    elif kind == "imbalanced":
        window = build_imbalanced_multi_step(model, opt_d, opt_g, 2, [1, 2], device="cpu", dp=dp)
        avg = torch.zeros(())
        run = lambda ts: window(ts, {"x": x}, None, avg, code_batches=codes)  # noqa: E731
    else:
        window = build_device_data_step(model, opt_d, opt_g, 2, B, device="cpu").with_mesh(dp)
        gen = torch.Generator().manual_seed(4)
        data = torch.tensor(rng.randn(4 * B, 8, 8, 1).astype(np.float32))
        run = lambda ts: window(ts, data, None, gen, code_batches=codes)  # noqa: E731
    for _ in range(2):
        ts, m = run(ts)
    if fsdp:
        assert ts.layout is not None and dp.ensure_placed(ts) is ts
        ts = ts.layout.gathered(ts)
    return ts.tensors(), m


@pytest.mark.parametrize("optimizer,bf16", [("adam", False), ("adam", True), ("adam_tf1", False),
                                            ("sgd", False), ("momentum", False),
                                            ("rmsprop", False)],
                         ids=["adam", "adam-bf16", "adam_tf1", "sgd", "momentum", "rmsprop"])
def test_every_optimizer_updates_shards_as_whole_tensors(one_rank, optimizer, bf16):
    """At one rank the gather and the reduce-scatter are copies, so a
    sharded state (every leaf split, its slots f32 or bf16) ends bitwise
    where the replicated one does under each optimizer; the gradient
    norms, which the sharded state sums from the shards' squares, agree
    to rounding."""
    got, m_got = _one_rank_run(one_rank, True, optimizer, bf16, "fused")
    want, m_want = _one_rank_run(one_rank, False, optimizer, bf16, "fused")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for k in m_want:
        torch.testing.assert_close(m_got[k], m_want[k], rtol=1e-5, atol=0, msg=k)


@pytest.mark.parametrize("kind", ["accum", "imbalanced", "device_data"])
def test_sharded_state_runs_every_step_builder(one_rank, kind):
    """The accumulated step (M=2), the imbalanced [1, 2] window (gated
    updates on the shards) and the device-data window take a sharded
    state, keep its layout, and end bitwise where the replicated state
    does at one rank."""
    got, m_got = _one_rank_run(one_rank, True, "adam", False, kind)
    want, m_want = _one_rank_run(one_rank, False, "adam", False, kind)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for k in m_want:
        torch.testing.assert_close(m_got[k], m_want[k], rtol=1e-5, atol=0, msg=k)
