"""The port's mesh in one process: the host tables and layouts of the
sharded dataset against the JAX package's (bitwise), the sharded samplers
on every rank of a mesh, the collectives a step issues (none without a
mesh), the deferred options, the divisibility errors, an in-process
one-rank gloo group through the Agent, and the cifar CLI under torchrun
at two gloo ranks. The multi-rank numerics are in
``tests/test_torch_mesh_ranks.py``."""

import copy
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmdgan_tpu.data import ReadTFRecords as JaxReadTFRecords
from mmdgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmdgan_tpu.train.step import EpochPermuter as JaxEpochPermuter
from mmdgan_tpu.train.step import sharded_same_class_tables as jax_sharded_same_class_tables
from mmdgan_torch.data.pipeline import ReadTFRecords
from mmdgan_torch.data.tfrecord import np_to_tfrecords
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.parallel import DataParallel, make_mesh_2d
from mmdgan_torch.parallel import collectives
from mmdgan_torch.parallel.mesh import init_distributed
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.step import (
    EpochPermuter,
    build_device_data_step,
    build_grad_accum_step,
    build_train_step,
    class_schedule,
    graph_steps,
    init_train_state,
    same_class_tables,
    sharded_same_class_tables,
)
from mmdgan_torch.train.trainer import Agent

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C = 8, 4
ARCH = {
    "input": [(1, 8, 8)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 8, "op": "d", "act": "tanh",
         "act_nm": "bn", "out_reshape": [1, 8, 8]}],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "d", "act": "lrelu", "w_nm": "s",
         "act_k": 1.3, "in_reshape": [8 * 8]},
        {"name": "l2", "out": 4, "op": "d", "w_nm": "s"}],
}
COND_ARCH = copy.deepcopy(ARCH)
COND_ARCH["generator"][0]["act_nm"] = "cbn"


def _labels(n=64, seed=0):
    return np.random.RandomState(seed).permutation(np.arange(n) % C)[:, None].astype(np.int32)


@pytest.mark.parametrize("width", [0, 40])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_same_class_tables_match_jax(shards, width):
    y = _labels()
    got = sharded_same_class_tables(y, C, shards, width=width)
    want = jax_sharded_same_class_tables(y, C, shards, width=width)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tables, counts = got
    for d in range(shards):
        rows = y[d * 64 // shards:(d + 1) * 64 // shards, 0]
        for c in range(C):
            assert (rows[tables[d, c, :counts[d, c]]] == c).all()
    if width:
        assert tables.shape[2] == width
    with pytest.raises(AssertionError):
        sharded_same_class_tables(np.repeat(np.arange(C), 16), C, 8)


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_epoch_permuter_matches_jax(ndev):
    """Each rank's shard through epochs 0-3 and a resume at epoch 2 equals
    JAX's shard of that device (its seeds fold the device index in)."""
    local_n = 12
    x = np.random.RandomState(1).randint(0, 256, (ndev * local_n, 2, 2, 1), np.uint8)
    mesh = jax_make_mesh(jax.devices()[:ndev])
    jax_p = JaxEpochPermuter.sharded(local_n, ndev, 5, mesh, "data")
    ports = [EpochPermuter.sharded(local_n, ndev, 5, r) for r in range(ndev)]
    shards = [torch.tensor(x[r * local_n:(r + 1) * local_n]) for r in range(ndev)]
    from jax.sharding import NamedSharding, PartitionSpec as P
    j_arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    for e in range(4):
        (j_arr,) = jax_p.advance(e, [j_arr])
        want = np.asarray(j_arr)
        for r in range(ndev):
            ports[r].advance(e, [shards[r]])
            np.testing.assert_array_equal(shards[r].numpy(),
                                          want[r * local_n:(r + 1) * local_n])
    for r in range(ndev):
        fresh = torch.tensor(x[r * local_n:(r + 1) * local_n])
        EpochPermuter.sharded(local_n, ndev, 5, r).advance(2, [fresh])
        (j2,) = JaxEpochPermuter.sharded(local_n, ndev, 5, mesh, "data").advance(
            2, [jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))])
        np.testing.assert_array_equal(fresh.numpy(),
                                      np.asarray(j2)[r * local_n:(r + 1) * local_n])
    assert EpochPermuter._perm_seed(5, 3, 2) == JaxEpochPermuter._perm_seed(5, 3, 2)


@pytest.mark.parametrize("files", [1, 4])
def test_pipeline_shard_record_sets_match_jax(tmp_path, files):
    """Record round-robin (one file) and per-file splits (four files over
    two shards): the rows of every shard, in order, equal JAX's."""
    rng = np.random.RandomState(0)
    names = []
    for f in range(files):
        np_to_tfrecords(rng.randint(0, 256, (12, 3, 4, 4), np.uint8), rng.randint(0, C, 12),
                        str(tmp_path / f"img{f}"))
        names.append(f"img{f}")
    shards = 4 if files == 1 else 2
    kw = dict(num_labels=1, batch_size=1, file_folder=str(tmp_path), buffer_size=1,
              num_epoch=1)

    def rows(pipe):
        return [(b["x"][0].tobytes(), int(b["y"][0, 0])) for b in pipe.next_batch()]

    for i in range(shards):
        got = rows(ReadTFRecords(names, **kw).shape2image(3, 4, 4).shard(shards, i))
        want = rows(JaxReadTFRecords(names, use_native=False, **kw).shape2image(3, 4, 4)
                    .shard(shards, i))
        assert got == want and len(got) == 12 * files // shards
    assert ReadTFRecords(names, **kw).shard().filenames == ReadTFRecords(names, **kw).filenames


def _rank(rank, size):
    """The attributes of a mesh rank the sampler reads."""
    return types.SimpleNamespace(rank=rank, size=size, axis="data", backend="gloo",
                                 device=torch.device("cpu"), is_main=rank == 0)


@pytest.mark.parametrize("same_class", [False, True])
def test_sharded_samplers_draw_local_rows(same_class):
    """Every rank of a 4-rank mesh samples B/4 rows of its own shard (rows
    tagged with their global index); same-class batches take one class
    per step, the same on every rank; at one rank the sampler is the
    single-device one bitwise."""
    n, ranks = 64, 4
    y = _labels(n)
    model = SNGan(COND_ARCH if same_class else ARCH, num_class=C if same_class else 0,
                  device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    tables = sharded_same_class_tables(y, C, ranks) if same_class else (None, None)
    fn = build_device_data_step(model, opt_d, opt_g, 2, B, same_class=same_class,
                                class_table=tables[0], class_counts=tables[1], device="cpu")
    tags = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1) * np.ones((1, 8, 8, 1), np.float32)
    classes = []
    for r in range(ranks):
        local = slice(r * n // ranks, (r + 1) * n // ranks)
        sample = fn.with_mesh(_rank(r, ranks)).sampler(torch.tensor(tags[local]),
                                                       torch.tensor(y[local]).long())
        rng = torch.Generator().manual_seed(3)
        per_step = []
        for t in range(6):
            batch = sample(rng, torch.tensor(t))
            rows = batch["x"][:, 0, 0, 0].long().numpy()     # global row indices
            assert batch["x"].shape[0] == B // ranks
            assert local.start <= rows.min() and rows.max() < local.stop
            got_y = y[rows, 0]
            assert np.array_equal(batch["y"][:, 0].numpy(), got_y)
            per_step.append(int(got_y[0]) if same_class else None)
            if same_class:
                assert (got_y == got_y[0]).all()
        classes.append(per_step)
    if same_class:
        assert all(c == classes[0] for c in classes) and len(set(classes[0])) > 1
    if same_class:
        with pytest.raises(ValueError, match="with_mesh"):
            fn(None, None, None, None)
    else:
        got = [s(torch.tensor(tags[:16]))(torch.Generator().manual_seed(4), torch.tensor(0))["x"]
               for s in (fn.sampler, fn.with_mesh(_rank(0, 1)).sampler)]
        assert torch.equal(got[0], got[1])


def test_scheduled_same_class_sampler_per_rank():
    """Same-class shuffled epochs over a 2-rank mesh: each rank walks its
    own local class-epochs (rank 0 the single-device stream), the class of
    each step from the shared schedule."""
    n, ranks = 128, 2
    y = _labels(n)
    model = SNGan(COND_ARCH, num_class=C, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    tables = sharded_same_class_tables(y, C, ranks)
    fn = build_device_data_step(model, opt_d, opt_g, 2, B, same_class=True,
                                class_table=tables[0], class_counts=tables[1],
                                sampling="shuffled_epochs", device="cpu")
    sched = class_schedule(C, 8, 0)
    tags = torch.arange(n, dtype=torch.float32).reshape(n, 1, 1, 1).expand(n, 8, 8, 1)
    seen = []
    for r in range(ranks):
        sample = fn.with_mesh(_rank(r, ranks)).sampler(tags[r * 64:(r + 1) * 64])
        rows = [sample(None, torch.tensor(t), torch.tensor(sched[t]))["x"][:, 0, 0, 0].long()
                for t in range(8)]
        for t, row in enumerate(rows):
            assert (y[row.numpy(), 0] == sched[t, 0]).all()
            assert (r * 64 <= row).all() and (row < (r + 1) * 64).all()
        seen.append(torch.cat(rows))
    assert not torch.equal(seen[0], seen[1])
    with pytest.raises(ValueError, match="batch_size rows"):
        build_device_data_step(model, opt_d, opt_g, 2, 64, same_class=True,
                               class_table=tables[0], class_counts=tables[1],
                               sampling="shuffled_epochs", device="cpu").with_mesh(_rank(0, 2))


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group of this process (a file:// store), left after
    the test."""
    init_distributed("gloo", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        yield DataParallel(device="cpu")
    finally:
        dist.destroy_process_group()


def _count_collectives(monkeypatch):
    calls = []
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast"):
        real = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _real=real, _n=name, **k: (
            calls.append(_n), _real(*a, **k))[1])
    return calls


def _model_and_state(loss="rep"):
    """SGD: Adam would turn the rounding noise on the score bias, whose true
    gradient is 0, into steps of the learning rate."""
    model = SNGan(ARCH, loss_type=loss, compute_dtype=torch.float32, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-2, 1e-2], optimizer="sgd")
    return model, opt_d, opt_g, init_train_state(model, 0, opt_d, opt_g, device="cpu")


def test_steps_without_a_mesh_issue_no_collective(monkeypatch):
    calls = _count_collectives(monkeypatch)
    x = np.random.RandomState(0).randn(B, 8, 8, 1).astype(np.float32)
    for loss in ("rep", "rmb_gp"):
        model, opt_d, opt_g, ts = _model_and_state(loss)
        build_train_step(model, opt_d, opt_g, device="cpu")(ts, {"x": x})
        build_grad_accum_step(model, opt_d, opt_g, 2, device="cpu")(ts, {"x": x})
        build_device_data_step(model, opt_d, opt_g, 2, B, device="cpu")(
            ts, torch.tensor(x), None, torch.Generator().manual_seed(0))
    assert calls == []


def test_mesh_step_issues_a_fixed_sequence_of_collectives(one_rank, monkeypatch):
    """On a one-rank mesh every step issues the same collectives, whatever
    the update flags; the one-rank mesh step equals the single-device step
    at the same batch; a gloo mesh refuses to capture."""
    calls = _count_collectives(monkeypatch)
    x = np.random.RandomState(0).randn(2, B, 8, 8, 1).astype(np.float32)
    z = np.random.RandomState(1).randn(2, B, 8).astype(np.float32)
    model, opt_d, opt_g, ts = _model_and_state()
    _, _, _, ts_plain = _model_and_state()
    step = build_train_step(model, opt_d, opt_g, device="cpu", dp=one_rank)
    plain = build_train_step(model, opt_d, opt_g, device="cpu")
    counts = []
    for k, flags in enumerate([(True, True), (False, True)]):
        before = len(calls)
        ts, m = step(ts, {"x": x[k]}, *flags, code_batch={"x": z[k]})
        counts.append(calls[before:])
        ts_plain, m_plain = plain(ts_plain, {"x": x[k]}, *flags, code_batch={"x": z[k]})
        for key in m:
            np.testing.assert_allclose(m[key].numpy(), m_plain[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    # forward: BN mean and variance, the score gather, |G(z)|; backward:
    # the gather's reduce-scatter twice, BN's two sums; one gradient
    # average per network; rank 0's SN vectors and BN statistics
    assert counts[0] == counts[1] and len(counts[0]) == 11, counts
    assert counts[0].count("broadcast") == 1
    assert counts[0].count("all_gather") == 1
    for a, b in zip(ts.tensors(), ts_plain.tensors()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="gloo"):
        graph_steps(step, 2, capture=True)(ts, {"x": torch.tensor(x)})


def test_collectives_differentiate_twice(one_rank):
    """The collectives' backwards are collectives themselves, so a second
    derivative runs through them: at one rank, the first and second
    derivatives of weighted cubes equal the plain ops'."""
    x = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64).reshape(3, 2).requires_grad_(True)
    w = torch.arange(6.0, dtype=torch.float64).reshape(3, 2)
    for reduce in (lambda t: torch.sum(collectives.all_gather(t, one_rank) * w),
                   lambda t: torch.sum(collectives.all_reduce(t, one_rank) * w),
                   lambda t: collectives.batch_mean(t * w, one_rank) * t.numel()):
        (g,) = torch.autograd.grad(reduce(x ** 3), x, create_graph=True)
        (gg,) = torch.autograd.grad(g.sum(), x)
        torch.testing.assert_close(g, 3 * x.detach() ** 2 * w)
        torch.testing.assert_close(gg, 6 * x.detach() * w)


def test_deferred_options_and_divisibility_errors(one_rank):
    """The 2-D mesh and fsdp (once deferred) build: a 2-D mesh needs its
    ranks, refuses ``fsdp=True`` with the JAX package's assertion
    (``mmdgan_tpu/parallel/mesh.py:206-209``) and otherwise shards over
    its model axis; fsdp shards a 1-D mesh's state, the small leaves
    replicated. Then the divisibility errors."""
    with pytest.raises(ValueError, match=r"\(2,2\) mesh needs 4 ranks"):
        make_mesh_2d(2, 2)
    dp2 = DataParallel(make_mesh_2d(1, 1), device="cpu")
    with pytest.raises(AssertionError, match="fsdp shards over the data"):
        dp2.shard_state({"w": torch.ones(4, 4)}, fsdp=True)
    assert dp2.shard_state({"w": torch.ones(4096)})["w"].shape == (4096,)
    model, opt_d, opt_g, ts = _model_and_state()
    sharded = dp2.shard_state(ts, min_size=64)
    assert sharded.layout.axis_name == "model" and not dp2._is_fsdp_layout(sharded)
    placed = one_rank.shard_state({"w": torch.ones(64, 64), "b": torch.ones(8)}, fsdp=True)
    assert placed["w"].shape == (4096,) and placed["b"].shape == (8,)
    sharded = one_rank.shard_state(ts, min_size=64, fsdp=True)
    assert one_rank._is_fsdp_layout(sharded) and one_rank.ensure_placed(sharded) is sharded
    # the two 512-element kernels and the generator's 64-wide BN scale and offset
    assert sharded.layout.sharded_leaves == 4
    ranks = types.SimpleNamespace(size=4, rank=1, process_count=4)
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        DataParallel.local_batch_size(ranks, 30)
    assert DataParallel.local_batch_size(ranks, 64) == 16
    t = torch.arange(16)
    with pytest.raises(ValueError, match="not divisible"):
        DataParallel.local_rows(ranks, t, 3)
    assert DataParallel.local_rows(ranks, t).tolist() == [4, 5, 6, 7]
    # micro-major: the second quarter of each half
    assert DataParallel.local_rows(ranks, t, 2).tolist() == [2, 3, 10, 11]
    model, opt_d, opt_g, _ = _model_and_state()
    with pytest.raises(ValueError, match="split over 4 ranks"):
        build_device_data_step(model, opt_d, opt_g, 2, 6, device="cpu").with_mesh(ranks)
    assert collectives.batch_mean(torch.ones(3), None) == 1.0


def test_data_parallel_helpers(one_rank):
    """The DataParallel API the JAX package's has: the mesh's sizes, a
    rank's batches placed on its device, the state replicated in place,
    the step check, the host values, the tower average (equal to JAX's)."""
    from mmdgan_tpu.parallel.mesh import average_tower_grads as jax_average_tower_grads
    from mmdgan_torch.parallel.mesh import average_tower_grads

    dp = one_rank
    assert (dp.num_devices, dp.data_size, dp.process_count, dp.rank, dp.axis) == (1, 1, 1, 0,
                                                                                  "data")
    assert dp.backend == "gloo" and dp.is_main and dp.local_batch_size(64) == 64
    batch = dp.shard_batch({"x": np.ones((4, 2), np.float32), "y": None})
    assert batch["y"] is None and batch["x"].device == dp.device
    assert [b["x"].shape for b in dp.prefetch([{"x": np.zeros((2, 3))}] * 2)] == [(2, 3)] * 2
    model, opt_d, opt_g, ts = _model_and_state()
    tensors = ts.tensors()
    assert dp.replicate(ts) is ts and all(a is b for a, b in zip(ts.tensors(), tensors))
    with pytest.raises(ValueError, match="dp="):
        dp.compile_step(build_train_step(model, opt_d, opt_g, device="cpu"))
    step = build_train_step(model, opt_d, opt_g, device="cpu", dp=dp)
    assert dp.compile_step(step) is step and dp.ensure_placed(ts) is ts
    assert dp.fully_replicated_value({"a": torch.ones(2)})["a"].tolist() == [1.0, 1.0]
    towers = [{"w": np.full(3, float(i)), "b": {"c": np.arange(2.0) * i}} for i in range(3)]
    got = average_tower_grads([{"w": torch.tensor(t["w"]), "b": {"c": torch.tensor(t["b"]["c"])}}
                               for t in towers])
    want = jax_average_tower_grads(towers)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_allclose(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))


def test_agent_on_a_one_rank_mesh_resumes(one_rank, tmp_path):
    """``Agent.train(dp=)`` in K=2 windows: 4 steps straight equal 2 +
    restore by a new Agent + 2, bitwise; ``train_device_data(dp=)``
    shuffled epochs runs and checkpoints."""
    def run(name, steps, load, start=0):
        model, opt_d, opt_g, ts = _model_and_state()
        step = build_train_step(model, opt_d, opt_g, device="cpu", dp=one_rank)
        agent = Agent(name, "t", output_dir=str(tmp_path), load_ckpt=load, print_loss=False,
                      use_tensorboard=False, query_step=2)
        data = ({"x": np.full((B, 8, 8, 1), 0.1 * i, np.float32)} for i in range(start, 100))
        return agent.train(step, ts, data, max_step=steps, step_per_epoch=10, dp=one_rank,
                           steps_per_call=2)

    straight = run("straight", 4, False)
    run("halves", 2, False)
    resumed = run("halves", 2, True, start=2)
    assert int(resumed.step) == 4
    for a, b in zip(straight.tensors(), resumed.tensors()):
        assert torch.equal(a, b)
    model, opt_d, opt_g, ts = _model_and_state()
    agent = Agent("device", "t", output_dir=str(tmp_path), print_loss=False,
                  use_tensorboard=False)
    data = {"x": np.random.RandomState(0).randint(0, 256, (32, 8, 8, 1), np.uint8), "y": None}
    ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=6, step_per_epoch=4,
                                 batch_size=B, steps_per_call=2, sampling="shuffled_epochs",
                                 dp=one_rank)
    assert int(ts.step) == 6 and os.path.isfile(os.path.join(agent.ckpt_folder, "ckpt-6.pt"))


def test_cifar_cli_under_torchrun_two_gloo_ranks(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2
    -m mmdgan_torch.experiments.cifar --device cpu``: two chunks of two
    steps of the full cifar model at a global batch of 4, the second
    resuming on both ranks from rank 0's checkpoint; rank 0 alone writes
    the metrics log and prints."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "mmdgan_torch.experiments.cifar", "--device", "cpu", "--synthetic-data",
         "--debug-mode", "true", "--debug-step", "2", "--steps-per-call", "1",
         "--query-step", "2", "--compute-dtype", "float32", "--skip-sampling",
         "--skip-metrics", "--chunks", "2", "--batch-size", "4", "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Devices: 2 (cpu cpu, gloo mesh)") == 1, out.stdout
    assert "restored checkpoint at step 2" in out.stdout
    run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    steps = sorted(os.listdir(tmp_path / "cifar_ckpt" / run))
    assert steps == ["ckpt-2.pt", "ckpt-4.pt"]
    recs = [json.loads(ln) for ln in open(tmp_path / "cifar_log" / run / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss_gen" in r] == [2, 4]
