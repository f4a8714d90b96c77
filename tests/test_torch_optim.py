"""The port's optimizers against the JAX package's (optax sgd, momentum,
rmsprop and adam, the package's ``adam_tf1``, each with and without
``with_bf16_slots``) on a small model's parameter trees.

Each case: three JAX updates from the JAX init, the state bridged into the
port (``jax_params_to_torch(optimizers=...)``), then ten more updates on
both sides with the same numpy gradients. sgd and momentum decay their lr
by 0.96 per step (``target_step`` 20 from 1e-2 to 5e-3), so the ten steps
read the schedule at counts 3-12 on the device. Parameters and slots are
compared at rtol 1e-5 (atol 1e-7 on the parameters, 1e-6 on the slots:
momentum's trace sums thirteen O(1) gradients, and an entry that cancels
keeps their rounding, which XLA's fused multiply-adds round otherwise);
with bf16 slots the slots at rtol 2^-7
(one bfloat16 rounding apart) and the parameters at rtol 1e-5 plus an atol
of lr * 2^-7 per step (a slot one rounding apart moves an update by that
much). Then ``gated_update_`` and the checkpoints, bitwise, and the CLI
with every optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_torch.experiments.cifar import main as cifar_main
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import SGD, Adam, AdamTF1, OptState, RMSProp, multi_opt_config
from mmdgan_torch.train.state import tree_leaves
from mmdgan_torch.train.step import build_train_step, init_train_state
from mmdgan_torch.utils import checkpoint
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(2)

ARCH = {
    "input": [(3, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 2 * 2, "op": "d", "act": "linear",
         "act_nm": None, "out_reshape": [8, 2, 2]},
        {"name": "l2_up", "out": 6, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3_up", "out": 4, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l4", "out": 3, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 4, "act": "lrelu", "act_k": 1.5, "w_nm": "s"},
        {"name": "l2_ds", "out": 8, "act": "lrelu", "act_k": 1.5, "w_nm": "s",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 8, "op": "c", "act": "lrelu", "act_k": 1.5, "w_nm": "s",
         "out_reshape": [4 * 4 * 8]},
        {"name": "l4_s", "out": 16, "op": "d", "act_k": 1.5, "bias": "b", "w_nm": "s"},
    ],
}
OPTIMIZERS = ["sgd", "momentum", "rmsprop", "adam", "adam_tf1"]
CONFIG = dict(end_lr=5e-3, target_step=20)   # sgd/momentum: 0.96 per step
LR = [1e-2, 2e-3]
JAX_STEPS, STEPS = 3, 10


@pytest.fixture(scope="module")
def models():
    jmodel = JaxSNGan(ARCH, compute_dtype=jnp.float32)
    params, net_state, _ = jmodel.init(jax.random.PRNGKey(0))
    model = SNGan(ARCH, compute_dtype=torch.float32, device="cpu")
    return jmodel, jax.device_get(params), jax.device_get(net_state), model


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * 0.3).astype(np.float32), params)


def _leaves(tree):
    return [np.asarray(v, np.float32) for v in tree_leaves(tree)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_jax_from_a_bridged_state(models, name, bf16):
    jmodel, params, net_state, model = models
    jopts = jax_multi_opt_config(LR, optimizer=name, bf16_moments=bf16, **CONFIG)
    opts = multi_opt_config(LR, optimizer=name, bf16_moments=bf16, **CONFIG)
    if name in ("sgd", "momentum"):
        # the generator's end_lr lies above its lr: a non-positive decay keeps it
        assert opts[0].decay_steps == 1 and opts[1].decay_steps <= 0
    nets = ("dis", "gen")
    states = [o.init(params[n]) for o, n in zip(jopts, nets)]
    updates = jax.jit(lambda g, s, i: jopts[i].update(g, s), static_argnums=2)

    def jax_step(params, states, seed):
        grads = _grads(params, seed)
        params, new = dict(params), []
        for i, n in enumerate(nets):
            u, s = updates(grads[n], states[i], i)
            params[n] = jax.tree.map(lambda p, d: p + d, params[n], u)
            new.append(s)
        return params, new

    for k in range(JAX_STEPS):
        params, states = jax_step(params, states, k)
    tparams, _, tstates = jax_params_to_torch(model, jax.device_get(params), net_state,
                                              opt_states=states, optimizers=opts)
    for s, o in zip(tstates, opts):
        assert isinstance(s, OptState) and set(s.slots) == set(o.slot_names)
        assert all(t.dtype == (torch.bfloat16 if bf16 else torch.float32)
                   for t in s.tensors()[1:])
    for k in range(JAX_STEPS, JAX_STEPS + STEPS):
        grads, _ = jax_params_to_torch(model, _grads(params, k), net_state)
        for o, s, n in zip(opts, tstates, nets):
            o.update_(tree_leaves(tparams[n]), tree_leaves(grads[n]), s)
        params, states = jax_step(params, states, k)

    want_params, _, want_states = jax_params_to_torch(model, jax.device_get(params), net_state,
                                                      opt_states=states, optimizers=opts)
    for o, n, got_s, want_s in zip(opts, nets, tstates, want_states):
        p_tol = dict(rtol=1e-5, atol=(o.lr * 2 ** -7 * STEPS) if bf16 else 1e-7)
        for g, w in zip(_leaves(tparams[n]), _leaves(want_params[n])):
            np.testing.assert_allclose(g, w, **p_tol, err_msg=f"{name} {n} params")
        s_tol = dict(rtol=2 ** -7, atol=1e-6) if bf16 else dict(rtol=1e-5, atol=1e-6)
        for g, w in zip(got_s.tensors()[1:], want_s.tensors()[1:]):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **s_tol,
                                       err_msg=f"{name} {n} slots")
        if name != "rmsprop":   # optax's rmsprop keeps no count
            assert int(got_s.count) == int(want_s.count) == JAX_STEPS + STEPS


def test_decayed_lr_is_read_on_the_device_before_the_increment():
    opt = SGD(0.1, decay_steps=2)
    count = torch.tensor(0, dtype=torch.int32)
    assert float(opt.lr_at(count)) == pytest.approx(0.1)
    count.fill_(3)
    assert float(opt.lr_at(count)) == pytest.approx(0.1 * 0.96 ** 1.5, rel=1e-6)
    assert isinstance(opt.lr_at(count), torch.Tensor) and SGD(0.1).lr_at(count) == 0.1
    p = [torch.ones(3)]
    state = opt.init({"w": p[0]})
    opt.update_(p, [torch.ones(3)], state)
    np.testing.assert_allclose(p[0].numpy(), 1.0 - 0.1, rtol=1e-7)   # count 0: lr
    assert int(state.count) == 1


OPT_CLASSES = [Adam(1e-3), AdamTF1(1e-3), SGD(1e-2, decay_steps=3), SGD(1e-2, momentum=0.9),
               RMSProp(1e-3), Adam(1e-3, True), SGD(1e-2, True, momentum=0.9),
               RMSProp(1e-3, True)]


@pytest.mark.parametrize("opt", OPT_CLASSES, ids=lambda o: f"{type(o).__name__}"
                         f"{'_momentum' if getattr(o, 'momentum', None) else ''}"
                         f"{'_bf16' if o.bf16_slots else ''}")
def test_gated_update_keeps_bits_when_false(opt):
    rng = np.random.RandomState(0)
    params = {"a": torch.tensor(rng.randn(4, 3).astype(np.float32)),
              "b": {"c": torch.tensor(rng.randn(5).astype(np.float32))}}
    grads = [torch.tensor(rng.randn(*p.shape).astype(np.float32)) for p in tree_leaves(params)]
    state = opt.init(params)
    opt.update_(tree_leaves(params), grads, state)   # slots and count non-trivial
    before = [t.clone() for t in tree_leaves(params) + state.tensors()]
    opt.gated_update_(tree_leaves(params), grads, state, torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params) + state.tensors()))
    on_params = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
    on = opt.init(on_params)
    for dst, src in zip(on.tensors(), state.tensors()):
        dst.copy_(src)
    opt.gated_update_(tree_leaves(params), grads, state, torch.tensor(True))
    opt.update_(tree_leaves(on_params), grads, on)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params) + state.tensors(),
                                                 tree_leaves(on_params) + on.tensors()))


@pytest.mark.parametrize("name,bf16", [("sgd", False), ("momentum", True), ("rmsprop", False),
                                       ("adam_tf1", True), ("adam", True)])
def test_checkpoint_round_trip_is_bitwise(tmp_path, name, bf16):
    model = SNGan(ARCH, compute_dtype=torch.float32, device="cpu")
    opts = multi_opt_config([1e-3, 1e-3], optimizer=name, bf16_moments=bf16, target_step=50)
    ts = init_train_state(model, 0, *opts, device="cpu")
    step = build_train_step(model, *opts, device="cpu")
    x = np.random.RandomState(0).randn(4, 8, 8, 3).clip(-1, 1).astype(np.float32)
    for _ in range(2):
        ts, _ = step(ts, {"x": x})
    path = checkpoint.save(str(tmp_path), ts, 2)
    fresh = init_train_state(model, 5, *opts, device="cpu")
    checkpoint.restore_into(fresh, path)
    assert len(fresh.tensors()) == len(ts.tensors())
    for a, b in zip(fresh.tensors(), ts.tensors()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(fresh.opt_state_dis.count) == 2


@pytest.mark.parametrize("flags", [["--optimizer", name] for name in OPTIMIZERS]
                         + [["--optimizer", "momentum", "--bf16-moments"],
                            ["--bf16-moments"]])
def test_cifar_cli_runs_every_optimizer(tmp_path, flags):
    """Two steps of the full cifar model at B=4 on the CPU under each
    optimizer; the checkpoint holds its slots (bf16 with --bf16-moments)."""
    cifar_main(["--device", "cpu", "--synthetic-data", "--debug-mode", "true",
                "--debug-step", "2", "--steps-per-call", "2", "--compute-dtype", "float32",
                "--skip-sampling", "--chunks", "1", "--batch-size", "4",
                "--out-dir", str(tmp_path), *flags])
    run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    saved = torch.load(tmp_path / "cifar_ckpt" / run / "ckpt-2.pt", weights_only=False)
    opt = saved["opt_state_dis"]
    assert int(opt["count"]) == 2
    slots = [k for k in opt if k != "count"]
    name = flags[1] if flags[0] == "--optimizer" else "adam"
    assert sorted(slots) == {"sgd": [], "momentum": ["trace"], "rmsprop": ["nu"],
                             "adam": ["mu", "nu"], "adam_tf1": ["m", "v"]}[name]
    dtype = torch.bfloat16 if "--bf16-moments" in flags else torch.float32
    assert all(t.dtype == dtype for k in slots for t in tree_leaves(opt[k]))
