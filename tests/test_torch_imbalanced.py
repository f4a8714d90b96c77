"""Imbalanced update schedules inside a K-step window (``imbalanced_scan``,
``mmdgan_tpu/train/step.py:507-565``): the flags are 0-d tensors computed
from the device's step count or from a generator and the carried average
of loss_gen, and the updates they gate are selections
(``Adam.gated_update_``) that must leave a gated-off net exactly as the
host-fed step's ``if`` leaves it."""

import numpy as np
import torch

from mmdgan_torch.train.state import tree_leaves
from mmdgan_torch.train.step import imbalanced_scan
from test_torch_trainer import assert_states_equal, setup

torch.set_num_threads(1)
K = 6


def _batches(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (K, 16, 8, 8, 1)).astype(np.uint8),
            rng.randn(K, 16, 16).astype(np.float32))


def test_list_window_equals_host_flagged_single_steps():
    """A [1, 5] window of K=6 steps from step 0 against six single steps
    given the same flags by the host (G updates at steps 0 and 5), bitwise
    on the CPU: every tensor of the state, the gated-off generator's Adam
    slots among them, every metric, and the carried loss_gen average."""
    x, z = _batches()
    _, _, _, ts_w, step = setup()
    _, _, _, ts_s, _ = setup()
    avg = torch.zeros(())
    ts_w, m = imbalanced_scan(step, K, [1, 5], capture=False)(
        ts_w, {"x": x}, None, avg, code_batches={"x": z})
    want_avg = torch.zeros(())
    for k in range(K):
        ts_s, mk = step(ts_s, {"x": x[k]}, True, k % 5 == 0, {"x": z[k]})
        for key in mk:
            assert torch.equal(m[key][k], mk[key]), key
        want_avg = 0.99 * want_avg + 0.01 * mk["loss_gen"]
    assert_states_equal(ts_w, ts_s)
    assert torch.equal(avg, want_avg)
    assert torch.equal(m["do_dis"], torch.ones(K))
    assert int(ts_w.opt_state_dis.count) == K and int(ts_w.opt_state_gen.count) == 2


def test_dynamic_window_keeps_dis_on_below_step_1000():
    """'dynamic': D updates at every step below 1000 whatever the average;
    from step 1000 on, with an average of 1e6 (update probability 1e-7), D
    is gated off: its parameters and Adam slots keep their bits while G
    trains. The uniforms come from the schedule generator, which
    advances."""
    x, z = _batches()
    _, _, _, ts, step = setup()
    multi = imbalanced_scan(step, K, "dynamic", capture=False)
    rng = torch.Generator().manual_seed(98765)
    avg = torch.tensor(1e6)
    before = rng.get_state()
    ts, m = multi(ts, {"x": x}, rng, avg, code_batches={"x": z})
    assert torch.equal(m["do_dis"], torch.ones(K))
    assert int(ts.opt_state_dis.count) == K and int(ts.opt_state_gen.count) == K
    assert not torch.equal(rng.get_state(), before)

    ts.step.fill_(1000)
    avg.fill_(1e6)
    snap = lambda: [t.detach().clone() for t in tree_leaves(ts.params["dis"])
                    + tree_leaves(ts.opt_state_dis.mu) + tree_leaves(ts.opt_state_dis.nu)]
    dis = snap()
    gen = ts.params["gen"]["gen/l1"]["kernel"]["kernel"].detach().clone()
    ts, m = multi(ts, {"x": x}, rng, avg, code_batches={"x": z})
    assert torch.equal(m["do_dis"], torch.zeros(K))
    assert all(torch.equal(a, b) for a, b in zip(dis, snap()))
    assert int(ts.opt_state_dis.count) == K and int(ts.opt_state_gen.count) == 2 * K
    assert not torch.equal(gen, ts.params["gen"]["gen/l1"]["kernel"]["kernel"])
