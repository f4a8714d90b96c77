"""hd512 (``hd_architecture(512)``, the benchmark's ``hd512`` configuration)
in the port, and the stage timer that gives its full-resolution layers'
device time (``utils/spans.py`` ``StageTimer``).

The configuration file holds the port's family dict; the port's leaves
have the plain reference's shapes at the published widths; the port's
float32 step follows the reference's (``benchmark/reference/mmdgan.py``)
over 3 steps of the same family at 32x32 and 64x64; the timer records
nothing untraced or off CUDA, and its marks change no bit of a step.

``test_traced_eager_window_times_the_marked_layers`` needs a CUDA card
(marker ``card``); on the card: ``python -m pytest --noconftest
tests/test_torch_hd512.py -m card``.
"""

import copy
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.drivers import _port
from benchmark.reference import mmdgan
from mmdgan_torch.architectures import hd_architecture
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.state import tree_leaves
from mmdgan_torch.train.step import build_train_step, graph_steps, init_train_state
from mmdgan_torch.utils import spans

CFG = harness.load_json(os.path.join(harness.BENCH_DIR, "configs", "hd512.json"))
CPU = torch.device("cpu")
HD512_PARAMETERS = 58_302_803


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def _cfg(size: int, dtype: str = "float32") -> dict:
    """The hd512 configuration with the family's ``size`` in its place."""
    cfg = copy.deepcopy(CFG)
    cfg["architecture"] = json.loads(json.dumps(hd_architecture(size)))
    cfg["dataset"]["shape_hwc"] = [size, size, 3]
    cfg["compute_dtype"] = dtype
    return cfg


def test_config_holds_hd_architecture_512():
    assert CFG["architecture"] == json.loads(json.dumps(hd_architecture(512)))
    assert CFG["dataset"]["shape_hwc"] == [512, 512, 3]
    assert CFG["reduced"] == ["dataset.rows"] and CFG["dataset"]["rows"] == 3000
    assert (CFG["batch_size"], CFG["loss"], CFG["compute_dtype"]) == (64, "rep", "bfloat16")


def test_port_leaves_have_the_reference_shapes_at_hd512():
    """Builds the model and draws its weights; takes no step."""
    model = SNGan(hd_architecture(512), device="cpu")
    params, state, _ = model.init(0)
    held = SimpleNamespace(params=params, net_state=state)
    specs = mmdgan.leaf_specs(CFG["architecture"])
    for name, spec in specs.items():
        assert tuple(_port.leaf(held, name).shape) == tuple(spec["shape"]), name
    in_specs = sum(int(np.prod(s["shape"])) for s in specs.values() if s["group"] == "param")
    assert sum(t.numel() for t in tree_leaves(params)) == in_specs == HD512_PARAMETERS
    assert len(tree_leaves(state)) == sum(s["group"] != "param" for s in specs.values())


# Tolerances of the float32 step against the float32 reference, from the
# CPU's readings at 32x32 and 64x64 (b8, 3 steps, weights of two seeds,
# under ATEN_CPU_CAPABILITY=default too), largest first:
# - the step's metrics, relative: 8.4e-4 read. The kernel means sit within
#   0.3% of 1, so the losses are differences of terms 300-2000x their size,
#   and float32's rounding of the terms comes back that much larger;
# - Adam's moments, the SN vectors and the BN statistics, each leaf by the
#   norm of its difference over the reference's norm: 3.6e-3 read (the
#   moments of G's trunk and of D's biases, whose gradients come through
#   those losses). The port in bfloat16 reads 0.16 (32x32) and 0.53
#   (64x64) at its worst leaf;
# - the parameters, by Adam's update from the port's own moments: 1.4e-4
#   read. The port takes the bias corrections on the device in float32
#   (``train/optim.py``, from the count), where 1 - 0.999^t rounds by up to
#   6e-5 of itself at t = 1. Against the reference's parameters an
#   element whose gradient is near zero moves by +-lr on either side's
#   rounding (Adam's first steps are near lr * sign(g)), which read up to
#   0.18 of a bias's change.
# The score layer's bias is left out with its slots: MMD is shift-invariant,
# so its gradient is round-off alone and Adam moves it by that round-off's
# sign (``benchmark/reference/check.py`` leaves it out too).
METRIC_RTOL = 5e-3
LEAF_RTOL = 2e-2
UPDATE_RTOL = 1e-3


def _leaf_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    return float((p.double() - r.double()).norm() / max(float(r.double().norm()), 1e-30))


def _adam_update(cfg: dict, net: str, p, mu, nu, t: int):
    """The reference's Adam step of ``p`` from the moments ``mu``, ``nu``."""
    b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["eps"]
    lr = cfg["lr_dis"] if net == "dis" else cfg["lr_gen"]
    return p - lr * (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + eps)


@pytest.mark.parametrize("size", [32, 64])
def test_float32_step_follows_the_reference(size):
    """Three steps on seeded weights, rows and codes; before each, the
    reference takes the port's state (Adam's moments and counts, the SN
    vectors and BN statistics with it), so each step is compared from the
    same start rather than after two paths have parted (from the saturated
    start they part within a few steps)."""
    cfg = _cfg(size)
    specs = mmdgan.leaf_specs(cfg["architecture"])
    b, code = 8, cfg["architecture"]["code"][0][0]
    model, opt_d, opt_g = _port.build(cfg, CPU)
    ts = init_train_state(model, 1, opt_d, opt_g, device=CPU)
    _port.write_state(ts, _port.make_state(cfg, specs, 7, CPU))
    ts.rng.manual_seed(11)
    step = build_train_step(model, opt_d, opt_g, device=CPU)
    codes = torch.Generator().manual_seed(11)   # the draws of ts.rng, one a step
    score_bias = f"dis/{cfg['architecture']['discriminator'][-1]['name']}/bias/bias"
    for i in range(3):
        start = _port.read_state(ts, specs)
        ref = dict(start)
        ref["count/dis"] = ref["count/gen"] = torch.tensor(float(i))
        x = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(100 + i))
        z = torch.randn(b, code, generator=codes)
        ts, metrics = step(ts, {"x": x})
        out = mmdgan.train_step(cfg, specs, ref, x, z)
        for k in ("loss_gen", "loss_dis", "e_kxx", "e_kxy", "e_kyy", "grad_norm_dis",
                  "grad_norm_gen", "x_gen_abs_mean"):
            assert float(metrics[k]) == pytest.approx(out[k], rel=METRIC_RTOL), (i, k)
        prog = _port.read_state(ts, specs)
        for n in prog:
            if n.endswith(score_bias):
                continue
            if n in specs and specs[n]["group"] == "param":
                want = _adam_update(cfg, n.split("/")[0], start[n], prog[f"mu/{n}"],
                                    prog[f"nu/{n}"], i + 1)
                gap, tol = _leaf_gap(prog[n] - start[n], want - start[n]), UPDATE_RTOL
            else:
                gap, tol = _leaf_gap(prog[n], ref[n]), LEAF_RTOL
            assert gap <= tol, (i, n, gap)


# ---------------------------------------------------------------------------
# the stage timer
# ---------------------------------------------------------------------------
class HostEvent:
    """A host-clock stand-in for a CUDA timing event."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def _marked_model(size: int = 32):
    """A float32 hd model and a host-clock timer of its maps of 16x16 and
    up: D's l1_f32, l2_ds, l3_ds and G's l3_up, l4_t16x2 at 32x32."""
    cfg = _cfg(size)
    model, opt_d, opt_g = _port.build(cfg, CPU)
    timer = spans.StageTimer(min_side=16, event=HostEvent)
    assert _timed(model, timer) == ["gen/l3_up", "gen/l4_t16x2", "dis/l1_f32", "dis/l2_ds",
                                    "dis/l3_ds"]
    return cfg, model, opt_d, opt_g, timer


def _timed(model, timer):
    return [l.layer_scope for net in (model.Gen, model.Dis) for l in net.net.layers
            if timer.covers((l.input_shape, l.pre_out_reshape_shape))]


def test_only_maps_of_128_and_up_are_timed():
    timer = spans.StageTimer()
    assert _timed(SNGan(hd_architecture(512), device="cpu"), timer) == [
        "gen/l6_up", "gen/l7_up", "gen/l8_t256x2",
        "dis/l1_f512", "dis/l2_ds", "dis/l3_ds", "dis/l4_ds"]
    for size in (32, 64):
        assert _timed(SNGan(hd_architecture(size), device="cpu"), timer) == []


def test_timer_records_nothing_untraced_or_off_cuda():
    assert not spans.tracing()
    assert spans.window_timer(torch.device("cuda")) is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.tracing()
        assert spans.window_timer(CPU) is None
    # a traced eager window of a model with 128x128 maps on the CPU counts
    # no time
    model, opt_d, opt_g = _port.build(_cfg(128), CPU)
    ts = init_train_state(model, 1, opt_d, opt_g, device=CPU)
    window = graph_steps(build_train_step(model, opt_d, opt_g, device=CPU), 2)
    x = torch.randint(0, 256, (2, 2, 128, 128, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]):
        window(ts, {"x": x})
    assert not [n for n in spans.counters() if n.startswith("hires.")]
    assert spans.stage_timer() is None


def test_a_timer_of_no_layer_records_nothing():
    _, model, opt_d, opt_g, _ = _marked_model()
    ts = init_train_state(model, 3, opt_d, opt_g, device=CPU)
    step = build_train_step(model, opt_d, opt_g, device=CPU)
    x = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8)
    with profile(activities=[ProfilerActivity.CPU]), \
            spans.timing(spans.StageTimer(min_side=64, event=HostEvent)):
        step(ts, {"x": x})
    assert not [n for n in spans.counters() if n.startswith("hires.")]


def test_stage_marks_leave_a_step_bitwise_unchanged():
    cfg, model, opt_d, opt_g, timer = _marked_model()
    specs = mmdgan.leaf_specs(cfg["architecture"])
    step = build_train_step(model, opt_d, opt_g, device=CPU)
    x = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(5))
    runs = []
    for t in (None, timer):
        ts = init_train_state(model, 3, opt_d, opt_g, device=CPU)
        metrics = []
        with profile(activities=[ProfilerActivity.CPU]), spans.timing(t):
            assert spans.stage_timer() is t
            for _ in range(2):
                metrics.append(step(ts, {"x": x})[1])
                if t is not None:
                    t.next_step()
        runs.append((metrics, _port.read_state(ts, specs)))
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), a
    assert all(torch.equal(s0[n], s1[n]) for n in s0)
    steps = timer.totals()
    assert len(steps) == 2 and all(t["fwd_ms"] > 0 and t["bwd_ms"] > 0 for t in steps)
    # the counters hold the fastest step
    t = min(steps, key=lambda t: t["fwd_ms"] + t["bwd_ms"])
    counters = spans.counters()
    assert counters["hires.steps"] == 1
    assert counters["hires.fwd_us"] == int(round(1e3 * t["fwd_ms"]))
    assert counters["hires.bwd_us"] == int(round(1e3 * t["bwd_ms"]))
    assert spans.stage_timer() is None


@pytest.mark.card
def test_traced_eager_window_times_the_full_resolution_layers():
    """On the card: a traced graphed window's eager first call records the
    128x128 layers' device time of its fastest step; its capture and
    replays add nothing, and an untraced call records nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = _cfg(128, "bfloat16")
    model, opt_d, opt_g = _port.build(cfg, dev)
    ts = init_train_state(model, 1, opt_d, opt_g, device=dev)
    step = build_train_step(model, opt_d, opt_g, device=dev)
    x = torch.randint(0, 256, (4, 64, 128, 128, 3), dtype=torch.uint8, device=dev)
    graph_steps(step, 4)(ts, {"x": x})
    assert spans.counters() == {}
    window = graph_steps(step, 4)   # a new window: eager, captured, then replayed
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(4):
            window(ts, {"x": x})
        torch.cuda.synchronize()
    c = spans.counters()
    assert (window.graphs.eager, window.graphs.captures) == (1, 1)
    assert c["hires.steps"] == 1, c
    assert c["hires.fwd_us"] > 0 and c["hires.bwd_us"] > 0, c
