"""The readers of the program's spans on canned traces: idle inside their
spans is counted, idle outside them or under another span is not, a
stretch without them reads nothing, and what they attribute never
exceeds the stretch's idle time."""

import random
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program_spans, trace
from benchmark.tests.helpers import run_fixture
from mmdgan_torch.utils import spans

TRAIN = ("launch_idle_ms_per_step.train", "guard_idle_ms_per_step.train",
         "feed_idle_ms_per_step.records")
SPANS = {"launch_idle_ms_per_step.train": ("graphs.replay",),
         "guard_idle_ms_per_step.train": ("agent.guard", "agent.report"),
         "feed_idle_ms_per_step.records": ("agent.feed_wait",),
         "serve_dispatch_idle_ms_per_call": ("serve.call",)}


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def _run(stretch=None):
    return types.SimpleNamespace(stretch=stretch, spans=types.SimpleNamespace(seconds={}),
                                 counters={}, cfg={})


def read(metric, run):
    return harness.load_reader(metric).read(run)


def _train_stretch(host):
    """A window [0, 1000) ns of 2 steps, busy at [100, 300) and [500, 700):
    idle [0, 100), [300, 500) and [700, 1000)."""
    device = [("conv", 100, 300, 1), ("gemm", 500, 700, 2)]
    return trace.Stretch(device, [(n, s, e, 0) for n, s, e in host], 0, 1000, 2, "step")


HOST = [("agent.call", -50, 1100), ("graphs.replay", 50, 150), ("cudaGraphLaunch", 60, 140),
        ("agent.guard", 250, 450), ("agent.report", 440, 600), ("agent.feed_wait", 650, 900),
        ("graphs.replay", 60, 120)]


def test_idle_inside_each_span_is_counted_and_nothing_else():
    run = _run(_train_stretch(HOST))
    # replay: [50, 100) idle, [100, 150) busy; the nested second replay adds nothing
    assert read("launch_idle_ms_per_step.train", run) == pytest.approx(50e-6 / 2)
    # guard with report: [250, 600) holds the idle [300, 500)
    assert read("guard_idle_ms_per_step.train", run) == pytest.approx(200e-6 / 2)
    # feed wait: [650, 900) holds the idle [700, 900)
    assert read("feed_idle_ms_per_step.records", run) == pytest.approx(200e-6 / 2)
    # a train stretch holds no served call, and no re-warm without the program's calls
    assert read("serve_dispatch_idle_ms_per_call", run) is None
    assert read("rewarm_s_per_call.train", run) is None


def test_idle_outside_the_spans_or_under_another_span_is_not_counted():
    host = [("agent.call", 0, 1000), ("graphs.replay", 100, 300), ("agent.guard", 500, 700),
            ("agent.feed_wait", 300, 300)]
    run = _run(_train_stretch(host))
    # each span lies over busy time only; the idle is under agent.call alone
    for metric in TRAIN:
        assert read(metric, run) == 0.0, metric


def test_a_stretch_without_the_spans_reads_nothing():
    run = _run(_train_stretch([("cudaGraphLaunch", 60, 140), ("agent.call", 0, 1000)]))
    for metric in SPANS:
        assert read(metric, run) is None, metric
    for metric in SPANS:
        assert read(metric, _run()) is None, metric


def test_serve_dispatch_idle_per_call():
    device = [("gemm", 200, 300, 1), ("copy", 300, 350, 2), ("gemm", 600, 700, 3)]
    host = [("bench.serve_stretch", 100, 900, 0), ("serve.call", 150, 250, 0),
            ("serve.call", 550, 640, 0), ("aten::copy_", 250, 360, 0)]
    st = trace.host_stretch(device, host, "bench.serve_stretch", units=2)
    run = _run(st)
    # [150, 200) and [550, 600) are idle inside the calls; [350, 550) is the client's
    assert read("serve_dispatch_idle_ms_per_call", run) == pytest.approx(100e-6 / 2)
    for metric in TRAIN:
        assert read(metric, run) is None, metric


@pytest.mark.parametrize("seed", range(6))
def test_attributed_idle_never_exceeds_the_idle_time(seed):
    """Random kernels and spans, against a count of idle nanoseconds one
    by one: each reader's idle is exact, and together they fit in the
    idle time (spans of different readers do not overlap, as in the
    program)."""
    rnd = random.Random(seed)
    w1 = 400
    device = []
    for i in range(12):
        s = rnd.randrange(w1)
        device.append(("k", s, s + rnd.randrange(1, 40), i))
    cuts = sorted(rnd.sample(range(w1), 8))
    names = ["graphs.replay", "agent.guard", "agent.report", "agent.feed_wait"]
    host = [(names[i // 2], cuts[i], cuts[i + 1]) for i in range(0, 8, 2)]
    # replays nested in the first: counted once
    host += [("graphs.replay", s, min(s + 5, cuts[1])) for s in range(cuts[0], cuts[1], 7)]
    st = trace.Stretch(device, [(n, s, e, 0) for n, s, e in host], 0, w1, 2, "step")
    busy = {t for _, s, e in st.kernels for t in range(s, e)}
    idle_ns = w1 - len(busy)
    assert st.window_s - st.busy_s == pytest.approx(idle_ns / 1e9)
    total = 0.0
    for metric in TRAIN:
        inside = {t for n, s, e in st.host if n in SPANS[metric] for t in range(s, e)}
        want = len([t for t in inside if 0 <= t < w1 and t not in busy])
        got = read(metric, _run(st))
        assert got == pytest.approx(1e3 * want / 1e9 / 2), metric
        total += got * 2 / 1e3
    assert total <= (st.window_s - st.busy_s) * (1 + 1e-9)


def test_overlap_of_sorted_intervals():
    assert program_spans.merged([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    assert program_spans.overlap_ns([(0, 4), (5, 10)], [(3, 6), (8, 20)]) == 1 + 1 + 2
    assert program_spans.overlap_ns([], [(0, 1)]) == 0


def test_rewarm_reads_the_programs_spans_per_call():
    st = _train_stretch([])
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with spans.span("agent.call"):
                with spans.span("agent.upload"):
                    time.sleep(0.001)
                with spans.span("graphs.warm_up"):
                    time.sleep(0.001)
                with spans.span("graphs.capture"):
                    time.sleep(0.001)
                with spans.span("graphs.replay"):
                    pass
    t = spans.totals()
    want = (t["agent.upload"].seconds + t["graphs.warm_up"].seconds
            + t["graphs.capture"].seconds) / 2
    assert want >= 0.003
    assert read("rewarm_s_per_call.train", _run(st)) == pytest.approx(want)
    # no stretch, or a program that recorded no call, reads nothing
    assert read("rewarm_s_per_call.train", _run()) is None
    spans.clear()
    assert read("rewarm_s_per_call.train", _run(st)) is None


def test_an_untraced_run_records_no_span():
    res = run_fixture("tiny.train")
    assert res["correct"] and spans.records() == [] and spans.counters() == {}
