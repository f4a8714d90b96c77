"""The port's spans (``mmdgan_torch/utils/spans.py``): nothing is recorded
without a profiler; under one, spans nest by thread with their parent,
root and self time, and sit among the profiler's host events.
``StepGraphs`` marks its replays and counts the graphs it drops.

``test_device_data_calls_capture_again_after_a_drop`` needs a CUDA card
(marker ``card``); on the card, run this file alone, without the JAX
test configuration: ``python -m pytest --noconftest tests/test_torch_spans.py -m card``.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmdgan_torch.train.step import StepGraphs
from mmdgan_torch.utils import spans


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records):
    return {r.name: r for r in records}


def test_nothing_is_recorded_without_a_profiler():
    assert not spans.tracing()
    s = spans.span("off")
    assert s is spans.span("other")      # the shared no-op
    with s:
        with spans.span("inner"):
            spans.count("off.count")
    assert spans.records() == [] and spans.counters() == {} and spans.totals() == {}


def test_spans_nest_with_parent_root_and_self_time():
    with cpu_profile() as prof:
        assert spans.tracing()
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("middle"):
                with spans.span("inner"):
                    time.sleep(0.002)
            spans.count("n", 2)
            spans.count("n")
    assert not spans.tracing()
    r = by_name(spans.records())
    assert [x.name for x in spans.records()] == ["inner", "middle", "outer"]
    assert r["outer"].parent is None and r["outer"].root == r["outer"].id
    assert r["middle"].parent == r["outer"].id and r["inner"].parent == r["middle"].id
    assert r["inner"].root == r["middle"].root == r["outer"].id
    assert r["outer"].start_ns <= r["middle"].start_ns <= r["inner"].end_ns <= r["outer"].end_ns
    t = spans.totals()
    length = lambda x: (x.end_ns - x.start_ns) / 1e9  # noqa: E731
    assert t["outer"].count == 1 and t["outer"].seconds == pytest.approx(length(r["outer"]))
    assert t["outer"].self_seconds == pytest.approx(length(r["outer"]) - length(r["middle"]))
    assert t["middle"].self_seconds == pytest.approx(length(r["middle"]) - length(r["inner"]))
    assert t["inner"].self_seconds == t["inner"].seconds >= 0.002
    assert t["outer"].self_seconds >= 0.002
    assert spans.counters() == {"n": 3}
    host = {e.name for e in prof.events()}
    assert {"outer", "middle", "inner"} <= host


def test_spans_of_another_thread_keep_their_thread():
    seen = {}

    def worker():
        with spans.span("thread.outer"):
            with spans.span("thread.inner"):
                seen["ident"] = threading.get_ident()

    with cpu_profile():
        with spans.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    r = by_name(spans.records())
    assert r["thread.outer"].thread == r["thread.inner"].thread == seen["ident"]
    assert r["main"].thread == threading.get_ident() != seen["ident"]
    # the other thread's stack is its own: its outermost span is its root
    assert r["thread.outer"].parent is None and r["thread.outer"].root == r["thread.outer"].id
    assert r["thread.inner"].parent == r["thread.outer"].id


def test_spanned_marks_every_call_and_passes_results_and_errors():
    @spans.spanned("fn")
    def fn(x, fail=False):
        if fail:
            raise ValueError("no")
        return 2 * x

    assert fn(2) == 4 and spans.records() == []
    with cpu_profile():
        assert fn(3) == 6
        with pytest.raises(ValueError):
            fn(1, fail=True)
        with spans.span("after"):
            pass
    r = spans.records()
    assert [x.name for x in r] == ["fn", "fn", "after"]
    assert r[2].parent is None          # the failed call left the stack clean


class _FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


def test_step_graphs_mark_replays_and_count_drops():
    """The host side of ``StepGraphs.run``, with a stand-in for a captured
    graph and for the eager warm-up (both need a card)."""
    graphs = StepGraphs()
    graphs._warm_up = lambda body: body()
    bound = [torch.zeros(2)]
    graph, out = _FakeGraph(), ("captured",)
    binding = (tuple(t.data_ptr() for t in bound), ())
    graphs._binding, graphs._graphs["k"], graphs._pool = binding, (graph, out), "pool"
    with cpu_profile():
        assert graphs.run("k", bound, [], lambda: ("eager",)) is out
        assert graph.replays == 1 and graphs.replays == 1
        # another bound tensor drops the graphs and the pool they were captured into
        assert graphs.run("k", [torch.zeros(2)], [], lambda: ("eager",)) == ("eager",)
    assert graphs._graphs == {} and graphs._pool is None
    assert [x.name for x in spans.records()] == ["graphs.replay"]
    assert spans.counters() == {"graphs.drop": 1}


@pytest.mark.card
def test_device_data_calls_capture_again_after_a_drop(tmp_path):
    """Two ``train_device_data`` calls on one Agent with no other graph
    alive: the second call's new generator drops the first call's graphs,
    and its K = 16 window is captured again, into a fresh pool (the
    caching allocator refuses a pool whose graphs are gone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mmdgan_torch.architectures import cifar_architecture
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import init_train_state
    from mmdgan_torch.train.trainer import Agent

    model = SNGan(cifar_architecture(), loss_type="rep", compute_dtype=torch.bfloat16)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g)
    data = {"x": np.random.RandomState(0).randint(0, 256, (2048, 32, 32, 3), dtype=np.uint8),
            "y": None}
    agent = Agent("spans", "run", do_save=False, output_dir=str(tmp_path),
                  use_tensorboard=False, print_loss=False)
    kw = dict(step_per_epoch=32, batch_size=64, steps_per_call=16)
    ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=32, seed=1, **kw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=64, seed=2, **kw)
        torch.cuda.synchronize()
    assert int(ts.step) == 96
    assert all(torch.isfinite(t.float()).all() for t in ts.tensors())
    t = spans.totals()
    counted = spans.counters()
    # beside the drop, the convs of the warm-up and the capture, all on the NHWC route,
    # and their blocks' bias, cast and activation, all fused
    assert counted.pop("graphs.drop") == 1
    assert sorted(counted) == ["fuse.bias_act", "layout.nhwc_conv"], counted
    assert t["agent.call"].count == t["agent.upload"].count == 1
    assert t["graphs.warm_up"].count == t["graphs.capture"].count == 1
    assert t["graphs.replay"].count == 3
    calls = [r for r in spans.records() if r.name == "agent.call"]
    assert all(r.root == calls[0].id for r in spans.records())
