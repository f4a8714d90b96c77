"""The trace reduction and every per-layer reader on canned traces: what
each reads where there is something to read, and nothing where there is
not."""

import types

import pytest

from benchmark import arith, harness, trace

CFG = harness.load_json(harness.os.path.join(harness.BENCH_DIR, "configs", "cifar10.json"))
FWD, BWD = "kernel_means_fwd", "kernel_means_bwd"


def _run(stretch=None, spans=None, counters=None):
    return types.SimpleNamespace(stretch=stretch, spans=types.SimpleNamespace(
        seconds=spans or {}), counters=counters or {}, cfg=CFG)


def _graph_trace():
    """Four replays of a 2-step window, each launched by a cudaGraphLaunch
    (correlation 10..13): per step a conv (4 us), a transpose (1 us), the
    forward (1 us) and backward (2 us) of the kernel means; 2 us idle
    between kernels of a window and 10 us between windows."""
    device, host = [], []
    t = 1000
    for w in range(4):
        corr = 10 + w
        host.append(("cudaGraphLaunch", t - 5, t - 3, corr))
        for _ in range(2):
            for name, dur in (("cutlass_conv", 4000), ("nchwToNhwcKernel", 1000),
                              (FWD, 1000), (BWD, 2000)):
                device.append((name, t, t + dur, corr))
                t += dur + 2000
        t += 10000
    host.append(("cudaStreamSynchronize", 0, t + 50000, 0))
    return device, host


def test_union_merges_overlaps():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.union_ns([]) == 0


def test_graph_stretch_spans_whole_replays():
    device, host = _graph_trace()
    st = trace.graph_stretch(device, host, first=1, count=2, steps_per_launch=2)
    starts = sorted({s for n, s, e, c in device if n == "cutlass_conv"})
    assert st.unit == "step" and st.units == 4
    assert (st.w0, st.w1) == (starts[2], starts[6])     # replay 1's first kernel .. replay 3's
    assert st.busy_s == pytest.approx(4 * 8000 / 1e9)
    assert st.window_s == pytest.approx((starts[6] - starts[2]) / 1e9)
    # too few replays, or kernels linked to none, read nothing
    assert trace.graph_stretch(device, host, first=1, count=3, steps_per_launch=2) is None
    assert trace.graph_stretch([(n, s, e, 99) for n, s, e, _ in device], host, 1, 2, 2) is None


def test_breakdown_names_ops_and_what_the_host_did_in_the_gaps():
    device, host = _graph_trace()
    st = trace.graph_stretch(device, host, 1, 2, 2)
    b = st.breakdown()
    assert b["device_ops"][0] == ["cutlass_conv", pytest.approx(4 * 4000 / 1e9)]
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert sum(t for _, t in b["idle_gaps"]) == pytest.approx(st.window_s - st.busy_s)


def test_host_stretch_counts_idle_at_its_edges():
    device = [("gemm", 200, 300, 1), ("Memcpy DtoH (Device -> Pinned)", 300, 350, 2),
              ("gemm", 600, 700, 3)]
    host = [("bench.serve_stretch", 100, 900, 0)]
    st = trace.host_stretch(device, host, "bench.serve_stretch", units=2)
    assert st.unit == "call" and st.window_s == pytest.approx(800e-9)
    assert st.busy_s == pytest.approx(250e-9)
    assert trace.host_stretch(device, host, "other", 2) is None


def read(metric, run):
    return harness.load_reader(metric).read(run)


def test_train_readers_on_a_canned_stretch():
    device, host = _graph_trace()
    st = trace.graph_stretch(device, host, 1, 2, 2)
    run = _run(st, {"setup.capture": 1.5})
    assert read("setup.capture_s", run) == 1.5
    assert read("device_busy_ms_per_step.train", run) == pytest.approx(8000 / 1e6)
    assert read("layout_transpose_ms_per_step.train", run) == pytest.approx(1000 / 1e6)
    idle = 100 * (1 - st.busy_s / st.window_s)
    assert read("device_idle_pct.train", run) == pytest.approx(idle)
    flops = arith.train_step_flops(CFG)["total"]
    assert read("step_mfu.train", run) == pytest.approx(
        100 * flops * 4 / st.window_s / arith.PEAK_BF16_FLOP_PER_S)
    fwd = arith.kernel_means_bound_ms(64, 16)[0]
    bwd = arith.kernel_means_backward_bound_ms(64, 16)[0]
    assert read("kernel_means_fwd_roofline", run) == pytest.approx(100 * fwd / 1e-3)
    assert read("kernel_means_bwd_roofline", run) == pytest.approx(100 * bwd / 2e-3)
    # serving's readers find nothing in a train stretch
    assert read("serve_device_ms_per_call", run) is None
    assert read("device_idle_pct.serve", run) is None


def test_serve_readers_on_a_canned_stretch():
    device = [("gemm", 200, 300, 1), ("gemm", 600, 700, 3)]
    st = trace.host_stretch(device, [("bench.serve_stretch", 100, 900, 0)],
                            "bench.serve_stretch", units=2)
    run = _run(st, {"setup.export": 3.0, "setup.load": 0.5})
    assert read("serve_device_ms_per_call", run) == pytest.approx(100e-6)
    assert read("device_idle_pct.serve", run) == pytest.approx(75.0)
    assert read("setup.export_load_s", run) == 3.5
    for metric in ("device_busy_ms_per_step.train", "step_mfu.train", "device_idle_pct.train",
                   "kernel_means_fwd_roofline", "setup.capture_s"):
        assert read(metric, run) is None


def test_readers_read_nothing_without_a_trace_or_a_match():
    empty = _run()
    for metric in [m["name"] for m in harness.load_spec()["per_layer"]]:
        assert read(metric, empty) is None, metric
    st = trace.Stretch([("cutlass_conv", 0, 10, 1)], [], 0, 20, 2, "step")
    assert read("layout_transpose_ms_per_step.train", _run(st)) is None
    assert read("kernel_means_fwd_roofline", _run(st)) is None
    assert read("data_wait_ms_per_step.records", _run(counters={"data_wait_s_per_step": 2e-4})) \
        == pytest.approx(0.2)
