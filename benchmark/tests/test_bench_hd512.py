"""The ``hd512.train`` cell: it resolves its configuration, traffic and
limits by name, and ``hires_ms_per_step.hd512`` reads the program's
``hires.*`` counters (nothing where they are absent or zero). A whole run
of the cell's traffic at a tiny size on the CPU."""

import copy
import json
import os
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.reference import mmdgan
from benchmark.tests.helpers import SEED
from mmdgan_torch.utils import spans

SPEC = harness.load_spec()
METRIC = "hires_ms_per_step.hd512"


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def _read():
    return harness.load_reader(METRIC).read(types.SimpleNamespace(stretch=None))


def test_hd512_train_resolves_its_files():
    cell = harness.load_cell(SPEC, "hd512.train")
    cfg, mix = cell["cfg"], cell["mix"]
    assert cell["config"] == "hd512" and cell["chips"] == 1
    assert cfg["architecture"]["input"] == [[3, 512, 512]]
    assert sum(s["group"] == "param" for s in mmdgan.leaf_specs(cfg["architecture"]).values())
    assert mix["kind"] == "device_train" and mix["sampling"] == "uniform"
    assert harness.driver(mix["kind"]).run
    # the traced stretch holds at least 40 replayed steps
    assert mix["trace_windows"] * mix["steps_per_call"] >= 40
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    config = next(c for c in SPEC["configs"] if c["name"] == "hd512")
    assert config["reduced"] == cfg["reduced"] == ["dataset.rows"]
    assert len(config["source"]) <= 200
    traced = [m["name"] for m in harness.cell_metrics(SPEC, "hd512.train", trace=True)]
    assert METRIC in traced and "device_busy_ms_per_step.train" in traced
    untraced = [m["name"] for m in harness.cell_metrics(SPEC, "hd512.train", trace=False)]
    assert untraced == ["train_img_per_s", "train_mfu", "setup_s"]
    only = next(m for m in SPEC["per_layer"] if m["name"] == METRIC)
    assert only["workloads"] == ["hd512.train"] and only["moves"] == "train_img_per_s"


def test_the_reader_reads_the_counters():
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("hires.fwd_us", 30_000)
        spans.count("hires.bwd_us", 50_000)
        spans.count("hires.steps", 4)
    assert _read() == pytest.approx(20.0)


def test_the_reader_reads_nothing_without_counters_or_with_zeros():
    assert _read() is None
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("layout.nhwc_conv", 12)
    assert _read() is None
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("hires.steps", 4)
        spans.count("hires.fwd_us", 0)
    assert _read() is None
    reader = harness.load_reader(METRIC)
    assert reader.ms_per_step(None) is None
    assert reader.ms_per_step({"hires.fwd_us": 5, "hires.bwd_us": 5, "hires.steps": 0}) is None


def test_the_cells_traffic_runs_at_a_tiny_size(tmp_path):
    """The cell's configuration and traffic, at the family's 16x16 and 64
    rows, through `drivers/device_train.py` and the check on the CPU."""
    from mmdgan_torch.architectures import hd_architecture

    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    cfg = copy.deepcopy(harness.load_cell(SPEC, "hd512.train")["cfg"])
    cfg["architecture"] = json.loads(json.dumps(hd_architecture(16)))
    cfg["dataset"].update(shape_hwc=[16, 16, 3], rows=64)
    cfg["batch_size"], cfg["compute_dtype"] = 8, "float32"
    (bench / "configs" / "hd16.json").write_text(json.dumps(cfg))
    mix = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic", "device_uniform_k4.json"))
    (bench / "traffic" / "k4.json").write_text(json.dumps(mix))
    spec = copy.deepcopy(SPEC)
    spec["workloads"] = [{"name": "hd16.train", "config": "hd16", "traffic": "k4", "chips": 1,
                          "why": "tiny"}]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["hd16.train"]
    res = harness.run_cell(spec, "hd16.train", SEED, 0.5, False, device="cpu",
                           bench_dir=str(bench))
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"train_img_per_s", "train_mfu", "setup_s"} <= set(res["metrics"])
    readings = {**res["observed"], **{n: c["value"] for n, c in res["compared"].items()}}
    # float32 against float32 from the same weights, rows and codes
    assert readings["grad1_median_diff"] < 1e-3 and readings["means1_gap"] < 1e-3
