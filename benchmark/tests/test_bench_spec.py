"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic mix, limit file and metric reader is found by name, and the file
keeps to the contract's shapes. A cell defined only in the test fixture
loads the same way."""

import json
import math
import os
import re

import pytest

from benchmark import harness
from benchmark.reference import mmdgan
from benchmark.tests.helpers import FIXTURES, fixture_spec

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[group]]
    assert all(NAME.match(n) for n in names), names
    assert len({e["name"] for e in SPEC["configs"]}) == len(SPEC["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and 1 <= len(m["layer"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_per_layer_metric():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    for cell in CELLS:
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell, trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.cell_metrics(SPEC, cell, trace=True), cell


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    # metrics of one layer name it letter for letter
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_by_name(cell):
    c = harness.load_cell(SPEC, cell)
    assert c["cfg"]["architecture"] and c["mix"]["kind"]
    harness.driver(c["mix"]["kind"])
    assert c["limits"], f"{cell} has no limits file"
    assert all(isinstance(v, (int, float)) and v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric).read)


def test_no_reader_without_a_metric():
    files = {f[:-3] for f in os.listdir(os.path.join(harness.BENCH_DIR, "metrics"))
             if f.endswith(".py")}
    assert files == {m["name"] for m in SPEC["per_layer"]}


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_are_the_published_sizes(config):
    path = os.path.join(harness.ROOT, config["file"])
    assert path.startswith(os.path.join(harness.BENCH_DIR, "configs"))
    cfg = harness.load_json(path)
    assert cfg["reduced"] == config["reduced"] == []
    assert cfg["batch_size"] == 64 and cfg["loss"] == "rep" and cfg["compute_dtype"] == "bfloat16"
    dis = cfg["architecture"]["discriminator"]
    assert dis[-1]["out"] == 16 and all(d.get("act_k") == cfg["act_k"] for d in dis)
    h, w, c = cfg["dataset"]["shape_hwc"]
    assert [c, h, w] == cfg["architecture"]["input"][0]
    assert mmdgan.leaf_specs(cfg["architecture"])


def test_published_widths_match_the_port_families():
    """The configuration files hold the port's own family dicts as they
    stand (``architectures.py``), JSON-normalised."""
    from mmdgan_torch.architectures import celeba_architecture, cifar_architecture

    for name, arch in (("cifar10", cifar_architecture()), ("celeba64", celeba_architecture())):
        cfg = harness.load_json(os.path.join(harness.BENCH_DIR, "configs", name + ".json"))
        assert cfg["architecture"] == json.loads(json.dumps(arch))
        assert math.isclose(cfg["act_k"], arch["discriminator"][0]["act_k"])


def test_a_cell_defined_only_in_a_fixture_loads():
    spec = fixture_spec()
    cell = harness.load_cell(spec, "tiny.train", FIXTURES)
    assert cell["cfg"]["architecture"]["input"] == [[3, 8, 8]]
    assert cell["mix"]["kind"] == "device_train" and cell["limits"]
    assert "tiny.train" not in CELLS
    assert [m["name"] for m in harness.cell_metrics(spec, "tiny.serve", False)] == [
        "serve_img_per_s", "serve_call_ms_p95", "setup_s"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(SPEC, "no.such.cell")


def test_run_length_fits_the_check():
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s a cell to compile and 1200 s spare, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
