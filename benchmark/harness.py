"""The harness: finds a cell's configuration, traffic and metrics by the
names in ``BENCHMARK.json``, runs the traffic's driver, reads the metrics
and builds the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in files of its own, found by name:

- ``configs/<config>.json``: the model's sizes, optimiser and data shape;
- ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming
  the driver that runs it (``drivers/<kind>.py``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None when it finds nothing to read;
- ``limits/<cell>.json``: each number the cell's check compares, with the
  limit it is held to.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names a run may not load: the JAX package, its scripts
# and tools, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmdgan_tpu", "experiments", "tools")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(it has {[c['name'] for c in spec['workloads']]})")


def load_cell(spec: dict, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The cell's entry with its configuration, traffic and limits."""
    cell = dict(find_cell(spec, name))
    cell["cfg"] = load_json(os.path.join(bench_dir, "configs", cell["config"] + ".json"))
    cell["mix"] = load_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json"))
    limits = os.path.join(bench_dir, "limits", name + ".json")
    cell["limits"] = load_json(limits) if os.path.exists(limits) else {}
    return cell


def cell_metrics(spec: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric without a
    ``workloads`` key belongs to every cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def load_reader(metric: str):
    """The module of ``metrics/<metric>.py`` (its ``read(run)``)."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    mod_name = "benchmark.metrics." + metric.replace(".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names among the loaded modules that a run may not load,
    compared whole (``mmdgan_torch`` is not ``mmdgan_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def set_cache_dirs(root: str = ROOT) -> str:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so only a checkout's first run builds."""
    cache = os.path.join(root, "build")
    os.environ["MMDGAN_TORCH_COMPILATION_CACHE"] = cache
    os.environ["MMDGAN_TORCH_CACHE_MIN_COMPILE_SECONDS"] = "0"
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    return cache


class Spans:
    """Host-clock spans the benchmark records around its calls into the
    program, by name (a repeated name adds up)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        if sync is not None:
            sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - start


class Run:
    """What one run knows: the cell, its seed and length, the spans and
    counters it recorded, the traced stretch, and what it measured."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str,
                 t0: float):
        self.cell, self.cfg, self.mix = cell, cell["cfg"], cell["mix"]
        self.seed, self.seconds, self.trace, self.device, self.t0 = (
            int(seed), float(seconds), bool(trace), device, t0)
        self.spans = Spans()
        self.counters: Dict[str, float] = {}
        self.stretch = None            # trace.Stretch of the traced run
        self.e2e: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.compared: List[tuple] = []    # (name, value, limit)
        self.observed: Dict[str, float] = {}   # readings no limit holds
        self.memory_peak = 0

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def setup_done(self) -> None:
        """The window starts: set-up is over."""
        self.e2e["setup_s"] = time.perf_counter() - self.t0

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            limit is not None and value == value and value <= limit
            for _, value, limit in self.compared)


def compare(run: Run, readings: Dict[str, float]) -> None:
    """Hold each reading that the cell's limits file names to its limit;
    the others are observed and reported. A cell without a limits file
    holds every reading to none, and is not correct."""
    limits = run.cell["limits"]
    for name, value in readings.items():
        if name in limits or not limits:
            run.compared.append((name, float(value), limits.get(name)))
        else:
            run.observed[name] = float(value)


def device_info(device: str, count: int, memory_peak: int) -> dict:
    if device.startswith("cuda"):
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             bench_dir: str = BENCH_DIR) -> dict:
    """Run one cell and return its result line (a dict)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(spec, name, bench_dir)
    run = Run(cell, seed, seconds, trace, device, t0)
    driver(cell["mix"]["kind"]).run(run)
    wanted = cell_metrics(spec, name, trace)
    metrics = {}
    for m in wanted:
        if trace:
            value = load_reader(m["name"]).read(run)
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": run.correct, "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info(device, cell["chips"], run.memory_peak)}
    if trace and run.stretch is not None:
        result["device"]["busy_s"] = run.stretch.busy_s
        result["device"]["window_s"] = run.stretch.window_s
        result["breakdown"] = run.stretch.breakdown()
    result["spans"] = run.spans.seconds
    result["observed"] = run.observed
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in run.compared}
    return result


def format_compared(result: dict) -> List[str]:
    """The observed readings, then one line per compared number with its
    limit (the last lines)."""
    return ([f"span {n}: {v!r} s" for n, v in result["spans"].items()]
            + [f"observed {n}: {v!r}" for n, v in result["observed"].items()]
            + [f"compared {n}: {c['value']!r} limit {c['limit']!r}"
               for n, c in result["compared"].items()])
