"""The command itself: without a card it fails and prints no result; a
whole run's result line holds the contract's keys; a run loads nothing
of JAX or the JAX package, compared by whole top-level names."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.helpers import SEED, run_fixture


def test_no_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cifar10.train",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_forbidden_names_are_compared_whole():
    mods = ["mmdgan_torch", "mmdgan_torch.train", "toolsmith", "jaxtyping", "benchmark.tools"]
    assert harness.forbidden_modules(mods) == []
    for bad in ("jax", "jaxlib.xla_client", "flax.linen", "optax", "mmdgan_tpu.ops",
                "experiments.cifar", "tools.bench"):
        assert harness.forbidden_modules(mods + [bad]) == [bad.split(".")[0]]


RUN_AND_LIST = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.helpers import run_fixture
from benchmark import harness
res = run_fixture({cell!r})
print(json.dumps({{"result": res, "forbidden": harness.forbidden_modules(),
                  "torch_port": "mmdgan_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve", "tiny.train-records"])
def test_a_run_loads_no_jax_and_prints_the_contract_line(cell):
    p = subprocess.run([sys.executable, "-c", RUN_AND_LIST.format(root=harness.ROOT, cell=cell)],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
                       env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == [] and out["torch_port"]
    res = out["result"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "compared"
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}


def test_traced_cpu_run_reports_its_spans():
    res = run_fixture("tiny.train", trace=True)
    assert res["metrics"]["setup.capture_s"]["value"] > 0
    assert res["correct"]


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run_cell(harness.load_spec(), "cifar10.serve", SEED, 1.0, False)
    assert res["correct"] and res["device"]["platform"] == "gpu"
