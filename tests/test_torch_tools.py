"""The port's research tools (``mmdgan_torch/tools``: ``quality_smoke``,
``figure1``, ``parity_run``, ``sweep_grid``) against the JAX package's
``tools/``, and the import rules of the modules this slice added.

- ``blob_batches``: bitwise the JAX tool's draws, with and without classes.
- ``parity_run``: its numpy rep formulas against the port's ``gan_loss``
  at rtol 1e-5 / atol 1e-6 (float32 sums in another order), and the JAX
  tool's numpy copy bitwise.
- ``sweep_grid``: ``cell_key``, ``format_markdown`` and ``format_csv``
  give the JAX tool's strings on ``tests/test_sweep_grid.py``'s cells.
- ``figure1``: the first 10 particle steps of each loss against the same
  steps through JAX's ``gan_loss`` (``tools/figure1.py:58-64``), from the
  same start: the particles at rtol 1e-5 / atol 1e-7, the losses, float32
  means of 16,384 kernel values summed in another order, at atol 1e-5.
- Each tool's CLI runs a tiny job on the CPU.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mmdgan_tpu.data import SimData as JaxSimData  # noqa: E402
from mmdgan_tpu.ops import gan_loss as jax_gan_loss  # noqa: E402
from mmdgan_torch.ops.losses import gan_loss  # noqa: E402
from mmdgan_torch.tools import parity_run, sweep_grid  # noqa: E402
from mmdgan_torch.tools.figure1 import particle_run  # noqa: E402
from mmdgan_torch.tools.quality_smoke import blob_batches  # noqa: E402
from tools import parity_run as jax_parity_run  # noqa: E402
from tools import sweep_grid as jax_sweep_grid  # noqa: E402
from tools.quality_smoke import blob_batches as jax_blob_batches  # noqa: E402

torch.set_num_threads(1)

NEW_MODULES = [
    "mmdgan_torch/data/native.py", "mmdgan_torch/data/converters.py",
    "mmdgan_torch/data/simdata.py", "mmdgan_torch/data/pipeline.py",
    "mmdgan_torch/utils/events.py", "mmdgan_torch/utils/fig.py",
    "mmdgan_torch/utils/checkpoint.py", "mmdgan_torch/utils/tf_bundle.py",
    "mmdgan_torch/utils/tf1_import.py", "mmdgan_torch/ops/_build.py",
    "mmdgan_torch/tools/quality_smoke.py", "mmdgan_torch/tools/figure1.py",
    "mmdgan_torch/tools/parity_run.py", "mmdgan_torch/tools/sweep_grid.py",
    "mmdgan_torch/tools/preflight.py", "mmdgan_torch/tools/scaling_study.py",
    "mmdgan_torch/metrics/graph_encode.py", "mmdgan_torch/tools/make_fake_inception.py",
    "mmdgan_torch/tools/inception_rehearsal.py", "mmdgan_torch/tools/imagenet_prep.py",
]


@pytest.mark.parametrize("num_class", [0, 4])
@pytest.mark.parametrize("size,seed", [(32, 0), (16, 3)])
def test_blob_batches_bitwise(num_class, size, seed):
    got = blob_batches(8, size=size, seed=seed, num_class=num_class)
    want = jax_blob_batches(8, size=size, seed=seed, num_class=num_class)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a["x"].dtype == np.float32
        np.testing.assert_array_equal(a["x"], b["x"])
        if num_class:
            np.testing.assert_array_equal(a["y"], b["y"])
        else:
            assert a["y"] is None and b["y"] is None


@pytest.mark.parametrize("w", [(0.0, -1.0), (1.0, 0.0), (2.0, 1.0)])
def test_parity_formulas_agree_with_the_port_losses(w):
    rng = np.random.RandomState(0)
    s_gen = (rng.randn(16, 4) * 0.5).astype(np.float32)
    s_x = (rng.randn(16, 4) * 0.5 + 0.2).astype(np.float32)
    lg, ld, _, _ = gan_loss(torch.tensor(s_gen), torch.tensor(s_x), "rep", batch_size=16,
                            rep_weights=w)
    want = parity_run.np_rep_loss(s_gen, s_x, 1.0, w)
    np.testing.assert_allclose([float(lg), float(ld)], want, rtol=1e-5, atol=1e-6)
    assert want == jax_parity_run.np_rep_loss(s_gen, s_x, 1.0, w)


def _cell(loss, k, d, g, fid, is_):
    return {"loss": loss, "k": k, "lr_dis": d, "lr_gen": g, "fid": fid, "is": is_,
            "loss_gen": 0.1, "loss_dis": -0.2, "e_kxx": 0.5, "steps": 100, "seconds": 1.0}


def test_sweep_grid_formatting_equals_jax():
    lr = [2e-4, 5e-4]
    cells = {}
    for i, (d, g) in enumerate([(a, b) for a in lr for b in lr]):
        cells[sweep_grid.cell_key("rep", 64, d, g)] = _cell("rep", 64, d, g, 10.0 - i, 5.0 + i)
    cells[sweep_grid.cell_key("rmb", 32, 1e-3, 2e-4)] = _cell("rmb", 32, 1e-3, 2e-4, 3.0, 2.0)
    for args in ((cells, ["rep"], [64], lr, lr, "random-feature"),
                 ({}, ["rep"], [64], lr, lr, "x"),
                 (cells, ["rep", "rmb"], [32, 64], lr + [1e-3], lr, "inception.pb")):
        assert sweep_grid.format_markdown(*args) == jax_sweep_grid.format_markdown(*args)
    assert sweep_grid.format_csv(cells) == jax_sweep_grid.format_csv(cells)
    md = sweep_grid.format_markdown(cells, ["rep"], [64], lr, lr, "random-feature")
    assert "**Best `rep` cell:** FID 7.00" in md and "lr_D=0.0005" in md
    for key in [("rep", 64, 5e-4, 2e-4), ("rmb", 32.5, 1e-3, 1e-4)]:
        assert sweep_grid.cell_key(*key) == jax_sweep_grid.cell_key(*key)


@pytest.mark.parametrize("loss", ["rep", "rmb", "mmd_g"])
def test_figure1_particle_steps_match_jax(loss):
    sim = JaxSimData("shell", batch_size=128, seed=0)
    target = jnp.asarray(sim(128))
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (128, 2)) * 0.05)
    step = jax.jit(lambda p: jax.value_and_grad(
        lambda q: jax_gan_loss(q, target, loss, batch_size=128)[0])(p))
    p, traj, losses = jnp.asarray(init), [init], []
    for _ in range(10):
        value, g = step(p)
        p = p - 2.0 * g
        traj.append(np.asarray(p))
        losses.append(float(value))
    run = particle_run(loss, steps=10, lr=2.0, batch=128, target="shell", seed=0,
                       device="cpu", init=init)
    np.testing.assert_array_equal(run["target"], np.asarray(target))
    np.testing.assert_allclose(run["particles"], np.stack(traj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(run["loss"], losses, rtol=0, atol=1e-5)
    assert run["steps"].tolist() == list(range(11))


def test_figure1_keeps_every_kth_step():
    run = particle_run("rep", steps=7, batch=16, device="cpu", keep_every=3)
    assert run["steps"].tolist() == [0, 3, 6, 7]
    assert run["particles"].shape == (4, 16, 2) and run["loss"].shape == (7,)


def _tool(name, *args, cwd=REPO, timeout=300):
    out = subprocess.run([sys.executable, "-m", f"mmdgan_torch.tools.{name}", *args],
                         cwd=cwd, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_figure1_cli_draws_frames(tmp_path):
    pytest.importorskip("matplotlib")
    out = _tool("figure1", "--device", "cpu", "--steps", "4", "--frames", "2", "--batch", "16",
                "--out", str(tmp_path))
    assert "final generator-side loss" in out
    frames = sorted(f for f in os.listdir(tmp_path) if f.startswith("frame_"))
    assert frames == ["frame_00000.png", "frame_00002.png", "frame_00004.png"]


def test_quality_smoke_cli_on_device_data(tmp_path):
    out = _tool("quality_smoke", "--device", "cpu", "--compute-dtype", "float32", "--steps", "4",
                "--eval-every", "2", "--scan-k", "2", "--batch", "8", "--eval-batches", "2",
                "--device-dataset", "32", "--sampling", "shuffled_epochs", "--ckpt-dir",
                str(tmp_path / "ckpt"), "--out", str(tmp_path / "out"))
    assert "step 0: random-feature FID" in out and "RESUMABLE" in out
    result = json.loads(out.strip().splitlines()[-1])
    assert [s for s, _ in result["fid"]] == [0, 2, 4] and result["steps"] == 4
    assert np.isfinite(result["loss_gen"])
    assert os.path.exists(tmp_path / "out" / "samples_step4.png")


def test_parity_run_cli_and_compare(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    for path in (a, b):
        _tool("parity_run", "--device", "cpu", "--steps", "2", "--check-every", "1",
              "--out", path)
    run = json.load(open(a))
    assert len(run["curve"]) == 2 and run["max_reference_formula_error"] < 1e-5
    assert "MATCH" in subprocess.run(
        [sys.executable, "-m", "mmdgan_torch.tools.parity_run", "--compare", a, b], cwd=REPO,
        capture_output=True, text=True, timeout=60).stdout


def test_sweep_grid_cli_resumes(tmp_path):
    args = ("--device", "cpu", "--compute-dtype", "float32", "--losses", "rep",
            "--lr-grid", "5e-4", "--steps", "2", "--scan-k", "2", "--batch", "8",
            "--eval-batches", "2", "--device-dataset", "16", "--out", str(tmp_path))
    _tool("sweep_grid", *args)
    assert "resuming campaign: 1 cells already done" in _tool("sweep_grid", *args)
    assert len(open(tmp_path / "cells.jsonl").read().splitlines()) == 1
    csv = open(tmp_path / "grid.csv").read().splitlines()
    assert csv[0].startswith("loss,k,lr_dis") and csv[1].startswith("rep,64.0,0.0005")


def test_new_modules_import_no_jax_and_no_optional_libraries():
    """The slices' modules name nothing of jax, mmdgan_tpu, experiments,
    tools/, TensorFlow or protobuf, and importing every module of the port
    loads neither PIL, matplotlib nor TensorFlow (the card's machine has
    none of them)."""
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mmdgan_tpu|experiments|tools|"
                        r"tensorflow|google)\b", re.M)
    for path in NEW_MODULES:
        with open(os.path.join(REPO, path)) as f:
            assert not banned.search(f.read()), path
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmdgan_torch\n"
        "for m in pkgutil.walk_packages(mmdgan_torch.__path__, 'mmdgan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('PIL', 'matplotlib', 'tensorflow', 'jax', 'mmdgan_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
