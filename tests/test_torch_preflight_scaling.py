"""The port's ``tools/preflight.py`` and ``tools/scaling_study.py``
(``mmdgan_torch/tools``) against the JAX package's tools of the same name.

- preflight: on the CPU (``--device cpu``) it exits 0 with the JAX tool's
  key set plus the pinned-memory bandwidths; a deadline it cannot meet,
  or ``cuda`` asked for on a machine without a GPU, gives exit 1 and
  ``healthy: false``, never a CPU run.
- scaling study: ``measure`` on the CPU is finite and positive, the batch
  it feeds its window is bitwise the JAX tool's (``RandomState(0)``
  draws), and the CLI's tables carry the JAX tool's headers.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mmdgan_torch.tools import preflight, scaling_study  # noqa: E402

torch.set_num_threads(2)
ENV = dict(os.environ, OMP_NUM_THREADS="2")
NEW_KEYS = {"h2d_pinned_gbps", "d2h_pinned_gbps"}


def _run(args, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env=ENV)


def test_preflight_on_the_cpu_has_the_jax_keys_and_the_pinned_bandwidths():
    small = ["--matmul-n", "256", "--mb", "1"]
    port = _run(["-m", "mmdgan_torch.tools.preflight", "--device", "cpu", *small])
    jax = _run(["tools/preflight.py", "--platform", "cpu", "--matmul-inner", "8", *small])
    assert port.returncode == 0, port.stdout + port.stderr
    assert jax.returncode == 0, jax.stdout + jax.stderr
    got, want = json.loads(port.stdout.splitlines()[-1]), json.loads(jax.stdout.splitlines()[-1])
    assert set(got) == set(want) | NEW_KEYS
    assert got["healthy"] is True and got["platform"] == want["platform"] == "cpu"
    assert got["n_devices"] == 1 and got["h2d_pinned_gbps"] is None
    for key in ("init_s", "dispatch_ms", "matmul_tflops", "h2d_gbps", "d2h_gbps", "probe_s"):
        assert np.isfinite(got[key]) and got[key] > 0, key


def test_preflight_probe_in_process():
    out = preflight.probe("cpu", 1, 64, 8)
    assert out["platform"] == "cpu" and out["matmul_tflops"] > 0 and out["h2d_gbps"] > 0


@pytest.mark.parametrize("args,error", [
    (["--device", "cpu", "--timeout", "0.01"], "hung"),
    (["--device", "cuda", "--matmul-n", "64", "--mb", "1"], "is_available"),
])
def test_preflight_unhealthy_exits_1(args, error):
    """A missed deadline, and ``cuda`` asked for where there is none: exit 1,
    ``healthy: false``, the error; no CPU fallback."""
    if "cuda" in args and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _run(["-m", "mmdgan_torch.tools.preflight", *args])
    line = json.loads(out.stdout.splitlines()[-1])
    assert out.returncode == 1 and line["healthy"] is False and error in line["error"]
    assert "platform" not in line


def _jax_fed_batches(monkeypatch, batch, scan_k):
    """The batch JAX's ``measure`` hands its step: the jitted step replaced
    by a recorder, the state's init skipped."""
    import jax
    import mmdgan_tpu.train
    import mmdgan_tpu.train.step

    from tools import scaling_study as jax_study

    fed = []

    def build(model, opt_d, opt_g, k):
        def step(ts, batches, do_dis, do_gen):
            fed.append(np.asarray(batches["x"]))
            return ts, {"loss_gen": np.zeros(k, np.float32)}
        return step

    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(mmdgan_tpu.train, "init_train_state", lambda *a, **k: None)
    monkeypatch.setattr(mmdgan_tpu.train.step, "build_multi_step", build)
    jax_study.measure("cifar", "rep", batch, scan_k, 4)
    return fed


def test_measure_feeds_the_jax_tools_batch_and_is_positive(monkeypatch):
    want = _jax_fed_batches(monkeypatch, 8, 2)
    monkeypatch.undo()

    import mmdgan_torch.train.step as port_step

    fed, real = [], port_step.build_multi_step

    def recording(*args, **kw):
        multi = real(*args, **kw)

        def step(ts, batches):
            fed.append(batches["x"].numpy().copy())
            return multi(ts, batches)
        return step

    monkeypatch.setattr(port_step, "build_multi_step", recording)
    sps = scaling_study.measure("cifar", "rep", 8, 2, 4, device="cpu")
    assert np.isfinite(sps) and sps > 0
    assert len(fed) == len(want) == 4   # 2 untimed + max(4 // 2, 2) timed windows
    for got, jax_batch in zip(fed, want):
        assert got.shape == (2, 8, 32, 32, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_batch)


def test_measure_without_a_gpu_raises_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        scaling_study.measure("cifar", "rep", 8, 2, 4)


def test_cli_tables_have_the_jax_headers(monkeypatch, capsys):
    """The CLI's two Markdown tables, with ``measure`` (tested above) stubbed
    so the full-width sweeps do not run on the CPU."""
    calls = []

    def fake(arch, loss, batch, k, steps, device):
        calls.append((arch, loss, batch, k, steps, str(device)))
        return 100.0 + k

    monkeypatch.setattr(scaling_study, "measure", fake)
    assert scaling_study.main(["--device", "cpu", "--k-sweep", "1,8",
                               "--batch-sweep", "4,32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert calls == [("cifar", "rep", 64, 1, 384, "cpu"), ("cifar", "rep", 64, 8, 384, "cpu"),
                     ("cifar", "rep", 4, 16, 384, "cpu"), ("cifar", "rep", 32, 16, 384, "cpu")]
    with open(os.path.join(REPO, "tools", "scaling_study.py")) as f:
        jax_source = f.read()
    headers = [ln for ln in out if ln.startswith("##") or re.fullmatch(r"\|[-| ]*\|", ln)
               or ln.startswith("| K ") or ln.startswith("| batch ")]
    assert len(headers) == 6, out
    for line in headers:
        assert line in jax_source, line
    assert "|   1 |    101.0 |" in out and "|     4 |    116.0 |       464 |" in out
