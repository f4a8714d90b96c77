"""The port's CIFAR CLI with the eval path on, on the CPU: the reference
chunk protocol shrunk (train, sprite, IS/FID, ``eval/*`` scalars), and the
bounded loss with non-repulsive weights, which takes the plain path."""

import json
import os
import subprocess
import sys

import numpy as np
from PIL import Image

from mmdgan_torch.experiments.cifar import main as cifar_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------------
def test_cifar_cli_eval_on_the_cpu(tmp_path):
    """The reference chunk protocol, shrunk: train 2 steps, write the 20x20
    sprite from code_x, score IS/FID over 2 batches, log eval/*. Two BLAS
    threads: the FID's 2048-wide SVDs thrash a host shared by six test
    workers."""
    env = dict(os.environ, OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "mmdgan_torch.experiments.cifar", "--device", "cpu",
         "--synthetic-data", "--debug-mode", "false", "--chunks", "1", "--steps-per-chunk", "2",
         "--eval-batches", "2", "--batch-size", "8", "--compute-dtype", "float32",
         "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    png = tmp_path / "cifar_log" / run / f"cifar_g_{run}_2_0.png"
    assert np.asarray(Image.open(png)).shape == (640, 640, 3)
    recs = [json.loads(ln) for ln in open(tmp_path / "cifar_log" / run / "metrics.jsonl")]
    scores = {k: v for r in recs for k, v in r.items() if k.startswith("eval/")}
    assert set(scores) == {"eval/inception_real", "eval/inception_gen", "eval/fid_xx",
                           "eval/fid_xg"}
    assert np.isfinite(list(scores.values())).all()
    parts = {k for r in recs for k in r if k.startswith("time/eval_")}
    assert parts == {"time/eval_data", "time/eval_generation", "time/eval_classifier",
                     "time/eval_fid"}
    assert "Chunk 0 scores" in out.stdout


def test_cifar_cli_rmb_with_non_repulsive_weights(tmp_path):
    """--loss rmb --rep-w0 1 --rep-w1 0 trains (the plain path) and samples."""
    cifar_main(["--device", "cpu", "--synthetic-data", "--debug-mode", "true",
                "--debug-step", "2", "--steps-per-call", "2", "--compute-dtype", "float32",
                "--chunks", "1", "--batch-size", "4", "--loss", "rmb", "--rep-w0", "1",
                "--rep-w1", "0", "--out-dir", str(tmp_path)])
    run = "sngan_rmb_5e-04_2e-04_k1.68_1.0_0.0"
    assert os.path.isfile(tmp_path / "cifar_ckpt" / run / "ckpt-2.pt")
    assert os.path.isfile(tmp_path / "cifar_log" / run / f"cifar_g_{run}_2_0.png")
