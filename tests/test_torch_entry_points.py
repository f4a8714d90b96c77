"""The entry points of the families (``python -m
mmdgan_torch.experiments.{stl,celeba,lsun}``) with the JAX scripts'
defaults, and the eval step on a narrow STL model."""

import os

import pytest
import torch

from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.step import build_eval_step, init_train_state
from test_torch_families import NARROW

torch.set_num_threads(1)


@pytest.mark.parametrize("module,log,run,instances", [
    ("stl", "stl_log", "sngan_rep_2e-04_2e-04_k1.68_0.0_-1.0", 100000),
    ("celeba", "celebA_log", "sngan_rep_1e-04_2e-04_k1.52_0.0_-1.0", 22511 * 9),
    ("lsun", "lsun_log", "sngan_rep_5e-04_2e-04_k1.52_0.0_-1.0", 49722 * 61),
])
def test_entry_points_take_the_jax_scripts_defaults(tmp_path, capsys, module, log, run,
                                                    instances):
    """``python -m mmdgan_torch.experiments.<module>`` with ``--debug-mode
    none`` builds the full-width model and names its run from the
    defaults: the learning rates and act_k enter the run folder, the
    dataset size the printed line."""
    main = __import__(f"mmdgan_torch.experiments.{module}", fromlist=["main"]).main
    main(["--device", "cpu", "--debug-mode", "none", "--synthetic-data", "--skip-sampling",
          "--skip-metrics", "--out-dir", str(tmp_path)])
    assert os.path.isdir(tmp_path / log / run)
    assert f"Num instance: {instances};" in capsys.readouterr().out


def test_eval_step_generates_in_eval_mode():
    """``build_eval_step``: NHWC images in [-1, 1] from the moving BN
    statistics, the same as ``SNGan.generate`` from the same generator."""
    model = SNGan(NARROW["stl"], compute_dtype=torch.float32, device="cpu")
    ts = init_train_state(model, 0, *multi_opt_config([1e-3, 1e-3]), device="cpu")
    images = build_eval_step(model)(ts, torch.Generator().manual_seed(4), 3)
    assert images.shape == (3, 48, 48, 3) and images.abs().max() <= 1.0
    want = model.generate(ts.params, ts.net_state, torch.Generator().manual_seed(4), 3)
    assert torch.equal(images, want)
