"""The port's accumulated step against the JAX package's for the losses
with a penalty or a scale: the witness penalties (``rep_gp``, ``rmb_gp``,
whose gradient reaches the global scores too) and the Jacobian scale
(``rmb_ds``), each a second-order pass per micro-batch. The model, the
state, the replayed draws and the tolerances are those of
``test_torch_accum.py`` (``wasserstein`` runs there)."""

import pytest
import torch

from test_torch_accum import check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("micro", [1, 2, 4])
@pytest.mark.parametrize("loss_type", ["rep_gp", "rmb_gp", "rmb_ds"])
def test_accum_step_matches_jax_penalised(loss_type, micro):
    check_against_jax(loss_type, micro)
