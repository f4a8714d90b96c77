"""The CIFAR-10 SNGAN architecture dict (own copy of
``experiments/architectures.py:13-63``, unconditional variant).

The dict is the reference's format: reshape and input specs are
channels-first, which is also the port's internal layout, so the layers
use them as they stand.
"""

from __future__ import annotations

import numpy as np


def cifar_architecture(act_k: float = float(np.power(64.0, 0.125)), w_nm: str = "s"):
    """my_test_cifar.py:12-38 — 32x32, code 128, DCGAN G (dense ->
    3x tc k4 s2 bn relu -> conv tanh), 8-layer SN-lrelu D, d=16 scores."""
    return {
        "input": [(3, 32, 32)],
        "code": [(128, "linear")],
        "generator": [
            {"name": "l1", "out": 512 * 4 * 4, "op": "d", "act": "linear",
             "act_nm": None, "out_reshape": [512, 4, 4]},
            {"name": "l2_up", "out": 256, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l3_up", "out": 128, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l4_up", "out": 64, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l5_t32", "out": 3, "act": "tanh"},
        ],
        "discriminator": [
            {"name": "l1_f32", "out": 64, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l2_ds", "out": 128, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l3", "out": 128, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l4_ds", "out": 256, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l5", "out": 256, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l6_ds", "out": 512, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l7", "out": 512, "op": "c", "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "out_reshape": [4 * 4 * 512]},
            {"name": "l8_s", "out": 16, "op": "d", "act_k": act_k,
             "bias": "b", "w_nm": w_nm},
        ],
    }
