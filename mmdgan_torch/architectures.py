"""The architecture dicts of the port (own copy of
``experiments/architectures.py:13-208``): CIFAR-10, STL-10, CelebA, LSUN
and the extrapolated hd family; CIFAR-10 and hd also class-conditional.

The dicts are the reference's format: reshape and input specs are
channels-first, which is also the port's internal layout, so the layers
use them as they stand. Every SAME padding of these families is
symmetric (even sizes under 4x4 stride-2 convs and transposed convs,
3x3 stride-1 convs), so each conv is one cuDNN call with torch's padding.
"""

from __future__ import annotations

import math

import numpy as np


def make_conditional(arch: dict) -> dict:
    """The class-conditional variant the reference builds for labelled
    data (my_sngan.py num_class >= 2): the generator's batch norms become
    conditional (cbn, layer_func.py:914-963) and the score head a
    conditionally scaled dense ('dck', dense * (1 + per-class scale),
    layer_func.py:679-690)."""
    for layer in arch["generator"]:
        if layer.get("act_nm") == "bn":
            layer["act_nm"] = "cbn"
    arch["discriminator"][-1]["op"] = "dck"
    return arch


def cifar_architecture(act_k: float = float(np.power(64.0, 0.125)), w_nm: str = "s",
                       conditional: bool = False):
    """my_test_cifar.py:12-38 — 32x32, code 128, DCGAN G (dense ->
    3x tc k4 s2 bn relu -> conv tanh), 8-layer SN-lrelu D, d=16 scores.
    ``conditional=True``: cbn generator, dck score head (``make_conditional``)."""
    arch = _cifar_arch(act_k, w_nm)
    return make_conditional(arch) if conditional else arch


def _cifar_arch(act_k: float, w_nm: str):
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


def stl_architecture(act_k: float = float(np.power(64.0, 0.125)), w_nm: str = "s"):
    """my_test_stl.py — 48x48 STL-10; one extra up/down stage vs CIFAR.
    The generator's trunk is a dense layer with BN on its 18,432 flat
    features, reshaped to 512 x 6 x 6 after the activation."""
    return {
        "input": [(3, 48, 48)],
        "code": [(128, "linear")],
        "generator": [
            {"name": "l1", "out": 512 * 6 * 6, "op": "d", "act": "relu",
             "act_nm": "bn", "out_reshape": [512, 6, 6]},
            {"name": "l2_up", "out": 256, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l3_up", "out": 128, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l4_up", "out": 64, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l5_t48", "out": 3, "act": "tanh"},
        ],
        "discriminator": [
            {"name": "l1_f48", "out": 64, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l2_ds", "out": 128, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l3", "out": 128, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l4_ds", "out": 256, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l5", "out": 256, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l6_ds", "out": 512, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l7", "out": 512, "op": "c", "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "out_reshape": [6 * 6 * 512]},
            {"name": "l8_s", "out": 16, "op": "d", "act_k": act_k, "w_nm": w_nm},
        ],
    }


def celeba_architecture(act_k: float = float(np.power(64.0, 0.1)), w_nm: str = "s"):
    """my_test_celebA.py:11-38 — 64x64 faces; 10-layer discriminator."""
    return _arch_64(act_k, w_nm)


def lsun_architecture(act_k: float = float(np.power(64.0, 0.1)), w_nm: str = "s"):
    """my_test_lsun.py:11-39 — 64x64 LSUN bedrooms; same topology as celebA."""
    return _arch_64(act_k, w_nm)


def _arch_64(act_k: float, w_nm: str):
    return {
        "input": [(3, 64, 64)],
        "code": [(128, "linear")],
        "generator": [
            {"name": "l1", "out": 1024 * 4 * 4, "op": "d", "act": "linear",
             "act_nm": None, "out_reshape": [1024, 4, 4]},
            {"name": "l2_up", "out": 512, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l3_up", "out": 256, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l4_up", "out": 128, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l5_up", "out": 64, "op": "tc", "act": "relu",
             "act_nm": "bn", "kernel": 4, "strides": 2},
            {"name": "l6_t64", "out": 3, "act": "tanh"},
        ],
        "discriminator": [
            {"name": "l1_f64", "out": 64, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l2_ds", "out": 128, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l3", "out": 128, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l4_ds", "out": 256, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l5", "out": 256, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l6_ds", "out": 512, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l7", "out": 512, "act": "lrelu", "act_k": act_k, "w_nm": w_nm},
            {"name": "l8_ds", "out": 1024, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "kernel": 4, "strides": 2},
            {"name": "l9", "out": 1024, "act": "lrelu", "act_k": act_k,
             "w_nm": w_nm, "out_reshape": [1024 * 4 * 4]},
            {"name": "l10_s", "out": 16, "op": "d", "act_k": act_k, "w_nm": w_nm},
        ],
    }


def hd_architecture(size: int = 128, act_k: float = float(np.power(64.0, 0.1)),
                    w_nm: str = "s", score_size: int = 16, conditional: bool = False):
    """The scaled DCGAN for 128/256/512... images: ``_arch_64``'s topology
    extrapolated to any power-of-two size >= 8. G: dense -> 4x4 trunk ->
    k4/s2 transposed-conv doublings with halving channels (capped at 1024,
    floored at 32); D: the mirrored conv/downsample stack to 4x4 -> dense
    score. At these sizes activations dominate memory: pair with
    ``build_grad_accum_step`` (``--micro-batches``).
    ``conditional=True``: cbn generator, dck score head."""
    if size < 8 or size & (size - 1):
        raise ValueError(f"size must be a power of two >= 8, got {size}")
    ups = int(math.log2(size // 4))
    top = min(1024, 64 * 2 ** (ups - 1))

    gen = [{"name": "l1", "out": top * 4 * 4, "op": "d", "act": "linear",
            "act_nm": None, "out_reshape": [top, 4, 4]}]
    ch = top
    for i in range(ups - 1):
        ch = max(ch // 2, 32)
        gen.append({"name": f"l{i + 2}_up", "out": ch, "op": "tc", "act": "relu",
                    "act_nm": "bn", "kernel": 4, "strides": 2})
    gen.append({"name": f"l{ups + 1}_t{size // 2}x2", "out": 3, "op": "tc",
                "act": "tanh", "act_nm": None, "kernel": 4, "strides": 2})

    ch = max(top // 2 ** (ups - 1), 32)
    dis = [{"name": f"l1_f{size}", "out": ch, "act": "lrelu", "act_k": act_k, "w_nm": w_nm}]
    for i in range(ups - 1):
        ch = min(ch * 2, 1024)
        dis.append({"name": f"l{i + 2}_ds", "out": ch, "act": "lrelu", "act_k": act_k,
                    "w_nm": w_nm, "kernel": 4, "strides": 2})
    dis.append({"name": f"l{ups + 1}_ds", "out": top, "act": "lrelu", "act_k": act_k,
                "w_nm": w_nm, "kernel": 4, "strides": 2, "out_reshape": [top * 4 * 4]})
    dis.append({"name": f"l{ups + 2}_s", "out": score_size, "op": "d", "act_k": act_k,
                "w_nm": w_nm})
    arch = {
        "input": [(3, size, size)],
        "code": [(128, "linear")],
        "generator": gen,
        "discriminator": dis,
    }
    return make_conditional(arch) if conditional else arch
