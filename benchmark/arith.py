"""The benchmark's yardstick arithmetic: published peaks of one NVIDIA H100
SXM, the model FLOPs of a train step, and the least
time of the two hand-written kernels of the port (the six kernel means
and their gradient).

Frozen copies: the kernel bounds are those of ``kernel_study.py``
``kernel_means_bound_ms`` / ``kernel_means_backward_bound_ms`` (PR 12),
the peaks NVIDIA's data sheet (dense rates, 700 W). Everything here reads
a configuration file's architecture and never the program.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.reference.mmdgan import layers

PEAK_BF16_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_SFU_PER_S = PEAK_FP32_PER_S / 16


def layer_macs(arch: dict, net: str) -> List[int]:
    """Multiply-adds of each layer of ``net`` for one image (one code)."""
    out = []
    for L in layers(arch, net):
        if L["op"] == "d":
            out.append(L["kernel_shape"][0] * L["kernel_shape"][1])
        elif L["op"] == "c":
            c_out, c_in, k, _ = L["kernel_shape"]
            out.append(c_out * c_in * k * k * L["out"][1] * L["out"][2])
        else:   # a transposed conv scatters each input pixel to k*k outputs
            c_in, c_out, k, _ = L["kernel_shape"]
            out.append(c_in * c_out * k * k * L["in"][1] * L["in"][2])
    return out


def train_step_flops(cfg: dict) -> Dict[str, float]:
    """Model FLOPs of one train step at the configuration's batch B, as 2 x
    multiply-adds of every conv, transposed conv and dense layer: G's
    forward (B rows); D's forward on concat(real, fake) (2B); D's backward
    for its update (2B: every weight gradient, and the input gradients of
    all layers but the first); the pull through D to G (input gradients
    of every layer over B rows); G's backward (weight gradients, input
    gradients of all layers but the first); and the spectral norm's power
    iteration (one product and one adjoint per normalised layer, one
    vector). No elementwise work, batch norm, loss, Adam or recomputation.
    Returns the parts and their ``total``."""
    arch, b = cfg["architecture"], cfg["batch_size"]
    g, d = layer_macs(arch, "gen"), layer_macs(arch, "dis")
    sn = sum(m for m, L in zip(d, layers(arch, "dis")) if L["sn"]) + sum(
        m for m, L in zip(g, layers(arch, "gen")) if L["sn"])
    parts = {
        "gen_forward": 2 * b * sum(g),
        "dis_forward": 2 * 2 * b * sum(d),
        "dis_backward": 2 * 2 * b * (sum(d) + sum(d[1:])),
        "pull_through_dis": 2 * b * sum(d),
        "gen_backward": 2 * b * (sum(g) + sum(g[1:])),
        "spectral_norm": 2 * 2 * sn,
    }
    parts["total"] = float(sum(parts.values()))
    return parts


def _bound(times: Dict[str, float]):
    by = max(times, key=times.get)
    return times[by] * 1e3, ("bytes" if by == "bytes" else "operations"), by


def kernel_means_bound_ms(b: int, d: int):
    """(bound in ms, 'bytes' or 'operations', the pipe that bounds it) for
    the six means. Bytes: each input read once, 24 bytes written. Entries:
    the B(B-1)/2 above the diagonal of each symmetric matrix (gen-gen,
    data-data) and all B^2 of gen-data. Per entry 2d flops of Gram product,
    3 of distance, one exponential on the special-function units and 2
    flops to scale and add it; per entry of a symmetric matrix 2 more
    (select the bounded kernel, add it); 2 flops per score element for the
    squared norms. The fp32 and special-function pipes run side by side,
    so the operations take the longer of their two times."""
    half = b * (b - 1) // 2
    entries = 2 * half + b * b
    flops = entries * (2 * d + 5) + 2 * half * 2 + 2 * 2 * b * d
    return _bound({"bytes": (2 * b * d * 4 + 6 * 4) / PEAK_BYTES_PER_S,
                   "fp32": flops / PEAK_FP32_PER_S, "special-function": entries / PEAK_SFU_PER_S})


def kernel_means_backward_bound_ms(b: int, d: int):
    """(bound in ms, 'bytes' or 'operations', the pipe that bounds it) for
    the gradient of the six means. Bytes: both inputs and the [6] cotangent
    read once, both [B, d] gradients written once. Entries as in
    ``kernel_means_bound_ms``, each computed once: 2d flops of Gram
    product, 3 of distance, one exponential, 3 to form the coefficient
    (select the bounded part, scale, multiply by k), and 2 * 2d to
    accumulate it into both endpoint rows; 2 flops per score element for
    the squared norms."""
    half = b * (b - 1) // 2
    entries = 2 * half + b * b
    flops = entries * (6 * d + 6) + 2 * 2 * b * d
    return _bound({"bytes": ((2 * b * d + 6) * 4 + 2 * b * d * 4) / PEAK_BYTES_PER_S,
                   "fp32": flops / PEAK_FP32_PER_S, "special-function": entries / PEAK_SFU_PER_S})


def score_shape(cfg: dict):
    """(B, d) at which the train step calls the kernel pair."""
    return cfg["batch_size"], cfg["architecture"]["discriminator"][-1]["out"]
