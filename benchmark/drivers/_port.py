"""What the drivers share: the seeds of a run, the program's model and
optimisers built from a configuration file, the benchmark's weights and
data made on the device from the seed, and the leaves of the program's
state read and written by the reference's names."""

from __future__ import annotations

import gc
import math
from typing import Dict

import numpy as np
import torch

from benchmark import arith
from benchmark.reference import mmdgan

SEED_NAMES = ("weights", "data", "z", "init", "call1", "call2", "warm1", "warm2", "window",
              "trace", "sample")


def seeds(seed: int) -> Dict[str, int]:
    """Independent 31-bit seeds of a run, from its ``--seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(SEED_NAMES))
    return {name: int(w) & 0x7FFFFFFF for name, w in zip(SEED_NAMES, words)}


def dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]


def build(cfg: dict, device: torch.device):
    """The program's model and optimisers for the configuration."""
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import Adam

    if cfg["optimizer"] != "adam":
        raise ValueError(f"optimizer {cfg['optimizer']} is not covered")
    model = SNGan(cfg["architecture"], loss_type=cfg["loss"],
                  rep_weights=tuple(cfg["repulsive_weights"]), compute_dtype=dtype(cfg),
                  use_fused_kernel=True, device=device)
    adam = lambda lr: Adam(lr, b1=cfg["beta1"], b2=cfg["beta2"], eps=cfg["eps"])  # noqa: E731
    return model, adam(cfg["lr_dis"]), adam(cfg["lr_gen"])


def make_state(cfg: dict, specs: Dict[str, dict], seed: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Every leaf of the model from ``seed``, in one draw on the device:
    kernels at the fan-in scales of their activation (2 for relu, 2/1.01
    for lrelu, 1 on the fan average otherwise), small biases, batch norms
    off their identity, and spectral-norm vectors power-iterated 20 times
    so that the first step is not the degenerate one of a raw vector."""
    names = list(specs)
    sizes = [math.prod(specs[n]["shape"]) for n in names]
    g = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    state, offset = {}, 0
    for n, size in zip(names, sizes):
        s = specs[n]
        x = flat[offset:offset + size].view(s["shape"])
        offset += size
        kind = s["kind"]
        if kind == "kernel":
            gain = {"relu": 2.0, "lrelu": 2.0 / 1.01}.get(s["act"])
            fan = s["fan_in"] if gain else (s["fan_in"] + s["fan_out"]) / 2.0
            x = x * math.sqrt((gain or 1.0) / fan)
        elif kind in ("bias", "beta", "moving_mean"):
            x = 0.1 * x if kind != "bias" else 0.01 * x
        elif kind == "gamma":
            x = 1.0 + 0.1 * x
        elif kind == "moving_var":
            x = torch.exp(0.2 * x)
        state[n] = x.clone()
    arch = cfg["architecture"]
    with mmdgan.float32_exact():
        for net in ("gen", "dis"):
            for L in mmdgan.layers(arch, net):
                key = f"{L['name']}/kernel/sn_x"
                if key in state:
                    u = state[key] / torch.linalg.vector_norm(state[key])
                    for _ in range(20):
                        _, u = mmdgan.power_iteration(L, state[f"{L['name']}/kernel/kernel"], u)
                    state[key] = u
    return state


def make_images(shape_nhwc, seed: int, device: torch.device) -> np.ndarray:
    """Seeded uint8 images, drawn on the device, handed over as host rows."""
    g = torch.Generator(device).manual_seed(int(seed))
    x = torch.randint(0, 256, tuple(shape_nhwc), generator=g, device=device, dtype=torch.uint8)
    return x.cpu().numpy()


def _split(name: str):
    net, layer, op, leaf = name.split("/")
    return net, f"{net}/{layer}", op, leaf


def leaf(ts, name: str, slot: str = None) -> torch.Tensor:
    """The program's tensor of a reference leaf: a parameter, an SN vector
    or BN statistic, or with ``slot`` ('mu', 'nu') Adam's slot of a
    parameter."""
    net, scope, op, key = _split(name)
    if slot is not None:
        opt = ts.opt_state_dis if net == "dis" else ts.opt_state_gen
        return opt.slots[slot][scope][op][key]
    tree = ts.net_state if key in ("sn_x", "moving_mean", "moving_var") else ts.params
    return tree[net][scope][op][key]


def write_state(ts, state: Dict[str, torch.Tensor]) -> None:
    """The benchmark's leaves into the program's state, in place."""
    with torch.no_grad():
        for name, value in state.items():
            t = leaf(ts, name)
            if tuple(t.shape) != tuple(value.shape):
                raise ValueError(f"{name}: the program holds {tuple(t.shape)}, "
                                 f"the reference {tuple(value.shape)}")
            t.copy_(value)


def read_state(ts, specs: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """Host copies of every leaf, and of Adam's slots as ``mu/<leaf>``,
    ``nu/<leaf>``."""
    out = {n: leaf(ts, n).detach().to("cpu", torch.float32, copy=True) for n in specs}
    for n, s in specs.items():
        if s["group"] == "param":
            for slot in ("mu", "nu"):
                out[f"{slot}/{n}"] = leaf(ts, n, slot).detach().to("cpu", torch.float32, copy=True)
    return out


def report_train(r, steps: int, seconds: float) -> None:
    """The train cells' end-to-end metrics over a window of ``steps``."""
    cfg = r.cfg
    r.e2e["train_img_per_s"] = cfg["batch_size"] * steps / seconds
    r.e2e["train_mfu"] = (100.0 * arith.train_step_flops(cfg)["total"] * steps / seconds
                          / arith.PEAK_BF16_FLOP_PER_S)


def release(r, device: torch.device) -> None:
    """After the window: read the memory peak, then free what the program
    held (the caller has dropped its references) before the reference runs."""
    if device.type == "cuda":
        r.memory_peak = torch.cuda.max_memory_allocated(device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
