"""Steps per graphed window (K) and per-card batch scaling study: the
counterpart of ``tools/scaling_study.py``.

Two sweeps over the full-width train step on a fixed noise feed, each
point a fresh state from seed 0 through ``build_multi_step``'s graphed
K-step window (one CUDA graph launch per K steps), fenced by
``torch.cuda.synchronize``:

1. a K sweep at batch 64: how many steps per launch amortize the host's
   launch and fence cost;
2. a batch sweep at K=16: throughput against the per-card batch, in
   steps/s and images/s (images/s keeps rising after steps/s falls).

    python -m mmdgan_torch.tools.scaling_study [--arch cifar] [--loss rep] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

IMAGE_SIZE = {"cifar": 32, "stl": 48, "celeba": 64, "lsun": 64}
K_SWEEP, BATCH_SWEEP, STEPS = (1, 2, 4, 8, 16, 32, 64), (16, 32, 64, 128, 256), 384


def sweep_batches(batch: int, scan_k: int, img: int, device) -> dict:
    """JAX's feed, ``RandomState(0).randn(K, B, img, img, 3)`` clipped to
    [-1, 1] (NHWC in both packages), on ``device``."""
    rng = np.random.RandomState(0)
    return {"x": torch.tensor(
        rng.randn(scan_k, batch, img, img, 3).astype(np.float32).clip(-1, 1), device=device)}


def setup(arch: str, loss: str, batch: int, scan_k: int, device=None) -> tuple:
    """``(step, ts, batches)``: the model of ``arch`` at full width, its
    state from seed 0 with Adam 5e-4 (D) / 2e-4 (G), the graphed K-step
    window and the fixed batch."""
    from mmdgan_torch import architectures, resolve_device
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_multi_step, init_train_state

    dev = resolve_device(device)
    model = SNGan(getattr(architectures, f"{arch}_architecture")(), num_class=0,
                  loss_type=loss, device=dev)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device=dev)
    step = build_multi_step(model, opt_d, opt_g, scan_k, device=dev)
    return step, ts, sweep_batches(batch, scan_k, IMAGE_SIZE[arch], dev)


def timed(step, ts, batches, scan_k: int, steps: int) -> tuple:
    """Two untimed windows (on CUDA the eager warm-up and the capture),
    then ``max(steps // K, 2)`` timed ones; returns ``(ts, steps/s)``."""
    def fence(m):
        if m["loss_gen"].is_cuda:
            torch.cuda.synchronize(m["loss_gen"].device)
        float(m["loss_gen"][-1])

    for _ in range(2):
        ts, m = step(ts, batches)
    fence(m)
    n_calls = max(steps // scan_k, 2)
    start = time.perf_counter()
    for _ in range(n_calls):
        ts, m = step(ts, batches)
    fence(m)
    return ts, n_calls * scan_k / (time.perf_counter() - start)


def measure(arch: str, loss: str, batch: int, scan_k: int, steps: int, device=None) -> float:
    """Steps/s of ``arch`` with ``loss`` at ``batch`` in K-step windows."""
    step, ts, batches = setup(arch, loss, batch, scan_k, device)
    return timed(step, ts, batches, scan_k, steps)[1]


K_TABLE = "## scan-K sweep (batch 64) — dispatch amortization\n\n| K | steps/s |\n|---|---------|"
BATCH_TABLE = ("## batch sweep (K=16) — per-chip batch scaling\n\n"
               "| batch | steps/s | images/s |\n|-------|---------|----------|")


def k_row(k: int, sps: float) -> str:
    return f"| {k:3d} | {sps:8.1f} |"


def batch_row(batch: int, sps: float) -> str:
    return f"| {batch:5d} | {sps:8.1f} | {sps * batch:9.0f} |"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="cifar", choices=sorted(IMAGE_SIZE))
    p.add_argument("--loss", default="rep")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--k-sweep", default=",".join(map(str, K_SWEEP)))
    p.add_argument("--batch-sweep", default=",".join(map(str, BATCH_SWEEP)))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from mmdgan_torch import resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}); arch={args.arch} loss={args.loss}\n")
    print(K_TABLE)
    for k in [int(v) for v in args.k_sweep.split(",")]:
        print(k_row(k, measure(args.arch, args.loss, 64, k, args.steps, dev)), flush=True)
    print("\n" + BATCH_TABLE)
    for b in [int(v) for v in args.batch_sweep.split(",")]:
        print(batch_row(b, measure(args.arch, args.loss, b, 16, args.steps, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
