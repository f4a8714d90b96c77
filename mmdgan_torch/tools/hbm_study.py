"""Device-resident dataset sampling study on the card: the counterpart of
``tools/hbm_study.py``.

Where does the gap between the noise feed and a dataset resident on the
card come from, and does another way of taking batches there close it?
Six variants, each a fresh state from seed 0 (rep, b64, bf16, full
width), K=16 steps per graphed window, the same dataset of 50,000 seeded
rows (``RandomState(0)``, uint8, NHWC) on the card:

- ``synthetic``: ``build_multi_step`` over staged float32 batches (no
  gather, no decode): the compute ceiling;
- ``base``: ``build_device_data_step``, ``sampling="uniform"``: B indices
  and a gather of uint8 rows per step, decoded in the step;
- ``pregather``: one gather of K*B uint8 rows at the window's start,
  then the K steps over its slices;
- ``pregather32``: the same, decoded to float32 at gather time;
- ``f32data``: ``base`` over a float32 copy of the dataset (4x the gather
  traffic, no decode);
- ``cursor``: ``sampling="shuffled_epochs"``: the contiguous rows at
  (step % N/B) * B, no gather (the rows the caller re-permutes per epoch).

``pregather`` and ``pregather32`` run ``build_train_step`` through
``train/step.py``'s ``_window_runner``, the one path from a batch source
to K steps under ``graph_steps`` and ``build_device_data_step``: the
gather runs inside the captured window, its index generator registered
with the graph as the device-data step registers its own (``graph_steps``
itself takes only host batches). Steps/s as JAX's study takes them: two
untimed windows (here the eager warm-up and the capture), then
``steps // K`` timed, fenced by a synchronize. Prints JAX's JSON line.
``--device cpu`` runs on the CPU (a check of the code, no measurement).

    python -m mmdgan_torch.tools.hbm_study [--arch cifar] [--steps 512] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mmdgan_torch import resolve_device

BATCH = 64
SCAN_K = 16
WARMUP = 2
ROWS = 50000
VARIANTS = ("synthetic", "base", "pregather", "pregather32", "f32data", "cursor")
ARCHS = ("cifar", "stl", "celeba", "lsun")


def dataset(n: int, img: int, dtype: str, device) -> torch.Tensor:
    """JAX's data: ``RandomState(0).randint(0, 256, (n, img, img, 3))``,
    uint8, or as float32 in [-1, 1] (``x / 127.5 - 1``)."""
    raw = np.random.RandomState(0).randint(0, 256, (n, img, img, 3), np.uint8)
    data = torch.tensor(raw, device=device)
    return data.float() / 127.5 - 1.0 if dtype == "f32" else data


def pregather_window(step: Callable, num_steps: int, batch: int, decode32: bool,
                     capture: Optional[bool] = None) -> Callable:
    """``fn(ts, data, rng) -> (ts, metrics)``: K steps of ``step``
    (``build_train_step``'s signature) over one gather of K*B rows of
    ``data`` at indices drawn uniformly from ``rng`` at the window's start,
    decoded to float32 then when ``decode32``; graphed on CUDA unless
    ``capture=False``."""
    from mmdgan_torch.train.step import _signature, _window_runner

    run = _window_runner(step, num_steps, capture)

    def window(ts, data: torch.Tensor, rng: torch.Generator, do_dis: bool = True,
               do_gen: bool = True):
        staged = {}

        def batch_at(k: int) -> Dict:
            if k == 0:
                idx = torch.randint(0, data.shape[0], (num_steps * batch,), generator=rng,
                                    device=data.device)
                xs = data.index_select(0, idx)
                staged["xs"] = xs.float() / 127.5 - 1.0 if decode32 else xs
            return {"x": staged["xs"][k * batch:(k + 1) * batch], "y": None}

        return run(ts, ("pregather", decode32, _signature(data)), batch_at, [data], [rng],
                   do_dis, do_gen, None)

    window.graphs = run.graphs
    return window


def _model(arch: str, architecture: Optional[dict], device):
    from mmdgan_torch import architectures
    from mmdgan_torch.models.sngan import SNGan

    if architecture is None:
        architecture = getattr(architectures, f"{arch}_architecture")()
    return SNGan(architecture, num_class=0, loss_type="rep", device=device)


def make_variant(name: str, arch: str = "cifar", device=None, scan_k: int = SCAN_K,
                 batch: int = BATCH, rows: int = ROWS, architecture: Optional[dict] = None):
    """``(call, ts)``: ``call(ts) -> (ts, metrics)`` runs one K-step window
    of variant ``name`` on a fresh state ``ts`` (``architecture``
    overrides the family's, for a narrow model). ``call.data`` is the
    dataset (None for ``synthetic``) and ``call.rng`` its index
    generator."""
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import (build_device_data_step, build_multi_step,
                                         build_train_step, init_train_state)

    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
    dev = resolve_device(device)
    model = _model(arch, architecture, dev)
    img = model.architecture["input"][0][1]
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device=dev)
    rng = torch.Generator(device=dev).manual_seed(1)
    data = None
    if name == "synthetic":
        step = build_multi_step(model, opt_d, opt_g, scan_k, device=dev)
        raw = np.random.RandomState(0).randn(scan_k, batch, img, img, 3)
        batches = {"x": torch.tensor(raw.astype(np.float32).clip(-1, 1), device=dev)}

        def call(ts_):
            return step(ts_, batches)
    elif name in ("base", "f32data", "cursor"):
        data = dataset(rows, img, "f32" if name == "f32data" else "uint8", dev)
        fn = build_device_data_step(
            model, opt_d, opt_g, scan_k, batch, device=dev,
            sampling="shuffled_epochs" if name == "cursor" else "uniform")

        def call(ts_):
            return fn(ts_, data, None, rng)
    else:
        data = dataset(rows, img, "uint8", dev)
        fn = pregather_window(build_train_step(model, opt_d, opt_g, device=dev), scan_k, batch,
                              name == "pregather32")

        def call(ts_):
            return fn(ts_, data, rng)
    call.data, call.rng = data, rng
    return call, ts


def measure(call: Callable, ts, steps: int, scan_k: int = SCAN_K) -> float:
    """WARMUP windows, then ``steps // K`` timed ones; steps/s."""
    def fence(m):
        if m["loss_gen"].is_cuda:
            torch.cuda.synchronize(m["loss_gen"].device)
        loss = float(m["loss_gen"][-1])
        if not np.isfinite(loss):
            raise RuntimeError(f"loss_gen is not finite: {loss}")

    for _ in range(WARMUP):
        ts, m = call(ts)
    fence(m)
    n_calls = max(steps // scan_k, 1)
    start = time.perf_counter()
    for _ in range(n_calls):
        ts, m = call(ts)
    fence(m)
    return n_calls * scan_k / (time.perf_counter() - start)


def run_variant(name: str, arch: str = "cifar", steps: int = 512, device=None) -> float:
    """Steps/s of variant ``name`` on ``arch`` at full width."""
    call, ts = make_variant(name, arch, device)
    sps = measure(call, ts, steps)
    del call, ts
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return sps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="cifar", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    results = {}
    for v in args.variants.split(","):
        sps = run_variant(v, args.arch, args.steps, dev)
        results[v] = sps
        print(f"[hbm_study] {args.arch} {v}: {sps:.1f} steps/s ({card})", file=sys.stderr,
              flush=True)
    print(json.dumps({"arch": args.arch, "steps": args.steps, "steps_per_sec": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
