"""Serving-path benchmark: generator inference throughput in images/s
(``tools/serving_bench.py``).

Measures the two deployment surfaces:

- ``model``: the in-process generator (``SNGan.generate``, eval mode, the
  weights on the device), the eval-sampling path;
- ``export``: the ``torch.export`` artifact (``utils/export.py``) loaded
  with ``load_exported`` and called, the serving path that needs no
  model code.

Each batch of the sweep is timed with CUDA events around ``CALLS`` calls
after ``WARMUP`` warm-up calls (on the CPU, the host clock), the two
surfaces in turns (in-process, exported, exported, in-process: small
batches are bound by the host's launches, which drift), and prints one
JSON line in the JAX tool's shape, the batch as the key of the mean of
each surface's two rates, with both readings and the seconds the export
and the load took. The weights are the model's init from ``--seed``; the
rate does not depend on them.

Usage: python -m mmdgan_torch.tools.serving_bench [--arch cifar]
    [--batches 64,256,1024] [--device cuda] [--compute-dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List

import torch

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.architectures import (
    celeba_architecture,
    cifar_architecture,
    hd_architecture,
    lsun_architecture,
    stl_architecture,
)
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.utils.export import export_generator, load_exported

CALLS = 64
WARMUP = 3
ARCHS = {"cifar": cifar_architecture, "stl": stl_architecture, "celeba": celeba_architecture,
         "lsun": lsun_architecture, "hd128": lambda: hd_architecture(128),
         "hd256": lambda: hd_architecture(256), "hd512": lambda: hd_architecture(512)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def images_per_sec(call: Callable, z: torch.Tensor, calls: int = CALLS,
                   warmup: int = WARMUP) -> float:
    """``call(z)`` ``calls`` times after ``warmup`` calls: images per second,
    by CUDA events on the card, by the host clock on the CPU."""
    for _ in range(warmup):
        call(z)
    if z.device.type == "cuda":
        torch.cuda.synchronize(z.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call(z)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        begin = time.perf_counter()
        for _ in range(calls):
            call(z)
        seconds = time.perf_counter() - begin
    return calls * z.shape[0] / seconds


def bench(arch: str, batches: List[int], device: DeviceLike = None,
          compute_dtype: torch.dtype = torch.bfloat16, calls: int = CALLS,
          seed: int = 0) -> List[Dict]:
    """One record per batch: images/s of the in-process generator and of
    the exported artifact (each the mean of two readings taken in turns),
    and the seconds to export and to load it."""
    dev = resolve_device(device)
    model = SNGan(ARCHS[arch](), num_class=0, loss_type="rep", compute_dtype=compute_dtype,
                  device=dev)
    params, state, _ = model.init(seed)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for b in batches:
            z = torch.randn(b, model.code_size, generator=torch.Generator().manual_seed(seed)).to(dev)
            path = os.path.join(tmp, f"gen_b{b}.pt2")
            start = time.perf_counter()
            export_generator(model, params, state, b, path, device=dev)
            export_s = time.perf_counter() - start
            start = time.perf_counter()
            served = load_exported(path, device=dev)
            load_s = time.perf_counter() - start
            surfaces = {"model": lambda z: model.generate(params, state, code_batch={"x": z}),
                        "export": served}
            turns = {"model": [], "export": []}
            for name in ("model", "export", "export", "model"):
                turns[name].append(images_per_sec(surfaces[name], z, calls))
            in_process, exported = (sum(turns[k]) / 2 for k in ("model", "export"))
            records.append({"arch": arch, "model_img_per_sec": {b: in_process},
                            "export_img_per_sec": {b: exported}, "turns": turns,
                            "export_s": export_s, "load_s": load_s})
            print(f"[serving] {arch} b{b}: model {in_process:,.0f} img/s, export "
                  f"{exported:,.0f} img/s (in turns: model {turns['model'][0]:,.0f}, export "
                  f"{turns['export'][0]:,.0f}, {turns['export'][1]:,.0f}, model "
                  f"{turns['model'][1]:,.0f}; export {export_s:.2f} s, load {load_s:.2f} s)",
                  file=sys.stderr)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cifar", choices=sorted(ARCHS) + ["all"])
    ap.add_argument("--batches", default="64,256,1024")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--calls", type=int, default=CALLS)
    args = ap.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    archs = ["cifar", "stl", "celeba", "lsun"] if args.arch == "all" else [args.arch]
    for arch in archs:
        for record in bench(arch, batches, args.device, DTYPES[args.compute_dtype], args.calls):
            print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
