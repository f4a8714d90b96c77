"""Per-kernel and per-module profile of the graphed train window
(``tools/profile_step.py``), on ``torch.profiler``:

  python -m mmdgan_torch.tools.profile_step [--arch cifar] [--loss rep] [--batch 64]

It builds the full-width model of ``--arch`` from seed 0, runs the K-step
window the ``Agent`` runs (``build_multi_step`` over a K-stacked noise
batch; with ``--micro-batches`` M > 1 the accumulated
``build_device_data_step`` over a uint8 dataset on the device, as JAX's
tool does), warms it up (its eager call, its capture, a replay), times
``--calls`` replays unprofiled, then profiles ``--calls`` replays and one
eager window with Python stacks, and prints:

  1. the top device kernels by self time, with their share of the
     replays' device time;
  2. the eager window's device time grouped by the port's module scope
     (the innermost ``mmdgan_torch`` frame that launched each kernel: a
     replayed graph has no host frames);
  3. the device totals per step beside the measured steps/s.

``window_timeline`` reads a profile into the numbers ``chip_smoke.py``
reports for its profiled windows. Run on the card; ``--device cpu`` works
and profiles the host's ops instead of kernels.
"""

from __future__ import annotations

import argparse
import re
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.tools.serving_bench import ARCHS, DTYPES

IMAGE_SIZE = {"cifar": 32, "stl": 48, "celeba": 64, "lsun": 64, "hd128": 128, "hd256": 256,
              "hd512": 512}


_FRAME = re.compile(r"\.py\(\d+\): ")


def _is_frame(event) -> bool:
    """Whether a host event is a Python frame (``with_stack=True``)."""
    return bool(_FRAME.search(event.name))


def _kernels(prof, device: torch.device) -> list:
    """``(name, start_ns, end_ns)`` of the profile's device activities
    (``raw_activities``); on the CPU, of its innermost host ops."""
    if device.type == "cuda":
        return raw_activities(prof, torch.autograd.DeviceType.CUDA)
    return [(e.name, int(e.time_range.start * 1e3), int(e.time_range.end * 1e3))
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
            and not _is_frame(e) and all(_is_frame(c) for c in e.cpu_children)]


def raw_activities(prof, device_type) -> list:
    """``(name, start_ns, end_ns)`` of the profile's events on ``device_type``
    (a ``torch.autograd.DeviceType``), read from the profiler's raw results
    with the names and filters ``prof.events()`` applies, without building
    that list: it costs about 50 us an event, seconds for an eager window of
    the CIFAR step. ``check_raw_activities`` holds the two against each
    other."""
    # torch's own private helpers, imported here so that a torch release
    # that moves them breaks this reader alone
    from torch.autograd.profiler_util import StringTable, _filter_name

    names = StringTable()
    return [(names[e.name()], e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == device_type and not _filter_name(e.name())
            and not getattr(e, "is_hidden_event", lambda: False)()]


def check_raw_activities(prof, device_type) -> Dict:
    """``raw_activities`` against ``prof.events()`` on ``device_type``: the
    same names as many times each and the same total time (to 1 ns), else
    an AssertionError that says what differs. Returns the activities and
    their total ns."""
    raw = raw_activities(prof, device_type)
    parsed = [e for e in prof.events() if e.device_type == device_type]
    raw_ns = sum(hi - lo for _, lo, hi in raw)
    parsed_ns = sum(e.time_range.elapsed_us() for e in parsed) * 1e3
    raw_names, parsed_names = Counter(n for n, _, _ in raw), Counter(e.name for e in parsed)
    if raw_names != parsed_names or abs(raw_ns - parsed_ns) > 1:
        raise AssertionError(
            f"raw results: {len(raw)} activities, {raw_ns} ns; prof.events(): {len(parsed)}, "
            f"{parsed_ns:.1f} ns; only in the raw results {dict(raw_names - parsed_names)}; "
            f"only in prof.events() {dict(parsed_names - raw_names)}")
    return {"activities": len(raw), "ns": raw_ns}


def window_timeline(prof, steps: int, device: torch.device, count: tuple = ()) -> Dict:
    """A profiled run of ``steps`` steps as per-step numbers: the device
    busy time (the sum of its kernels' times, and the union of their
    intervals), the span from the first kernel's start to the last one's
    end, the activities, the time and calls by kernel name, the launches
    of each name in ``count`` (by substring), and the collectives the host
    issued (``nccl:`` events; a replayed graph issues none)."""
    kernels = _kernels(prof, device)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((lo, hi) for _, lo, hi in kernels)
    covered, reach = 0, spans[0][0]
    for lo, hi in spans:
        covered += max(0, hi - max(lo, reach))
        reach = max(reach, hi)
    out = {"busy": sum(hi - lo for lo, hi in spans) / 1e6 / steps,
           "union": covered / 1e6 / steps, "span": (reach - spans[0][0]) / 1e6 / steps,
           "activities": len(kernels) / steps, "by_name": {}, "calls_by_name": {}}
    for name, lo, hi in kernels:
        out["by_name"][name] = out["by_name"].get(name, 0.0) + (hi - lo) / 1e6
        out["calls_by_name"][name] = out["calls_by_name"].get(name, 0) + 1
    for name in count:
        out[name] = sum(name in k[0] for k in kernels)
    out["nccl_ops"] = sum(name.startswith("nccl:") for name, _, _ in
                          raw_activities(prof, torch.autograd.DeviceType.CPU))
    return out


def module_scope(event) -> str:
    """The innermost Python frame of the port above a host op, as
    ``mmdgan_torch/<module>.py: <function>``."""
    parent = event.cpu_parent
    while parent is not None:
        path, _, func = parent.name.partition(": ")
        if "mmdgan_torch" in path and "tools/profile_step" not in path:
            return f"{path[path.rindex('mmdgan_torch'):].split('(')[0]}: {func}"
        parent = parent.cpu_parent
    return "(outside mmdgan_torch)"


def by_module(prof, device: torch.device) -> Dict[str, float]:
    """The device time (host time on the CPU) of a profile recorded with
    ``with_stack=True``, in ms by the module scope of the op that launched
    it (each op's self time: nested ops are not counted twice)."""
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or _is_frame(e):
            continue
        us = e.self_device_time_total if device.type == "cuda" else e.self_cpu_time_total
        if us > 0:
            scope = module_scope(e)
            out[scope] = out.get(scope, 0.0) + us / 1e3
    return out


def collect(arch: str, loss: str, batch: int, scan_k: int, calls: int, micro_batches: int = 1,
            device: DeviceLike = None, compute_dtype: torch.dtype = torch.bfloat16,
            seed: int = 0) -> Dict:
    """Build, warm, time and profile the window; returns the timeline of
    the replays (``window_timeline``), the module table of one eager
    window, the steps/s of the unprofiled replays and the steps counted."""
    from torch.profiler import ProfilerActivity, profile

    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_device_data_step, build_multi_step, init_train_state

    dev = resolve_device(device)
    model = SNGan(ARCHS[arch](), num_class=0, loss_type=loss, compute_dtype=compute_dtype,
                  device=dev)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, seed, opt_d, opt_g, device=dev)
    img = IMAGE_SIZE[arch]
    rng = np.random.RandomState(seed)

    def window(capture: Optional[bool]):
        if micro_batches > 1:
            fn = build_device_data_step(model, opt_d, opt_g, scan_k, batch,
                                        micro_batches=micro_batches, device=dev, capture=capture)
            data = torch.tensor(rng.randint(0, 256, (4 * batch, img, img, 3), np.uint8),
                                device=dev)
            gen = torch.Generator(dev).manual_seed(seed + 1)
            return lambda ts: fn(ts, data, None, gen)
        multi = build_multi_step(model, opt_d, opt_g, scan_k, device=dev, capture=capture)
        batches = {"x": torch.tensor(rng.randn(scan_k, batch, img, img, 3).astype(np.float32)
                                     .clip(-1, 1), device=dev)}
        return lambda ts: multi(ts, batches)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    graphed = window(None)
    for _ in range(3):   # the eager warm-up, the capture, a replay
        ts, m = graphed(ts)
    sync()
    start = time.perf_counter()
    for _ in range(calls):
        ts, m = graphed(ts)
    sync()
    steps_per_sec = calls * scan_k / (time.perf_counter() - start)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for _ in range(calls):
            ts, m = graphed(ts)
        sync()
    timeline = window_timeline(prof, calls * scan_k, dev, ("kernel_means_fwd",
                                                           "kernel_means_bwd"))
    eager = window(False)
    with profile(activities=activities, with_stack=True) as prof:
        ts, m = eager(ts)
        sync()
    return {"timeline": timeline, "modules": by_module(prof, dev), "module_steps": scan_k,
            "steps_per_sec": steps_per_sec, "steps": calls * scan_k,
            "loss_gen": float(m["loss_gen"][-1])}


def report(result: Dict, top: int = 20) -> List[str]:
    """The three tables as text lines."""
    tl, steps = result["timeline"], result["steps"]
    total = sum(tl["by_name"].values()) or 1.0
    lines = [f"## Top {top} device kernels by self time (device total {total:.3f} ms over "
             f"{steps} steps = {tl['busy']:.4f} ms/step)", "",
             "| % | self ms | calls | kernel |", "|---|---|---|---|"]
    for name, ms in sorted(tl["by_name"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"| {100 * ms / total:5.1f} | {ms:8.3f} | {tl['calls_by_name'][name]:5d} | "
                     f"{name[:90]} |")
    modules = result["modules"]
    mod_total = sum(modules.values()) or 1.0
    lines += ["", f"## By module scope, one eager window of {result['module_steps']} steps "
              f"(top {top})", "", "| % | ms/step | scope |", "|---|---|---|"]
    for scope, ms in sorted(modules.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"| {100 * ms / mod_total:5.1f} | {ms / result['module_steps']:8.4f} | "
                     f"{scope} |")
    step_ms = 1e3 / result["steps_per_sec"]
    lines += ["", "## Device totals", "",
              f"  measured {result['steps_per_sec']:.2f} steps/s unprofiled = {step_ms:.4f} "
              "ms/step",
              f"  device busy {tl['busy']:.4f} ms/step (union {tl['union']:.4f}), span "
              f"{tl['span']:.4f} ms/step, idle {100 * (1 - tl['union'] / tl['span']):.1f}% of "
              f"the span, {100 * (1 - tl['union'] / step_ms):.1f}% of the measured step",
              f"  {tl['activities']:.0f} device activities per step; kernel means "
              f"{tl['kernel_means_fwd'] / steps:g} + {tl['kernel_means_bwd'] / steps:g} "
              "launches per step"]
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cifar", choices=sorted(IMAGE_SIZE))
    ap.add_argument("--loss", default="rep")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scan-k", type=int, default=16)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--micro-batches", type=int, default=1,
                    help="profile the accumulated device-data step instead of the fused "
                         "host-fed one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}; "
          f"arch={args.arch} loss={args.loss} b={args.batch} K={args.scan_k} "
          f"micro={args.micro_batches}", flush=True)
    result = collect(args.arch, args.loss, args.batch, args.scan_k, args.calls,
                     args.micro_batches, dev, DTYPES[args.compute_dtype])
    print("\n".join(report(result, args.top)), flush=True)


if __name__ == "__main__":
    main()
