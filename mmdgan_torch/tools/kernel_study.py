"""Kernel-means study on the card: the counterpart of ``tools/pallas_study.py``.

Does the hand-written kernel-means pair (``csrc/kernel_means.cu``, the
port of ``mmdgan_tpu/ops/pallas_mmd.py``'s Pallas kernel and its
backward) earn its place as the default (``use_fused_kernel=True``)?

1. **Microbench**: ``fused_kernel_means`` (both kernels through autograd)
   against its plain version (``kernel_means_reference`` under autograd),
   forward only and forward+grad, for (B, d) in {64, 256} x {16, 256}, on
   JAX's scalar ``e0 - 2 e1 + e2 + 0.1 (e3 - e4 + e5)``. Each shape is
   gated first: the scalar and its gradient against the plain version's
   (rtol 1e-5 / atol 1e-6; rtol 1e-4 / atol 1e-8 plus
   ``kernel_means_backward_atol``), raising on a miss. A reading is N
   chained iterations captured in one CUDA graph (JAX's one-jit
   ``lax.scan``), each perturbing the scores by 1e-6 times its own draw
   (and, with the grad, by 1e-6 times the gradient), replayed between
   CUDA events; the median of the repeats. Each row carries the bound:
   the least time the card could take for the forward, and for the
   forward and the backward (the larger of bytes over 3.35 TB/s and
   operations over the fp32 and special-function rates, H100 SXM data
   sheet): ``kernel_means_bound_ms`` and ``kernel_means_backward_bound_ms``,
   which ``chip_smoke.py`` uses too.

2. **Full train step**: the CIFAR SNGAN with ``use_fused_kernel`` on and
   off for rep, rmb and rmb_gp at B in {64, 256}, graphed K=16 windows
   (``tools/scaling_study.py``'s ``setup`` and ``timed``), 512 steps a
   reading. One steps/s reading of this step is bimodal (near 206 or
   about 5% higher, whatever K), so on and off are read in turns (on, off,
   off, on, ...), each at least twice, and every reading is printed.

Prints JAX's two Markdown tables (its ``pallas`` columns are the port's
``kernel``), the microbench with the bounds beside it.
``--device cpu`` runs both on the CPU by the host clock, where the
kernel's wrapper takes the plain version: a check of the code, no
measurement of the card.

    python -m mmdgan_torch.tools.kernel_study [--steps 512] [--micro-iters 512]
"""

from __future__ import annotations

import argparse
import gc
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from mmdgan_torch import resolve_device
from mmdgan_torch.ops import cuda_mmd

MICRO_SHAPES = [(64, 16), (64, 256), (256, 16), (256, 256)]
STEP_LOSSES, STEP_BATCHES = ("rep", "rmb", "rmb_gp"), (64, 256)
STEPS, MICRO_ITERS, REPEAT, SCAN_K, TURNS = 512, 512, 5, 16, 2
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)
# d(scalar)/d(means) of JAX's scalar
SCALAR_CT = (1.0, -2.0, 1.0, 0.1, -0.1, 0.1)
# H100 SXM data sheet: HBM bandwidth, fp32 rate outside the tensor cores.
# Exponentials run on the special-function units, which issue 16 results
# per SM per clock against 128 fp32 FMAs (256 flops): the fp32 rate / 16
# (CUDA C++ Programming Guide, arithmetic instruction throughput, 9.0)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_SFU_PER_S = PEAK_FP32_PER_S / 16
MICRO_TABLE = ("| B | d | fwd ref | fwd kernel | fwd+grad ref | fwd+grad kernel | "
               "fwd bound | fwd+grad bound |\n"
               "|---|---|---------|------------|--------------|-----------------|"
               "-----------|----------------|")
STEP_TABLE = "| loss | batch | ref | kernel | delta |\n|------|-------|-----|--------|-------|"


def _bound(times: Dict[str, float]) -> tuple:
    by = max(times, key=times.get)
    return times[by] * 1e3, ("bytes" if by == "bytes" else "operations"), by


def kernel_means_bound_ms(b: int, d: int) -> tuple:
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


def kernel_means_backward_bound_ms(b: int, d: int) -> tuple:
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


def scalar(means: torch.Tensor) -> torch.Tensor:
    """JAX's study scalar (``tools/pallas_study.py:48-50``)."""
    return means[0] - 2.0 * means[1] + means[2] + 0.1 * (means[3] - means[4] + means[5])


def means_fn(fused: bool) -> Callable:
    return cuda_mmd.fused_kernel_means if fused else cuda_mmd.kernel_means_reference


def scores(b: int, d: int, device) -> tuple:
    """JAX's inputs: ``RandomState(0)``'s [B, d] gen and data scores."""
    rng = np.random.RandomState(0)
    return tuple(torch.tensor(rng.randn(b, d).astype(np.float32), device=device)
                 for _ in range(2))


def value_and_grad(fused: bool, sg: torch.Tensor, sx: torch.Tensor) -> tuple:
    a = sg.detach().requires_grad_(True)
    v = scalar(means_fn(fused)(a, sx, 1.0))
    return v.detach(), torch.autograd.grad(v, a)[0]


def gate(b: int, d: int, device) -> float:
    """The scalar and its gradient by the scores, kernel against plain, at
    (b, d); raises on a miss. Returns the largest gradient difference."""
    sg, sx = scores(b, d, device)
    v_k, g_k = value_and_grad(True, sg, sx)
    v_p, g_p = value_and_grad(False, sg, sx)
    ct = torch.tensor(SCALAR_CT, dtype=torch.float32, device=device)
    atol = cuda_mmd.kernel_means_backward_atol(sg, sx, ct, 1.0)[0]
    val_err = float((v_k - v_p).abs())
    grad_err = float((g_k - g_p).abs().max())
    if not (val_err <= VAL_TOL["atol"] + VAL_TOL["rtol"] * float(v_p.abs())
            and bool(((g_k - g_p).abs() <= GRAD_TOL["atol"] + atol
                      + GRAD_TOL["rtol"] * g_p.abs()).all())):
        raise RuntimeError(f"kernel study ({b}, {d}): kernel against plain, value |err| "
                           f"{val_err:.3e}, gradient max |err| {grad_err:.3e}")
    return grad_err


def micro_bench(b: int, d: int, n_iter: int, with_grad: bool, fused: bool, device,
                repeats: int = REPEAT) -> float:
    """Seconds per iteration of the scalar (and its gradient): ``n_iter``
    chained iterations in one captured CUDA graph on the card (a host loop
    on the CPU), the median of ``repeats`` timed replays."""
    sg, sx = scores(b, d, device)
    xs = torch.tensor(np.random.RandomState(0).randn(n_iter).astype(np.float32), device=device)
    acc = torch.zeros((), device=device)
    fn = means_fn(fused)

    def iteration(i: int):
        sg.add_(xs[i], alpha=1e-6)   # a new input each iteration, as JAX's scan
        if with_grad:
            v, g = value_and_grad(fused, sg, sx)
            sg.add_(g, alpha=1e-6)
        else:
            with torch.no_grad():
                v = scalar(fn(sg, sx, 1.0))
        acc.add_(v)

    def run():
        for i in range(n_iter):
            iteration(i)

    if sg.device.type != "cuda":
        readings = []
        for _ in range(repeats):
            start = time.perf_counter()
            run()
            float(acc)
            readings.append(time.perf_counter() - start)
        return statistics.median(readings) / n_iter
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        iteration(0)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    readings = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / 1e3)
    if not torch.isfinite(acc):
        raise RuntimeError(f"kernel study ({b}, {d}): the chained scalar is not finite")
    return statistics.median(readings) / n_iter


def micro_row(b: int, d: int, n_iter: int, device, repeats: int = REPEAT) -> Dict:
    """One row, after ``gate``: us/iter of plain and kernel, forward and
    forward+grad, and the two bounds in us."""
    row = {"B": b, "d": d}
    for grad in (False, True):
        for fused in (False, True):
            key = f"{'fwd+grad' if grad else 'fwd'} {'kernel' if fused else 'ref'}"
            row[key] = micro_bench(b, d, n_iter, grad, fused, device, repeats) * 1e6
    fwd, fwd_by, _ = kernel_means_bound_ms(b, d)
    bwd, _, _ = kernel_means_backward_bound_ms(b, d)
    row["fwd bound"], row["fwd+grad bound"], row["bound_by"] = fwd * 1e3, (fwd + bwd) * 1e3, fwd_by
    return row


def format_micro(row: Dict) -> str:
    cells = [f"{row[k]:.3f}" for k in ("fwd ref", "fwd kernel", "fwd+grad ref", "fwd+grad kernel")]
    return (f"| {row['B']} | {row['d']} | {' | '.join(cells)} | {row['fwd bound']:.5f} | "
            f"{row['fwd+grad bound']:.5f} |")


def step_bench(loss: str, batch: int, fused: bool, steps: int = STEPS, scan_k: int = SCAN_K,
               device=None) -> float:
    """Steps/s of the full-width CIFAR step with ``use_fused_kernel=fused``
    in graphed K-step windows, a fresh state from seed 0."""
    from mmdgan_torch.tools import scaling_study

    step, ts, batches = scaling_study.setup("cifar", loss, batch, scan_k, device,
                                            use_fused_kernel=fused)
    ts, sps = scaling_study.timed(step, ts, batches, scan_k, steps)
    del step, ts, batches
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return sps


def step_readings(loss: str, batch: int, steps: int = STEPS, turns: int = TURNS,
                  device=None) -> Dict[bool, List[float]]:
    """{fused: [steps/s]}: on and off in turns (on, off, off, on, ...),
    ``turns`` readings each, every reading printed."""
    out = {True: [], False: []}
    for t in range(turns):
        for fused in ((True, False) if t % 2 == 0 else (False, True)):
            sps = step_bench(loss, batch, fused, steps, device=device)
            out[fused].append(sps)
            print(f"[kernel_study] {loss} b{batch} use_fused_kernel={fused}: {sps:.2f} steps/s",
                  file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--micro-iters", type=int, default=MICRO_ITERS)
    ap.add_argument("--repeat", type=int, default=REPEAT)
    ap.add_argument("--turns", type=int, default=TURNS, help="readings of on and of off")
    ap.add_argument("--skip-step-bench", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({card})\n")

    print("## Kernel microbench (us/iter, graph-chained, lower is better; bounds in us)\n")
    print(MICRO_TABLE)
    for b, d in MICRO_SHAPES:
        gate(b, d, dev)
        print(format_micro(micro_row(b, d, args.micro_iters, dev, args.repeat)), flush=True)

    if args.skip_step_bench:
        return 0
    print("\n## Full CIFAR train step (steps/s, higher is better; the mean of the "
          "readings in turns)\n")
    print(STEP_TABLE)
    for loss in STEP_LOSSES:
        for batch in STEP_BATCHES:
            r = step_readings(loss, batch, args.steps, args.turns, dev)
            ref, ker = np.mean(r[False]), np.mean(r[True])
            print(f"| {loss} | {batch} | {ref:.1f} | {ker:.1f} | {(ker / ref - 1) * 100:+.1f}% |",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
