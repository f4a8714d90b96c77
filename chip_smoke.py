#!/usr/bin/env python3
"""Drive the PyTorch port (``mmdgan_torch``) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile every CUDA kernel of the main path from ``mmdgan_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   then timed beside it: the forward's means (rtol 1e-5 / atol 1e-6) and
   the backward's gradients (rtol 1e-4, atol 1e-8 plus the mask-rounding
   term of ``kernel_means_backward_atol``) at (64, 16), (23, 5) and
   (256, 16) and on a saturated input whose raw gen-gen distances go
   below 0, two launches of each bitwise equal, and the autograd path of
   ``fused_kernel_means`` against autograd of the plain means;
4. reference: a narrow float32 model, three steps on the card (kernel path)
   against the same three steps on the CPU (plain path), TF32 off;
5. main path: the full-width CIFAR-10 SNGAN at batch 64, bf16, for the
   'rep' and 'rmb' losses, through ``build_multi_step``; finite metrics,
   parameters, SN vectors and BN statistics changed, one forward and two
   backward kernel launches per step (the step's two ``autograd.grad``
   calls); steps/s, and a profiler window of the 'rep' path;
6. determinism: the 'rmb' main path twice more with deterministic
   algorithms, whose end states must be bitwise equal.

The line before the last two is a JSON object of the kernels, the next
the nvidia-smi line, the last ``{"ok": true, "device": {...}}``. Without a
GPU, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mmdgan_torch.architectures import cifar_architecture  # noqa: E402
from mmdgan_torch.models.sngan import SNGan  # noqa: E402
from mmdgan_torch.ops import _build, cuda_mmd  # noqa: E402
from mmdgan_torch.train.optim import multi_opt_config  # noqa: E402
from mmdgan_torch.train.state import tree_leaves  # noqa: E402
from mmdgan_torch.train.step import (  # noqa: E402
    build_multi_step,
    build_train_step,
    init_train_state,
)

BATCH, SCAN_K = 64, 16              # bench.py's cifar line
WARMUP_CALLS, MEASURE_CALLS = 2, 8
KERNEL_SHAPES = [(64, 16), (23, 5), (256, 16)]
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)
# H100 SXM data sheet: HBM bandwidth, fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# exponentials run on the special-function units, which issue 16 results
# per SM per clock against 128 fp32 FMAs (256 flops): the fp32 rate / 16
# (CUDA C++ Programming Guide, arithmetic instruction throughput, 9.0)
PEAK_SFU_PER_S = PEAK_FP32_PER_S / 16


def log(msg: str) -> None:
    print(msg, flush=True)


def scores(b: int, d: int, seed: int, device) -> tuple:
    """Score pairs whose distances straddle both rmb bounds."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        scale = rng.uniform(0.05, 0.5, (b, 1)) * np.sqrt(16.0 / d)
        out.append(torch.tensor((rng.randn(b, d) * scale).astype(np.float32), device=device))
    return tuple(out)


def saturated_scores(b: int, d: int, seed: int, device) -> tuple:
    """The saturated regime (e_kxx near 1): gen rows that are one row plus
    noise at 1e-4 of its scale, whose raw distances sit at 0 up to rounding
    and many come out negative; data rows as in ``scores``."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1, d) * 0.25
    sg = (base + 2.5e-5 * rng.randn(b, d)).astype(np.float32)
    sx = (rng.randn(b, d) * rng.uniform(0.05, 0.5, (b, 1))).astype(np.float32)
    return torch.tensor(sg, device=device), torch.tensor(sx, device=device)


def cotangents(device) -> dict:
    """d(loss)/d(means) of the step's losses (repulsive weights (0, -1)) and
    a random one."""
    return {name: torch.tensor(np.asarray(ct, np.float32), device=device) for name, ct in (
        ("random", np.random.RandomState(3).randn(6)),
        ("loss_gen", [1, -2, 1, 0, 0, 0]),
        ("rep_loss_dis", [-1, 0, 1, 0, 0, 0]),
        ("rmb_loss_dis", [0, 0, 0, -1, 0, 1]))}


def assert_grads_close(got, want, atols, what: str) -> float:
    """rtol 1e-4 / atol 1e-8, plus the mask-rounding term of
    ``kernel_means_backward_atol``; returns the largest |got - want|."""
    err = 0.0
    for name, g, w, extra in zip(("g_gen", "g_x"), got, want, atols):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + extra, err_msg=f"{what}: {name}")
        err = max(err, float((g - w).abs().max()))
    return err


def cuda_ms(fn, calls: int, warmup: int = 20) -> float:
    """Milliseconds per call between CUDA events around ``calls`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(fn, per_graph: int = 100, replays: int = 20) -> float:
    """Device milliseconds per call with the host taken out: ``per_graph``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()   # warm the allocator outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, replays, warmup=2) / per_graph


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
    times = {"bytes": (2 * b * d * 4 + 6 * 4) / PEAK_BYTES_PER_S,
             "fp32": flops / PEAK_FP32_PER_S,
             "special-function": entries / PEAK_SFU_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, ("bytes" if by == "bytes" else "operations"), by


def kernel_means_backward_bound_ms(b: int, d: int) -> tuple:
    """(bound in ms, 'bytes' or 'operations', the pipe that bounds it) for
    the gradient of the six means. Bytes: both inputs and the [6] cotangent
    read once, both [B, d] gradients written once. Entries as in
    ``kernel_means_bound_ms``, each computed once (the kernel's row owners
    compute a symmetric entry twice; the function needs it once): 2d flops
    of Gram product, 3 of distance, one exponential, 3 to form the
    coefficient (select the bounded part, scale, multiply by k), and 2 * 2d
    to accumulate it into both endpoint rows; 2 flops per score element
    for the squared norms."""
    half = b * (b - 1) // 2
    entries = 2 * half + b * b
    flops = entries * (6 * d + 6) + 2 * 2 * b * d
    times = {"bytes": ((2 * b * d + 6) * 4 + 2 * b * d * 4) / PEAK_BYTES_PER_S,
             "fp32": flops / PEAK_FP32_PER_S,
             "special-function": entries / PEAK_SFU_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, ("bytes" if by == "bytes" else "operations"), by


def check_kernel_means(dev) -> dict:
    """Phase 3: the CUDA kernel against its plain version, then timed."""
    max_err = 0.0
    for i, (b, d) in enumerate(KERNEL_SHAPES):
        sg, sx = scores(b, d, seed=i, device=dev)
        got = cuda_mmd.kernel_means_cuda(sg, sx, 1.0)
        again = cuda_mmd.kernel_means_cuda(sg, sx, 1.0)
        want = cuda_mmd.kernel_means_reference(sg, sx, 1.0)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **VAL_TOL,
                                   err_msg=f"kernel means at {(b, d)}")
        assert torch.equal(got, again), f"kernel means not deterministic at {(b, d)}"
        max_err = max(max_err, float((got - want).abs().max()))

        log(f"[kernels] kernel_means {(b, d)}: max |kernel - plain| = "
            f"{float((got - want).abs().max()):.3e}, deterministic")

    b, d = BATCH, 16
    sg, sx = scores(b, d, seed=0, device=dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: cuda_mmd.kernel_means_cuda(sg, sx, 1.0), 2000)
        plain_ms = cuda_ms(lambda: cuda_mmd.kernel_means_reference(sg, sx, 1.0), 2000)
        device_ms = graph_ms(lambda: cuda_mmd.kernel_means_cuda(sg, sx, 1.0))
        plain_device_ms = graph_ms(lambda: cuda_mmd.kernel_means_reference(sg, sx, 1.0))
    bound, bound_by, pipe = kernel_means_bound_ms(b, d)
    log(f"[kernels] kernel_means at ({b}, {d}): {ms:.5f} ms/call "
        f"({device_ms:.5f} ms on the device from a CUDA graph), plain {plain_ms:.5f} ms/call "
        f"({plain_device_ms:.5f} ms from a graph), bound {bound:.3e} ms ({pipe}); "
        "no single PyTorch call computes these six means, so no library yardstick")
    return {"name": "kernel_means", "route": "cuda",
            "source": "mmdgan_torch/csrc/kernel_means.cu",
            "replaces": "mmdgan_tpu/ops/pallas_mmd.py:50",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms}


def check_kernel_means_backward(dev) -> dict:
    """Phase 3: the backward kernel against its plain version (the closed
    form) on ordinary scores at the three shapes and on one saturated input
    at the main path's shape, for each cotangent; two launches bitwise
    equal; the autograd path of ``fused_kernel_means`` (both kernels)
    against autograd of the plain means; then timed."""
    max_err = 0.0
    inputs = [(f"{(b, d)}", scores(b, d, seed=i, device=dev))
              for i, (b, d) in enumerate(KERNEL_SHAPES)]
    inputs.append((f"saturated {(BATCH, 16)}", saturated_scores(BATCH, 16, seed=5, device=dev)))
    cts = cotangents(dev)
    for what, (sg, sx) in inputs:
        for name, ct in cts.items():
            got = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
            again = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
            want = cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0)
            torch.cuda.synchronize()
            atols = cuda_mmd.kernel_means_backward_atol(sg, sx, ct, 1.0)
            err = assert_grads_close(got, want, atols, f"backward {what} ct={name}")
            max_err = max(max_err, err)
            assert all(torch.equal(g, h) for g, h in zip(got, again)), (
                f"backward kernel not deterministic at {what} ct={name}")

        ct = cts["random"]
        a, c = sg.clone().requires_grad_(True), sx.clone().requires_grad_(True)
        g_fused = torch.autograd.grad(cuda_mmd.fused_kernel_means(a, c, 1.0), (a, c), ct)
        g_plain = torch.autograd.grad(cuda_mmd.kernel_means_reference(a, c, 1.0), (a, c), ct)
        atols = cuda_mmd.kernel_means_backward_atol(sg, sx, ct)
        assert_grads_close(g_fused, g_plain, atols, f"fused_kernel_means autograd at {what}")
        negative = int((cuda_mmd.raw_distances(sg, sx)[0] < 0).sum())
        log(f"[kernels] kernel_means_backward {what}: {len(cts)} cotangents agree with the "
            f"closed form, deterministic; fused autograd agrees with autograd of the plain "
            f"means (mask-rounding atol {atols[0]:.2e} / {atols[1]:.2e} for the random "
            f"cotangent); {negative} raw gen-gen distances below 0")

    b, d = BATCH, 16
    sg, sx = scores(b, d, seed=0, device=dev)
    ct = cts["loss_gen"]
    a, c = sg.clone().requires_grad_(True), sx.clone().requires_grad_(True)
    ms = cuda_ms(lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0), 2000)
    plain_ms = cuda_ms(lambda: cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0), 2000)
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(
        cuda_mmd.kernel_means_reference(a, c, 1.0), (a, c), ct), 500)
    device_ms = graph_ms(lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0))
    plain_device_ms = graph_ms(lambda: cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0))
    bound, bound_by, pipe = kernel_means_backward_bound_ms(b, d)
    log(f"[kernels] kernel_means_backward at ({b}, {d}): {ms:.5f} ms/call "
        f"({device_ms:.5f} ms on the device from a CUDA graph), plain closed form "
        f"{plain_ms:.5f} ms/call ({plain_device_ms:.5f} ms from a graph), autograd of the plain "
        f"means {autograd_ms:.5f} ms/call, bound {bound:.3e} ms ({pipe}); no single PyTorch "
        "call computes this gradient, so no library yardstick")
    return {"name": "kernel_means_backward", "route": "cuda",
            "source": "mmdgan_torch/csrc/kernel_means.cu",
            "replaces": "mmdgan_tpu/ops/pallas_mmd.py:166",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms}


def narrow_architecture() -> dict:
    """cifar_architecture() at 1/8 of the hidden channels (32x32, d=16)."""
    arch = copy.deepcopy(cifar_architecture())
    for layer in arch["generator"][1:-1] + arch["discriminator"][:-1]:
        layer["out"] //= 8
    arch["generator"][0].update(out=64 * 4 * 4, out_reshape=[64, 4, 4])
    arch["discriminator"][-2]["out_reshape"] = [4 * 4 * 64]
    return arch


def check_against_cpu(dev) -> None:
    """Phase 4: three float32 steps of a narrow model on the card (the
    kernel path) and on the CPU (the plain path) from the same init, data
    and z. TF32 off on both conv and matmul, so the two differ only in
    summation order: rtol 1e-3 / atol 1e-5 on every step metric, the
    score means taken as s_x_mean - s_gen_mean."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(7)
        x = rng.randn(3, 8, 32, 32, 3).clip(-1, 1).astype(np.float32)
        z = rng.randn(3, 8, 128).astype(np.float32)
        runs = {}
        for device in ("cpu", dev):
            model = SNGan(narrow_architecture(), loss_type="rmb",
                          compute_dtype=torch.float32, device=device)
            opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
            ts = init_train_state(model, 0, opt_d, opt_g, device=device)
            one = build_train_step(model, opt_d, opt_g, device=device)
            metrics = []
            for k in range(3):
                ts, m = one(ts, {"x": x[k]}, code_batch={"x": z[k]})
                metrics.append({key: v.item() for key, v in m.items()})
            runs[str(device)] = metrics
        for k, (mc, mg) in enumerate(zip(runs["cpu"], runs[str(dev)])):
            # the score layer's bias has no true gradient (a common shift
            # of all scores leaves every distance unchanged), so Adam moves
            # it by rounding noise that differs between devices; compare
            # the score means only through their shift-free difference
            for m in (mc, mg):
                m["s_x_mean"] -= m.pop("s_gen_mean")
            for key in mc:
                np.testing.assert_allclose(mg[key], mc[key], rtol=1e-3, atol=1e-5,
                                           err_msg=f"step {k} {key}, card vs CPU")
        last = runs[str(dev)][-1]
        log(f"[reference] narrow f32 rmb, 3 steps card vs CPU agree: step 2 loss_gen "
            f"{last['loss_gen']:.6f} e_kxx {last['e_kxx']:.6f}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def main_path_setup(dev, loss_type: str) -> tuple:
    """The full-width model at bf16, its train state from seed 0, the
    K-step driver and one K-stacked batch of noise from seed 0."""
    model = SNGan(cifar_architecture(), loss_type=loss_type)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g)
    multi = build_multi_step(model, opt_d, opt_g, SCAN_K)
    rng = np.random.RandomState(0)
    batches = {"x": torch.tensor(
        rng.randn(SCAN_K, BATCH, 32, 32, 3).astype(np.float32).clip(-1, 1), device=dev)}
    return model, ts, multi, batches


def run_main_path(dev, loss_type: str, card: str, profile: bool) -> tuple:
    """Phase 5 for one loss; returns the forward and backward kernel
    launches of the run and the last step's e_kxx."""
    model, ts, multi, batches = main_path_setup(dev, loss_type)
    params0 = [p.detach().clone() for p in tree_leaves(ts.params)]
    state0 = [v.clone() for v in tree_leaves(ts.net_state)]
    torch.cuda.reset_peak_memory_stats(dev)

    forward, backward = cuda_mmd.kernel_means_cuda, cuda_mmd.kernel_means_backward_cuda
    forward.launches = backward.launches = 0
    for _ in range(WARMUP_CALLS):
        ts, m = multi(ts, batches)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(MEASURE_CALLS):
        ts, m = multi(ts, batches)
    torch.cuda.synchronize()
    dur = time.perf_counter() - start
    launches = (forward.launches, backward.launches)
    steps = (WARMUP_CALLS + MEASURE_CALLS) * SCAN_K
    assert launches == (steps, 2 * steps), (
        f"{loss_type}: {launches} forward and backward kernel launches for {steps} steps")

    for k, v in m.items():
        assert torch.isfinite(v).all(), f"{loss_type}: non-finite {k}"
    for what, before, tree in (("parameter", params0, ts.params),
                               ("SN/BN state", state0, ts.net_state)):
        same = sum(torch.equal(a, b) for a, b in zip(before, tree_leaves(tree)))
        assert same == 0, f"{loss_type}: {same} {what} tensors unchanged"
    images = model.generate(ts.params, ts.net_state, torch.Generator(dev).manual_seed(0), 8)
    assert images.shape == (8, 32, 32, 3) and torch.isfinite(images).all()

    steps_per_s = MEASURE_CALLS * SCAN_K / dur
    e_kxx = float(m["e_kxx"][-1])
    log(f"[main] cifar10 sngan {loss_type} b{BATCH} bf16: {steps_per_s:.2f} steps/s "
        f"({MEASURE_CALLS * SCAN_K} steps after {WARMUP_CALLS * SCAN_K} warm-up), "
        f"loss_gen={float(m['loss_gen'][-1]):.5f} e_kxx={e_kxx:.5f}, "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB, "
        f"kernel launches {launches[0]} forward and {launches[1]} backward for {steps} steps; "
        f"card: {card}")
    if profile:
        _profile(multi, ts, batches, 1e3 / steps_per_s)
    return launches, e_kxx


def check_determinism(dev, default_e_kxx: float) -> None:
    """Phase 6: the 'rmb' main path's 160 steps twice more, with
    ``torch.use_deterministic_algorithms`` and deterministic cuDNN
    algorithms. The two end states (parameters, SN vectors, BN statistics,
    last metrics) must be bitwise equal, which shows the same code on the
    same seeds is reproducible once the algorithms are; the default run's
    e_kxx is printed beside theirs."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ends = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                _, ts, multi, batches = main_path_setup(dev, "rmb")
                for _ in range(WARMUP_CALLS + MEASURE_CALLS):
                    ts, m = multi(ts, batches)
                ends.append((tree_leaves(ts.params) + tree_leaves(ts.net_state), m))
        torch.cuda.synchronize()
        for msg in sorted({str(w.message)[:160] for w in caught}):
            log(f"[determinism] warning: {msg}")
        (leaves_a, m_a), (leaves_b, m_b) = ends
        differ = sum(not torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))
        differ += sum(not torch.equal(m_a[k], m_b[k]) for k in m_a)
        assert differ == 0, f"determinism: {differ} tensors differ between two deterministic runs"
        log(f"[determinism] rmb b{BATCH} bf16, {(WARMUP_CALLS + MEASURE_CALLS) * SCAN_K} steps "
            f"twice with deterministic algorithms: end states bitwise equal, e_kxx "
            f"{float(m_a['e_kxx'][-1]):.5f}; the default-algorithm run above ended at "
            f"e_kxx {default_e_kxx:.5f}")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _profile(multi, ts, batches, step_ms: float) -> None:
    """One call (SCAN_K steps) under torch.profiler: device busy time per
    step, its share of the untraced step time ``step_ms`` (the traced wall
    time includes the profiler's own cost), the kernel-means kernels'
    device time and launches per step (one forward, two backward), and the
    kernels taking most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        multi(ts, batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("[profile] the profiler recorded no device activity: not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / SCAN_K
    log(f"[profile] rep: device busy {busy:.4f} ms/step of {step_ms:.4f} ms/step untraced "
        f"(idle {100 * (1 - busy / step_ms):.1f}%); traced wall {wall_ms / SCAN_K:.4f} "
        f"ms/step; {len(kernels) / SCAN_K:.0f} device activities per step")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    for kernel, per_step in (("kernel_means_fwd", 1), ("kernel_means_bwd", 2)):
        mine = [e for e in kernels if kernel in e.name]
        ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3 / SCAN_K
        log(f"[profile]   kernel means: {kernel} {ms:.5f} ms/step on the device, "
            f"{len(mine) / SCAN_K:g} launches/step")
        assert len(mine) == per_step * SCAN_K, f"{kernel}: {len(mine)} launches in {SCAN_K} steps"
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {t / SCAN_K:8.4f} ms/step  {name[:100]}")


def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace, chosen before
    # its first call (phase 6)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 Gram products, as the reference
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")

    existed = _build.library_path(cuda_mmd.SOURCE).exists()
    start = time.perf_counter()
    _build.build(cuda_mmd.SOURCE)
    cuda_mmd._library()
    log(f"[build] {cuda_mmd.SOURCE}: {time.perf_counter() - start:.2f} s "
        f"({'loaded from build/' if existed else 'nvcc sm_90a'})")

    kernels = [check_kernel_means(dev), check_kernel_means_backward(dev)]
    check_against_cpu(dev)
    runs = {loss: run_main_path(dev, loss, card, profile=(loss == "rep"))
            for loss in ("rep", "rmb")}
    for i, kernel in enumerate(kernels):
        kernel["launches"] = sum(launches[i] for launches, _ in runs.values())
    check_determinism(dev, runs["rmb"][1])

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
