"""Card preflight: is the GPU reachable, and how fast is the path to it? The
counterpart of ``tools/preflight.py``.

Prints one JSON line: the device's identity, the seconds to bring it up
(``init_s``), the host time per tiny launch (``dispatch_ms``), the bf16
matmul rate (``matmul_tflops``) and the host<->device bandwidth, from
pageable host memory (``h2d_gbps``, ``d2h_gbps``, what JAX's tool
measures) and from pinned memory (``h2d_pinned_gbps``,
``d2h_pinned_gbps``; null on the CPU). Run it before long training or
benchmarking: a card that hangs at start-up or a degraded link corrupts
every timing taken after it. The probe runs in a subprocess with
``--timeout`` as its deadline, so the tool itself never hangs.

    python -m mmdgan_torch.tools.preflight [--timeout 120] [--mb 32] [--device cuda]

Exit code 0 when healthy; 1, with ``"healthy": false`` and the error, when
the probe hangs, fails or finds no device. ``--device cuda`` (the default)
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gbps(mb: int, seconds: float) -> float:
    return mb / 1024 / max(seconds, 1e-12)


def probe(device: str, mb: int, matmul_n: int, matmul_inner: int) -> dict:
    """The measurements, in this process, on ``device``."""
    import numpy as np
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: torch.cuda.is_available() is false")

    def fence():
        if cuda:
            torch.cuda.synchronize(dev)

    start = time.perf_counter()
    torch.zeros((), device=dev).add_(1)    # the CUDA context and the first launch
    fence()
    out = {"platform": "gpu" if cuda else "cpu",
           "device": f"{dev} ({torch.cuda.get_device_name(dev)})" if cuda else str(dev),
           "n_devices": torch.cuda.device_count() if cuda else 1,
           "init_s": time.perf_counter() - start}

    # dispatch latency: a tiny op, fenced
    x = torch.zeros((), device=dev)
    float(x + 1.0)
    start = time.perf_counter()
    for _ in range(10):
        x = x + 1.0
    fence()
    out["dispatch_ms"] = (time.perf_counter() - start) / 10 * 1e3

    # compute: bf16 matmul chains of two lengths, timed and differenced, so
    # the per-chain launch and fence latency cancels (tools/preflight.py:47-63)
    n, inner = matmul_n, matmul_inner
    i1 = max(inner // 8, 1)
    a = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)

    def chain(k):
        def run():
            y = a
            for _ in range(k):
                y = torch.tanh(torch.matmul(y, y))
            return float(y[0, 0])
        run()   # warm
        fence()
        start = time.perf_counter()
        run()
        return time.perf_counter() - start

    d_small, d_big = chain(i1), chain(inner)
    out["matmul_tflops"] = (inner - i1) * 2 * n ** 3 / max(d_big - d_small, 1e-9) / 1e12

    # link bandwidth both ways, pageable then pinned host memory; one
    # warm-up copy each, then a timed one
    nbytes = mb << 20
    host = np.zeros((nbytes,), np.uint8)
    src = torch.from_numpy(host)
    for _ in range(2):
        start = time.perf_counter()
        d = src.to(dev, copy=True)
        int(d[0])              # a one-byte read orders after the copy
        h2d = time.perf_counter() - start
    out["h2d_gbps"] = _gbps(mb, h2d)
    for _ in range(2):
        fence()
        start = time.perf_counter()
        d.cpu() if cuda else d.clone()
        d2h = time.perf_counter() - start
    out["d2h_gbps"] = _gbps(mb, d2h)
    out["h2d_pinned_gbps"] = out["d2h_pinned_gbps"] = None
    if cuda:
        pinned = torch.zeros((nbytes,), dtype=torch.uint8, pin_memory=True)
        for _ in range(2):
            fence()
            start = time.perf_counter()
            d.copy_(pinned, non_blocking=True)
            fence()
            h2d = time.perf_counter() - start
        for _ in range(2):
            fence()
            start = time.perf_counter()
            pinned.copy_(d, non_blocking=True)
            fence()
            d2h = time.perf_counter() - start
        out["h2d_pinned_gbps"], out["d2h_pinned_gbps"] = _gbps(mb, h2d), _gbps(mb, d2h)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--timeout", type=float, default=120.0,
                   help="deadline for the whole probe, in seconds (a card that is down "
                        "hangs at start-up)")
    p.add_argument("--mb", type=int, default=32, help="transfer size of the bandwidth probe, MiB")
    p.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    p.add_argument("--matmul-n", type=int, default=4096,
                   help="matmul probe matrix size (drop to ~512 on the CPU: bf16 is slow there)")
    p.add_argument("--matmul-inner", type=int, default=64,
                   help="long-chain length of the differenced matmul timing")
    p.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.probe:   # the child: measure and print
        print("PREFLIGHT " + json.dumps(probe(args.device, args.mb, args.matmul_n,
                                              args.matmul_inner)), flush=True)
        return 0

    start = time.time()
    cmd = [sys.executable, "-m", "mmdgan_torch.tools.preflight", "--probe",
           "--device", args.device, "--mb", str(args.mb), "--matmul-n", str(args.matmul_n),
           "--matmul-inner", str(args.matmul_inner)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                              cwd=REPO)
    except subprocess.TimeoutExpired:
        print(json.dumps({"healthy": False,
                          "error": f"device probe hung > {args.timeout} s"}))
        return 1
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PREFLIGHT ")]
    if proc.returncode != 0 or not line:
        print(json.dumps({"healthy": False, "error": (proc.stderr or proc.stdout)[-400:]}))
        return 1
    out = json.loads(line[0][len("PREFLIGHT "):])
    out["healthy"] = True
    out["probe_s"] = time.time() - start
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
