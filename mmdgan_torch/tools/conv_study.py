"""Conv study on the card: the counterpart of ``tools/conv_study.py``.

Can another exact formulation of the 64x64 discriminator's hot convs
(``_arch_64``, celeba/lsun) beat the port's direct convolution, and does
the memory layout matter? Four formulations of each shape, each gated
first (float32, TF32 off in cuDNN and cuBLAS, within 1e-5 relative of
``direct``; a variant that misses raises), then timed forward and
forward+backward at bf16, batch 64, in the port's NCHW and in
``channels_last``:

- ``direct``: ``ops/conv.py`` ``Geometry.forward``, what ``models/ops.py``
  runs (one cuDNN call);
- ``s2d``: space-to-depth(2) and a 2x2/s1 VALID conv, exact for the
  4x4/s2 SAME convs (the kernel's taps regrouped per 2x2 input phase);
- ``im2col``: ``F.unfold`` and one matmul;
- ``pad8``: the 3-channel first conv with the image and the kernel's input
  channels zero-padded to 8.

JAX's study ran NHWC only; on this card the layout is the open question,
so each layout gets its own table, speedups against ``direct`` in the
same layout. A reading is ``INNER`` calls captured in one CUDA graph,
replayed ``REPEAT`` times, each replay timed by CUDA events, the median
taken: the counterpart of JAX's INNER chained ops in one jit. A CUDA
graph neither merges nor drops calls, so no data dependence is chained
through them. ``--device cpu`` runs the same on the CPU by the host
clock (a check of the code, no measurement of the card).

    python -m mmdgan_torch.tools.conv_study [--shapes l1_f64,l2_ds] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import resolve_device
from mmdgan_torch.ops.conv import Geometry

B = 64
INNER = 200
REPEAT = 7
COMPUTE_DTYPE = torch.bfloat16
GATE = 1e-5
LAYOUTS = ("nchw", "channels_last")

# (name, H, W, Cin, Cout, kernel, stride): the celeba/lsun discriminator's
# hot shapes (``experiments/architectures.py::_arch_64``)
SHAPES = [
    ("l1_f64 3x3/s1 3->64", 64, 64, 3, 64, 3, 1),
    ("l2_ds 4x4/s2 64->128", 64, 64, 64, 128, 4, 2),
    ("l3   3x3/s1 128->128", 32, 32, 128, 128, 3, 1),
    ("l4_ds 4x4/s2 128->256", 32, 32, 128, 256, 4, 2),
    ("l5   3x3/s1 256->256", 16, 16, 256, 256, 3, 1),
    ("l6_ds 4x4/s2 256->512", 16, 16, 256, 512, 4, 2),
    ("l7   3x3/s1 512->512", 8, 8, 512, 512, 3, 1),
    ("l8_ds 4x4/s2 512->1024", 8, 8, 512, 1024, 4, 2),
]
TABLE = ("| shape | variant | fwd us | fwd vs direct | fwd+bwd us | fwd+bwd vs direct |\n"
         "|---|---|---|---|---|---|")


def direct(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The port's conv (``w`` [out, in, k, k]), SAME as lax pads it."""
    return Geometry.make("c", x.shape[2:], w.shape[2], stride).forward(x, w)


def s2d(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Space-to-depth(2) + 2x2/s1 VALID conv == 4x4/s2 SAME conv, exactly.

    SAME pads (1, 1) on an even size, so output (i, j) reads input rows
    2i-1..2i+2, three 2x2 phase blocks; padding 1 on every side aligns the
    window to padded rows 2i..2i+3, blocks i and i+1. The op becomes a 2x2
    VALID conv over the 4C phase channels, (ph, pw, c) in order, with the
    taps regrouped as ``ws[o, (ph, pw, c), by, bx] = w[o, c, 2 by + ph,
    2 bx + pw]``."""
    n, c, h, wd = x.shape
    co, _, kh, kw = w.shape
    if not (stride == 2 and kh == kw == 4 and h % 2 == 0 and wd % 2 == 0):
        raise ValueError(f"s2d is exact for 4x4/s2 on even sizes, not {kh}x{kw}/s{stride}")
    xp = F.pad(x, (1, 1, 1, 1))
    h2, w2 = (h + 2) // 2, (wd + 2) // 2
    xs = xp.reshape(n, c, h2, 2, w2, 2).permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h2, w2)
    ws = w.reshape(co, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(co, 4 * c, 2, 2)
    return F.conv2d(xs, ws)


def im2col(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``F.unfold`` (patch channels in (c, kh, kw) order, as ``w`` flattens)
    and one matmul."""
    n, c, h, wd = x.shape
    co, _, k, _ = w.shape
    geo = Geometry.make("c", (h, wd), k, stride)
    (lh, hh), (lw, hw) = geo.pads
    patches = F.unfold(F.pad(x, (lw, hw, lh, hh)), k, stride=stride)   # [N, C k k, L]
    out = torch.matmul(w.reshape(co, c * k * k), patches)               # [N, Cout, L]
    return out.reshape(n, co, *geo.out_hw)


def pad8(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Zero-pad the 3-channel image, and the kernel's input channels, to 8."""
    return direct(F.pad(x, (0, 0, 0, 0, 0, 5)), F.pad(w, (0, 0, 0, 0, 0, 5)), stride)


def variants(cin: int, k: int, s: int) -> Dict[str, Callable]:
    out = {"direct": direct, "im2col": im2col}
    if k == 4 and s == 2:
        out["s2d"] = s2d
    if cin == 3:
        out["pad8"] = pad8
    return out


@contextlib.contextmanager
def tf32_off():
    """TF32 off in cuDNN and cuBLAS, both flags restored after
    (``metrics/graphdef.py``): an exactness gate in float32 compares
    summation orders, not TF32's ten-bit mantissa."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def to_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "channels_last":
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-12))


def gate(fns: Dict[str, Callable], args: tuple, tol: float, what: str) -> Dict[str, float]:
    """Each function of ``fns`` on the float32 ``args`` against the first
    (``direct``), TF32 off, in both layouts; raises on a relative error of
    ``tol`` or more. Returns the largest error of each variant."""
    worst = {}
    with tf32_off(), torch.no_grad():
        for layout in LAYOUTS:
            laid = [to_layout(a, layout) if torch.is_tensor(a) else a for a in args]
            outs = {name: fn(*laid) for name, fn in fns.items()}
            ref = outs.pop(next(iter(fns)))
            for name, out in outs.items():
                err = relative_error(out, ref)
                if not err < tol:
                    raise RuntimeError(f"{what} {name} ({layout}): relative error {err:.3e} "
                                       f"against direct, gate {tol}")
                worst[name] = max(worst.get(name, 0.0), err)
    return worst


def op_ms(fn: Callable, inner: int = INNER, repeat: int = REPEAT) -> float:
    """Median milliseconds per call of ``fn()``: ``repeat`` readings of
    ``inner`` calls. On CUDA the calls are captured in one graph after a
    warm-up call on a side stream (cuDNN's algorithm search stays out of
    the capture); each reading is one replay between CUDA events. On the
    CPU each reading is the host clock around ``inner`` calls."""
    probe = fn()
    if not probe.is_cuda:
        readings = []
        for _ in range(repeat):
            start = time.perf_counter()
            for _ in range(inner):
                fn()
            readings.append((time.perf_counter() - start) * 1e3)
        return statistics.median(readings) / inner
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    readings = []
    for _ in range(repeat):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end))
    del graph
    return statistics.median(readings) / inner


def fwd_bwd(fn: Callable, x: torch.Tensor, w: torch.Tensor, *rest) -> Callable:
    """One forward and the gradients of ``sum(out^2)`` by both inputs."""
    xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)

    def call():
        out = fn(xg, wg, *rest)
        return torch.autograd.grad(out.float().square().sum(), (xg, wg))[0]

    return call


def time_variants(calls: Dict[str, tuple], inner: int, repeat: int) -> Dict:
    """``calls``: {variant: (fn, args)}. Returns {variant: {fwd_us,
    fwdbwd_us, fwd_speedup, fwdbwd_speedup}}, the speedups against the
    first variant (``direct``), as JAX's rows."""
    res = {}
    for name, (fn, args) in calls.items():
        with torch.no_grad():
            t_f = op_ms(lambda fn=fn, args=args: fn(*args), inner, repeat)
        t_b = op_ms(fwd_bwd(fn, *args), inner, repeat)
        res[name] = (t_f, t_b)
    base_f, base_b = res[next(iter(calls))]
    return {name: {"fwd_us": t_f * 1e3, "fwdbwd_us": t_b * 1e3, "fwd_speedup": base_f / t_f,
                   "fwdbwd_speedup": base_b / t_b} for name, (t_f, t_b) in res.items()}


def shape_inputs(shape: tuple, device, batch: int = B) -> tuple:
    """One shape's float32 input [B, Cin, H, W] and kernel [Cout, Cin, k, k],
    ``RandomState(0)`` (the kernel scaled by 0.05), as JAX's study draws them."""
    _, h, wd, cin, cout, k, _ = shape
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(batch, cin, h, wd), dtype=torch.float32, device=device)
    w = torch.tensor(rng.randn(cout, cin, k, k) * 0.05, dtype=torch.float32, device=device)
    return x, w


def time_shape(shape: tuple, fns: Dict[str, Callable], x: torch.Tensor, w: torch.Tensor,
               inner: int = INNER, repeat: int = REPEAT) -> Dict[str, Dict]:
    """``{layout: {variant: timings}}`` of ``fns`` at bf16."""
    s = shape[6]
    out = {}
    for layout in LAYOUTS:
        args = (to_layout(x.to(COMPUTE_DTYPE), layout), to_layout(w.to(COMPUTE_DTYPE), layout), s)
        out[layout] = time_variants({n: (fn, args) for n, fn in fns.items()}, inner, repeat)
    return out


def study_shape(shape: tuple, device, batch: int = B, inner: int = INNER,
                repeat: int = REPEAT) -> Dict[str, Dict]:
    """One shape of ``SHAPES``: the gate, then ``time_shape``."""
    name, _, _, cin, _, k, s = shape
    x, w = shape_inputs(shape, device, batch)
    fns = variants(cin, k, s)
    errs = gate(fns, (x, w, s), GATE, name)
    print(f"[conv_study] {name}: exact ({', '.join(f'{v} {e:.1e}' for v, e in errs.items())} "
          f"relative, float32, both layouts)", file=sys.stderr, flush=True)
    return time_shape(shape, fns, x, w, inner, repeat)


def table_rows(name: str, res: Dict) -> List[str]:
    return [f"| {name} | {vn} | {v['fwd_us']:.2f} | x{v['fwd_speedup']:.3f} | "
            f"{v['fwdbwd_us']:.2f} | x{v['fwdbwd_speedup']:.3f} |" for vn, v in res.items()]


def select(shapes: List[tuple], names: str) -> List[tuple]:
    """The shapes whose names start with one of the comma-separated
    ``names`` (all of them for an empty string)."""
    if not names:
        return list(shapes)
    wanted = [n.strip() for n in names.split(",") if n.strip()]
    chosen = [sh for sh in shapes if any(sh[0].startswith(n) for n in wanted)]
    if not chosen:
        raise SystemExit(f"no shape starts with any of {wanted}")
    return chosen


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="", help="name prefixes, comma-separated (default all)")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--inner", type=int, default=INNER)
    p.add_argument("--repeat", type=int, default=REPEAT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# conv study: device={dev} ({card}) B={args.batch} INNER={args.inner} "
          f"REPEAT={args.repeat} dtype=bfloat16", flush=True)
    rows = {layout: [] for layout in LAYOUTS}
    for shape in select(SHAPES, args.shapes):
        res = study_shape(shape, dev, args.batch, args.inner, args.repeat)
        for layout in LAYOUTS:
            rows[layout] += table_rows(shape[0], res[layout])
            print(f"[conv_study] {shape[0]} {layout}: " + ", ".join(
                f"{vn} {v['fwd_us']:.2f}us x{v['fwd_speedup']:.3f} / {v['fwdbwd_us']:.2f}us "
                f"x{v['fwdbwd_speedup']:.3f}" for vn, v in res[layout].items()),
                file=sys.stderr, flush=True)
        cl, nchw = res["channels_last"]["direct"], res["nchw"]["direct"]
        print(f"[conv_study] {shape[0]} direct channels_last vs NCHW: fwd "
              f"x{nchw['fwd_us'] / cl['fwd_us']:.3f}, fwd+bwd "
              f"x{nchw['fwdbwd_us'] / cl['fwdbwd_us']:.3f}", file=sys.stderr, flush=True)
    for layout in LAYOUTS:
        print(f"\n## {layout}\n\n{TABLE}")
        print("\n".join(rows[layout]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
