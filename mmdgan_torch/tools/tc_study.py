"""Transposed-conv study on the card: the counterpart of ``tools/tc_study.py``.

Can the generator's ``tc`` 4x4/s2 SAME layers beat the direct route by an
exact periodic-shuffle formulation? ``F.conv_transpose2d`` may, like
``lax.conv_transpose`` on the TPU, spend work on the zeros of the
stride-dilated input. Output phase (p, q) in {0, 1}^2 is a 2x2/s1 conv of
the input with the parity-matched taps, and the four phases interleave
(depth-to-space). Variants, each gated first in float32 (TF32 off in
cuDNN and cuBLAS, within 2e-5 relative of ``direct``, in NCHW and in
``channels_last``; a variant that misses raises), then timed forward and
forward+backward at bf16, batch 64, in both layouts:

- ``direct``: ``ops/conv.py`` ``Geometry.forward``, what ``models/ops.py``
  runs below ``TC_PS3_MIN_SIZE`` (one ``F.conv_transpose2d``);
- ``ps2``: four 2x2/s1 phase convs and an interleave;
- ``ps3``: ``ops/conv.py`` ``ps3_conv``, one 3x3/s1 conv to 4*Cout
  channels (16 of its 36 taps per phase useful) and depth-to-space, the
  lowering ``models/ops.py`` runs at and above ``TC_PS3_MIN_SIZE``; timed
  on its kernel ``ps3_kernel(w)`` made once, as JAX's study times it
  (the gate runs ``conv_transpose_ps3``, the kernel's making included);
- ``grad``: the transposed conv as the VJP of the matching 4x4/s2 conv
  (``autograd.grad`` of ``F.conv2d`` by its input).

Readings as ``tools/conv_study.py`` takes them: ``INNER`` calls in one
captured CUDA graph (25 at 128x128 and up, as JAX's), ``REPEAT`` timed
replays, the median.

``--e2e`` adds the end-to-end A/B that set JAX's default
(``mmdgan_tpu/models/ops.py:50-63``): hd128, hd256 and hd512 at full
width, rep b64 bf16, ``build_device_data_step`` (M=1) over a seeded
256-row uint8 dataset on the card, graphed K=16 windows, with
``TC_PS3_MIN_SIZE`` at inf and at 64 in turns (inf, 64, 64, inf; the
gate is read when a model is built, so each reading builds its own). It
reports what the card says; the port's default stays inf.

    python -m mmdgan_torch.tools.tc_study [--shapes g4,g8] [--e2e] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import resolve_device
from mmdgan_torch.ops.conv import Geometry, conv_transpose_ps3, ps3_conv, ps3_kernel
from mmdgan_torch.tools.conv_study import (LAYOUTS, gate, select, table_rows, time_variants,
                                           to_layout)

B = 64
INNER = 200
INNER_LARGE = 25    # 128x128 and up: about 100x the work of the 4x4 trunk's shapes
REPEAT = 7
COMPUTE_DTYPE = torch.bfloat16
GATE = 2e-5

# (name, H, Cin, Cout): the generators' tc 4x4/s2 shapes: the 64x64 arch
# (celeba/lsun, _arch_64), the CIFAR trio, and the hd family's
# image-resolution layers (hd128's, hd256's and hd512's last two)
SHAPES = [
    ("g2 4x4 1024->512 (64sq)", 4, 1024, 512),
    ("g3 8x8 512->256 (64sq)", 8, 512, 256),
    ("g4 16x16 256->128 (64sq)", 16, 256, 128),
    ("g5 32x32 128->64 (64sq)", 32, 128, 64),
    ("g2 4x4 512->256 (cifar)", 4, 512, 256),
    ("g3 8x8 256->128 (cifar)", 8, 256, 128),
    ("g4 16x16 128->64 (cifar)", 16, 128, 64),
    ("g6 64x64 64->3 (hd128)", 64, 64, 3),
    ("g7 128x128 32->3 (hd256)", 128, 32, 3),
    ("g7 128x128 32->32 (hd512)", 128, 32, 32),
    ("g8 256x256 32->3 (hd512)", 256, 32, 3),
]
E2E_ARCHS = (128, 256, 512)
E2E_GATES = (float("inf"), 64, 64, float("inf"))
E2E_ROWS, E2E_K, E2E_STEPS = 256, 16, 64


def direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The port's transposed conv, ``w`` [Cin, Cout, 4, 4]."""
    return Geometry.make("tc", x.shape[2:], 4, 2).forward(x, w)


def ps2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Four 2x2/s1 phase convs and an interleave. Phase p = 0 reads rows
    {i - 1, i} (pad (1, 0)), p = 1 rows {i, i + 1} (pad (0, 1)), through
    JAX's taps ``W[2a + p, 2b + q]``, the flipped kernel's even or odd
    rows and columns (``ops/conv.py`` ``ps3_kernel``)."""
    n, _, h, wd = x.shape
    wf = w.flip(2, 3)
    outs = {(p, q): F.conv2d(F.pad(x, (1 - q, q, 1 - p, p)), wf[:, :, p::2, q::2].transpose(0, 1))
            for p in (0, 1) for q in (0, 1)}
    rows = [torch.stack([outs[(p, 0)], outs[(p, 1)]], dim=-1) for p in (0, 1)]
    return torch.stack(rows, dim=3).reshape(n, w.shape[1], 2 * h, 2 * wd)


def grad_form(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The transposed conv as the VJP of the 4x4/s2 SAME conv of the
    2x-size output by the same kernel (``F.conv2d``'s weight [out=Cin,
    in=Cout, 4, 4] is the ``tc`` kernel as it is), pulled back through
    ``autograd.grad``; differentiable itself (``create_graph``) when an
    input needs a gradient."""
    n, _, h, wd = x.shape
    channels_last = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    with torch.enable_grad():
        y0 = torch.zeros((n, w.shape[1], 2 * h, 2 * wd), dtype=x.dtype, device=x.device)
        y0 = y0.contiguous(memory_format=fmt).requires_grad_(True)
        out = F.conv2d(y0, w, stride=2, padding=1)
        return torch.autograd.grad(out, y0, x, create_graph=x.requires_grad or w.requires_grad)[0]


GATED = {"direct": direct, "ps2": ps2, "ps3": conv_transpose_ps3, "grad": grad_form}


def shape_inputs(shape: tuple, device, batch: int = B) -> tuple:
    """One shape's float32 input [B, Cin, H, H] and ``tc`` kernel [Cin, Cout,
    4, 4], ``RandomState(0)`` (the kernel scaled by 0.05), as JAX's study."""
    _, h, cin, cout = shape
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(batch, cin, h, h), dtype=torch.float32, device=device)
    w = torch.tensor(rng.randn(cin, cout, 4, 4) * 0.05, dtype=torch.float32, device=device)
    return x, w


def time_shape(shape: tuple, x: torch.Tensor, w: torch.Tensor, inner: int = None,
               repeat: int = REPEAT) -> Dict[str, Dict]:
    """``{layout: {variant: timings}}`` at bf16, each layout's rows printed;
    ``inner`` INNER (INNER_LARGE at 128x128 and up) unless given."""
    name, h = shape[:2]
    inner = (INNER if h < 128 else INNER_LARGE) if inner is None else inner
    out = {}
    for layout in LAYOUTS:
        xl = to_layout(x.to(COMPUTE_DTYPE), layout)
        wl = to_layout(w.to(COMPUTE_DTYPE), layout)
        w3 = to_layout(ps3_kernel(w).to(COMPUTE_DTYPE), layout)
        calls = {"direct": (direct, (xl, wl)), "ps2": (ps2, (xl, wl)), "ps3": (ps3_conv, (xl, w3)),
                 "grad": (grad_form, (xl, wl))}
        out[layout] = time_variants(calls, inner, repeat)
        for row in table_rows(name, out[layout]):
            print(f"[{layout}] {row}", flush=True)
    return out


def study_shape(shape: tuple, device, batch: int = B, inner: int = None,
                repeat: int = REPEAT) -> Dict[str, Dict]:
    """One shape of ``SHAPES``: the gate, then ``time_shape``."""
    x, w = shape_inputs(shape, device, batch)
    errs = gate(GATED, (x, w), GATE, shape[0])
    print(f"## {shape[0]}: exactness ok ({', '.join(f'{v} {e:.1e}' for v, e in errs.items())} "
          f"relative to direct, float32, both layouts)", flush=True)
    return time_shape(shape, x, w, inner, repeat)


def e2e_reading(size: int, gate_size: float, device, steps: int = E2E_STEPS,
                batch: int = B) -> float:
    """Steps/s of hd``size`` (rep, bf16, M=1) through
    ``build_device_data_step`` over E2E_ROWS seeded uint8 rows on the
    device, with ``TC_PS3_MIN_SIZE`` at ``gate_size`` while the model is
    built: two untimed windows (the eager warm-up and the capture), then
    ``steps // K`` timed ones, fenced by a synchronize."""
    from mmdgan_torch.architectures import hd_architecture
    from mmdgan_torch.models import ops
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_device_data_step, init_train_state

    old = ops.TC_PS3_MIN_SIZE
    ops.TC_PS3_MIN_SIZE = gate_size
    try:
        model = SNGan(hd_architecture(size), loss_type="rep", device=device)
    finally:
        ops.TC_PS3_MIN_SIZE = old
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device=device)
    fn = build_device_data_step(model, opt_d, opt_g, E2E_K, batch, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    data = torch.randint(0, 256, (E2E_ROWS, size, size, 3), generator=gen, device=device,
                         dtype=torch.uint8)
    rng = torch.Generator(device=device).manual_seed(1)

    def fence(m):
        if m["loss_gen"].is_cuda:
            torch.cuda.synchronize(m["loss_gen"].device)
        return float(m["loss_gen"][-1])

    for _ in range(2):
        ts, m = fn(ts, data, None, rng)
    fence(m)
    n_calls = max(steps // E2E_K, 1)
    start = time.perf_counter()
    for _ in range(n_calls):
        ts, m = fn(ts, data, None, rng)
    if not np.isfinite(fence(m)):
        raise RuntimeError(f"hd{size} at gate {gate_size}: loss_gen is not finite")
    sps = n_calls * E2E_K / (time.perf_counter() - start)
    del ts, fn, data, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return sps


def e2e(device, sizes=E2E_ARCHS, steps: int = E2E_STEPS,
        batch: int = B) -> Dict[int, Dict[float, List[float]]]:
    """{size: {gate: [steps/s readings]}}, the gates read in E2E_GATES'
    order (in turns)."""
    out = {}
    for size in sizes:
        out[size] = {}
        for g in E2E_GATES:
            sps = e2e_reading(size, g, device, steps, batch)
            out[size].setdefault(g, []).append(sps)
            print(f"[tc_study e2e] hd{size} TC_PS3_MIN_SIZE={g}: {sps:.3f} steps/s",
                  file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="", help="name prefixes, comma-separated (default all)")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--inner", type=int, default=None,
                   help=f"calls per graph (default {INNER}, {INNER_LARGE} at 128x128 and up)")
    p.add_argument("--repeat", type=int, default=REPEAT)
    p.add_argument("--e2e", action="store_true", help="also the hd128/256/512 gate A/B")
    p.add_argument("--e2e-steps", type=int, default=E2E_STEPS)
    p.add_argument("--e2e-sizes", default=",".join(map(str, E2E_ARCHS)))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# tc study: device={dev} ({card}) B={args.batch} INNER={args.inner or INNER} "
          f"dtype=bfloat16", flush=True)
    rows = []
    for shape in select(SHAPES, args.shapes):
        res = study_shape(shape, dev, args.batch, args.inner, args.repeat)
        for layout in LAYOUTS:
            rows += [(shape[0], layout, vn, v) for vn, v in res[layout].items()]
    print("\n# summary (speedup vs direct, >1 = faster)")
    for name, layout, vname, v in rows:
        if vname != "direct":
            print(f"{name:28s} {layout:13s} {vname:6s} fwd x{v['fwd_speedup']:.3f}  "
                  f"fwd+bwd x{v['fwdbwd_speedup']:.3f}")
    if args.e2e:
        res = e2e(dev, [int(s) for s in args.e2e_sizes.split(",")], steps=args.e2e_steps,
                  batch=args.batch)
        print("\n# e2e: graphed K=16 windows, rep b64 bf16, TC_PS3_MIN_SIZE inf vs 64 in turns\n")
        print("| arch | inf steps/s | 64 steps/s | 64 vs inf |\n|---|---|---|---|")
        for size, by_gate in res.items():
            base, ps3 = by_gate[float("inf")], by_gate[64]
            print(f"| hd{size} | {', '.join(f'{v:.3f}' for v in base)} | "
                  f"{', '.join(f'{v:.3f}' for v in ps3)} | "
                  f"{100 * (np.mean(ps3) / np.mean(base) - 1):+.2f}% |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
