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
  runs for every ``tc`` (one ``F.conv_transpose2d``);
- ``ps2``: four 2x2/s1 phase convs and an interleave;
- ``ps3``: ``ps3_conv``, one 3x3/s1 conv to 4*Cout channels (16 of its 36
  taps per phase useful) and depth-to-space, the lowering that the JAX
  package's size gate selects (``mmdgan_tpu/models/ops.py:50-63,383-414``;
  it lost to the direct route on the TPU and on the H100, and no model of
  the port runs it); timed on its kernel ``ps3_kernel(w)`` made once, as
  JAX's study times it (the gate runs ``conv_transpose_ps3``, the kernel's
  making included);
- ``grad``: the transposed conv as the VJP of the matching 4x4/s2 conv
  (``autograd.grad`` of ``F.conv2d`` by its input).

Readings as ``tools/conv_study.py`` takes them: ``INNER`` calls in one
captured CUDA graph (25 at 128x128 and up, as JAX's), ``REPEAT`` timed
replays, the median.

    python -m mmdgan_torch.tools.tc_study [--shapes g4,g8] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import resolve_device
from mmdgan_torch.ops.conv import Geometry
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


def direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The port's transposed conv, ``w`` [Cin, Cout, 4, 4]."""
    return Geometry.make("tc", x.shape[2:], 4, 2).forward(x, w)


def ps2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Four 2x2/s1 phase convs and an interleave. Phase p = 0 reads rows
    {i - 1, i} (pad (1, 0)), p = 1 rows {i, i + 1} (pad (0, 1)), through
    JAX's taps ``W[2a + p, 2b + q]``, the flipped kernel's even or odd
    rows and columns (``ps3_kernel``)."""
    n, _, h, wd = x.shape
    wf = w.flip(2, 3)
    outs = {(p, q): F.conv2d(F.pad(x, (1 - q, q, 1 - p, p)), wf[:, :, p::2, q::2].transpose(0, 1))
            for p in (0, 1) for q in (0, 1)}
    rows = [torch.stack([outs[(p, 0)], outs[(p, 1)]], dim=-1) for p in (0, 1)]
    return torch.stack(rows, dim=3).reshape(n, w.shape[1], 2 * h, 2 * wd)


def ps3_kernel(w: torch.Tensor) -> torch.Tensor:
    """The 3x3 kernel ``[4 * Cout, Cin, 3, 3]`` of ``conv_transpose_ps3``
    from a ``tc`` kernel ``[Cin, Cout, 4, 4]`` (k=4, s=2, SAME).

    Output phase (p, q) (row 2i + p, column 2j + q) reads input rows
    i - 1 + p + a and columns j - 1 + q + b, a, b in {0, 1}, through tap
    ``w[:, :, 3 - 2a - p, 3 - 2b - q]``: torch's transposed conv flips the
    kernel that ``lax.conv_transpose`` does not, so the flipped kernel
    ``wf`` holds JAX's taps ``W[2a + p, 2b + q]`` at ``wf[..., 2a + p, 2b +
    q]``. Its even or odd rows and columns, padded to 3x3 at offset (p, q),
    are phase (p, q)'s block of Cout output channels, blocks in (p, q)
    order."""
    cin, cout = w.shape[:2]
    wf = w.flip(2, 3)
    blocks = [F.pad(wf[:, :, p::2, q::2], (q, 1 - q, p, 1 - p)) for p in (0, 1) for q in (0, 1)]
    return torch.stack(blocks).transpose(1, 2).reshape(4 * cout, cin, 3, 3)


def ps3_conv(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """The 3x3/s1 conv (pad 1) to the four phases' channels, then
    depth-to-space: channel (p, q, c) at (i, j) goes to (c, 2i + p, 2j + q).
    The result keeps the conv's memory layout (one copy either way)."""
    n, _, h, wd = x.shape
    cout = w3.shape[0] // 4
    z = F.conv2d(x, w3, padding=1)
    if z.is_contiguous(memory_format=torch.channels_last):
        # NHWC memory (n, i, j, p, q, c) to (n, i, p, j, q, c)
        z = z.permute(0, 2, 3, 1).reshape(n, h, wd, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return z.reshape(n, 2 * h, 2 * wd, cout).permute(0, 3, 1, 2)
    z = z.reshape(n, 2, 2, cout, h, wd)
    return z.permute(0, 3, 4, 1, 5, 2).reshape(n, cout, 2 * h, 2 * wd)


def conv_transpose_ps3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``tc`` k=4/s2/SAME of ``x`` [N, Cin, H, W] by ``w`` [Cin, Cout, 4, 4]
    as one 3x3 conv and a depth-to-space: equal to the direct route up to
    summation order, forward and both gradients."""
    return ps3_conv(x, ps3_kernel(w))


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="", help="name prefixes, comma-separated (default all)")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--inner", type=int, default=None,
                   help=f"calls per graph (default {INNER}, {INNER_LARGE} at 128x128 and up)")
    p.add_argument("--repeat", type=int, default=REPEAT)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
