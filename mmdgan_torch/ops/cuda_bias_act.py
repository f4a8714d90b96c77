"""A conv block's bias, return to the compute dtype and activation, fused
(``csrc/bias_act.cu``).

Plainly, a ``default`` block runs ``(x + bias).to(compute_dtype)`` then its
activation: on a 16-bit map the add promotes to float32, so the forward
makes three passes over the map and the backward four (the activation's
gradient, the cast's copy to float32, the bias's sum, the cast back). The
kernel pair does the same arithmetic in one pass each way:

- ``bias_act_forward_cuda`` launches the forward kernel: ``y`` from the
  conv's output ``x`` (bf16 or fp16, channels_last) and the float32 bias;
- ``bias_act_backward_cuda`` launches the backward kernel: the gradient of
  ``x`` from the output's gradient and ``y`` and, where asked, the bias's
  gradient, summed per channel in float32 in a fixed order;
- ``bias_act`` is the differentiable entry: ``BiasAct`` launches the
  forward, ``BiasActGrad`` the backward, and its own backward launches the
  backward kernel again, so a backward that is itself differentiated
  (``create_graph``, the penalties' double backward) runs the kernels too.

The plain block's ops, which the kernels reproduce, are
``models/ops.py`` ``bias_act_plain`` and ``bias_act_plain_backward``.
Each launcher counts its launches in ``<launcher>.launches``. The
activations are those of ``models/layers.py`` ``ACTIVATIONS`` under the same
names (``lrelu``'s slope 0.1).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mmdgan_torch.ops import _build

SOURCE = "bias_act.cu"
ACTS = ("linear", "relu", "lrelu", "tanh")   # the kernel's codes 0-3
DTYPES = (torch.bfloat16, torch.float16)     # the kernel's codes 0-1
THREADS = 256      # kThreads
UNROLL = 4         # kUnroll: rows in flight per thread
VEC = 8            # channels per 16-byte access
BLOCKS_PER_SM = 4  # the blocks per SM that the grid holds at most


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bias_act_forward.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i, p]
    lib.bias_act_forward.restype = i
    lib.bias_act_backward.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i, i, p]
    lib.bias_act_backward.restype = i
    lib.bias_act_error_string.argtypes = [i]
    lib.bias_act_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def geometry(rows: int, channels: int, vec: int, sms: int) -> Tuple[int, int, int]:
    """(width, grid_x, grid_y) of a launch over ``rows`` x ``channels``
    with ``vec`` channels per access: a block holds ``width`` channel
    groups of ``THREADS // width`` rows per pass, ``grid_y`` blocks side by
    side cover the channels, and ``grid_x`` of them, at most
    ``BLOCKS_PER_SM`` per SM in all and no more than the rows need, stride
    over the rows."""
    groups = channels // vec
    width = min(groups, THREADS)
    grid_y = -(-groups // width)
    rows_per_block = THREADS // width * UNROLL
    grid_x = max(1, min(-(-rows // rows_per_block), BLOCKS_PER_SM * sms // grid_y))
    return width, grid_x, grid_y


def _check_map(who: str, name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{who}: {name} is on {t.device}, not CUDA")
    if t.dtype not in DTYPES:
        raise TypeError(f"{who}: {name} is {t.dtype}, needs bfloat16 or float16")
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{who}: {name} must be a channels_last [N, C, H, W] map, got "
                         f"{tuple(t.shape)} with strides {t.stride()}")


def _launch_shape(maps) -> Tuple[int, int, int]:
    """(rows, channels, vec) of maps of one shape: 8 channels per access
    where the channels divide by 8 and every pointer is 16-byte aligned."""
    n, c, h, w = maps[0].shape
    vec = VEC if c % VEC == 0 and all(t.data_ptr() % 16 == 0 for t in maps) else 1
    return n * h * w, c, vec


def _raise_on(who: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{who}: launch failed, CUDA error {err}: "
                           f"{_library().bias_act_error_string(err).decode()}")


def bias_act_forward_cuda(x: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """Launch the forward kernel on the current stream: ``act((x + bias)
    .to(x.dtype))`` as a new channels_last map. ``x`` is a bf16 or fp16
    channels_last map, ``bias`` float32 [C] on its device. Not
    differentiable by itself: use :func:`bias_act`."""
    who = "bias_act_forward_cuda"
    _check_map(who, "x", x)
    if bias.dtype != torch.float32 or bias.shape != (x.shape[1],) or bias.device != x.device:
        raise ValueError(f"{who}: bias must be float32 [{x.shape[1]}] on {x.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    bias = bias.contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    rows, channels, vec = _launch_shape((x, y))
    width, grid_x, grid_y = geometry(rows, channels, vec, _sms(x.device.index))
    err = _library().bias_act_forward(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, channels, vec, ACTS.index(act),
        DTYPES.index(x.dtype), width, grid_x, grid_y, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(who, err)
    bias_act_forward_cuda.launches += 1
    return y


bias_act_forward_cuda.launches = 0


def bias_act_backward_cuda(g: torch.Tensor, y: torch.Tensor, act: str,
                           bias_grad: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernel on the current stream: (the gradient of
    the conv's output, the bias's float32 gradient or None) from the
    output's gradient ``g`` and the output ``y``, two channels_last maps of
    one shape and dtype. The bias's gradient takes a second, short launch
    over the blocks' partial sums."""
    who = "bias_act_backward_cuda"
    _check_map(who, "g", g)
    _check_map(who, "y", y)
    if g.shape != y.shape or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(f"{who}: g {g.dtype} {tuple(g.shape)} on {g.device} and y {y.dtype} "
                         f"{tuple(y.shape)} on {y.device} differ")
    gx = torch.empty_like(y, memory_format=torch.channels_last)
    rows, channels, vec = _launch_shape((g, y, gx))
    width, grid_x, grid_y = geometry(rows, channels, vec, _sms(y.device.index))
    gb = partial = None
    if bias_grad:
        # the bias's gradient, then the blocks' partial sums
        buf = torch.empty((grid_x + 1) * channels, dtype=torch.float32, device=y.device)
        gb, partial = buf[:channels], buf[channels:]
    err = _library().bias_act_backward(
        g.data_ptr(), y.data_ptr(), gx.data_ptr(), None if partial is None else partial.data_ptr(),
        None if gb is None else gb.data_ptr(), rows, channels, vec, ACTS.index(act),
        DTYPES.index(y.dtype), width, grid_x, grid_y, y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream)
    _raise_on(who, err)
    bias_act_backward_cuda.launches += 1
    return gx, gb


bias_act_backward_cuda.launches = 0


class BiasAct(torch.autograd.Function):
    """``act((x + bias).to(x.dtype))`` by the forward kernel; saves only its
    output, which the next conv saves as its input anyway. Its backward is
    ``BiasActGrad``, itself differentiable; where no gradient reaches the
    output (a double backward's, but for tanh) it passes none on."""

    @staticmethod
    def forward(ctx, x, bias, act):
        ctx.act = act
        ctx.set_materialize_grads(False)
        y = bias_act_forward_cuda(x, bias, act)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        (y,) = ctx.saved_tensors
        gx, gb = BiasActGrad.apply(g.contiguous(memory_format=torch.channels_last), y, ctx.act,
                                   ctx.needs_input_grad[1])
        return gx, gb, None


class BiasActGrad(torch.autograd.Function):
    """(``gx``, ``gb``) = (``g * act'(y)`` in ``y``'s dtype, its float32 sum
    per channel or None) by the backward kernel. Linear in ``g``, so its own
    backward is the same kernel on the incoming gradient (``gb``'s
    broadcast to every row added in float32, where the plain route sums
    it) and no bias gradient; ``act'`` is
    piecewise constant for linear, relu and lrelu, so ``y`` gets no
    gradient, and for tanh ``-2 * y * g`` times the incoming gradient, as
    autograd differentiates ``tanh_backward``. So a backward run with
    ``create_graph`` (the penalties' double backward) launches the kernel
    too."""

    @staticmethod
    def forward(ctx, g, y, act, bias_grad):
        ctx.act = act
        ctx.set_materialize_grads(False)   # an unused output's gradient stays None
        ctx.save_for_backward(g if act == "tanh" else None, y)
        return bias_act_backward_cuda(g, y, act, bias_grad)

    @staticmethod
    def backward(ctx, ggx, ggb):
        g, y = ctx.saved_tensors
        if ggb is None:
            gg = ggx
        elif ggx is None:
            gg = ggb.to(y.dtype).view(1, -1, 1, 1).expand(y.shape)
        else:
            gg = (ggx.float() + ggb.view(1, -1, 1, 1)).to(y.dtype)
        if gg is None:
            return None, None, None, None
        gg = gg.contiguous(memory_format=torch.channels_last)
        grad_g = BiasActGrad.apply(gg, y, ctx.act, False)[0] if ctx.needs_input_grad[0] else None
        grad_y = gg * (-2 * y * g) if ctx.act == "tanh" and ctx.needs_input_grad[1] else None
        return grad_g, grad_y, None, None


def bias_act(x: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """Differentiable ``act((x + bias).to(x.dtype))`` of a 16-bit
    channels_last CUDA map ``x`` [N, C, H, W] and a float32 bias [C]: the
    kernel pair, to any order of differentiation."""
    if act not in ACTS:
        raise ValueError(f"bias_act: activation {act} is not one of {ACTS}")
    return BiasAct.apply(x, bias, act)
