"""Fused kernel means for the repulsive MMD losses
(``mmdgan_tpu/ops/pallas_mmd.py``).

- ``kernel_means_cuda`` launches the hand-written CUDA kernel
  ``csrc/kernel_means.cu`` (the port of ``_kernel_means_kernel``) and
  counts its launches in ``kernel_means_cuda.launches``.
- ``kernel_means_reference`` is the same function in plain PyTorch
  (``_means_reference``), built on ``distance.py`` and ``kernels.py``.
- ``fused_kernel_means`` is the differentiable entry: its forward runs the
  kernel for CUDA tensors and the plain version for CPU tensors; its
  backward is the autograd of the plain version, as JAX's ``_fkm_bwd`` is.
  There is no backward kernel, as there is none on the TPU.

All three return ``[6] = (e_kxx, e_kxy, e_kyy, e_kxx_b, e_kxy_b, e_kyy_b)``
with xx = gen-gen, xy = gen-data, yy = data-data.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from mmdgan_torch.ops import _build
from mmdgan_torch.ops.distance import get_squared_dist
from mmdgan_torch.ops.kernels import matrix_mean_wo_diagonal

SOURCE = "kernel_means.cu"
# the bounds the dispatcher uses (math_func.py:2539); the kernel takes them
# as arguments, the loss functions below assert them
LOWER_BOUND = 0.25
UPPER_BOUND = 4.0
MEAN_KEYS = ("e_kxx", "e_kxy", "e_kyy", "e_kxx_b", "e_kxy_b", "e_kyy_b")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmd_kernel_means.argtypes = [p, p, p, p, i, i, f, f, f, i, p]
    lib.mmd_kernel_means.restype = i
    lib.mmd_scratch_floats.argtypes = [i]
    lib.mmd_scratch_floats.restype = i
    lib.mmd_error_string.argtypes = [i]
    lib.mmd_error_string.restype = ctypes.c_char_p
    return lib


def _check_scores(s_gen: torch.Tensor, s_x: torch.Tensor) -> Tuple[int, int]:
    for name, t in (("s_gen", s_gen), ("s_x", s_x)):
        if not t.is_cuda:
            raise ValueError(f"kernel_means_cuda: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel_means_cuda: {name} is {t.dtype}, needs float32")
        if t.dim() != 2:
            raise ValueError(f"kernel_means_cuda: {name} must be [B, d], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"kernel_means_cuda: {name} must be contiguous")
    if s_gen.shape != s_x.shape:
        raise ValueError(f"kernel_means_cuda: shapes differ, {tuple(s_gen.shape)} "
                         f"vs {tuple(s_x.shape)}")
    if s_gen.device != s_x.device:
        raise ValueError("kernel_means_cuda: inputs on different devices")
    batch, dim = s_gen.shape
    if batch < 2 or dim < 1:
        raise ValueError(f"kernel_means_cuda: needs B >= 2 and d >= 1, got {batch}, {dim}")
    return batch, dim


def kernel_means_cuda(s_gen: torch.Tensor, s_x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns the [6] means.

    Not differentiable by itself: use :func:`fused_kernel_means`."""
    batch, dim = _check_scores(s_gen, s_x)
    lib = _library()
    with torch.cuda.device(s_gen.device):
        scratch = torch.empty(lib.mmd_scratch_floats(batch), dtype=torch.float32,
                              device=s_gen.device)
        out = torch.empty(6, dtype=torch.float32, device=s_gen.device)
        stream = torch.cuda.current_stream(s_gen.device).cuda_stream
        err = lib.mmd_kernel_means(
            s_gen.data_ptr(), s_x.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            batch, dim, 1.0 / (2.0 * sigma ** 2), LOWER_BOUND, UPPER_BOUND,
            s_gen.device.index, stream)
    if err != 0:
        raise RuntimeError(f"kernel_means_cuda: launch failed, CUDA error {err}: "
                           f"{lib.mmd_error_string(err).decode()}")
    kernel_means_cuda.launches += 1
    return out


kernel_means_cuda.launches = 0


def kernel_means_reference(s_gen: torch.Tensor, s_x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """The six means in plain PyTorch (``pallas_mmd.py::_means_reference``)."""
    b = s_gen.shape[0]
    d_gg, d_gx, d_xx = get_squared_dist(s_gen, s_x, mode="xxxyyy")
    t = 2.0 * sigma ** 2
    m = float(b)
    e = lambda k: matrix_mean_wo_diagonal(k, m)
    k_gx = e(torch.exp(-d_gx / t))
    return torch.stack([
        e(torch.exp(-d_gg / t)),
        k_gx,
        e(torch.exp(-d_xx / t)),
        e(torch.exp(-torch.clamp(d_gg, min=LOWER_BOUND) / t)),
        k_gx,
        e(torch.exp(-torch.clamp(d_xx, max=UPPER_BOUND) / t)),
    ])


class _FusedKernelMeans(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s_gen, s_x, sigma):
        ctx.save_for_backward(s_gen, s_x)
        ctx.sigma = sigma
        if s_gen.is_cuda:
            return kernel_means_cuda(s_gen, s_x, sigma)
        return kernel_means_reference(s_gen, s_x, sigma)

    @staticmethod
    def backward(ctx, ct):
        s_gen, s_x = ctx.saved_tensors
        with torch.enable_grad():
            a = s_gen.detach().requires_grad_(True)
            b = s_x.detach().requires_grad_(True)
            e = kernel_means_reference(a, b, ctx.sigma)
            g_a, g_b = torch.autograd.grad(e, (a, b), ct)
        return g_a, g_b, None


def fused_kernel_means(s_gen: torch.Tensor, s_x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Differentiable [6] kernel means: the CUDA kernel forward on CUDA
    tensors, the plain version on CPU tensors; plain autograd backward."""
    return _FusedKernelMeans.apply(s_gen, s_x, sigma)


def repulsive_mmd_g_fused(
    s_gen: torch.Tensor,
    s_x: torch.Tensor,
    sigma: float = 1.0,
    repulsive_weights: Sequence[float] = (0.0, -1.0),
):
    """'rep' pair from the fused means: loss_gen = e_kxx + e_kyy - 2 e_kxy;
    loss_dis = w0 e_kxy - e_kxx - w1 e_kyy. Returns (loss_gen, loss_dis, e)."""
    w0, w1 = repulsive_weights
    assert w0 - w1 == 1.0, "w[0]-w[1] must be 1"
    e = fused_kernel_means(s_gen, s_x, sigma)
    e_kxx, e_kxy, e_kyy = e[0], e[1], e[2]
    loss_gen = e_kxx + e_kyy - 2.0 * e_kxy
    loss_dis = w0 * e_kxy - e_kxx - w1 * e_kyy
    return loss_gen, loss_dis, e


def repulsive_mmd_g_bounded_fused(
    s_gen: torch.Tensor,
    s_x: torch.Tensor,
    sigma: float = 1.0,
    lower_bound: float = LOWER_BOUND,
    upper_bound: float = UPPER_BOUND,
    repulsive_weights: Sequence[float] = (0.0, -1.0),
):
    """'rmb' pair from the fused means; the kernel implements the bounds
    (0.25, 4.0) and the repulsive direction only. Returns (loss_gen,
    loss_dis, e)."""
    assert (lower_bound, upper_bound) == (LOWER_BOUND, UPPER_BOUND), (
        "fused rmb kernel is specialized for bounds (0.25, 4.0)")
    w0, w1 = repulsive_weights
    assert w0 - w1 == 1.0, "w[0]-w[1] must be 1"
    assert w0 <= 0 and w1 <= 0, (
        "fused rmb kernel implements the repulsive direction (w0<=0, w1<=0)")
    e = fused_kernel_means(s_gen, s_x, sigma)
    loss_gen = e[0] + e[2] - 2.0 * e[1]
    loss_dis = w0 * e[4] - e[3] - w1 * e[5]
    return loss_gen, loss_dis, e
