"""Fused kernel means for the repulsive MMD losses
(``mmdgan_tpu/ops/pallas_mmd.py``).

- ``kernel_means_cuda`` launches the hand-written forward kernel of
  ``csrc/kernel_means.cu`` (the port of ``_kernel_means_kernel``);
  ``kernel_means_reference`` is the same function in plain PyTorch
  (``_means_reference``), built on ``distance.py`` and ``kernels.py``.
- ``kernel_means_backward_cuda`` launches the backward kernel of the same
  source (JAX's backward, ``_fkm_bwd``, is plain JAX);
  ``kernel_means_backward_reference`` is its closed form in plain PyTorch.
- Each wrapper counts its launches in ``<wrapper>.launches``.
- ``fused_kernel_means`` is the differentiable entry: forward and backward
  run the kernels for CUDA tensors and the plain versions for CPU tensors.

The means are ``[6] = (e_kxx, e_kxy, e_kyy, e_kxx_b, e_kxy_b, e_kyy_b)``
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
_TILE = 32   # rows of the kernels' tiles (kTile in the source)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mmd_kernel_means.argtypes = [p, p, p, i, i, f, f, f, i, p]
    lib.mmd_kernel_means.restype = i
    lib.mmd_kernel_means_backward.argtypes = [p, p, p, p, p, i, i, f, f, f, i, p]
    lib.mmd_kernel_means_backward.restype = i
    lib.mmd_error_string.argtypes = [i]
    lib.mmd_error_string.restype = ctypes.c_char_p
    return lib


def _check_scores(who: str, s_gen: torch.Tensor, s_x: torch.Tensor) -> Tuple[int, int]:
    for name, t in (("s_gen", s_gen), ("s_x", s_x)):
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} is {t.dtype}, needs float32")
        if t.dim() != 2:
            raise ValueError(f"{who}: {name} must be [B, d], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if s_gen.shape != s_x.shape:
        raise ValueError(f"{who}: shapes differ, {tuple(s_gen.shape)} vs {tuple(s_x.shape)}")
    if s_gen.device != s_x.device:
        raise ValueError(f"{who}: inputs on different devices")
    batch, dim = s_gen.shape
    if batch < 2 or dim < 1:
        raise ValueError(f"{who}: needs B >= 2 and d >= 1, got {batch}, {dim}")
    return batch, dim


def _raise_on(who: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{who}: launch failed, CUDA error {err}: "
                           f"{_library().mmd_error_string(err).decode()}")


def kernel_means_cuda(s_gen: torch.Tensor, s_x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Launch the forward kernel on the current stream; returns the [6] means.

    Not differentiable by itself: use :func:`fused_kernel_means`."""
    batch, dim = _check_scores("kernel_means_cuda", s_gen, s_x)
    lib = _library()
    # out[6], then two partial sums for each of the kernel's t(t+1) + t^2 blocks
    t = -(-batch // _TILE)
    buf = torch.empty(6 + 2 * (t * (t + 1) + t * t), dtype=torch.float32, device=s_gen.device)
    err = lib.mmd_kernel_means(
        s_gen.data_ptr(), s_x.data_ptr(), buf.data_ptr(), batch, dim,
        1.0 / (2.0 * sigma ** 2), LOWER_BOUND, UPPER_BOUND, s_gen.device.index,
        torch.cuda.current_stream(s_gen.device).cuda_stream)
    _raise_on("kernel_means_cuda", err)
    kernel_means_cuda.launches += 1
    return buf[:6]


kernel_means_cuda.launches = 0


def kernel_means_backward_cuda(s_gen: torch.Tensor, s_x: torch.Tensor, ct: torch.Tensor,
                               sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on the current stream: the gradients of
    ``<ct, means>`` with respect to ``s_gen`` and ``s_x``. ``ct`` is the
    float32 [6] cotangent on the scores' device; it is read on the device,
    so the call never waits for it."""
    who = "kernel_means_backward_cuda"
    if ct.dtype != torch.float32 or ct.shape != (6,) or not ct.is_contiguous():
        raise ValueError(f"{who}: ct must be a contiguous float32 [6], "
                         f"got {ct.dtype} {tuple(ct.shape)}")
    batch, dim = _check_scores(who, s_gen, s_x)
    if ct.device != s_gen.device:
        raise ValueError(f"{who}: ct is on {ct.device}, the scores on {s_gen.device}")
    lib = _library()
    grads = torch.empty((2, batch, dim), dtype=torch.float32, device=s_gen.device)
    g_gen, g_x = grads[0], grads[1]
    err = lib.mmd_kernel_means_backward(
        s_gen.data_ptr(), s_x.data_ptr(), ct.data_ptr(), g_gen.data_ptr(), g_x.data_ptr(),
        batch, dim, 1.0 / (2.0 * sigma ** 2), LOWER_BOUND, UPPER_BOUND, s_gen.device.index,
        torch.cuda.current_stream(s_gen.device).cuda_stream)
    _raise_on(who, err)
    kernel_means_backward_cuda.launches += 1
    return g_gen, g_x


kernel_means_backward_cuda.launches = 0


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


def raw_distances(s_gen: torch.Tensor, s_x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """d_i - 2 G_ij + d_j before the clamp at 0, formed as
    ``get_squared_dist`` forms it (norms from the Gram diagonals)."""
    gg, gx, xx = s_gen @ s_gen.T, s_gen @ s_x.T, s_x @ s_x.T
    dg, dx = torch.diagonal(gg), torch.diagonal(xx)
    return (dg[:, None] - 2.0 * gg + dg[None, :], dg[:, None] - 2.0 * gx + dx[None, :],
            dx[:, None] - 2.0 * xx + dx[None, :])


def kernel_means_backward_reference(s_gen: torch.Tensor, s_x: torch.Tensor, ct: torch.Tensor,
                                    sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, in closed form (no
    autograd): the gradients of ``<ct, kernel_means_reference(s_gen, s_x)>``.

    With N = B(B-1), the raw distances R, k = exp(-max(R, 0) / 2 sigma^2)
    and every coefficient zero on the diagonal and where R < 0 (the clamp):
    alpha = -(c0 + c3 [R_gg >= lb]) k_gg / (2 sigma^2 N), beta = -(c1 + c4)
    k_gx / (2 sigma^2 N), gamma = -(c2 + c5 [R_xx <= ub]) k_xx / (2 sigma^2 N);
    g_gen_i = sum_j 4 alpha_ij (a_i - a_j) + 2 beta_ij (a_i - b_j) and
    g_x_j = sum_i 2 beta_ij (b_j - a_i) + sum_k 4 gamma_jk (b_j - b_k),
    each sum taken as a row sum times the scores minus a matrix product."""
    b = s_gen.shape[0]
    scale = -1.0 / (2.0 * sigma ** 2 * b * (b - 1))
    off = ~torch.eye(b, dtype=torch.bool, device=s_gen.device)

    def kernel(raw):   # k where the coefficient is kept, else 0
        return torch.where(off & (raw >= 0), torch.exp(-raw / (2.0 * sigma ** 2)), 0.0)

    r_gg, r_gx, r_xx = raw_distances(s_gen, s_x)
    alpha = scale * (ct[0] + ct[3] * (r_gg >= LOWER_BOUND)) * kernel(r_gg)
    beta = scale * (ct[1] + ct[4]) * kernel(r_gx)
    gamma = scale * (ct[2] + ct[5] * (r_xx <= UPPER_BOUND)) * kernel(r_xx)
    g_gen = (4.0 * (alpha.sum(1, keepdim=True) * s_gen - alpha @ s_gen)
             + 2.0 * (beta.sum(1, keepdim=True) * s_gen - beta @ s_x))
    g_x = (2.0 * (beta.sum(0)[:, None] * s_x - beta.T @ s_gen)
           + 4.0 * (gamma.sum(1, keepdim=True) * s_x - gamma @ s_x))
    return g_gen, g_x


def kernel_means_backward_atol(s_gen: torch.Tensor, s_x: torch.Tensor, ct: torch.Tensor,
                               sigma: float = 1.0) -> Tuple[float, float]:
    """Absolute tolerances ``(for g_gen, for g_x)`` between two codes of the
    backward that round the raw distances differently.

    The gradient jumps where a raw distance R crosses a mask threshold: 0
    (the clamp) in all three matrices, lb in gen-gen's bounded kernel, ub in
    data-data's. A pair whose R lies within float32 rounding of a threshold,
    eps = 2 (d + 2) 2^-24 (|a_i|^2 + |a_j|^2), may be kept by one code and
    dropped by the other. That happens to many pairs of near-duplicate rows
    (the saturated regime, where R sits at 0 up to rounding). Each such pair
    moves an output row by at most its coefficient's jump times k times
    |a_i - a_j|; the tolerance of an output is the largest such sum over a
    row. It is 0 where no pair lies within eps of a threshold."""
    b, d = s_gen.shape
    scale = 1.0 / (2.0 * sigma ** 2 * b * (b - 1))
    c = ct.abs().to(s_gen.device)
    off = ~torch.eye(b, dtype=torch.bool, device=s_gen.device)
    n_g = (s_gen * s_gen).sum(1)
    n_x = (s_x * s_x).sum(1)

    def jumps(raw, n_r, n_c, factor, at_zero, bounded=None):
        eps = 2.0 * (d + 2) * 2.0 ** -24 * (n_r[:, None] + n_c[None, :])
        near = lambda t: ((raw - t).abs() <= eps).float()
        jump = at_zero * near(0.0)
        if bounded is not None:
            jump = jump + bounded[0] * near(bounded[1])
        k = torch.exp(-raw.clamp(min=0) / (2.0 * sigma ** 2))
        return factor * scale * torch.where(off, jump * k, 0.0)

    def spread(x, y):   # |x_i - y_j| in its largest feature
        return (x[:, None, :] - y[None, :, :]).abs().amax(-1)

    r_gg, r_gx, r_xx = raw_distances(s_gen, s_x)
    m_gg = jumps(r_gg, n_g, n_g, 4.0, c[0] + c[3], (c[3], LOWER_BOUND))
    m_gx = jumps(r_gx, n_g, n_x, 2.0, c[1] + c[4])
    m_xx = jumps(r_xx, n_x, n_x, 4.0, c[2] + c[5], (c[5], UPPER_BOUND))
    gx = m_gx * spread(s_gen, s_x)
    atol_gen = ((m_gg * spread(s_gen, s_gen)).sum(1) + gx.sum(1)).max()
    atol_x = (gx.sum(0) + (m_xx * spread(s_x, s_x)).sum(1)).max()
    return float(atol_gen), float(atol_x)


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
        if s_gen.is_cuda:
            g_gen, g_x = kernel_means_backward_cuda(s_gen, s_x, ct.contiguous(), ctx.sigma)
        else:
            g_gen, g_x = kernel_means_backward_reference(s_gen, s_x, ct, ctx.sigma)
        return g_gen, g_x, None


def fused_kernel_means(s_gen: torch.Tensor, s_x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Differentiable [6] kernel means: the forward and backward kernels on
    CUDA tensors, their plain versions on CPU tensors."""
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
