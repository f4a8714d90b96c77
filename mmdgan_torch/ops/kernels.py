"""Gaussian-kernel MMD, plain and bounded (``mmdgan_tpu/ops/kernels.py:37-162``).

``custom_weights=[w0, w1]`` (w0 - w1 == 1) gives the repulsive pair
``(mmd1, mmd2)`` = (generator loss, discriminator loss
``w0*e_kxy - e_kxx - w1*e_kyy``), where k_yy is the *real* data kernel.
``with_aux=True`` appends the kernel means as a dict.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def matrix_mean_wo_diagonal(matrix: torch.Tensor, num_row: float) -> torch.Tensor:
    """Mean of a square matrix's entries off the diagonal."""
    diag_sum = torch.sum(torch.diagonal(matrix))
    return (torch.sum(matrix) - diag_sum) / (num_row * (num_row - 1.0))


def mmd_g(
    dist_xx: torch.Tensor,
    dist_xy: torch.Tensor,
    dist_yy: torch.Tensor,
    batch_size: int,
    sigma: float = 1.0,
    custom_weights: Optional[Sequence[float]] = None,
    with_aux: bool = False,
):
    """Gaussian-kernel MMD; the repulsive pair with ``custom_weights``."""
    two_sigma2 = 2.0 * sigma ** 2
    k_xx = torch.exp(-dist_xx / two_sigma2)
    k_yy = torch.exp(-dist_yy / two_sigma2)
    k_xy = torch.exp(-dist_xy / two_sigma2)
    m = float(batch_size)
    e_kxx = matrix_mean_wo_diagonal(k_xx, m)
    e_kxy = matrix_mean_wo_diagonal(k_xy, m)
    e_kyy = matrix_mean_wo_diagonal(k_yy, m)
    aux = {"e_kxx": e_kxx, "e_kxy": e_kxy, "e_kyy": e_kyy}
    mmd1 = e_kxx + e_kyy - 2.0 * e_kxy
    if custom_weights is None:
        return (mmd1, aux) if with_aux else mmd1
    assert custom_weights[0] - custom_weights[1] == 1.0, "w[0]-w[1] must be 1"
    mmd2 = custom_weights[0] * e_kxy - e_kxx - custom_weights[1] * e_kyy
    return (mmd1, mmd2, aux) if with_aux else (mmd1, mmd2)


def mmd_g_bounded(
    dist_xx: torch.Tensor,
    dist_xy: torch.Tensor,
    dist_yy: torch.Tensor,
    batch_size: int,
    sigma: float = 1.0,
    upper_bound: float = 4.0,
    lower_bound: float = 0.25,
    custom_weights: Optional[Sequence[float]] = None,
    with_aux: bool = False,
):
    """The 'rmb' pair: the generator loss uses plain kernels; the
    discriminator loss uses ``k_xx_b = exp(-max(d_xx, lb)/2s^2)`` and, in
    the repulsive direction (w1 <= 0), ``k_yy_b = exp(-min(d_yy, ub)/2s^2)``."""
    assert custom_weights is not None, "mmd_g_bounded requires custom_weights"
    two_sigma2 = 2.0 * sigma ** 2
    k_xx = torch.exp(-dist_xx / two_sigma2)
    k_yy = torch.exp(-dist_yy / two_sigma2)
    k_xy = torch.exp(-dist_xy / two_sigma2)
    k_xx_b = torch.exp(-torch.clamp(dist_xx, min=lower_bound) / two_sigma2)
    if custom_weights[0] > 0:
        k_xy_b = torch.exp(-torch.clamp(dist_xy, max=upper_bound) / two_sigma2)
    else:  # no lower bound: k_xy may be zero at equilibrium
        k_xy_b = k_xy
    if custom_weights[1] > 0:  # original mmd-g direction
        k_yy_b = torch.exp(-torch.clamp(dist_yy, min=lower_bound) / two_sigma2)
    else:  # repulsive direction
        k_yy_b = torch.exp(-torch.clamp(dist_yy, max=upper_bound) / two_sigma2)

    m = float(batch_size)
    e_kxx = matrix_mean_wo_diagonal(k_xx, m)
    e_kxy = matrix_mean_wo_diagonal(k_xy, m)
    e_kyy = matrix_mean_wo_diagonal(k_yy, m)
    e_kxx_b = matrix_mean_wo_diagonal(k_xx_b, m)
    e_kyy_b = matrix_mean_wo_diagonal(k_yy_b, m)
    e_kxy_b = matrix_mean_wo_diagonal(k_xy_b, m) if custom_weights[0] < 0 else e_kxy
    aux = {"e_kxx": e_kxx, "e_kxy": e_kxy, "e_kyy": e_kyy,
           "e_kxx_b": e_kxx_b, "e_kxy_b": e_kxy_b, "e_kyy_b": e_kyy_b}
    assert custom_weights[0] - custom_weights[1] == 1.0, "w[0]-w[1] must be 1"
    mmd1 = e_kxx + e_kyy - 2.0 * e_kxy
    mmd2 = custom_weights[0] * e_kxy_b - e_kxx_b - custom_weights[1] * e_kyy_b
    return (mmd1, mmd2, aux) if with_aux else (mmd1, mmd2)
