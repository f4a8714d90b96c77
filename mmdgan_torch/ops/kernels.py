"""The MMD kernel family (``mmdgan_tpu/ops/kernels.py:37-534``): Gaussian,
bounded Gaussian ('rmb'), t-kernel, Cramér, the witness functions, the
closed-form MMD against a reference normal, and the adaptive-bandwidth
``rand_*`` family with its Newton solve of the bandwidth ``beta``.

``custom_weights=[w0, w1]`` (w0 - w1 == 1) gives the repulsive pair
``(mmd1, mmd2)`` = (generator loss, discriminator loss
``w0*e_kxy - e_kxx - w1*e_kyy``), where k_yy is the *real* data kernel.
``with_aux=True`` appends the kernel means (and ``beta``) as a dict.

The reference's quirks are kept: the witness functions and ``mmd_g_xn``
divide by ``2 sigma``, not ``2 sigma^2``; the Newton-solved ``beta`` is not
detached, so gradients flow through its iterations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mmdgan_torch.ops.distance import get_squared_dist

EPSI = 1e-10


def matrix_mean_wo_diagonal(matrix: torch.Tensor, num_row: float) -> torch.Tensor:
    """Mean of a square matrix's entries off the diagonal."""
    diag_sum = torch.sum(torch.diagonal(matrix))
    return (torch.sum(matrix) - diag_sum) / (num_row * (num_row - 1.0))


def _means(k_xx, k_xy, k_yy, batch_size):
    m = float(batch_size)
    return {"e_kxx": matrix_mean_wo_diagonal(k_xx, m),
            "e_kxy": matrix_mean_wo_diagonal(k_xy, m),
            "e_kyy": matrix_mean_wo_diagonal(k_yy, m)}


def _with_var_target(aux, var_target, with_aux):
    """(mmd, loss) with loss = (var - var_target)^2, var = e_kxx + e_kyy +
    2 e_kxy: the trainable-bandwidth variant."""
    e_kxx, e_kxy, e_kyy = aux["e_kxx"], aux["e_kxy"], aux["e_kyy"]
    mmd = e_kxx + e_kyy - 2.0 * e_kxy
    loss = torch.square(e_kxx + e_kyy + 2.0 * e_kxy - var_target)
    return (mmd, loss, aux) if with_aux else (mmd, loss)


def mmd_g(
    dist_xx: torch.Tensor,
    dist_xy: torch.Tensor,
    dist_yy: torch.Tensor,
    batch_size: int,
    sigma: float = 1.0,
    var_target: Optional[float] = None,
    upper_bound: Optional[float] = None,
    lower_bound: Optional[float] = None,
    custom_weights: Optional[Sequence[float]] = None,
    with_aux: bool = False,
):
    """Gaussian-kernel MMD; the repulsive pair with ``custom_weights``;
    ``(mmd, loss_sigma)`` with ``var_target``. ``lower_bound`` clamps d_xx
    and d_yy from below, ``upper_bound`` d_xy from above ('mgb')."""
    two_sigma2 = 2.0 * sigma ** 2
    if lower_bound is None:
        k_xx = torch.exp(-dist_xx / two_sigma2)
        k_yy = torch.exp(-dist_yy / two_sigma2)
    else:
        k_xx = torch.exp(-torch.clamp(dist_xx, min=lower_bound) / two_sigma2)
        k_yy = torch.exp(-torch.clamp(dist_yy, min=lower_bound) / two_sigma2)
    if upper_bound is None:
        k_xy = torch.exp(-dist_xy / two_sigma2)
    else:
        k_xy = torch.exp(-torch.clamp(dist_xy, max=upper_bound) / two_sigma2)
    aux = _means(k_xx, k_xy, k_yy, batch_size)
    if var_target is not None:
        return _with_var_target(aux, var_target, with_aux)
    e_kxx, e_kxy, e_kyy = aux["e_kxx"], aux["e_kxy"], aux["e_kyy"]
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
    var_target: Optional[float] = None,
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
    aux = _means(k_xx, k_xy, k_yy, batch_size)
    aux["e_kxx_b"] = matrix_mean_wo_diagonal(k_xx_b, m)
    aux["e_kxy_b"] = (matrix_mean_wo_diagonal(k_xy_b, m) if custom_weights[0] < 0
                      else aux["e_kxy"])
    aux["e_kyy_b"] = matrix_mean_wo_diagonal(k_yy_b, m)
    if var_target is not None:
        return _with_var_target(aux, var_target, with_aux)
    assert custom_weights[0] - custom_weights[1] == 1.0, "w[0]-w[1] must be 1"
    mmd1 = aux["e_kxx"] + aux["e_kyy"] - 2.0 * aux["e_kxy"]
    mmd2 = (custom_weights[0] * aux["e_kxy_b"] - aux["e_kxx_b"]
            - custom_weights[1] * aux["e_kyy_b"])
    return (mmd1, mmd2, aux) if with_aux else (mmd1, mmd2)


def _mixture(fn, dist_xx, dist_xy, dist_yy, batch_size, prefix, kwargs_list,
             var_targets, with_aux):
    """Sum of ``fn`` over a list of kernel parameters, with per-parameter
    kernel means keyed ``{prefix}_{i}/e_k**``."""
    mmd, loss, aux = 0.0, 0.0, {}
    targets = [None] * len(kwargs_list) if var_targets is None else list(var_targets)
    for i, (kw, vt) in enumerate(zip(kwargs_list, targets)):
        out = fn(dist_xx, dist_xy, dist_yy, batch_size, var_target=vt, with_aux=True, **kw)
        mmd = mmd + out[0]
        if vt is not None:
            loss = loss + out[1]
        aux.update({f"{prefix}_{i}/{k}": v for k, v in out[-1].items()})
    if var_targets is None:
        return (mmd, aux) if with_aux else mmd
    return (mmd, loss, aux) if with_aux else (mmd, loss)


def mixture_mmd_g(dist_xx, dist_xy, dist_yy, batch_size, sigma: Sequence[float],
                  var_targets: Optional[Sequence[float]] = None, with_aux: bool = False):
    """Sum of Gaussian-kernel MMDs over a sigma list; per-sigma kernel
    means under ``sigma_{i}/``."""
    return _mixture(mmd_g, dist_xx, dist_xy, dist_yy, batch_size, "sigma",
                    [{"sigma": s} for s in sigma], var_targets, with_aux)


def mmd_t(dist_xx, dist_xy, dist_yy, batch_size, alpha: float = 1.0, beta: float = 2.0,
          var_target: Optional[float] = None, with_aux: bool = False):
    """MMD with the inverse-multiquadratic (t-distribution) kernel
    ``(1 + d / (beta alpha))^-alpha``, in log form."""
    k = lambda d: torch.exp(-alpha * torch.log(d / (beta * alpha) + 1.0))
    aux = _means(k(dist_xx), k(dist_xy), k(dist_yy), batch_size)
    if var_target is not None:
        return _with_var_target(aux, var_target, with_aux)
    mmd = aux["e_kxx"] + aux["e_kyy"] - 2.0 * aux["e_kxy"]
    return (mmd, aux) if with_aux else mmd


def mixture_mmd_t(dist_xx, dist_xy, dist_yy, batch_size, alpha: Sequence[float],
                  beta: float = 2.0, var_targets: Optional[Sequence[float]] = None,
                  with_aux: bool = False):
    """Sum of t-kernel MMDs over an alpha list; per-alpha kernel means
    under ``alpha_{i}/``."""
    return _mixture(mmd_t, dist_xx, dist_xy, dist_yy, batch_size, "alpha",
                    [{"alpha": a, "beta": beta} for a in alpha], var_targets, with_aux)


def cramer(dist_xx, dist_xy, dist_yy, batch_size, epsi: float = 1e-16,
           with_aux: bool = False):
    """Energy distance without independent sample pairs."""
    k = lambda d: -torch.sqrt(d + epsi)
    aux = _means(k(dist_xx), k(dist_xy), k(dist_yy), batch_size)
    mmd = aux["e_kxx"] + aux["e_kyy"] - 2.0 * aux["e_kxy"]
    return (mmd, aux) if with_aux else mmd


# ---------------------------------------------------------------------------
# witness functions (the MMD gradient penalties)
# ---------------------------------------------------------------------------

def witness_g(dist_zx, dist_zy, sigma: float = 2.0):
    """Gaussian witness f(z) = E k(x, z) - E k(y, z); divides by 2 sigma."""
    k_zx = torch.exp(-dist_zx / (2.0 * sigma))
    k_zy = torch.exp(-dist_zy / (2.0 * sigma))
    return torch.mean(k_zx, dim=1) - torch.mean(k_zy, dim=1)


def witness_mix_g(dist_zx, dist_zy, sigma: Sequence[float]):
    return sum(witness_g(dist_zx, dist_zy, sigma=s) for s in sigma)


def witness_t(dist_zx, dist_zy, alpha: float = 1.0, beta: float = 2.0):
    k = lambda d: torch.exp(-alpha * torch.log(d / (beta * alpha) + 1.0))
    return torch.mean(k(dist_zx), dim=1) - torch.mean(k(dist_zy), dim=1)


def witness_mix_t(dist_zx, dist_zy, alpha: Sequence[float], beta: float = 2.0):
    return sum(witness_t(dist_zx, dist_zy, alpha=a, beta=beta) for a in alpha)


# ---------------------------------------------------------------------------
# closed-form MMD against a reference normal
# ---------------------------------------------------------------------------

def mmd_g_xn(batch_size: int, d: int, sigma: float, x: torch.Tensor,
             dist_xx: Optional[torch.Tensor] = None, y_mu: float = 0.0, y_var: float = 1.0):
    """MMD between x and N(y_mu, y_var I) in closed form; divides d_xx by
    2 sigma."""
    if dist_xx is None:
        dist_xx = get_squared_dist(x, mode="xx")
    dist_xy = torch.sum(torch.square(x - y_mu), dim=1)
    k_xx = torch.exp(-dist_xx / (2.0 * sigma))
    k_xy = torch.exp(-dist_xy / (2.0 * (sigma + y_var))) * (sigma / (sigma + y_var)) ** (d / 2.0)
    e_kxx = matrix_mean_wo_diagonal(k_xx, float(batch_size))
    e_kyy = (sigma / (sigma + 2.0 * y_var)) ** (d / 2.0)
    return e_kxx + e_kyy - 2.0 * torch.mean(k_xy)


def mixture_g_xn(batch_size, d, sigma: Sequence[float], x, dist_xx=None, y_mu=0.0, y_var=1.0):
    return sum(mmd_g_xn(batch_size, d, s, x, dist_xx=dist_xx, y_mu=y_mu, y_var=y_var)
               for s in sigma)


# ---------------------------------------------------------------------------
# the adaptive-bandwidth rand_* family (Newton's method on beta)
# ---------------------------------------------------------------------------

def _newton_iters(beta0, f_df, max_iter: int):
    """``max_iter`` Newton updates b <- b - f(b) / f'(b), not detached: the
    counterpart of the reference's ``fori_loop``."""
    beta = beta0
    for _ in range(max_iter):
        fx, gx = f_df(beta)
        beta = beta - fx / (gx + EPSI)
    return beta


def rand_mmd_g(dist_all, batch_size: int, omega: float = 0.5, max_iter: int = 0):
    """Global-bandwidth MMD on a combined 2B x 2B distance matrix: beta
    solved so the mean off-diagonal kernel value matches omega."""
    m = float(batch_size)

    def f_df(b):
        k = torch.exp(-dist_all * b)
        return (matrix_mean_wo_diagonal(k, 2 * m) - omega,
                matrix_mean_wo_diagonal(-k * dist_all, 2 * m))

    beta = -torch.log(torch.as_tensor(omega, dtype=dist_all.dtype, device=dist_all.device)) / (
        matrix_mean_wo_diagonal(dist_all, 2 * m) + EPSI)
    beta = _newton_iters(beta, f_df, max_iter)
    k_all = torch.exp(-dist_all * beta)
    b = batch_size
    e = lambda k: matrix_mean_wo_diagonal(k, m)
    return e(k_all[:b, :b]) + e(k_all[b:, b:]) - e(k_all[:b, b:]) - e(k_all[b:, :b])


def _mean_maybe_wo_diag(k, batch_size):
    return torch.mean(k) if batch_size is None else matrix_mean_wo_diagonal(k, float(batch_size))


def _solve_beta(dist_xy, dist_yx, omega, max_iter):
    """The Newton-solved bandwidth of ``rand_mmd_g_xy`` and its bounded
    sibling: mean k(d_xy) (and k(d_yx)) matched to omega."""
    log_omega = torch.log(torch.as_tensor(omega, dtype=dist_xy.dtype, device=dist_xy.device))
    if dist_yx is None:
        def f_df(b):
            k = torch.exp(-dist_xy * b)
            return torch.mean(k) - omega, torch.mean(-k * dist_xy)
        beta = -log_omega / torch.mean(dist_xy + EPSI)
    else:
        def f_df(b):
            k0 = torch.exp(-dist_xy * b)
            k1 = torch.exp(-dist_yx * b)
            return (torch.mean(k0) + torch.mean(k1) - 2.0 * omega,
                    torch.mean(-k0 * dist_xy) + torch.mean(-k1 * dist_yx))
        beta = -2.0 * log_omega / (torch.mean(dist_xy) + torch.mean(dist_yx) + EPSI)
    return _newton_iters(beta, f_df, max_iter)


def rand_mmd_g_xy(dist_xx, dist_xy, dist_yy, batch_size: Optional[int] = None,
                  dist_yx=None, omega: float = 0.5, max_iter: int = 3, with_aux: bool = False):
    """Adaptive-bandwidth Gaussian MMD; ``with_aux`` adds ``beta`` to the
    kernel means."""
    beta = _solve_beta(dist_xy, dist_yx, omega, max_iter)
    e = lambda d: _mean_maybe_wo_diag(torch.exp(-d * beta), batch_size)
    aux = {"beta": beta, "e_kxx": e(dist_xx), "e_kxy": e(dist_xy), "e_kyy": e(dist_yy)}
    if dist_yx is None:
        mmd = aux["e_kxx"] + aux["e_kyy"] - 2.0 * aux["e_kxy"]
    else:
        aux["e_kyx"] = e(dist_yx)
        mmd = aux["e_kxx"] + aux["e_kyy"] - aux["e_kxy"] - aux["e_kyx"]
    return (mmd, aux) if with_aux else mmd


def rand_mmd_g_xy_bounded(dist_xx, dist_xy, dist_yy, batch_size: Optional[int] = None,
                          dist_yx=None, omega: float = 0.5, max_iter: int = 3,
                          beta_lb: float = 0.125, beta_ub: float = 2.0, with_aux: bool = False):
    """Adaptive-bandwidth MMD with beta clipped to [beta_lb, beta_ub] and
    bounded kernels at d_lb = 0.125 / beta, d_ub = 2 / beta ('rgb').
    Returns (mmd, bounded_loss) when dist_yx is None."""
    beta = torch.clamp(_solve_beta(dist_xy, dist_yx, omega, max_iter), beta_lb, beta_ub)
    e = lambda k: _mean_maybe_wo_diag(k, batch_size)
    aux = {"beta": beta,
           "e_kxx": e(torch.exp(-dist_xx * beta)),
           "e_kxy": e(torch.exp(-dist_xy * beta)),
           "e_kyy": e(torch.exp(-dist_yy * beta)),
           "e_kxx_b": e(torch.exp(-torch.maximum(dist_xx, 0.125 / beta) * beta)),
           "e_kxy_b": e(torch.exp(-torch.minimum(dist_xy, 2.0 / beta) * beta)),
           "e_kyy_b": e(torch.exp(-torch.maximum(dist_yy, 0.125 / beta) * beta))}
    if dist_yx is None:
        out = (aux["e_kxx"] + aux["e_kyy"] - 2.0 * aux["e_kxy"],
               aux["e_kxx_b"] - 2.0 * aux["e_kyy_b"] + aux["e_kxy_b"])
        return out + (aux,) if with_aux else out
    aux["e_kyx"] = e(torch.exp(-dist_yx * beta))
    mmd = aux["e_kxx"] + aux["e_kyy"] - aux["e_kxy"] - aux["e_kyx"]
    return (mmd, aux) if with_aux else mmd


def rand_mmd_g_xn(x: torch.Tensor, y_rho: float, batch_size: int, d: int, y_mu: float = 0.0,
                  dist_xx: Optional[torch.Tensor] = None, omega: float = 0.5, max_iter: int = 0,
                  with_aux: bool = False):
    """Adaptive-bandwidth MMD between x and a reference normal; the
    x-vs-normal expectation has a closed form."""
    if dist_xx is None:
        dist_xx = get_squared_dist(x, mode="xx")
    dist_xy = torch.sum(torch.square(x - y_mu), dim=1)

    def f_df(b):
        const_f = d / (d + b * y_rho)
        k = torch.pow(const_f, d / 2.0) * torch.exp(-b * const_f * dist_xy)
        e_k = torch.mean(k)
        # the reference's gradient formula (math_func.py:1939-1942)
        kd = -y_rho * const_f / 2.0 * e_k - torch.mean(torch.pow(const_f, 2) * dist_xy * k)
        return e_k - omega, torch.mean(kd)

    log_omega = torch.log(torch.as_tensor(omega, dtype=x.dtype, device=x.device))
    beta = -log_omega / (torch.mean(dist_xy) + y_rho / 2.0)
    beta = _newton_iters(beta, f_df, max_iter)
    const_0 = d / (d + beta * y_rho)
    e_kxx = matrix_mean_wo_diagonal(torch.exp(-dist_xx * beta), float(batch_size))
    e_kxy = torch.mean(torch.pow(const_0, d / 2.0) * torch.exp(-beta * const_0 * dist_xy))
    e_kyy = torch.pow(d / (d + 2.0 * beta * y_rho), d / 2.0)
    mmd = e_kxx + e_kyy - 2.0 * e_kxy
    if with_aux:
        return mmd, {"beta": beta, "e_kxx": e_kxx, "e_kxy": e_kxy, "e_kyy": e_kyy}
    return mmd
