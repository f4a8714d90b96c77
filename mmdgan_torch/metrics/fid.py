"""FID / Inception-Score math on the host in float64 numpy: the port's copy
of ``mmdgan_tpu/metrics/fid.py:17-72`` (math_func.py:56-81, :2671-2730;
graph_func.py:1732-1746; tfgan's ``classifier_score_from_logits``)."""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

EPSI = 1e-10


def mean_cov_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sample mean and covariance (math_func.py:56-66)."""
    x = np.asarray(x, np.float64)
    mu = x.mean(axis=0)
    diff = x - mu
    cov = diff.T @ diff / (x.shape[0] - 1.0)
    return mu, cov


def sqrt_sym_mat_np(mat: np.ndarray, eps: float = EPSI) -> np.ndarray:
    """Symmetric matrix square root via SVD; singular values below ``eps``
    are kept as they are, not rooted (math_func.py:2671-2693)."""
    u, s, vt = np.linalg.svd(np.asarray(mat, np.float64))
    si = np.where(s < eps, s, np.sqrt(s))
    return u @ np.diag(si) @ vt


def trace_sqrt_product_np(cov1: np.ndarray, cov2: np.ndarray) -> float:
    """trace(sqrtm(cov1 cov2)) in the symmetric form
    trace(sqrtm(sqrtm(cov1) cov2 sqrtm(cov1))) (math_func.py:2696-2712)."""
    sqrt_cov1 = sqrt_sym_mat_np(cov1)
    return float(np.trace(sqrt_sym_mat_np(sqrt_cov1 @ cov2 @ sqrt_cov1)))


def fid_from_activations(
    x_act: Union[np.ndarray, List[np.ndarray]],
    y_act: Union[np.ndarray, List[np.ndarray]],
) -> float:
    """Fréchet distance between two activation distributions; each argument
    is an [N, D] activation matrix or a precomputed [mean, cov] pair
    (graph_func.py:1732-1746)."""
    x_mean, x_cov = x_act if isinstance(x_act, (list, tuple)) else mean_cov_np(x_act)
    y_mean, y_cov = y_act if isinstance(y_act, (list, tuple)) else mean_cov_np(y_act)
    return float(
        np.sum((x_mean - y_mean) ** 2)
        + np.trace(x_cov) + np.trace(y_cov)
        - 2.0 * trace_sqrt_product_np(x_cov, y_cov)
    )


def inception_score_from_logits(logits: np.ndarray) -> float:
    """IS = exp(E_x KL(p(y|x) || p(y))) from classifier logits."""
    logits = np.asarray(logits, np.float64)
    log_p = logits - _logsumexp(logits, axis=1, keepdims=True)
    p = np.exp(log_p)
    log_q = _logsumexp(log_p, axis=0, keepdims=True) - np.log(logits.shape[0])
    kl = np.sum(p * (log_p - log_q), axis=1)
    return float(np.exp(kl.mean()))


def _logsumexp(x, axis=None, keepdims=False):
    m = np.max(x, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return out if keepdims else np.squeeze(out, axis=axis)
