"""SimData: samplable toy distributions (normal, gaussian mixture, shell,
shell2, star, uniform) with an optional random semi-orthogonal projection
to higher dimensions, and their prob/log_prob; the port's own copy of
``mmdgan_tpu/data/simdata.py`` (``input_func.py:969-1163``).

Draws come from ``np.random.RandomState(seed)`` in the JAX package's
order, so the two packages' draws from one seed are bitwise equal. The
batches are numpy on the host; a caller moves them to its device. Used to
check that the MMD losses fit data with a known target.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _as_cov(std_or_cov: np.ndarray) -> np.ndarray:
    """[d] std vector -> diag cov; [d,d] cov -> itself."""
    std_or_cov = np.asarray(std_or_cov, np.float64)
    if std_or_cov.ndim == 1:
        return np.diag(std_or_cov ** 2)
    return std_or_cov


class SimData:
    def __init__(
        self,
        method: str,
        batch_size: int = 64,
        x_dof: Optional[int] = None,
        z_dof: Optional[int] = None,
        probs: Optional[Sequence[float]] = None,
        mu=None,
        std_or_cov=None,
        low: float = 0.0,
        high: float = 1.0,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.D = x_dof
        self.d = z_dof
        self.rng = np.random.RandomState(seed)
        self.w = None
        if self.d is not None and self.D is not None and self.d != self.D:
            # random semi-orthogonal projection (input_func.py:1017-1025)
            g = self.rng.randn(self.d, self.D)
            u, _, vt = np.linalg.svd(g, full_matrices=False)
            self.w = (u @ vt).astype(np.float32)

        self.method = method
        self.kind = None       # 'gm' | 'uniform'
        self.low, self.high = low, high
        if method in ("normal", "gaussian"):
            self._set_gm([1.0], np.asarray(mu, np.float64)[None, :],
                         _as_cov(std_or_cov)[None, :, :])
        elif method in ("gaussian_mixture", "gm"):
            std_or_cov = np.asarray(std_or_cov, np.float64)
            if std_or_cov.ndim == 2:  # [C, d] stds
                covs = np.stack([np.diag(s ** 2) for s in std_or_cov])
            else:
                covs = std_or_cov
            self._set_gm(probs, np.asarray(mu, np.float64), covs)
        elif method == "shell":
            self._shell()
        elif method == "shell2":
            self._shell2()
        elif method == "star":
            self._star()
        elif method in ("uniform", "uni", "u"):
            self.kind = "uniform"
        else:
            raise NotImplementedError(f"{method} distribution not implemented yet.")

    # ------------------------------------------------------------------
    def _set_gm(self, probs, mus, covs):
        self.kind = "gm"
        self.probs = np.asarray(probs, np.float64)
        self.probs = self.probs / self.probs.sum()
        self.mus = np.asarray(mus, np.float64)
        self.covs = np.asarray(covs, np.float64)
        self._chols = np.linalg.cholesky(self.covs)

    def _shell(self):
        """8-Gaussian ring (input_func.py:1078-1095)."""
        c1 = 0.707106
        c2 = [[0.03, 0.0], [0.0, 0.03]]
        c3 = [[0.04, 0.0395], [0.0395, 0.04]]
        c4 = [[0.04, -0.0395], [-0.0395, 0.04]]
        probs = [0.125] * 8
        mu = [[1.0, 0.0], [c1, c1], [0.0, 1.0], [-c1, c1],
              [-1.0, 0.0], [-c1, -c1], [0.0, -1.0], [c1, -c1]]
        cov = [c2, c3, c2, c4, c2, c3, c2, c4]
        self._set_gm(probs, np.asarray(mu) / 1.5, np.asarray(cov) / 2.25)

    def _shell2(self):
        """Ring with axis-aligned elongated components (input_func.py:1097-1115)."""
        c1 = 0.707106
        c2 = [[0.03, 0.0], [0.0, 0.03]]
        c3 = [[0.04, 0.0], [0.0, 0.0005]]
        c4 = [[0.0005, 0.0], [0.0, 0.04]]
        probs = [0.125] * 8
        mu = [[c1, 0.0], [c1, c1], [0.0, c1], [-c1, c1],
              [-c1, 0.0], [-c1, -c1], [0.0, -c1], [c1, -c1]]
        cov = [c3, c2, c4, c2, c3, c2, c4, c2]
        self._set_gm(probs, np.asarray(mu) / 1.5, np.asarray(cov) / 2.25)

    def _star(self):
        """8 tight Gaussians on a star (input_func.py:1117-1131)."""
        c1 = 0.8
        c2 = c1 * np.tan(22.5 / 180.0 * np.pi)
        c3 = [[0.001, 0.0], [0.0, 0.001]]
        probs = [0.125] * 8
        mu = [[c2, c1], [c1, c2], [c1, -c2], [c2, -c1],
              [-c2, -c1], [-c1, -c2], [-c1, c2], [-c2, c1]]
        self._set_gm(probs, np.asarray(mu), np.asarray([c3] * 8))

    # ------------------------------------------------------------------
    def next_batch(self, batch_size: Optional[int] = None) -> np.ndarray:
        if batch_size is None:
            batch_size = self.batch_size
        if self.kind == "gm":
            comp = self.rng.choice(len(self.probs), size=batch_size, p=self.probs)
            eps = self.rng.randn(batch_size, self.mus.shape[1])
            z = self.mus[comp] + np.einsum("nij,nj->ni", self._chols[comp], eps)
        elif self.kind == "uniform":
            d = self.d or self.D or 2
            z = self.rng.uniform(self.low, self.high, size=(batch_size, d))
        z = z.astype(np.float32)
        if self.w is not None:
            z = z @ self.w
        return z

    def __call__(self, batch_size: Optional[int] = None) -> np.ndarray:
        return self.next_batch(batch_size)

    # ------------------------------------------------------------------
    def log_prob(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self.kind == "uniform":
            in_range = np.all((x >= self.low) & (x <= self.high), axis=-1)
            d = x.shape[-1]
            return np.where(
                in_range, -d * np.log(self.high - self.low), -np.inf
            )
        d = self.mus.shape[1]
        log_comps = []
        for p, mu, cov in zip(self.probs, self.mus, self.covs):
            diff = x - mu
            inv = np.linalg.inv(cov)
            _, logdet = np.linalg.slogdet(cov)
            quad = np.einsum("ni,ij,nj->n", diff, inv, diff)
            log_comps.append(
                np.log(p) - 0.5 * (d * np.log(2 * np.pi) + logdet + quad)
            )
        m = np.stack(log_comps)  # [C, N]
        mx = m.max(axis=0)
        return mx + np.log(np.exp(m - mx).sum(axis=0))

    def prob(self, x: np.ndarray) -> np.ndarray:
        return np.exp(self.log_prob(x))
