"""Pairwise squared distances between score rows (``mmdgan_tpu/ops/distance.py:25-93``).

Gram form ``max(d_i - 2 G_ij + d_j, 0)``. The Gram products must run in
full fp32, as the reference's HIGHEST-precision matmuls do: ``torch.matmul``
does so on the card while ``torch.backends.cuda.matmul.allow_tf32`` is
False, which is PyTorch's default.
"""

from __future__ import annotations

import torch


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, y.T)


def _dist_from_parts(dx: torch.Tensor, xyt: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return torch.clamp(dx[:, None] - 2.0 * xyt + dy[None, :], min=0.0)


def get_squared_dist(x: torch.Tensor, y: torch.Tensor, mode: str = "xxxyyy"):
    """Pairwise squared euclidean distances between rows of x [m, d] and
    y [n, d]. ``mode='xxxyyy'`` returns (dist_xx, dist_xy, dist_yy);
    ``mode='xy'`` returns dist_xy."""
    if x.dim() != 2:
        raise ValueError("get_squared_dist: input must be a matrix.")
    if mode == "xxxyyy":
        xxt = _gram(x, x)
        yyt = _gram(y, y)
        dx = torch.diagonal(xxt)
        dy = torch.diagonal(yyt)
        return (_dist_from_parts(dx, xxt, dx),
                _dist_from_parts(dx, _gram(x, y), dy),
                _dist_from_parts(dy, yyt, dy))
    if mode == "xy":
        dx = torch.sum(x * x, dim=1)
        dy = torch.sum(y * y, dim=1)
        return _dist_from_parts(dx, _gram(x, y), dy)
    raise ValueError(f"Mode {mode} not supported")
