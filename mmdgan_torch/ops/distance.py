"""Pairwise squared distances between score rows, their batched form for
the non-local blocks, the reference checks, and the slices of a combined
distance matrix (``mmdgan_tpu/ops/distance.py``).

Gram form ``max(d_i - 2 G_ij + d_j, 0)``. The Gram products must run in
full fp32, as the reference's HIGHEST-precision matmuls do: ``torch.matmul``
does so on the card while ``torch.backends.cuda.matmul.allow_tf32`` is
False, which is PyTorch's default.

The mixed slices of the mix-coin losses keep static shapes and never ask
the host what a mask holds (no ``t[mask]``, no ``nonzero``), so a CUDA
graph can capture them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, y.T)


def _dist_from_parts(dx: torch.Tensor, xyt: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return torch.clamp(dx[:, None] - 2.0 * xyt + dy[None, :], min=0.0)


def get_squared_dist(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None, z_score: bool = False,
                     mode: str = "xxxyyy"):
    """Pairwise squared euclidean distances between rows of x [m, d] and
    y [n, d].

    :param scale: optional [d] precision vector; d(x, y) uses x * scale . y
    :param z_score: subtract the mean of concat(x, y) first
    :param mode: 'xx' -> dist_xx (also whenever y is None); 'xy' -> dist_xy;
        'xxxy' -> (dist_xx, dist_xy); 'xxxyyy' -> (dist_xx, dist_xy, dist_yy)
    """
    if x.dim() != 2:
        raise ValueError("get_squared_dist: input must be a matrix.")
    if y is None:
        mode = "xx"
    if z_score:
        if y is None:
            x = x - torch.mean(x, dim=0, keepdim=True)
        else:
            mu = torch.mean(torch.cat([x, y], dim=0), dim=0, keepdim=True)
            x, y = x - mu, y - mu
    xs = x if scale is None else x * scale
    ys = y if y is None or scale is None else y * scale

    if mode in ("xx", "xxxy", "xxxyyy"):
        xxt = _gram(xs, x)
        dx = torch.diagonal(xxt)
        dist_xx = _dist_from_parts(dx, xxt, dx)
        if mode == "xx":
            return dist_xx
        xyt = _gram(xs, y)
        if mode == "xxxy":
            # dy without forming yyt (math_func.py:812-824)
            return dist_xx, _dist_from_parts(dx, xyt, torch.sum(ys * y, dim=1))
        yyt = _gram(ys, y)
        dy = torch.diagonal(yyt)
        return dist_xx, _dist_from_parts(dx, xyt, dy), _dist_from_parts(dy, yyt, dy)
    if mode == "xy":
        dx = torch.sum(xs * x, dim=1)
        dy = torch.sum(ys * y, dim=1)
        return _dist_from_parts(dx, _gram(xs, y), dy)
    raise ValueError(f"Mode {mode} not supported")


def get_squared_dist_ref(x: torch.Tensor, y: Optional[torch.Tensor] = None):
    """Exact but slow O(m d n) distances, a cross-check of the Gram form
    (math_func.py:861-888): dist_xx, or (dist_xx, dist_xy, dist_yy)."""
    if x.dim() != 2:
        raise ValueError("get_squared_dist_ref: input must be a matrix.")
    pair = lambda a, b: torch.sum(torch.square(a[:, None, :] - b[None, :, :]), dim=-1)  # noqa: E731
    if y is None:
        return pair(x, x)
    return pair(x, x), pair(x, y), pair(y, y)


def squared_dist_triplet(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """All pairwise distance matrices among three batches (math_func.py:892-931):
    (d_xx, d_yy, d_zz, d_xy, d_xz, d_yz)."""
    x_x, y_y, z_z = _gram(x, x), _gram(y, y), _gram(z, z)
    d_x, d_y, d_z = torch.diagonal(x_x), torch.diagonal(y_y), torch.diagonal(z_z)
    return (_dist_from_parts(d_x, x_x, d_x), _dist_from_parts(d_y, y_y, d_y),
            _dist_from_parts(d_z, z_z, d_z), _dist_from_parts(d_x, _gram(x, y), d_y),
            _dist_from_parts(d_x, _gram(x, z), d_z), _dist_from_parts(d_y, _gram(y, z), d_z))


def get_batch_squared_dist(x_batch: torch.Tensor, y_batch: Optional[torch.Tensor] = None,
                           axis: int = 1, mode: str = "xx"):
    """Batched pairwise squared distances (math_func.py:954-1023), used by
    the non-local 'dist' blocks. ``x_batch`` [N, a, b] and ``y_batch``
    [N, c, d] hold their features on ``axis`` (1 or 2); ``mode`` as in
    :func:`get_squared_dist`, returning [N, p, q] matrices."""
    assert axis in (1, 2), "axis has to be 1 or 2."
    if y_batch is not None and mode == "xx":
        mode = "xy"
    feat_last = lambda t: t.transpose(1, 2) if axis == 1 else t   # noqa: E731
    bmm = lambda u, v: torch.matmul(u, v.transpose(1, 2))         # noqa: E731
    parts = lambda da, g, db: torch.clamp(da[:, :, None] - 2.0 * g + db[:, None, :],  # noqa: E731
                                          min=0.0)
    xb = feat_last(x_batch)
    if mode in ("xx", "xxxy", "xxxyyy"):
        xxt = bmm(xb, xb)
        dx = torch.diagonal(xxt, dim1=1, dim2=2)
        dist_xx = parts(dx, xxt, dx)
        if mode == "xx":
            return dist_xx
        yb = feat_last(y_batch)
        dy = torch.sum(yb * yb, dim=2)
        dist_xy = parts(dx, bmm(xb, yb), dy)
        if mode == "xxxy":
            return dist_xx, dist_xy
        return dist_xx, dist_xy, parts(dy, bmm(yb, yb), dy)
    if mode == "xy":
        yb = feat_last(y_batch)
        return parts(torch.sum(xb * xb, dim=2), bmm(xb, yb), torch.sum(yb * yb, dim=2))
    raise ValueError(f"Mode {mode} not supported")


def get_dist_np(x, y) -> np.ndarray:
    """Numpy pairwise euclidean distances (math_func.py:935-950); the
    reference returns the square root here."""
    x = np.array(x, dtype=np.float32)
    y = np.array(y, dtype=np.float32)
    return np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1), dtype=np.float32)


def _true_first(mask: torch.Tensor) -> torch.Tensor:
    """``argsort(~mask, stable=True)``: the positions where ``mask`` is True
    in order, then those where it is False in order. Each position's slot
    comes from a cumulative sum, and the slots are inverted by an n x n
    comparison: no sort, no scatter, no host read."""
    m = mask.long()
    slot = torch.where(mask, torch.cumsum(m, 0) - 1, m.sum() + torch.cumsum(1 - m, 0) - 1)
    pos = torch.arange(mask.shape[0], device=mask.device)
    return ((slot[None, :] == pos[:, None]).long() * pos[None, :]).sum(1)


def mat_slice(mat: torch.Tensor, row_mask: torch.Tensor,
              col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The square sub-matrix of ``mat`` on the first ``k = n // 2`` rows
    (and columns) where the masks are True, as the JAX package takes it
    (``argsort(~mask, stable=True)[:k]``). The masks of
    :func:`slice_pairwise_distance` hold exactly k True entries."""
    k = mat.shape[0] // 2
    rows = _true_first(row_mask)[:k]
    cols = rows if col_mask is None else _true_first(col_mask)[:k]
    return mat.index_select(0, rows).index_select(1, cols)


def slice_pairwise_distance(pair_dist: torch.Tensor, batch_size: Optional[int] = None,
                            indices: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A 2B x 2B pairwise-distance matrix as its (g1, g1g2, g2) blocks. With
    ``indices`` (a [B] boolean vector) the groups are mixed: group 1 takes
    row i of the first half where indices[i], else row i of the second."""
    if indices is None:
        b = batch_size
        return pair_dist[:b, :b], pair_dist[:b, b:], pair_dist[b:, b:]
    group_1 = torch.cat([indices, ~indices], dim=0)
    group_2 = torch.cat([~indices, indices], dim=0)
    return (mat_slice(pair_dist, group_1), mat_slice(pair_dist, group_1, group_2),
            mat_slice(pair_dist, group_2))
