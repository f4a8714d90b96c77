"""MeshCode: latent-code grids for evaluation sampling
(``mmdgan_tpu/ops/mesh_code.py:24-108``; math_func.py:9-36, 140-168,
219-352), in numpy.

Random draws come from an explicit ``torch.Generator`` (on the CPU; one
seeded 0 when none is given), where JAX takes a key; ``by_sine`` takes its
support codes and ``by_feature`` its permutation as arguments, so a caller
can pass codes of its own (or JAX's draws) instead.

Modes (math_func.py:235-245):
  0 / 'random'  - z ~ N(0, 1)
  1 / 'sine'    - a sine-interpolated 2-D manifold between 4 support codes
  2 / 'feature' - per-feature sweeps over [-grid, grid]
plus ``simple_grid`` for 2-D codes.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

Array = np.ndarray


def kron_by_reshape(mat1: Array, mat2: Array) -> Array:
    """Kronecker product via reshape and transpose (math_func.py:9-36)."""
    a, b = mat1.shape
    c, d = mat2.shape
    mat3 = np.matmul(np.reshape(mat1, [-1, 1]), np.reshape(mat2, [1, -1]))
    mat3 = np.reshape(mat3, [a, b, c, d])
    mat3 = np.transpose(mat3, axes=[0, 2, 1, 3])
    return np.reshape(mat3, [a * c, b * d])


def slerp(p0: Array, p1: Array, t: Union[float, Array]) -> Array:
    """Spherical linear interpolation (math_func.py:140-168)."""
    from numpy.linalg import norm

    theta = np.arccos(np.clip(np.dot(p0 / norm(p0), p1 / norm(p1)), -1.0, 1.0))
    st = np.sin(theta)
    if not np.isscalar(t):
        p0 = np.expand_dims(p0, axis=0)
        p1 = np.expand_dims(p1, axis=0)
        t = np.expand_dims(np.asarray(t), axis=1)
    if st > 0.1:
        return np.sin((1.0 - t) * theta) / st * p0 + np.sin(t * theta) / st * p1
    return (1.0 - t) * p0 + t * p1


class MeshCode:
    def __init__(self, code_length: int, mesh_num: Optional[Tuple[int, int]] = None):
        self.D = code_length
        self.mesh_num = (10, 10) if mesh_num is None else tuple(mesh_num)

    def get_batch(self, mesh_mode, generator: Optional[torch.Generator] = None) -> Array:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if mesh_mode in (0, "random"):
            return self.by_random(generator)
        if mesh_mode in (1, "sine"):
            return self.by_sine(generator=generator)
        if mesh_mode in (2, "feature"):
            return self.by_feature(generator=generator)
        raise ValueError("mesh_mode is not supported.")

    def by_random(self, generator: Optional[torch.Generator] = None) -> Array:
        n = self.mesh_num[0] * self.mesh_num[1]
        return torch.randn((n, self.D), generator=generator).numpy()

    def by_sine(self, z_support: Optional[Array] = None,
                generator: Optional[torch.Generator] = None) -> Array:
        """Sine interpolation between 4 support codes [4, D]
        (math_func.py:259-295), drawn from ``generator`` when not given."""
        if z_support is None:
            z_support = torch.randn((4, self.D), generator=generator).numpy()
        z_support = np.asarray(z_support, np.float32)
        z0, z1, z2, z3 = (z_support[i][None, :] for i in range(4))
        mesh_phi = np.float32(
            np.expand_dims(np.pi / 4.0 * np.linspace(0.0, 1.0, self.mesh_num[0]), 1))
        mesh_psi = np.float32(
            np.expand_dims(np.pi / 4.0 * np.linspace(0.0, 1.0, self.mesh_num[1]), 1))
        return (
            kron_by_reshape(
                np.cos(mesh_psi) @ z0 + np.sin(mesh_psi) @ z1, np.cos(mesh_phi))
            + kron_by_reshape(
                np.cos(mesh_psi) @ z2 + np.sin(mesh_psi) @ z3, np.sin(mesh_phi))
        ).astype(np.float32)

    def by_feature(self, grid: float = 2.0, generator: Optional[torch.Generator] = None,
                   perm: Optional[Array] = None) -> Array:
        """One-hot feature sweeps (math_func.py:297-318), the feature
        dimensions shuffled by ``perm`` or by a permutation drawn from
        ``generator``; unshuffled when neither is given."""
        mesh = np.float32(np.expand_dims(np.linspace(-grid, grid, self.mesh_num[1]), 1))
        z_batch = kron_by_reshape(np.eye(self.mesh_num[0], self.D, dtype=np.float32), mesh)
        if perm is None and generator is not None:
            perm = torch.randperm(self.D, generator=generator).numpy()
        if perm is not None:
            z_batch = z_batch[:, np.asarray(perm)]
        return z_batch.astype(np.float32)

    def simple_grid(self, grid: Optional[Array] = None):
        """2-D grid (math_func.py:320-338); returns (z, x, y)."""
        if self.D != 2:
            raise ValueError("Code length has to be two")
        if grid is None:
            grid = np.array([[-1.0, 1.0], [-1.0, 1.0]], dtype=np.float32)
        x = np.linspace(grid[0][0], grid[0][1], self.mesh_num[0])
        y = np.linspace(grid[1][0], grid[1][1], self.mesh_num[1])
        z0 = np.reshape(np.transpose(np.tile(x, (self.mesh_num[1], 1))), [-1, 1])
        z1 = np.reshape(np.tile(y, (1, self.mesh_num[0])), [-1, 1])
        return np.concatenate((z0, z1), axis=1).astype(np.float32), x, y
