"""Sliced Wasserstein distance between image batches
(``mmdgan_tpu/metrics/swd.py:21-104``): Laplacian-pyramid patch
descriptors and the 1-D Wasserstein distance over random unit projections
(Karras et al. 2018, appendix A).

The draws (patch indices, then directions, level by level) come from an
explicit ``torch.Generator``; ``draws`` passes them in instead, so the
deterministic parts can be held against JAX's on JAX's own draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import DeviceLike
from mmdgan_torch.metrics._device import as_float, metric_device

# (batch, row, column) indices of one batch's patches
PatchIndex = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _gauss_kernel5() -> np.ndarray:
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    k2 = np.outer(k, k)
    return (k2 / k2.sum()).astype(np.float32)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur of NHWC ``x``, SAME with zero padding."""
    c = x.shape[-1]
    k = torch.tensor(_gauss_kernel5(), device=x.device).expand(c, 1, 5, 5)
    return F.conv2d(x.permute(0, 3, 1, 2), k, padding=2, groups=c).permute(0, 2, 3, 1)


def laplacian_pyramid(x: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """NHWC levels: level i holds the detail at scale i, the last the rest."""
    levels = []
    cur = x
    for _ in range(num_levels - 1):
        blurred = _blur(cur)
        levels.append(cur - blurred)
        cur = blurred[:, ::2, ::2, :]
    levels.append(cur)
    return levels


def draw_patch_index(shape, patch: int, num_patches: int,
                     generator: Optional[torch.Generator], device) -> PatchIndex:
    n, h, w, _ = shape
    draw = lambda high: torch.randint(0, high, (num_patches,), generator=generator,
                                      device=device)
    return draw(n), draw(h - patch + 1), draw(w - patch + 1)


def _extract_patches(x: torch.Tensor, patch: int, index: PatchIndex) -> torch.Tensor:
    """[P, patch*patch*C] descriptors at ``index``, each normalized per
    channel by its mean and (population) standard deviation."""
    idx_n, idx_h, idx_w = (torch.as_tensor(i, device=x.device).long() for i in index)
    off = torch.arange(patch, device=x.device)
    rows = (idx_h[:, None] + off)[:, :, None]
    cols = (idx_w[:, None] + off)[:, None, :]
    patches = x[idx_n[:, None, None], rows, cols]            # [P, p, p, C]
    mu = torch.mean(patches, dim=(1, 2), keepdim=True)
    sd = torch.std(patches, dim=(1, 2), keepdim=True, unbiased=False) + 1e-8
    return ((patches - mu) / sd).reshape(patches.shape[0], -1)


def draw_directions(d: int, num_dirs: int, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    return torch.randn((d, num_dirs), generator=generator, device=device)


def sliced_wasserstein(a: torch.Tensor, b: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Mean 1-D Wasserstein distance over the unit columns of ``dirs``."""
    dirs = torch.as_tensor(dirs, device=a.device).float()
    dirs = dirs / (torch.linalg.norm(dirs, dim=0, keepdim=True) + 1e-8)
    pa = torch.sort(a @ dirs, dim=0).values
    pb = torch.sort(b @ dirs, dim=0).values
    return torch.mean(torch.abs(pa - pb))


def sliced_wasserstein_distance(
    x, y, num_levels: int = 3, patch: int = 7, num_patches: int = 2048,
    num_dirs: int = 128, generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[Tuple[PatchIndex, PatchIndex, torch.Tensor]]] = None,
    device: DeviceLike = None,
) -> List[float]:
    """Per-level SWD (finest first, x1e3 like the PGGAN paper) between two
    NHWC batches in [-1, 1]. ``draws[level]`` = (x's patch index, y's,
    directions) replaces the draws of that level; a level smaller than
    ``patch`` is skipped. Without a generator the draws use one seeded 0."""
    dev = metric_device(x, device)
    if generator is None and draws is None:
        generator = torch.Generator(dev).manual_seed(0)
    pyr_x = laplacian_pyramid(as_float(x, dev), num_levels)
    pyr_y = laplacian_pyramid(as_float(y, dev), num_levels)
    scores = []
    for level, (lx, ly) in enumerate(zip(pyr_x, pyr_y)):
        if min(lx.shape[1], lx.shape[2]) < patch:
            continue
        if draws is not None:
            ix, iy, dirs = draws[level]
        else:
            ix = draw_patch_index(lx.shape, patch, num_patches, generator, dev)
            iy = draw_patch_index(ly.shape, patch, num_patches, generator, dev)
            dirs = draw_directions(patch * patch * lx.shape[-1], num_dirs, generator, dev)
        pa, pb = _extract_patches(lx, patch, ix), _extract_patches(ly, patch, iy)
        scores.append(float(sliced_wasserstein(pa, pb, dirs)) * 1e3)
    return scores
