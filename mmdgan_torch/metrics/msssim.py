"""Multi-scale SSIM (``mmdgan_tpu/metrics/msssim.py:21-94``; the reference's
``ms_ssim``, graph_func.py:1984-2023, i.e. ``tf.image.ssim_multiscale``):
an 11x11 Gaussian window (sigma 1.5), power factors (0.0448, 0.2856,
0.3001, 0.2363, 0.1333), a 2x2 average pool between scales. The
contrast-structure term enters at every scale and the luminance term at
the coarsest only; powers apply per channel and channels are averaged
last.

TF pads an odd size ``SYMMETRIC`` by one pixel before the pool; a
one-pixel symmetric pad repeats the edge, which is ``replicate`` (not
``reflect``, which skips it).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import DeviceLike
from mmdgan_torch.metrics._device import as_float, metric_device

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    kernel2d = np.outer(g, g)
    kernel2d /= kernel2d.sum()
    return torch.tensor(kernel2d, dtype=torch.float32, device=device)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID convolution of NCHW ``x`` with one 2-D kernel."""
    c = x.shape[1]
    return F.conv2d(x, kernel.expand(c, 1, *kernel.shape), groups=c)


def _ssim_per_scale(x, y, max_val, k1=0.01, k2=0.03):
    """([N, C] mean SSIM, [N, C] mean contrast-structure) of NCHW inputs."""
    kernel = _gaussian_kernel(x.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_x = _filter2d(x, kernel)
    mu_y = _filter2d(y, kernel)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2d(x * x, kernel) - mu_xx
    sigma_yy = _filter2d(y * y, kernel) - mu_yy
    sigma_xy = _filter2d(x * y, kernel) - mu_xy
    lum = (2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    return torch.mean(lum * cs, dim=(2, 3)), torch.mean(cs, dim=(2, 3))


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return F.avg_pool2d(x, 2)


def ms_ssim(x, y, max_val: float = 255.0,
            power_factors: Sequence[float] = _MSSSIM_WEIGHTS,
            device: DeviceLike = None) -> torch.Tensor:
    """[N] MS-SSIM of two NHWC image batches (numpy or torch), on the
    tensors' device or ``device``; images should be at least 176x176 for
    the five scales (graph_func.py:1999)."""
    dev = metric_device(x, device)
    x = as_float(x, dev).permute(0, 3, 1, 2)
    y = as_float(y, dev).permute(0, 3, 1, 2)
    terms = []   # per-channel factors [N, C]
    ssim_cc = None
    for i, w in enumerate(power_factors):
        ssim_cc, cs = _ssim_per_scale(x, y, max_val)
        if i < len(power_factors) - 1:
            terms.append(torch.relu(cs) ** w)
            x = _avg_pool2(x)
            y = _avg_pool2(y)
    out = torch.relu(ssim_cc) ** power_factors[-1]
    for c in terms:
        out = out * c
    return torch.mean(out, dim=-1)
