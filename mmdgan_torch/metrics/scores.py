"""GenerativeModelMetric: IS / FID / intra-FID / MS-SSIM over a model's
samples (``mmdgan_tpu/metrics/scores.py:26-130``; graph_func.py:1607-2094).

``inception_score_and_fid`` is the reference protocol
(graph_func.py:1748-1799): ``num_batch`` batches of real and of generated
images through the classifier, then (IS(real), IS(gen), FID(real half 1,
real half 2), FID(real, gen)). The classifier runs on the device and its
outputs stay there; the pool3 activations and logits come to the host
once, for the float64 math of ``metrics/fid.py``.

``seconds``, where given, is filled with the time of each part, the device
synchronized at each boundary: ``data`` (taking the real batches),
``generation`` (taking the generated ones), ``classifier`` and ``fid``
(the copy to the host and the host math).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import DeviceLike
from mmdgan_torch.metrics._device import as_float, metric_device, synchronize
from mmdgan_torch.metrics.fid import (
    fid_from_activations,
    inception_score_from_logits,
    mean_cov_np,
)
from mmdgan_torch.metrics.msssim import ms_ssim


class _Timer:
    def __init__(self, seconds: Optional[Dict[str, float]], device: torch.device):
        self.seconds, self.device = seconds, device

    def __call__(self, part: str, fn: Callable):
        if self.seconds is None:
            return fn()
        synchronize(self.device)
        start = time.perf_counter()
        out = fn()
        synchronize(self.device)
        self.seconds[part] = self.seconds.get(part, 0.0) + time.perf_counter() - start
        return out


def _host(parts) -> np.ndarray:
    return torch.cat([torch.as_tensor(p) for p in parts]).cpu().numpy()


def resize_linear(x: torch.Tensor, size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """``jax.image.resize(x, (N, h, w, C), "linear")`` of NHWC ``x`` (``size``
    = h = w, or (h, w)): half-pixel centres, and a triangle filter widened
    by the scale where it shrinks (antialiased), which
    ``F.interpolate(bilinear, antialias=True)`` computes; where it grows,
    plain bilinear."""
    size = (size, size) if isinstance(size, int) else tuple(size)
    shrink = size[0] < x.shape[1] or size[1] < x.shape[2]
    out = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=False, antialias=shrink)
    return out.permute(0, 2, 3, 1)


class GenerativeModelMetric:
    def __init__(self, classifier: Optional[Callable] = None, model: str = "v1",
                 model_path: Optional[str] = None, device: DeviceLike = None):
        """:param classifier: fn(NHWC images in [-1, 1]) -> (logits, pool3);
        by default ``InceptionClassifier`` (the frozen graph at
        ``model_path`` when given) on ``device``."""
        if classifier is None and model in ("v1", "custom"):
            from mmdgan_torch.metrics.inception import InceptionClassifier
            classifier = InceptionClassifier(pb_path=model_path, device=device)
        self.classifier = classifier

    def _device(self) -> torch.device:
        return getattr(self.classifier, "device", torch.device("cpu"))

    def activations(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.classifier(images)

    def inception_score_and_fid(
        self,
        real_batches: Iterable,
        gen_batches: Iterable,
        num_batch: int = 10,
        seconds: Optional[Dict[str, float]] = None,
    ) -> Tuple[float, float, float, float]:
        """(inc_real, inc_gen, fid_real_vs_real, fid_real_vs_gen); about 50k
        samples at the reference protocol (781 batches of 64)."""
        timed = _Timer(seconds, self._device())
        x_logits, x_pool, y_logits, y_pool = [], [], [], []
        real_it, gen_it = iter(real_batches), iter(gen_batches)
        for _ in range(num_batch):
            xb = timed("data", lambda: next(real_it))
            yb = timed("generation", lambda: next(gen_it))
            xl, xp = timed("classifier", lambda: self.activations(xb))
            yl, yp = timed("classifier", lambda: self.activations(yb))
            x_logits.append(xl)
            x_pool.append(xp)
            y_logits.append(yl)
            y_pool.append(yp)

        def host_math():
            xl, yl, xp, yp = (_host(p) for p in (x_logits, y_logits, x_pool, y_pool))
            xp1, xp2 = np.split(xp, 2, axis=0)
            return (inception_score_from_logits(xl), inception_score_from_logits(yl),
                    fid_from_activations(xp1, xp2), fid_from_activations(xp, yp))

        return timed("fid", host_math)

    def ref_stats(self, batches: Iterable, num_batch: int):
        """Pool3 mean and covariance (imagenet_ref_stats, graph_func.py:2038-2094)."""
        it = iter(batches)
        return mean_cov_np(_host([self.activations(next(it))[1] for _ in range(num_batch)]))

    def save_ref_stats(self, batches, num_batch: int, out_path: str) -> str:
        mean, cov = self.ref_stats(batches, num_batch)
        np.savez(out_path, mean=mean, cov=cov)
        return out_path

    def intra_fid(self, ref_stat_file: str, gen_batches: Iterable, num_batch: int = 50) -> float:
        """FID of generated images against cached statistics
        (graph_func.py:1801-1825)."""
        it = iter(gen_batches)
        pools = _host([self.activations(next(it))[1] for _ in range(num_batch)])
        ref = np.load(ref_stat_file if ref_stat_file.endswith(".npz")
                      else ref_stat_file + ".npz")
        return fid_from_activations(pools, [ref["mean"], ref["cov"]])

    @staticmethod
    def ms_ssim_score(x_batches: Iterable, y_batches: Iterable, num_batch: int = 128,
                      image_size: int = 256, device: DeviceLike = None) -> float:
        """Mean MS-SSIM over paired batches (graph_func.py:1984-2023): images
        mapped from [-1, 1] to [0, 255] and resized to ``image_size`` (SSIM's
        five scales need 176 or more), on the batches' device or ``device``."""
        scores = []
        x_it, y_it = iter(x_batches), iter(y_batches)
        for _ in range(num_batch):
            xb, yb = next(x_it), next(y_it)
            dev = metric_device(xb, device)
            x = (as_float(xb, dev) + 1.0) * 128.5
            y = (as_float(yb, dev) + 1.0) * 128.5
            if x.shape[1] != image_size:
                x, y = resize_linear(x, image_size), resize_linear(y, image_size)
            scores.append(ms_ssim(x, y, max_val=255.0))
        return float(torch.cat(scores).mean())
