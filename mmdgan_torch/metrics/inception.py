"""Classifiers for IS/FID (``mmdgan_tpu/metrics/inception.py:36-217``).

The reference runs the frozen ``inception_v1_2015_12_05`` graph
(graph_func.py:1616, 1635-1655): images resized bilinearly to 299 the TF1
way, fed at 'Mul:0', read at 'logits:0' (IS) and 'pool_3:0' (FID).

- :class:`FrozenGraphClassifier` executes a given ``.pb`` with the port's
  GraphDef executor (``metrics/graphdef.py``) on the device.
- :class:`RandomFeatureClassifier` is a fixed-seed random conv feature
  extractor for when no weights are given. Its default weights come from
  a seeded ``torch.Generator``, so its IS/FID are comparable only within
  the port: not with the JAX package's random features, nor with
  published numbers. ``weights=`` takes JAX's (``utils/jax_bridge.py``
  ``jax_random_classifier_to_torch``).
- :class:`InceptionClassifier` takes the frozen graph when a path is given
  (or set in the config) and the random features, with a warning, when
  none is. Unlike JAX's, it does not fall back when a given ``.pb`` fails
  to load: it raises, so a broken graph cannot hide behind random
  features.

Every classifier runs on an explicit device (``cuda`` unless ``"cpu"`` is
passed), takes NHWC images in [-1, 1] (numpy or torch, any device) and
returns ``(logits, pool3)`` as float32 tensors on its device, chunked at
``CHUNK`` images (the reference's 100, graph_func.py:1670-1705).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.metrics._device import as_float

CHUNK = 100
IMAGE_SIZE = 299   # tfgan.eval.INCEPTION_DEFAULT_IMAGE_SIZE


def _to_rgb(images: torch.Tensor) -> torch.Tensor:
    """Three channels: tile grayscale, average any other count."""
    c = images.shape[-1]
    if c == 3:
        return images
    if c == 1:
        return images.repeat(1, 1, 1, 3)
    return images.mean(dim=-1, keepdim=True).repeat(1, 1, 1, 3)


def resize_bilinear_tf1(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """TF1 ``tf.image.resize_bilinear(align_corners=False)`` of NHWC ``x``:
    source coordinates at ``i * in/out`` with no half-pixel offset, which
    is not ``F.interpolate(align_corners=False)``; the gather is written
    out (graph_func.py:1649-1651)."""
    n, h, w, c = x.shape
    out_h, out_w = size
    ys = torch.arange(out_h, dtype=torch.float32, device=x.device) * (h / out_h)
    xs = torch.arange(out_w, dtype=torch.float32, device=x.device) * (w / out_w)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0.float())[None, :, None, None]
    wx = (xs - x0.float())[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def same_pads(size: Sequence[int], window: Sequence[int], strides: Sequence[int]) -> List[int]:
    """F.pad's [left, right, top, bottom] of TF ``SAME`` on (H, W): the
    odd pixel goes after, so an even size with stride 2 and kernel 3 pads
    0 before and 1 after, which ``F.conv2d(padding=1)`` does not."""
    pads = []
    for n, k, s in zip(reversed(size), reversed(window), reversed(strides)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NCHW ``x`` padded for a square ``SAME`` window (``same_pads``)."""
    return F.pad(x, same_pads(x.shape[2:], (kernel, kernel), (stride, stride)))


class _Chunked:
    """``__call__`` over CHUNK-image chunks on ``self.device``."""

    device: torch.device

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        images = _to_rgb(as_float(images, self.device))
        logits_all, pool_all = [], []
        for i in range(0, len(images), CHUNK):
            chunk = images[i:i + CHUNK]
            logits, pool3 = self._forward(chunk)
            logits_all.append(logits.reshape(len(chunk), -1))
            pool_all.append(pool3.reshape(len(chunk), -1))
        return torch.cat(logits_all), torch.cat(pool_all)


class RandomFeatureClassifier(_Chunked):
    """Four 3x3 stride-2 SAME convs with ReLU (3 -> 16 -> 32 -> 64 -> 128
    channels) at the images' own size, a global average pool, then
    ``pool3 = tanh(h W_pool)`` [N, pool_dim] and ``logits = pool3 W_log``
    [N, num_logits]. For pipeline tests and relative comparisons, not for
    absolute IS/FID."""

    DIMS = (3, 16, 32, 64, 128)

    def __init__(self, seed: int = 0, pool_dim: int = 2048, num_logits: int = 1001,
                 device: DeviceLike = None, weights: Optional[Sequence] = None):
        """:param weights: ``(kernels, w_pool, w_log)`` as numpy, the four
        kernels HWIO as JAX's; drawn from ``seed`` when not given."""
        self.device = resolve_device(device)
        self.seed, self.pool_dim, self.num_logits = seed, pool_dim, num_logits
        if weights is None:
            g = torch.Generator().manual_seed(int(seed))
            dims = self.DIMS
            kernels = [torch.randn((3, 3, dims[i], dims[i + 1]), generator=g)
                       * float(np.sqrt(2.0 / (9 * dims[i]))) for i in range(4)]
            w_pool = torch.randn((dims[-1], pool_dim), generator=g) * float(
                np.sqrt(1.0 / dims[-1]))
            w_log = torch.randn((pool_dim, num_logits), generator=g) * float(
                np.sqrt(1.0 / pool_dim))
            weights = (kernels, w_pool, w_log)
        kernels, w_pool, w_log = weights
        as_dev = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)
        self.kernels = [as_dev(k).permute(3, 2, 0, 1).contiguous() for k in kernels]
        self.w_pool, self.w_log = as_dev(w_pool), as_dev(w_log)

    def _forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for k in self.kernels:
            h = torch.relu(F.conv2d(pad_same(h, 3, 2), k, stride=2))
        pool3 = torch.tanh(h.mean(dim=(2, 3)) @ self.w_pool)
        return pool3 @ self.w_log, pool3


class FrozenGraphClassifier(_Chunked):
    """A frozen classifier graph run by ``metrics/graphdef.GraphDefModule``
    on the device; images not at ``image_size`` are first resized the TF1
    way, as the reference feeds its graph."""

    def __init__(self, pb_path, input_tensor: str = "Mul:0",
                 output_tensors: Tuple[str, str] = ("logits:0", "pool_3:0"),
                 device: DeviceLike = None, image_size: int = IMAGE_SIZE):
        from mmdgan_torch.metrics.graphdef import GraphDefModule

        self.device = resolve_device(device)
        self.image_size = image_size
        self.module = GraphDefModule(pb_path, [input_tensor], list(output_tensors),
                                     device=self.device)

    def _forward(self, x):
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            x = resize_bilinear_tf1(x, (self.image_size, self.image_size))
        return self.module(x)


def InceptionClassifier(pb_path: Optional[str] = None, seed: int = 0,
                        device: DeviceLike = None):
    """The frozen graph at ``pb_path`` (or the config's ``inception_pb``),
    which raises if it does not load; random features, with a warning,
    when no path is given."""
    if pb_path is None:
        from mmdgan_torch.config import get_config
        pb_path = get_config().inception_pb
    if pb_path is not None:
        return FrozenGraphClassifier(pb_path, device=device)
    warnings.warn(
        "No frozen inception graph given: using the random-feature classifier. Its "
        "weights come from a seeded torch.Generator, so IS/FID are comparable only "
        "between runs of this package (not with the JAX package's random features, nor "
        "with published numbers); give the reference frozen_inception_v1_2015_12_05 .pb "
        "(--inception-pb) for those.")
    return RandomFeatureClassifier(seed=seed, device=device)
