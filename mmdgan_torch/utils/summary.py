"""Metric / summary writer (``mmdgan_tpu/utils/summary.py``).

A JSONL event log, always on, plus TensorBoard's writer when
``torch.utils.tensorboard`` imports. The JSONL stands alone: a machine
without tensorboard or PIL still gets every scalar and histogram.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)

    def _write(self, rec: Dict) -> None:
        self._jsonl.write(json.dumps(rec) + "\n")

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._write(rec)
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def histogram(self, step: int, tag: str, counts: np.ndarray, lo: float, hi: float):
        """A precomputed fixed-bin histogram: counts over equal bins
        spanning [lo, hi]."""
        counts = np.asarray(counts, np.float64).reshape(-1)
        self._write({"step": int(step), "time": time.time(), "hist": tag, "lo": float(lo),
                     "hi": float(hi), "counts": [int(c) for c in counts]})
        if self._tb is not None:
            edges = np.linspace(lo, hi, len(counts) + 1)
            reps = np.repeat(0.5 * (edges[:-1] + edges[1:]), counts.astype(np.int64))
            if reps.size:
                self._tb.add_histogram(tag, reps, int(step))

    def raw_histogram(self, step: int, tag: str, values: np.ndarray, nbins: int = 64):
        """Histogram of host-side values (parameter tensors at query steps)
        over their own range."""
        values = np.asarray(values, np.float64).reshape(-1)
        if values.size == 0:
            return
        lo, hi = float(values.min()), float(values.max())
        if hi <= lo:
            hi = lo + 1e-12
        counts, _ = np.histogram(values, bins=nbins, range=(lo, hi))
        self._write({"step": int(step), "time": time.time(), "hist": tag, "lo": lo, "hi": hi,
                     "counts": [int(c) for c in counts]})
        if self._tb is not None:
            self._tb.add_histogram(tag, values, int(step))

    def images(self, step: int, tag: str, images: np.ndarray):
        """images: [N, H, W, C] in [-1, 1], to TensorBoard, else a PNG grid
        beside the log when PIL imports, else nowhere."""
        arr = np.clip((np.asarray(images) + 1.0) / 2.0, 0.0, 1.0)
        if self._tb is not None:
            self._tb.add_images(tag, arr, int(step), dataformats="NHWC")
            return
        try:
            from PIL import Image
        except ImportError:
            return
        n, h, w, c = arr.shape
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        grid = np.zeros((rows * h, cols * w, c), np.uint8)
        for i in range(n):
            r, cc = divmod(i, cols)
            grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = (arr[i] * 255).astype(np.uint8)
        Image.fromarray(grid.squeeze()).save(os.path.join(self.log_dir, f"{tag}_{step}.png"))

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
