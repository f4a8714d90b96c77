"""Synthetic image batches for tests and benchmarks (no dataset needed);
the port's copy of ``mmdgan_tpu/data/synthetic.py``."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_image_batches(
    batch_size: int,
    height: int,
    width: int,
    channels: int,
    num_class: int = 0,
    seed: int = 0,
) -> Iterator[dict]:
    """Infinite stream of {'x': [B,H,W,C] float32 in [-1,1], 'y': labels}.

    Draws smooth random images (low-frequency noise) so discriminators see
    non-degenerate structure; deterministic per seed.
    """
    rng = np.random.RandomState(seed)
    while True:
        base = rng.randn(batch_size, height // 4 + 1, width // 4 + 1, channels)
        # cheap upsample for smoothness
        x = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :height, :width, :]
        x = np.tanh(x).astype(np.float32)
        y = (
            rng.randint(0, num_class, size=(batch_size, 1)).astype(np.int32)
            if num_class >= 2 else None
        )
        yield {"x": x, "y": y}
