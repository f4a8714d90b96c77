"""PyTorch/CUDA port of the MMD-GAN trainer in ``mmdgan_tpu``.

The JAX package stays the reference: every module here names its
counterpart there, and ``tests/test_torch_*.py`` hold the two against each
other on the same numpy inputs. Internally the port runs NCHW on an
explicit device; its public functions take and return the JAX layout
(data batches ``{"x": [B, H, W, C]}``, images NHWC).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than fall back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present, so nothing moves to the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mmdgan_torch runs on CUDA by default and no GPU is present; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(model_device: torch.device, device: DeviceLike) -> torch.device:
    """Resolve ``device`` and require it to be the model's device."""
    dev = resolve_device(device)
    if dev != model_device:
        raise ValueError(f"model lives on {model_device}, step asked for {dev}")
    return dev


__all__ = ["resolve_device", "check_device"]
