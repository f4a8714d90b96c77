"""Where a metric computes: on the device of the tensors it is given, else
on the device asked for (``cuda`` unless ``"cpu"`` is passed)."""

from __future__ import annotations

import torch

from mmdgan_torch import DeviceLike, resolve_device


def metric_device(x, device: DeviceLike = None) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def as_float(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or torch) as a float32 tensor on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.float32)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
