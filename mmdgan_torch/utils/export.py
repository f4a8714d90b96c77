"""The generator as a serving artifact (``mmdgan_tpu/utils/export.py:17-104``).

``export_generator`` traces eval-mode generation with ``torch.export`` at a
static batch and writes the program with ``torch.export.save``: the
generator's weights and BN statistics travel inside it as buffers, so
``load_exported`` runs it with nothing but ``torch``, no model code, as
JAX's StableHLO artifact runs without the model-building code.

JAX bakes its target platforms into the artifact (``platforms=``); a
``torch.export`` program is device-neutral once its buffers and constants
are moved, so ``load_exported(path, device=)`` runs an artifact made on
one device on another (``move_to_device_pass``).

JAX's ``mesh=`` exports a batch-sharded entry point for zero-collective
data-parallel serving. Here ``dp=`` (a ``parallel.DataParallel``) exports
the program of one rank: it takes the rank's ``dp.local_batch_size(B)``
rows of the global batch, the weights replicated in it, and returns those
rows' images. Every rank loads the same file; no collective runs.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import torch

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.train.state import tree_leaves, tree_map


class _Generate(torch.nn.Module):
    """Eval-mode ``SNGan.generate`` with the generator's parameters and
    state as buffers: ``forward(z[, y]) -> NHWC images in [-1, 1]``."""

    def __init__(self, model, params: Dict, net_state: Dict, device: torch.device):
        super().__init__()
        self._model = model
        self._names = []   # the two trees, each leaf the name of its buffer
        for tree_name, tree in (("p", params["gen"]), ("s", net_state["gen"])):
            names = iter(f"{tree_name}{i}" for i in range(len(tree_leaves(tree))))
            self._names.append(tree_map(lambda _: next(names), tree))
            for name, t in zip(tree_leaves(self._names[-1]), tree_leaves(tree)):
                self.register_buffer(name, t.detach().to(device).clone())

    def forward(self, z: torch.Tensor, y: torch.Tensor = None) -> torch.Tensor:
        params, state = (tree_map(lambda name: getattr(self, name), names)
                         for names in self._names)
        label = None if y is None else y.long()
        x, _ = self._model.Gen.apply(params, state, z, train=False, label=label)
        return torch.clamp(x.permute(0, 2, 3, 1), -1.0, 1.0)


def export_generator(model, params: Dict, net_state: Dict, batch_size: int, out_path: str,
                     device: DeviceLike = None, dp=None) -> str:
    """Write ``generate(z) -> images`` (``generate(z, y)`` for a
    conditional model, ``num_class >= 2``: ``y`` an int32 ``[B, 1]``
    column) as a ``torch.export`` program at a static batch; returns the
    path.

    ``z`` is float32 ``[B, code]``; the images are NHWC float32 clipped to
    [-1, 1], as ``SNGan.generate`` gives them in eval mode. The program is
    traced on ``device`` (``cuda`` unless asked otherwise), with the
    weights copied there. With ``dp``, ``batch_size`` is the global batch
    and the program takes one rank's ``dp.local_batch_size(batch_size)``
    rows; rank 0 writes it and every rank returns once it is there."""
    dev = resolve_device(device)
    rows = batch_size if dp is None else dp.local_batch_size(batch_size)
    if dp is None or dp.is_main:
        module = _Generate(model, params, net_state, dev).eval()
        args = (torch.zeros((rows, model.code_size), dtype=torch.float32, device=dev),)
        if getattr(model, "num_class", 0) >= 2:
            args += (torch.zeros((rows, 1), dtype=torch.int32, device=dev),)
        with torch.no_grad():
            program = torch.export.export(module, args, strict=False)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        tmp = f"{out_path}.{os.getpid()}.tmp.pt2"
        torch.export.save(program, tmp)
        os.replace(tmp, out_path)   # atomic: a reader sees all of it or nothing
    if dp is not None:
        dp.barrier()
    return out_path


def load_exported(path: str, device: DeviceLike = None) -> Callable:
    """The artifact at ``path`` as a callable ``fn(z)`` (``fn(z, y)`` for
    a conditional export) on ``device`` (``cuda`` unless asked
    otherwise), whatever device it was exported on. Needs no model code."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    program = move_to_device_pass(torch.export.load(path), dev)
    module = program.module()

    def fn(z, y=None):
        z = torch.as_tensor(z, dtype=torch.float32, device=dev)
        with torch.no_grad():
            if y is None:
                return module(z)
            return module(z, torch.as_tensor(y, dtype=torch.int32, device=dev))

    return fn
