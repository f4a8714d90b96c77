"""Exported-generator study on the card: the counterpart of
``tools/export_study.py``.

Is the serving artifact (``utils/export.py``) as fast as the generator in
process? Per architecture at one batch (bf16, weights from seed 0,
images/s over ``CALLS`` calls after ``WARMUP``, CUDA events,
``tools/serving_bench.py``'s ``images_per_sec``):

- ``model``: the in-process generator (``SNGan.generate``, eval mode),
  the reference point;
- ``exp``: ``export_generator`` then ``load_exported``, a file round trip
  as real serving makes it, weights and BN statistics as buffers inside
  the program: the shipped default, the counterpart of JAX's ``exp_tpu``
  (a single-platform export);
- ``exp_args``: a ``torch.export`` program of ``generate(*weights,
  *statistics, z)``, the weights and BN statistics as call inputs, not
  buffers, through the same round trip: does holding the weights inside
  the program change what it runs?

JAX's ``exp_multi`` (a StableHLO module exported for two platforms, with
its platform-index dispatch) has no counterpart: a ``torch.export``
program names no platform (``load_exported`` moves one to any device), so
no key is printed for it. One JSON line per architecture, JAX's keys:
``img_per_sec`` and ``vs_model`` (each surface's rate over ``model``'s).
``--device cpu`` runs on the CPU (a check of the code, no measurement).

    python -m mmdgan_torch.tools.export_study [--arch celeba,lsun] [--batch 1024]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict

import numpy as np
import torch

from mmdgan_torch import resolve_device
from mmdgan_torch.train.state import tree_leaves, tree_map, tree_rebuild
from mmdgan_torch.utils.export import export_generator, load_exported

CALLS = 64
WARMUP = 3
ARCHS = ("cifar", "stl", "celeba", "lsun")


class _GenerateArgs(torch.nn.Module):
    """``forward(*weights, *statistics, z) -> NHWC images in [-1, 1]``:
    eval-mode generation with the generator's trees as inputs."""

    def __init__(self, model, params: Dict, net_state: Dict):
        super().__init__()
        self._model = model
        self._trees = [tree_map(lambda _: None, tree) for tree in (params, net_state)]

    def forward(self, *args):
        *leaves, z = args
        leaves = iter(leaves)   # in tree_leaves order, params then statistics
        params, state = (tree_rebuild(tree, leaves) for tree in self._trees)
        x, _ = self._model.Gen.apply(params, state, z, train=False)
        return torch.clamp(x.permute(0, 2, 3, 1), -1.0, 1.0)


def export_args(model, params: Dict, net_state: Dict, batch: int, path: str, device) -> Callable:
    """Export ``_GenerateArgs`` at ``batch``, save it, load it back onto
    ``device``; returns ``fn(z)`` that passes the weights and statistics,
    on ``device``, with every call."""
    from torch.export.passes import move_to_device_pass

    leaves = [t.detach().to(device) for t in
              tree_leaves(params["gen"]) + tree_leaves(net_state["gen"])]
    module = _GenerateArgs(model, params["gen"], net_state["gen"]).eval()
    z = torch.zeros((batch, model.code_size), dtype=torch.float32, device=device)
    with torch.no_grad():
        torch.export.save(torch.export.export(module, (*leaves, z), strict=False), path)
    served = move_to_device_pass(torch.export.load(path), device).module()

    def fn(z):
        with torch.no_grad():
            return served(*leaves, z)

    return fn


def surfaces(model, params: Dict, net_state: Dict, batch: int, device, folder: str) -> Dict:
    """{'model', 'exp', 'exp_args'}: each ``fn(z) -> images`` at ``batch``,
    the exported ones written to and read back from ``folder``."""
    exp = load_exported(export_generator(model, params, net_state, batch,
                                         os.path.join(folder, "exp.pt2"), device=device),
                        device=device)
    return {"model": lambda z: model.generate(params, net_state, code_batch={"x": z}),
            "exp": exp,
            "exp_args": export_args(model, params, net_state, batch,
                                    os.path.join(folder, "exp_args.pt2"), device)}


def study(arch: str, batch: int, device=None, calls: int = CALLS) -> Dict:
    """One JSON record: images/s of each surface and each over ``model``'s."""
    from mmdgan_torch import architectures
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.tools.serving_bench import images_per_sec

    dev = resolve_device(device)
    model = SNGan(getattr(architectures, f"{arch}_architecture")(), num_class=0,
                  loss_type="rep", device=dev)
    params, state, _ = model.init(0)
    z = torch.tensor(np.random.RandomState(0).randn(batch, model.code_size).astype(np.float32),
                     device=dev)
    out = {"arch": arch, "batch": batch, "platform": "gpu" if dev.type == "cuda" else "cpu",
           "img_per_sec": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in surfaces(model, params, state, batch, dev, tmp).items():
            out["img_per_sec"][name] = images_per_sec(fn, z, calls, WARMUP)
    base = out["img_per_sec"]["model"]
    out["vs_model"] = {k: v / base for k, v in out["img_per_sec"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="celeba,lsun")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=CALLS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for a in args.arch.split(","):
        if a.strip() not in ARCHS:
            raise SystemExit(f"unknown arch {a!r}; one of {ARCHS}")
        print(json.dumps(study(a.strip(), args.batch, dev, args.calls)), flush=True)
    if dev.type == "cuda":
        print(f"[export_study] {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
