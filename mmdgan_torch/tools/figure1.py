"""The reference's loss-geometry figures (Figures/figure1.ipynb, the README
GIFs), the counterpart of ``tools/figure1.py``: free 2-D particles moved
directly by the generator-side gradient of a loss (``rep``, ``rmb`` or the
attractive ``mmd_g``) against a fixed ``SimData`` target sample.

``particle_run`` is the compute: it runs on any device and needs no
matplotlib (``rep`` and ``rmb`` reach the kernel-means kernels through
``GANLoss``'s fused route on the card: one forward and one backward launch
per step, the particles being the only input that takes a gradient).
``main`` draws every ``steps / frames``-th step with ``utils/fig.py`` and
assembles a GIF when PIL imports.

Usage: python -m mmdgan_torch.tools.figure1 --loss rep --steps 600
    --out ./figure1_out [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.data.simdata import SimData
from mmdgan_torch.ops.losses import gan_loss

TARGETS = ("shell", "shell2", "star")


def particle_run(loss: str = "rep", steps: int = 600, lr: float = 2.0, batch: int = 128,
                 target: str = "shell", seed: int = 0, device: DeviceLike = None,
                 init: Optional[np.ndarray] = None, keep_every: int = 1) -> Dict[str, np.ndarray]:
    """Gradient descent of ``batch`` particles on the generator loss.

    :param init: [batch, 2] starting particles; by default normals from
        ``seed`` times 0.05 (the JAX tool draws them from its key)
    :param keep_every: keep the particles of every this-many steps
    :returns: ``target`` [batch, 2], ``particles`` [n, batch, 2] at steps
        0, keep_every, ... (and the last), ``steps`` [n], ``loss`` [steps]
        (the loss at each step's particles before it moves them)
    """
    dev = resolve_device(device)
    sim = SimData(target, batch_size=batch, seed=seed)
    data = torch.tensor(sim(batch), device=dev)
    if init is None:
        init = np.random.RandomState(seed).randn(batch, 2).astype(np.float32) * 0.05
    p = torch.tensor(np.asarray(init, np.float32), device=dev)
    kept, at, losses = [], [], []
    for i in range(steps + 1):
        if i % keep_every == 0 or i == steps:
            kept.append(p.detach().clone())
            at.append(i)
        if i == steps:
            break
        p = p.detach().requires_grad_(True)
        loss_gen = gan_loss(p, data, loss, batch_size=batch)[0]
        (grad,) = torch.autograd.grad(loss_gen, p)
        p = p - lr * grad
        losses.append(loss_gen.detach())
    return {"target": data.cpu().numpy(), "particles": torch.stack(kept).cpu().numpy(),
            "steps": np.asarray(at), "loss": torch.stack(losses).cpu().numpy()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loss", default="rep", choices=["rep", "rmb", "mmd_g"])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--target", default="shell", choices=TARGETS)
    ap.add_argument("--out", default="./figure1_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from mmdgan_torch.utils.fig import Fig

    run = particle_run(args.loss, args.steps, args.lr, args.batch, args.target, args.seed,
                       args.device, keep_every=max(args.steps // args.frames, 1))
    os.makedirs(args.out, exist_ok=True)
    fig = Fig(fig_folder=args.out)
    labels = np.concatenate([np.zeros(args.batch, int), np.ones(args.batch, int)])
    frames = [fig.scatter(np.concatenate([run["target"], pts]), labels=labels,
                          filename=f"frame_{i:05d}", title=f"{args.loss} step {i}", s=6.0)
              for i, pts in zip(run["steps"], run["particles"])]
    print(f"final generator-side loss: {float(run['loss'][-1]):.5f}")
    try:
        from PIL import Image
    except ImportError:
        print("(gif skipped: PIL is not installed)")
        return
    images = [Image.open(f) for f in frames]
    gif = os.path.join(args.out, f"figure1_{args.loss}.gif")
    images[0].save(gif, save_all=True, append_images=images[1:], duration=120, loop=0)
    print(f"wrote {gif}")


if __name__ == "__main__":
    main()
