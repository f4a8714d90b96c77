"""Fixed-seed parity and reproducibility harness, the counterpart of
``tools/parity_run.py``.

Runs N train steps of the CIFAR SNGAN (rep, batch 64) from seed ``--seed``
on synthetic data (normals clipped to [-1, 1] from ``RandomState(seed)``,
as the JAX tool draws them) and writes the loss curve and the score
statistics to JSON. Two uses:

1. Reproducibility: the same seed on the same device must reproduce the
   curve (bitwise under deterministic algorithms, to float tolerance
   across devices); ``--compare`` holds two runs' ``loss_gen`` curves to
   rtol 1e-5.
2. Reference-formula parity: every ``check_every``-th step the losses are
   recomputed from the discriminator's scores by an independent numpy copy
   of the reference formulas (math_func.py:1288-1431) and the largest
   deviation from the port's ``gan_loss`` is recorded.

Usage:
  python -m mmdgan_torch.tools.parity_run --steps 50 --out run_a.json
  python -m mmdgan_torch.tools.parity_run --compare run_a.json run_b.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def np_rep_loss(s_gen, s_x, sigma=1.0, w=(0.0, -1.0)):
    """The rep loss pair (loss_gen, loss_dis) in numpy, at the scores'
    precision: Gaussian kernel means over off-diagonal pairs of the squared
    distances."""

    def pd(a, b):
        return np.maximum((a * a).sum(1)[:, None] - 2 * a @ b.T + (b * b).sum(1)[None, :], 0.0)

    def offdiag(m):
        n = m.shape[0]
        return (m.sum() - np.trace(m)) / (n * (n - 1))

    t = 2 * sigma ** 2
    e_xx = offdiag(np.exp(-pd(s_gen, s_gen) / t))
    e_xy = offdiag(np.exp(-pd(s_gen, s_x) / t))
    e_yy = offdiag(np.exp(-pd(s_x, s_x) / t))
    return e_xx + e_yy - 2 * e_xy, w[0] * e_xy - e_xx - w[1] * e_yy


def run(steps: int, seed: int, out_path: str, check_every: int = 10, device=None,
        compute_dtype: str = "float32") -> dict:
    from mmdgan_torch import resolve_device
    from mmdgan_torch.architectures import cifar_architecture
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.ops.losses import gan_loss
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_train_step, init_train_state

    dev = resolve_device(device)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    model = SNGan(cifar_architecture(), loss_type="rep", compute_dtype=dtype, device=dev)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, seed, opt_d, opt_g, device=dev)
    step = build_train_step(model, opt_d, opt_g, device=dev)
    rng = np.random.RandomState(seed)

    curve, max_err = [], 0.0
    for i in range(steps):
        x = rng.randn(64, 32, 32, 3).astype(np.float32).clip(-1, 1)
        ts, m = step(ts, {"x": x, "y": None})
        curve.append({k: float(v) for k, v in m.items() if not k.startswith("hist/")})
        if i % check_every == 0:
            with torch.no_grad():
                gen = model.generate(ts.params, ts.net_state,
                                     torch.Generator(dev).manual_seed(7), 64)
                s_gen = model.discriminate(ts.params, ts.net_state, gen).float()
                s_x = model.discriminate(ts.params, ts.net_state, x).float()
                lg, ld, _, _ = gan_loss(s_gen, s_x, "rep", batch_size=64)
            lg_np, ld_np = np_rep_loss(s_gen.cpu().numpy(), s_x.cpu().numpy())
            max_err = max(max_err, abs(float(lg) - float(lg_np)), abs(float(ld) - float(ld_np)))
    result = {"seed": seed, "steps": steps, "device": str(dev),
              "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "curve": curve, "max_reference_formula_error": max_err}
    with open(out_path, "w") as f:
        json.dump(result, f)
    print(f"wrote {out_path}; final loss_gen={curve[-1]['loss_gen']:.6f} "
          f"max formula err={max_err:.2e}")
    return result


def compare(path_a: str, path_b: str, rtol: float = 1e-5) -> int:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    ca = np.asarray([v["loss_gen"] for v in a["curve"]])
    cb = np.asarray([v["loss_gen"] for v in b["curve"]])
    n = min(len(ca), len(cb))
    print(f"loss curves: max |diff| over {n} steps = {np.abs(ca[:n] - cb[:n]).max():.3e}")
    ok = np.allclose(ca[:n], cb[:n], rtol=rtol, atol=1e-7)
    print("MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check-every", type=int, default=10)
    p.add_argument("--out", default="parity_run.json")
    p.add_argument("--compare", nargs=2, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    run(args.steps, args.seed, args.out, args.check_every, args.device, args.compute_dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
