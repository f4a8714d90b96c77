"""Quality smoke: does the whole stack learn on the card? The counterpart of
``tools/quality_smoke.py``.

Trains an SNGAN (the CIFAR architecture at 32x32 by default) on structured
synthetic images, coloured Gaussian blobs on gradients (``blob_batches``,
bitwise the JAX tool's draws), and reports the random-feature FID between
generated and held-out samples at every ``--eval-every`` steps. The FID is
not comparable to published numbers (no inception weights, and the port's
random features are drawn by torch, not JAX), but its trend shows
end-to-end learning: data, the graphed K-step window, the eval stack.

It prints the JAX tool's text lines, then one JSON line: the FID at each
evaluation, the steps and steps/s, and the final losses. ``--sweep`` trains
every loss of the dispatcher on the device-resident blob data instead,
checks finite losses and that the stateful losses' state moves, and prints
its table and a JSON line of the rows.

    python -m mmdgan_torch.tools.quality_smoke --steps 3000 --eval-every 1000
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch


def blob_batches(batch, size=32, seed=0, n_blobs=3, num_class=0):
    """Structured synthetic images: coloured blobs on smooth gradients, an
    endless iterator of ``{'x': [B, size, size, 3] f32 in (-1, 1), 'y'}``.

    With ``num_class`` >= 2 each sample gets a class label and the class
    sets the base-gradient colour and the blob palette's centre (fixed
    per-class directions from a fixed seed): the classes look different,
    so per-class FID drops only if the generator uses its conditioning."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if num_class >= 2:
        crng = np.random.RandomState(12345)
        class_grad = (crng.rand(num_class, 3) * 0.6 - 0.3).astype(np.float32)
        class_color = (crng.rand(num_class, 3) * 2 - 1).astype(np.float32)
    while True:
        if num_class >= 2:
            y = rng.randint(0, num_class, size=batch)
            g = (class_grad[y] + (rng.rand(batch, 3) * 0.2 - 0.1)).astype(np.float32)
        else:
            y = None
            g = (rng.rand(batch, 3) * 0.6 - 0.3).astype(np.float32)
        base = (xx[None] * g[:, 0, None, None] + yy[None] * g[:, 1, None, None]
                + g[:, 2, None, None])                           # [B, H, W]
        img = np.repeat(base[..., None], 3, axis=-1)             # [B, H, W, 3]
        centers = rng.rand(batch, n_blobs, 2).astype(np.float32)
        sig = (0.05 + rng.rand(batch, n_blobs) * 0.1).astype(np.float32)
        colors = (rng.rand(batch, n_blobs, 3) * 2 - 1).astype(np.float32)
        if num_class >= 2:
            colors = (0.3 * colors + 0.7 * class_color[y][:, None, :]).astype(np.float32)
        d2 = ((xx[None, None] - centers[..., 0, None, None]) ** 2
              + (yy[None, None] - centers[..., 1, None, None]) ** 2)
        blobs = np.exp(-d2 / (2 * sig[..., None, None] ** 2))   # [B, K, H, W]
        img = img + np.einsum("bkhw,bkc->bhwc", blobs, colors)
        yield {"x": np.tanh(img).astype(np.float32),
               "y": None if y is None else y.reshape(-1, 1).astype(np.int64)}


# every dispatcher branch (math_func.py:2600-2651)
SWEEP_LOSSES = [
    "logistic", "hinge", "wasserstein",
    "mmd_g", "mmd_t", "mgb", "cramer",
    "mmd_g_mix", "sgm", "rand_g", "rgb", "rand_g_mix", "sym_rg_mix",
    "sym_rg", "instance_noise",
    "rep", "rep_ds", "rep_gp", "rmb", "rmb_ds", "rmb_gp",
]
STATEFUL_LOSSES = {"mmd_g_mix", "sgm", "rand_g_mix", "sym_rg_mix", "instance_noise"}
IMAGE_SIZE = {"cifar": 32, "stl": 48, "celeba": 64, "lsun": 64, "hd128": 128,
              "hd256": 256, "hd512": 512}


def _architecture(name: str, conditional: bool) -> dict:
    from mmdgan_torch import architectures as A

    if name.startswith("hd"):
        return A.hd_architecture(int(name[2:]), conditional=conditional)
    if conditional:
        if name != "cifar":
            raise SystemExit("conditional mode supports --arch cifar or the hd family")
        return A.cifar_architecture(conditional=True)
    return getattr(A, f"{name}_architecture")()


def _dataset(data, n: int, uint8: bool):
    """The first ``n`` rows of a blob stream (x, and y or None)."""
    xs, ys, got = [], [], 0
    while got < n:
        b = next(data)
        x = b["x"]
        if uint8:
            x = np.round((x + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        xs.append(x)
        if b["y"] is not None:
            ys.append(b["y"])
        got += len(x)
    return np.concatenate(xs)[:n], (np.concatenate(ys)[:n] if ys else None)


def _as_float(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 127.5 - 1.0 if x.dtype == np.uint8 else x


def _last(metrics: dict) -> dict:
    return {k: float(v.reshape(-1)[-1]) for k, v in metrics.items() if not k.startswith("hist/")}


def run_sweep(args, dev, dtype) -> int:
    """Every dispatcher branch trains ``--steps`` graphed steps on the blob
    data resident on the device; finite losses, and the stateful losses'
    ``LossState`` moved off its start."""
    from mmdgan_torch.architectures import cifar_architecture
    from mmdgan_torch.metrics.fid import fid_from_activations
    from mmdgan_torch.metrics.inception import RandomFeatureClassifier
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_device_data_step, init_train_state

    host_x, _ = _dataset(blob_batches(args.batch, size=32), args.device_dataset or 4096, False)
    data_x = torch.tensor(host_x, device=dev)
    clf = RandomFeatureClassifier(seed=0, device=dev)
    real_pool = clf(host_x[:args.eval_batches * args.batch])[1].cpu().numpy()
    rows = []
    for loss in SWEEP_LOSSES:
        t0 = time.time()
        model = SNGan(cifar_architecture(), loss_type=loss, compute_dtype=dtype, device=dev)
        opt_d, opt_g = multi_opt_config([args.lr_dis, args.lr_gen])
        ts = init_train_state(model, 0, opt_d, opt_g, device=dev)
        step = build_device_data_step(model, opt_d, opt_g, args.scan_k, args.batch, device=dev)
        rng = torch.Generator(dev).manual_seed(1)

        def eval_fid():
            gen = [model.generate(ts.params, ts.net_state,
                                  torch.Generator(dev).manual_seed(500 + i), args.batch)
                   for i in range(args.eval_batches)]
            return fid_from_activations(real_pool, clf(torch.cat(gen))[1].cpu().numpy())

        fid0, done, mm, err = eval_fid(), 0, {}, ""
        try:
            while done < args.steps:
                ts, m = step(ts, data_x, None, rng)
                done += args.scan_k
            mm = _last({k: v.cpu().numpy() for k, v in m.items()})
            if not (math.isfinite(mm["loss_gen"]) and math.isfinite(mm["loss_dis"])):
                raise FloatingPointError(f"loss_gen={mm['loss_gen']} loss_dis={mm['loss_dis']}")
            if loss in STATEFUL_LOSSES and float(ts.loss_state.loss_average) == 0.0:
                raise AssertionError(f"{loss}: LossState.loss_average did not move")
            fid1, ok = eval_fid(), True
        except Exception as e:   # keep sweeping; reported at the end
            fid1, ok, err = float("nan"), False, f"{type(e).__name__}: {e}"
        state = ts.loss_state
        rows.append({"loss": loss, "ok": ok, "err": err, "steps": done, "fid0": fid0,
                     "fid1": fid1, "loss_gen": mm.get("loss_gen", float("nan")),
                     "loss_dis": mm.get("loss_dis", float("nan")), "e_kxx": mm.get("e_kxx"),
                     "coin_avg": (float(state.loss_average) if loss in STATEFUL_LOSSES
                                  else None),
                     "mix_prob": float(state.mix_prob) if loss in STATEFUL_LOSSES else None,
                     "ins_sigma": float(state.ins_sigma) if loss == "instance_noise" else None,
                     "sec": round(time.time() - t0, 1)})
        r = rows[-1]
        print(f"[sweep] {loss:>14s}: {'OK ' if ok else 'FAIL '} fid {r['fid0']:.2f}->"
              f"{r['fid1']:.2f} lg={r['loss_gen']:.4f} ld={r['loss_dis']:.4f} "
              f"coin_avg={r['coin_avg']} ins_sigma={r['ins_sigma']} ({r['sec']}s) {err}",
              flush=True)
    print("\n| loss | steps | FID 0 -> end | loss_gen | loss_dis | e_kxx "
          "| coin avg | mix prob | ins sigma |")
    print("|---|---|---|---|---|---|---|---|---|")
    fmt = lambda v: "—" if v is None else f"{v:.4f}"
    for r in rows:
        print(f"| {r['loss']} | {r['steps']} | {r['fid0']:.2f} -> {r['fid1']:.2f} "
              f"| {r['loss_gen']:.4f} | {r['loss_dis']:.4f} | {fmt(r['e_kxx'])} "
              f"| {fmt(r['coin_avg'])} | {fmt(r['mix_prob'])} | {fmt(r['ins_sigma'])} |")
    failed = [r["loss"] for r in rows if not r["ok"]]
    print(f"\nsweep: {len(rows) - len(failed)}/{len(rows)} branches OK"
          + (f"; FAILED: {failed}" if failed else ""))
    print(json.dumps({"sweep": rows}))
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--scan-k", type=int, default=16)
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--out", default="./quality_smoke_out")
    p.add_argument("--arch", default="cifar", choices=sorted(IMAGE_SIZE),
                   help="cifar: 32x32 (my_test_cifar.py); stl: 48x48; celeba/lsun: the "
                        "64x64 archs; hd128/hd256/hd512: the hd family")
    p.add_argument("--sweep", action="store_true",
                   help="every loss of the dispatcher trains --steps steps on the blob data "
                        "on the device; finite losses and the stateful losses' state moved")
    p.add_argument("--loss", default="rep")
    p.add_argument("--lr-dis", type=float, default=5e-4)
    p.add_argument("--lr-gen", type=float, default=2e-4)
    p.add_argument("--ckpt-dir", default=None,
                   help="the port's checkpoint folder: resume from it if it holds one, save "
                        "at each eval, and check a save/restore bitwise at the end")
    p.add_argument("--device-dataset", type=int, default=0, metavar="N",
                   help="a fixed N-image dataset resident on the device, batches gathered "
                        "there (build_device_data_step); 0 feeds host batches")
    p.add_argument("--device-dataset-dtype", default="uint8", choices=["uint8", "f32"])
    p.add_argument("--sampling", default="uniform", choices=["uniform", "shuffled_epochs"])
    p.add_argument("--num-class", type=int, default=0,
                   help=">=2: the conditional model on class-coloured blobs, same-class "
                        "batches, mean per-class FID; needs --device-dataset")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--micro-batches", type=int, default=1,
                   help="exact gradient accumulation over M micro-batches; needs "
                        "--device-dataset")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from mmdgan_torch import resolve_device
    from mmdgan_torch.metrics.fid import fid_from_activations
    from mmdgan_torch.metrics.inception import RandomFeatureClassifier
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import (EpochPermuter, build_device_data_step,
                                         build_multi_step, class_schedule, init_train_state,
                                         same_class_tables)
    from mmdgan_torch.utils import checkpoint
    from mmdgan_torch.utils.sprite import write_sprite_wrapper

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    if args.sweep:
        if args.steps == 3000:
            args.steps = 2000   # the sweep's default: 2k steps per branch
        return run_sweep(args, dev, dtype)

    cond = args.num_class >= 2
    if cond and not args.device_dataset:
        raise SystemExit("conditional mode needs --device-dataset")
    if not args.device_dataset and (args.micro_batches > 1 or args.sampling != "uniform"):
        raise SystemExit("--micro-batches and --sampling shuffled_epochs need --device-dataset")
    os.makedirs(args.out, exist_ok=True)
    size = IMAGE_SIZE[args.arch]
    model = SNGan(_architecture(args.arch, cond), num_class=args.num_class,
                  loss_type=args.loss, compute_dtype=dtype, device=dev)
    model.sample_same_class = cond
    opt_d, opt_g = multi_opt_config([args.lr_dis, args.lr_gen])
    ts = init_train_state(model, 0, opt_d, opt_g, device=dev)
    data = blob_batches(args.batch, size=size, num_class=args.num_class)
    clf = RandomFeatureClassifier(seed=0, device=dev)
    pool = lambda images: clf(images)[1].cpu().numpy()

    data_x = data_y = host_x = host_y = None
    if args.device_dataset:
        n = args.device_dataset
        print(f"pregenerating fixed {n}-image dataset ...", flush=True)
        host_x, host_y = _dataset(data, n, args.device_dataset_dtype == "uint8")
        data_x = torch.tensor(host_x, device=dev)
        print(f"uploaded {data_x.numel() * data_x.element_size() / 1e6:.0f} MB to the device",
              flush=True)
        kw = {}
        if cond:
            data_y = torch.tensor(host_y, device=dev)
            table, counts = same_class_tables(host_y, args.num_class)
            kw = dict(same_class=True, class_table=table, class_counts=counts)
        step = build_device_data_step(model, opt_d, opt_g, args.scan_k, args.batch,
                                      sampling=args.sampling,
                                      micro_batches=args.micro_batches, device=dev, **kw)
    else:
        step = build_multi_step(model, opt_d, opt_g, args.scan_k, device=dev)

    done = 0
    if args.ckpt_dir and checkpoint.get_ckpt(args.ckpt_dir) is not None:
        done = int(checkpoint.restore_into(
            ts, checkpoint.ckpt_path(args.ckpt_dir, checkpoint.get_ckpt(args.ckpt_dir))).step)
        print(f"resumed from step {done}", flush=True)

    if cond:
        # per-class held-out pools: the mean per-class (intra) FID drops
        # only if the generator uses its class
        per_class = max((args.eval_batches * args.batch) // args.num_class, args.batch)
        real_c = [pool(_as_float(host_x[np.where(host_y.reshape(-1) == c)[0][:per_class]]))
                  for c in range(args.num_class)]

        def eval_fid():
            fids = []
            for c in range(args.num_class):
                g = torch.cat([model.generate(
                    ts.params, ts.net_state, torch.Generator(dev).manual_seed(500 + 97 * c + i),
                    labels=np.full((min(args.batch, per_class - i),), c, np.int64))
                    for i in range(0, per_class, args.batch)])
                fids.append(fid_from_activations(real_c[c], pool(g)))
            return float(np.mean(fids)), g
    else:
        real = (np.concatenate([_as_float(host_x[i:i + args.batch])
                                for i in range(0, args.eval_batches * args.batch, args.batch)])
                if host_x is not None else
                np.concatenate([next(data)["x"] for _ in range(args.eval_batches)]))
        real_pool = pool(real)

        def eval_fid():
            g = torch.cat([model.generate(ts.params, ts.net_state,
                                          torch.Generator(dev).manual_seed(500 + i), args.batch)
                           for i in range(args.eval_batches)])
            return fid_from_activations(real_pool, pool(g)), g

    fid0, g = eval_fid()
    print(f"step 0: random-feature FID = {fid0:.4f}", flush=True)
    write_sprite_wrapper(g[:64].cpu().numpy(), (8, 8), "samples", args.out, "_step0")

    permuter = sched = None
    rng = torch.Generator(dev).manual_seed(done + 1)
    if data_x is not None and args.sampling == "shuffled_epochs":
        if cond:
            sched = torch.tensor(class_schedule(args.num_class, args.steps, seed=0), device=dev)
        else:
            n_batches = data_x.shape[0] // args.batch
            permuter = EpochPermuter.single_device(data_x.shape[0], seed=0)
            permuter.advance(done // n_batches, [data_x, data_y])
    start, start_step, fid, evals, m = time.time(), done, fid0, [[done, fid0]], None
    while done < args.steps:
        if data_x is not None:
            if permuter is not None:
                permuter.advance(done // n_batches, [data_x, data_y])
            window = None if sched is None else sched[done:done + args.scan_k]
            ts, m = step(ts, data_x, data_y, rng, schedule=window)
        else:
            host = [next(data) for _ in range(args.scan_k)]
            ts, m = step(ts, {"x": np.stack([b["x"] for b in host])})
        done += args.scan_k
        if done % args.eval_every < args.scan_k:
            fid, g = eval_fid()
            evals.append([done, fid])
            mm = _last({k: v.cpu().numpy() for k, v in m.items()})
            speed = (done - start_step) / (time.time() - start)
            print(f"step {done}: FID = {fid:.4f} loss_gen={mm['loss_gen']:.4f} "
                  f"loss_dis={mm['loss_dis']:.4f} s_x={mm['s_x_mean']:.3f} "
                  f"s_g={mm['s_gen_mean']:.3f} ({speed:.1f} steps/s incl. host data)",
                  flush=True)
            write_sprite_wrapper(g[:64].cpu().numpy(), (8, 8), "samples", args.out,
                                 f"_step{done}")
            if args.ckpt_dir:
                checkpoint.save(args.ckpt_dir, ts, done)
    seconds = time.time() - start
    print(f"FID {fid0:.3f} -> {fid:.3f} "
          f"({'LEARNING' if fid < 0.5 * fid0 else 'check dynamics'})")

    if args.ckpt_dir:
        # the final checkpoint restores bitwise into a fresh state, which
        # then trains on
        checkpoint.save(args.ckpt_dir, ts, done)
        restored, _ = checkpoint.rollback(ts, args.ckpt_dir, ckpt_step=done)
        bad = [i for i, (a, b) in enumerate(zip(ts.tensors(), restored.tensors()))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"restore differs at leaves {bad[:5]}")
        print(f"checkpoint at step {done}: restore bitwise-equal — RESUMABLE", flush=True)
    last = {} if m is None else _last({k: v.cpu().numpy() for k, v in m.items()})
    print(json.dumps({"fid": evals, "steps": done - start_step,
                      "steps_per_sec": (done - start_step) / max(seconds, 1e-9),
                      "loss_gen": last.get("loss_gen"), "loss_dis": last.get("loss_dis"),
                      "device": str(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
