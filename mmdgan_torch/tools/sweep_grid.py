"""Results-grid campaign, the counterpart of ``tools/sweep_grid.py``: the
reference's hyperparameter grids (Results/README.md:1-5, per-loss blocks of
Inception Score and FID over lr_D x lr_G x act_k, the paper's Appendix C/D)
as one command.

Every cell trains the CIFAR-10 SNGAN as the cifar CLI builds it
(``cifar_architecture(act_k=k ** (1/8))``, bf16, batch 64) for ``--steps``
graphed steps on a fixed f32 blob dataset resident on the device
(``quality_smoke.blob_batches``; quantized to uint8 the synthetic target is
adversarially separable), and is scored with FID and IS against a held-out
blob stream. The scores come from the random-feature classifier (relative
comparison only), or from ``--inception-pb``'s frozen graph through the
GraphDef executor (the reference's scoring path, graph_func.py:1616). The
best-cell tables are written as markdown, CSV and JSONL.

The port's optimizers hold their learning rate as a Python float captured
in the step's CUDA graph, so each (lr_D, lr_G) cell builds its own step;
the JAX tool compiles once per (loss, k) block instead.

    python -m mmdgan_torch.tools.sweep_grid --losses rep,rmb --steps 3000
    python -m mmdgan_torch.tools.sweep_grid --losses rep --k-grid 32,64 \\
        --lr-grid 2e-4,5e-4,1e-3 --steps 5000 --out ./grid

Cells stream to ``<out>/cells.jsonl`` as they finish; running the same
command again resumes the campaign (finished cells are skipped).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
import zlib

import numpy as np
import torch


def _floats(s):
    return [float(v) for v in s.split(",") if v]


def cell_key(loss, k, lr_d, lr_g):
    return f"{loss}/k{k:g}/lrD{lr_d:g}/lrG{lr_g:g}"


def format_markdown(cells, losses, k_grid, lr_d_grid, lr_g_grid, classifier_name):
    """xlsx-style blocks: one table per (loss, k), rows lr_D, columns lr_G,
    cell 'FID (IS)'; each loss's best cell named under its blocks."""
    lines = [f"# Hyperparameter grid ({classifier_name} scores)", ""]
    for loss in losses:
        best = None
        for k in k_grid:
            lines.append(f"## loss `{loss}`, k = {k:g}")
            lines.append("")
            lines.append("| lr_D \\ lr_G | " + " | ".join(f"{g:g}" for g in lr_g_grid) + " |")
            lines.append("|---" * (len(lr_g_grid) + 1) + "|")
            for d in lr_d_grid:
                row = [f"**{d:g}**"]
                for g in lr_g_grid:
                    c = cells.get(cell_key(loss, k, d, g))
                    if c is None:
                        row.append("—")
                        continue
                    row.append(f"{c['fid']:.2f} ({c['is']:.2f})")
                    if best is None or c["fid"] < best["fid"]:
                        best = c
                lines.append("| " + " | ".join(row) + " |")
            lines.append("")
        if best is not None:
            lines.append(f"**Best `{loss}` cell:** FID {best['fid']:.2f} (IS {best['is']:.2f}) "
                         f"at lr_D={best['lr_dis']:g}, lr_G={best['lr_gen']:g}, "
                         f"k={best['k']:g}")
            lines.append("")
    return "\n".join(lines)


def format_csv(cells):
    cols = ["loss", "k", "lr_dis", "lr_gen", "fid", "is", "loss_gen", "loss_dis", "e_kxx",
            "steps", "seconds"]
    out = [",".join(cols)]
    for c in sorted(cells.values(), key=lambda c: (c["loss"], c["k"], c["lr_dis"], c["lr_gen"])):
        out.append(",".join(str(c[k]) for k in cols))
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--losses", default="rep,rmb", help="comma list of dispatcher names")
    ap.add_argument("--lr-grid", type=_floats, default=[2e-4, 5e-4, 1e-3],
                    help="comma list for both the lr_D and the lr_G axis")
    ap.add_argument("--lr-dis-grid", type=_floats, default=None)
    ap.add_argument("--lr-gen-grid", type=_floats, default=None)
    ap.add_argument("--k-grid", type=_floats, default=[64.0],
                    help="the paper's k values; act_k = k ** (1/8) per layer of the 8-op "
                         "CIFAR discriminator (my_test_cifar.py:10)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scan-k", type=int, default=16)
    ap.add_argument("--eval-batches", type=int, default=16)
    ap.add_argument("--device-dataset", type=int, default=4096,
                    help="rows of the fixed f32 blob dataset on the device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="./sweep_grid_out")
    ap.add_argument("--inception-pb", default=None,
                    help="a frozen inception .pb: score through the GraphDef executor")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from mmdgan_torch import resolve_device
    from mmdgan_torch.architectures import cifar_architecture
    from mmdgan_torch.metrics.fid import fid_from_activations, inception_score_from_logits
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.tools.quality_smoke import _dataset, blob_batches
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_device_data_step, init_train_state

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    lr_d_grid = args.lr_dis_grid or args.lr_grid
    lr_g_grid = args.lr_gen_grid or args.lr_grid
    losses = [l for l in args.losses.split(",") if l]
    k_grid = args.k_grid

    os.makedirs(args.out, exist_ok=True)
    cells_path = os.path.join(args.out, "cells.jsonl")
    cells = {}
    if os.path.exists(cells_path):
        with open(cells_path) as f:
            for line in f:
                c = json.loads(line)
                cells[cell_key(c["loss"], c["k"], c["lr_dis"], c["lr_gen"])] = c
        print(f"resuming campaign: {len(cells)} cells already done", flush=True)

    if args.inception_pb:
        from mmdgan_torch.metrics.inception import FrozenGraphClassifier

        clf = FrozenGraphClassifier(args.inception_pb, device=dev)
        clf_name = os.path.basename(args.inception_pb)
    else:
        from mmdgan_torch.metrics.inception import RandomFeatureClassifier

        clf = RandomFeatureClassifier(seed=0, device=dev)
        clf_name = "random-feature"

    host_x, _ = _dataset(blob_batches(args.batch, size=32, seed=args.seed),
                         args.device_dataset, False)
    data_x = torch.tensor(host_x, device=dev)
    held_out = blob_batches(args.batch, size=32, seed=args.seed + 777)
    real_pool = clf(np.concatenate([next(held_out)["x"]
                                    for _ in range(args.eval_batches)]))[1].cpu().numpy()

    def eval_cell(model, ts):
        g = torch.cat([model.generate(ts.params, ts.net_state,
                                      torch.Generator(dev).manual_seed(9000 + i), args.batch)
                       for i in range(args.eval_batches)])
        logits, pool = clf(g)
        return (fid_from_activations(real_pool, pool.cpu().numpy()),
                inception_score_from_logits(logits.cpu().numpy()))

    total = len(losses) * len(k_grid) * len(lr_d_grid) * len(lr_g_grid)
    done_n = 0
    for loss, k in itertools.product(losses, k_grid):
        todo = [(d, g) for d, g in itertools.product(lr_d_grid, lr_g_grid)
                if cell_key(loss, k, d, g) not in cells]
        done_n += len(lr_d_grid) * len(lr_g_grid) - len(todo)
        if not todo:
            continue
        model = SNGan(cifar_architecture(act_k=float(k) ** 0.125), loss_type=loss,
                      compute_dtype=dtype, device=dev)
        print(f"block ({loss}, k={k:g}): {len(todo)} cells ...", flush=True)
        for lr_d, lr_g in todo:
            t0 = time.time()
            key = cell_key(loss, k, lr_d, lr_g)
            opt_d, opt_g = multi_opt_config([lr_d, lr_g])
            ts = init_train_state(model, args.seed, opt_d, opt_g, device=dev)
            step = build_device_data_step(model, opt_d, opt_g, args.scan_k, args.batch,
                                          device=dev)
            # crc32 of the key, not hash(): str hashes are salted per process
            rng = torch.Generator(dev).manual_seed(
                (args.seed + 1) * 1000003 + zlib.crc32(key.encode()))
            s, beat = 0, max(args.scan_k, (args.steps // 4 // args.scan_k) * args.scan_k)
            while s < args.steps:
                ts, m = step(ts, data_x, None, rng)
                s += args.scan_k
                if s % beat == 0 and s < args.steps:
                    print(f"  ... {key}: step {s}/{args.steps} ({time.time() - t0:.0f}s)",
                          flush=True)
            fid, is_score = eval_cell(model, ts)
            mm = {n: float(v.reshape(-1)[-1]) for n, v in m.items() if not n.startswith("hist/")}
            cell = {"loss": loss, "k": k, "lr_dis": lr_d, "lr_gen": lr_g,
                    "fid": round(fid, 4), "is": round(is_score, 4),
                    "loss_gen": round(mm["loss_gen"], 4), "loss_dis": round(mm["loss_dis"], 4),
                    "e_kxx": round(mm.get("e_kxx", float("nan")), 4),
                    "steps": s, "seconds": round(time.time() - t0, 1)}
            cells[key] = cell
            with open(cells_path, "a") as f:
                f.write(json.dumps(cell) + "\n")
            done_n += 1
            print(f"[{done_n}/{total}] {key}: FID {fid:.2f} IS {is_score:.2f} "
                  f"loss_gen {mm['loss_gen']:.3f} ({cell['seconds']:.0f}s)", flush=True)

    md = format_markdown(cells, losses, k_grid, lr_d_grid, lr_g_grid, clf_name)
    with open(os.path.join(args.out, "grid.md"), "w") as f:
        f.write(md)
    with open(os.path.join(args.out, "grid.csv"), "w") as f:
        f.write(format_csv(cells))
    print(md, flush=True)
    print(f"wrote {os.path.join(args.out, 'grid.md')} + grid.csv + cells.jsonl", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
