"""End-to-end rehearsal of the inception IS/FID protocol on the device: the
counterpart of ``tools/inception_rehearsal.py``.

The one piece of the reference's metric protocol the repository cannot
hold is the frozen inception weights file. This tool drives every other
link of the chain, as ``experiments/runner.py --inception-pb`` would:

1. synthesize the inception-shaped random-weight ``.pb`` and its twin
   (``tools/make_fake_inception.py``) when ``--pb`` does not exist;
2. cross-check the GraphDef executor on the device against a reference
   on random 32x32 images (resized to 299 inside both): the same executor
   on the CPU by default (the card's machine has no TensorFlow), or the
   ``reference`` classifier that ``main`` is given, such as TensorFlow on
   the twin. The gate is JAX's: max relative difference < 1e-4;
3. restore a trained checkpoint of the CIFAR architecture from
   ``--ckpt-dir`` (``tools/quality_smoke.py --ckpt-dir`` writes one), then
   run the reference protocol (graph_func.py:1748-1799):
   ``--eval-batches`` x ``--batch`` real blob batches (``blob_batches``)
   and generated ones (a ``torch.Generator`` seeded 1000 + i per batch)
   through ``GenerativeModelMetric(FrozenGraphClassifier(pb))``, giving
   IS(x), IS(g), FID(x half, x half) and FID(x, g).

It prints one JSON line with the JAX tool's keys, plus the classifier's
images/s at 299x299 and the eval's seconds by part. The graph's weights
are random, so the numbers are not comparable with published ones; with
the real ``inception_v1_2015_12_05`` ``.pb`` (``--pb``) they are.

    python -m mmdgan_torch.tools.inception_rehearsal --ckpt-dir CKPT \\
        --eval-batches 781 --batch 64 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

GATE = 1e-4   # tools/inception_rehearsal.py:106


def relative_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def crosscheck(pb: str, device, batch: int, n_batches: int,
               reference: Optional[Callable] = None) -> float:
    """The executor on ``device`` against ``reference`` (by default the same
    executor on the CPU) on ``n_batches`` batches of random 32x32 images
    (``RandomState(7)``, as JAX's); the largest relative difference of the
    logits and the pool3 features."""
    from mmdgan_torch.metrics.inception import FrozenGraphClassifier

    tested = FrozenGraphClassifier(pb, device=device)
    if reference is None:
        reference = FrozenGraphClassifier(pb, device="cpu")
    rng = np.random.RandomState(7)
    worst = 0.0
    for _ in range(n_batches):
        imgs = rng.rand(batch, 32, 32, 3).astype(np.float32) * 2 - 1
        got, want = tested(imgs), reference(imgs)
        for g, w in zip(got, want):
            w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
            worst = max(worst, relative_gap(g.cpu().numpy().reshape(len(imgs), -1),
                                            np.reshape(w, (len(imgs), -1))))
    return worst


def main(argv=None, reference: Optional[Callable] = None) -> int:
    """:param reference: the cross-check's reference classifier,
    ``fn(images) -> (logits, pool3)``; the executor on the CPU when None."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pb", default="fake_inception_v1.pb",
                   help="frozen graph; synthesized with its twin if missing")
    p.add_argument("--ckpt-dir", required=True,
                   help="the port's checkpoint folder of a trained CIFAR-architecture run "
                        "(tools/quality_smoke.py --ckpt-dir)")
    p.add_argument("--loss", default="rmb",
                   help="the loss the checkpointed run used (its loss state)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--eval-batches", type=int, default=781,
                   help="the reference protocol: 781 x 64, about 50k samples per side")
    p.add_argument("--crosscheck-batches", type=int, default=2)
    p.add_argument("--no-crosscheck", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from mmdgan_torch import resolve_device
    from mmdgan_torch.architectures import cifar_architecture
    from mmdgan_torch.metrics.inception import FrozenGraphClassifier
    from mmdgan_torch.metrics.scores import GenerativeModelMetric
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.tools import make_fake_inception
    from mmdgan_torch.tools.quality_smoke import blob_batches
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import init_train_state
    from mmdgan_torch.utils import checkpoint

    dev = resolve_device(args.device)
    if not os.path.isfile(args.pb):
        make_fake_inception.write(args.pb, seed=0)
        print(f"synthesized {args.pb} + twin", flush=True)

    worst = None
    if not args.no_crosscheck:
        worst = crosscheck(args.pb, dev, min(args.batch, 32), args.crosscheck_batches,
                           reference)
        against = "the CPU executor" if reference is None else "the given reference"
        print(f"executor on {dev} vs {against} cross-check: max rel diff {worst:.2e}",
              flush=True)
        if not worst < GATE:
            raise AssertionError(f"cross-check: max relative difference {worst:.3e} "
                                 f"is not below {GATE:g}")

    # the trained model (quality_smoke's checkpoint layout)
    model = SNGan(cifar_architecture(), num_class=0, loss_type=args.loss, device=dev)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g, device=dev)
    step = checkpoint.get_ckpt(args.ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
    checkpoint.restore_into(ts, checkpoint.ckpt_path(args.ckpt_dir, step))
    print(f"restored trained checkpoint at step {step}", flush=True)

    # the reference evaluation protocol
    metric = GenerativeModelMetric(classifier=FrozenGraphClassifier(args.pb, device=dev))
    data = (b["x"] for b in blob_batches(args.batch, size=32))

    def gen_batches():
        i = 0
        while True:
            yield model.generate(ts.params, ts.net_state,
                                 torch.Generator(dev).manual_seed(1000 + i), args.batch)
            i += 1

    seconds = {}
    start = time.time()
    inc_x, inc_g, fid_xx, fid_xg = metric.inception_score_and_fid(
        data, gen_batches(), num_batch=args.eval_batches, seconds=seconds)
    dt = time.time() - start
    n = args.eval_batches * args.batch
    print(json.dumps({
        "metric": "inception_rehearsal",
        "pb": args.pb,
        "ckpt_step": int(step),
        "samples": n,
        "is_x": float(inc_x),
        "is_g": float(inc_g),
        "fid_xx": float(fid_xx),
        "fid_xg": float(fid_xg),
        "crosscheck_max_rel_diff": worst,
        "eval_seconds": dt,
        "images_per_sec": 2 * n / dt,
        "classifier_images_per_sec": 2 * n / seconds["classifier"],
        "seconds_by_part": seconds,
        "device": str(dev),
        "note": ("random-weight inception-SHAPED graph: numbers are not "
                 "publication-comparable; swap --pb for the real "
                 "inception_v1_2015_12_05 .pb for parity"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
