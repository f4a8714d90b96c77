"""The experiment runner of the port (``experiments/runner.py:20-345``): the
my_test_*.py protocol as a CLI on one device (``--device``, ``cuda`` by
default). Each of N chunks trains, logs the SN sigmas, writes a 20x20
sprite from the fixed ``code_x`` (unless ``--skip-sampling``) and, in a
full run (``--debug-mode false``, no ``--skip-metrics``), scores IS(real),
IS(gen), FID(real, real) and FID(real, gen) over ``--eval-batches``
batches as ``eval/*`` scalars, the seconds of each part as ``time/eval_*``.

The flags are the JAX runner's, with its defaults. ``--optimizer`` takes
adam, adam_tf1, sgd, momentum and rmsprop (sgd and momentum decay to
``--end-lr`` over chunks x steps), ``--bf16-moments`` stores their slots in
bfloat16. ``--micro-batches M`` runs the accumulated step
(``build_grad_accum_step``), host-fed or, with ``--device-dataset``, inside
the device-data windows; ``--imbalanced-update`` runs inside
``--steps-per-call`` windows, its flags computed on the device.
``--inception-pb`` gives the frozen classifier graph; without it the
scores come from random features, comparable only within the port.
``--num-class C`` (C >= 2) reads labels with the images (synthetic labels
with ``--synthetic-data``) and trains the class-conditional model the
dataset's script builds; ``--sample-same-class`` takes each batch from
one class and generates that class. One flag raises and names its
ROADMAP item: ``--use-pallas`` (the TPU kernel; the port always runs its
own CUDA kernel-means kernel, B1). ``--compilation-cache DIR`` moves the
kernels' build directory to DIR. ``--loss`` takes every name of the loss
dispatcher.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the host-fed path
trains data-parallel, as the JAX runner's ``DataParallel()`` does
(``experiments/runner.py:238,295``): one rank per process on
``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``), each reading its
shard of the records (``ReadTFRecords.shard``) at
``local_batch_size(--batch-size)`` rows, the global batch keeping the
one-device semantics; rank 0 writes the checkpoints, the summaries, the
sprites and the scores. The device-resident path stays on one device per
process, as JAX's does (``runner.py:272``)::

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m mmdgan_torch.experiments.cifar --batch-size 64 ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Sequence

import numpy as np
import torch


def build_arg_parser(dataset: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"Train MMD-GAN ({dataset}) with the PyTorch port — rebuild of "
                    f"the reference my_test_{dataset}.py")
    p.add_argument("--loss", default="rep",
                   help="loss type, any name of the dispatcher (mmdgan_torch.ops.losses."
                        "LOSS_TYPES): rep | rmb | rep_gp | rmb_ds | mmd_g | hinge | ...")
    p.add_argument("--lr-dis", type=float, default=5e-4)
    p.add_argument("--lr-gen", type=float, default=2e-4)
    p.add_argument("--end-lr", type=float, default=1e-7,
                   help="end of the decay schedules of SGD/momentum (adam keeps its lr)")
    p.add_argument("--optimizer", default="adam",
                   help="adam | adam_tf1 | sgd | momentum | rmsprop")
    p.add_argument("--bf16-moments", action="store_true",
                   help="store the optimizer slots (Adam m/v, momentum, RMS) in bfloat16")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--act-k", type=float, default=None,
                   help="activation compensation multiplier (default per dataset)")
    p.add_argument("--rep-w0", type=float, default=0.0)
    p.add_argument("--rep-w1", type=float, default=-1.0)
    p.add_argument("--chunks", type=int, default=8,
                   help="number of train->eval rounds (reference: 8)")
    p.add_argument("--steps-per-chunk", type=int, default=12500)
    p.add_argument("--num-class", type=int, default=0)
    p.add_argument("--sample-same-class", action="store_true")
    p.add_argument("--imbalanced-update", default=None,
                   help="'d,g' period list (e.g. '1,5'), or 'dynamic'")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--synthetic-data", action="store_true",
                   help="train on synthetic images (no dataset needed)")
    p.add_argument("--debug-mode", default="false", choices=["false", "true", "none"],
                   help="false: full run; true: short debug run; none: print model only")
    p.add_argument("--debug-step", type=int, default=400)
    p.add_argument("--query-step", type=int, default=1000)
    p.add_argument("--trace", action="store_true", help="profile last 5 steps")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--load-ckpt", action="store_true", default=True)
    p.add_argument("--fresh", dest="load_ckpt", action="store_false")
    p.add_argument("--eval-batches", type=int, default=781,
                   help="metric batches per eval (781*64 ~ 50k samples)")
    p.add_argument("--skip-metrics", action="store_true")
    p.add_argument("--skip-sampling", action="store_true")
    p.add_argument("--inception-pb", default=None,
                   help="path to frozen inception .pb for exact IS/FID parity")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--steps-per-call", type=int, default=16,
                   help="K train steps per CUDA graph launch (an imbalanced schedule "
                        "is computed on the device inside the window)")
    p.add_argument("--device-dataset", action="store_true",
                   help="upload the whole dataset to device memory once and take "
                        "batches on the device")
    p.add_argument("--sampling", default="uniform", choices=["uniform", "shuffled_epochs"],
                   help="device-dataset batches: uniform with-replacement gather, or "
                        "shuffled_epochs (without-replacement epoch slices, re-permuted "
                        "per epoch)")
    p.add_argument("--host-decode", action="store_true",
                   help="scale images to f32 on the host instead of the device")
    p.add_argument("--use-pallas", action="store_true",
                   help="the TPU's fused Pallas MMD kernel (not ported: ROADMAP B1)")
    p.add_argument("--summary-histograms", action="store_true",
                   help="fixed-bin hist/* summaries of distances and scores from the step")
    p.add_argument("--param-hist-step", type=int, default=0,
                   help="write per-variable parameter histograms every N steps (0 = off)")
    p.add_argument("--micro-batches", type=int, default=1, metavar="M",
                   help="exact gradient accumulation: run each batch in M micro-batch "
                        "chunks at 1/M activation memory (the hd configurations)")
    p.add_argument("--compilation-cache", default="", metavar="DIR",
                   help="persistent compilation cache directory: a restarted process "
                        "(resume, next chunk, serving worker) loads the built CUDA "
                        "kernels instead of running nvcc (utils/compilation_cache.py)")
    p.add_argument("--device", default="cuda",
                   help="the device to train on: cuda (default) or cpu")
    return p


def refuse_unported(args) -> None:
    """Raise for a flag whose module the port does not have yet."""
    unported = [
        (args.use_pallas, "--use-pallas selects the TPU's Pallas kernel; the port runs "
                          "its CUDA kernel-means kernel (ROADMAP B1)"),
    ]
    for refused, why in unported:
        if refused:
            raise NotImplementedError(why)
    if args.sampling != "uniform" and not (args.device_dataset and not args.synthetic_data):
        raise ValueError("--sampling shuffled_epochs only applies to the device-resident "
                         "dataset: pass --device-dataset (without --synthetic-data)")


def run_name(loss_type: str, lr_list: Sequence[float], act_k: float,
             rep_weights: Sequence[float]) -> str:
    """The run's sub-folder; the repulsive weights enter only for rep and
    rmb (``experiments/runner.py:152-157``)."""
    name = "sngan_{}_{:.0e}_{:.0e}_k{:.3g}".format(loss_type, lr_list[0], lr_list[1], act_k)
    if loss_type in ("rep", "rmb"):
        name += "_{:.1f}_{:.1f}".format(rep_weights[0], rep_weights[1])
    return name


def run_experiment(args, architecture: dict, filename, num_instance: int,
                   input_chw: Sequence[int]):
    from mmdgan_torch import resolve_device
    from mmdgan_torch.config import get_config, set_config
    from mmdgan_torch.data.pipeline import ReadTFRecords
    from mmdgan_torch.data.synthetic import synthetic_image_batches
    from mmdgan_torch.models.sngan import SNGan
    from mmdgan_torch.parallel import DataParallel
    from mmdgan_torch.train.optim import multi_opt_config
    from mmdgan_torch.train.step import build_grad_accum_step, build_train_step, init_train_state
    from mmdgan_torch.train.trainer import Agent

    refuse_unported(args)
    cfg = get_config()
    if args.data_dir:
        cfg = cfg.with_updates(data_dir=args.data_dir)
    if args.out_dir:
        cfg = cfg.with_updates(output_dir=args.out_dir)
    if args.inception_pb:
        cfg = cfg.with_updates(inception_pb=args.inception_pb)
    set_config(cfg)
    if args.compilation_cache:
        from mmdgan_torch.utils.compilation_cache import enable_compilation_cache

        print(f"Compilation cache: {enable_compilation_cache(args.compilation_cache)}")
    use_device_data = args.device_dataset and not args.synthetic_data
    # launched by torchrun: the host-fed path is data-parallel
    dp = DataParallel(device=args.device) if "WORLD_SIZE" in os.environ else None
    device = resolve_device(args.device) if dp is None else dp.device
    main = dp is None or dp.is_main
    feed_dp = None if use_device_data else dp
    local_batch = args.batch_size if feed_dp is None else feed_dp.local_batch_size(
        args.batch_size)

    c, h, w = input_chw
    loss_type = args.loss
    lr_list = [args.lr_dis, args.lr_gen]
    rep_weights = [args.rep_w0, args.rep_w1]
    act_k = architecture["discriminator"][-1].get("act_k", 1.0)
    sub_folder = run_name(loss_type, lr_list, act_k, rep_weights)

    debug_mode = {"false": False, "true": True, "none": None}[args.debug_mode]
    imbalanced = args.imbalanced_update
    if imbalanced and imbalanced != "dynamic":
        imbalanced = [int(v) for v in imbalanced.split(",")]
    name = filename if isinstance(filename, str) else filename[0].split("_")[0]
    agent = Agent(name, sub_folder, load_ckpt=args.load_ckpt, do_trace=args.trace,
                  do_save=not args.no_save, debug_mode=debug_mode,
                  debug_step=args.debug_step, query_step=args.query_step,
                  imbalanced_update=imbalanced, print_loss=True,
                  output_dir=cfg.output_dir, param_hist_step=args.param_hist_step)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = SNGan(architecture, num_class=args.num_class, loss_type=loss_type,
                  rep_weights=rep_weights, compute_dtype=compute_dtype,
                  summary_histograms=args.summary_histograms, device=device)
    model.sample_same_class = args.sample_same_class
    num_labels = 0 if args.num_class < 2 else 1

    step_per_epoch = int(np.floor(num_instance / args.batch_size))
    # file_repeat gcd trick (my_sngan.py:381-397), per class for labelled data
    if args.steps_per_chunk >= step_per_epoch or isinstance(filename, str):
        per_repeat = num_instance if args.num_class < 2 else int(num_instance / args.num_class)
        file_repeat = int(args.batch_size / math.gcd(per_repeat, args.batch_size))
        shuffle_file = False
    else:
        file_repeat = 1
        shuffle_file = True

    def make_data_iter(batch_size: int = args.batch_size, rank: int = 0, shards: int = 1):
        if args.synthetic_data:
            return synthetic_image_batches(batch_size, h, w, c, num_class=args.num_class,
                                           seed=args.seed + rank)
        return ReadTFRecords(filename, num_labels=num_labels, batch_size=batch_size,
                             file_repeat=file_repeat, shuffle_file=shuffle_file,
                             device_decode=not args.host_decode,
                             ).shard(shards, rank).shape2image(c, h, w).next_batch(
                                 args.sample_same_class)

    def train_iter():
        """The rank's batches: its shard of the records at its rows."""
        if feed_dp is None:
            return make_data_iter()
        return make_data_iter(local_batch, feed_dp.rank, feed_dp.size)

    opt_d, opt_g = multi_opt_config(lr_list, end_lr=args.end_lr, optimizer=args.optimizer,
                                    target_step=args.chunks * args.steps_per_chunk,
                                    bf16_moments=args.bf16_moments)
    ts = init_train_state(model, args.seed, opt_d, opt_g, device=device)
    # the device-resident path builds its own step in train_device_data
    step_fn = None
    if not use_device_data:
        step_fn = (build_grad_accum_step(model, opt_d, opt_g, args.micro_batches, device=device,
                                         dp=feed_dp)
                   if args.micro_batches > 1 else
                   build_train_step(model, opt_d, opt_g, device=device, dp=feed_dp))
    name_of = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if main:
        print(f"Devices: {1 if feed_dp is None else feed_dp.num_devices} ({device} {name_of}"
              f"{'' if feed_dp is None else f', {feed_dp.backend} mesh'}); "
              f"Num instance: {num_instance}; Num class: {args.num_class}; "
              f"Batch: {args.batch_size}; File_repeat: {file_repeat}", flush=True)

    device_data = None
    if use_device_data:
        device_data = ReadTFRecords(filename, num_labels=num_labels, batch_size=args.batch_size,
                                    device_decode=True).shape2image(c, h, w).load_all()
        if main:
            print(f"Device-resident dataset: x{device_data['x'].shape} "
                  f"{device_data['x'].dtype} "
                  f"({device_data['x'].nbytes / 2**20:.1f} MiB to the device)", flush=True)

    code_x = np.random.RandomState(args.seed).randn(400, model.code_size).astype(np.float32)
    # assumed TF1-GPU reference throughput at this resolution (bench.py
    # BASELINES: 12 steps/s at 32x32, scaled by pixel count)
    baseline_sps = 12.0 * (32.0 / max(h, w)) ** 2
    train_seconds = 0.0
    train_steps = 0
    max_step = args.steps_per_chunk if debug_mode is not True else args.debug_step

    for chunk in range(args.chunks):
        step_before = int(ts.step)
        t_train = time.time()
        images = lambda ts: model.generate(ts.params, ts.net_state,
                                           torch.Generator(device).manual_seed(chunk), 8)
        if device_data is not None:
            ts = agent.train_device_data(
                model, opt_d, opt_g, ts, device_data, max_step=max_step,
                step_per_epoch=step_per_epoch, batch_size=args.batch_size,
                steps_per_call=max(args.steps_per_call, 16), summary_image_fn=images,
                seed=args.seed + chunk, sample_same_class=args.sample_same_class,
                sampling=args.sampling,
                # the epoch permutations must not change at chunk boundaries
                sampling_seed=args.seed, micro_batches=args.micro_batches)
        else:
            ts = agent.train(step_fn, ts, train_iter(), max_step=max_step,
                             step_per_epoch=step_per_epoch, dp=feed_dp, summary_image_fn=images,
                             steps_per_call=args.steps_per_call)
        if debug_mode is None:
            return ts
        gstep = int(ts.step)
        train_seconds += time.time() - t_train
        train_steps += gstep - step_before
        if not main:
            continue
        # per-layer spectral norms (reference kernel_norm summaries)
        norms = model.Dis.kernel_norms(ts.params["dis"], ts.net_state["dis"])
        agent.writer.scalars(gstep, {f"sigma/{k}": v for k, v in norms.items()
                                     if isinstance(v, float)})
        if not args.skip_sampling:
            model.eval_sampling(ts.params, ts.net_state, agent.filename, sub_folder,
                                mesh_num=(20, 20), mesh_mode=0, code_x=code_x, do_sprite=True,
                                do_embedding=False, get_dis_score=False,
                                output_dir=cfg.output_dir, global_step=gstep)
        if debug_mode is False and not args.skip_metrics:
            seconds = {}
            scores = model.mdl_score(
                ts.params, ts.net_state, make_data_iter(), batch_size=args.batch_size,
                num_batch=args.eval_batches, model="v1", model_path=cfg.inception_pb,
                generator=torch.Generator(device).manual_seed(1000 + chunk), seconds=seconds)
            print(f"Chunk {chunk} scores (inc_x, inc_g, fid_xx, fid_xg): {scores}; seconds "
                  f"by part: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
                  flush=True)
            agent.writer.scalars(gstep, {
                "eval/inception_real": scores[0],
                "eval/inception_gen": scores[1],
                "eval/fid_xx": scores[2],
                "eval/fid_xg": scores[3],
            })
            agent.writer.scalars(gstep, {f"time/eval_{k}": v for k, v in seconds.items()})
    if not main:
        return ts
    agent.writer.flush()
    if train_steps > 0 and train_seconds > 0:
        sps = train_steps / train_seconds
        print(json.dumps({
            "metric": f"train_steps_per_sec_{agent.filename}",
            "value": round(sps, 2),
            "unit": "steps/sec",
            "vs_baseline": round(sps / baseline_sps, 3),
        }), flush=True)
    print("Chunk of code finished.", flush=True)
    return ts
