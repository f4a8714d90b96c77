#!/usr/bin/env python3
"""Drive the PyTorch port (``mmdgan_torch``) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments (every phase):

    python3 chip_smoke.py

or with ``--phases 3,16,17`` for some of them (phase 3 always runs: the
kernels line needs it; that line sums the launches of the phases that ran,
named on the line after the timing). The main process's log lines start
with the seconds since it started.

Order: the parts of the chosen phases that time things run first, in
phase order, alone on the card. Then the checks that time nothing (4, 6,
7's and 12b's bitwise runs, 9's and 10's determinism, 10's accumulation,
11's optimizer windows, 12's card-vs-CPU models, 16d, 17's tc layer) run in this process
while the phases' subprocesses that time nothing run beside them: the CLI
smokes of 8, 10 and 12, 13b and 13d (its resumed CLI started by a thread
when the fresh one ends), 14's gloo ranks and step profiler, and 16c's
checkpoint run. Last, 16c's rehearsal.

Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile every CUDA kernel of the main path from ``mmdgan_torch/csrc``,
   and log each kernel's registers, shared memory and spills (``ptxas -v``
   of a device-only compile beside the build);
3. kernels: each kernel against its plain PyTorch version on the card,
   then timed beside it: the forward's means (rtol 1e-5 / atol 1e-6) at
   (64, 16), (23, 5) and (256, 16); the backward's gradients (rtol 1e-4,
   atol 1e-8 plus the mask-rounding term of ``kernel_means_backward_atol``)
   at those, (64, 256), (256, 256), the ragged (100, 37) and the smallest
   (2, 1), and on saturated inputs whose raw gen-gen distances go below 0
   at (64, 16), (256, 16) and (256, 256), for four cotangents; two
   launches of each bitwise equal, three replays of a captured backward
   bitwise equal to its eager launch, and the autograd path of
   ``fused_kernel_means`` against autograd of the plain means; then both
   held, timed and bounded at (16, 16), (256, 16), (64, 8), (128, 8),
   (128, 2), (64, 256) and (256, 256), beside their plain versions;
4. reference: a narrow float32 model, three steps on the card (kernel path)
   against the same three steps on the CPU (plain path), after a first
   'rmb' step that both run (step 0 is degenerate), TF32 off, for
   'rmb' and for the losses that draw nothing inside the loss ('hinge',
   'mmd_t', 'cramer', 'mgb', and 'rep_ds' / 'rmb_ds' with their Jacobian
   scale);
5. main path: the full-width CIFAR-10 SNGAN at batch 64, bf16, for the
   'rep' and 'rmb' losses, through ``build_multi_step``: K=16 steps per
   CUDA graph launch, and the same windows eager (``capture=False``).
   A counted run profiles every window of a graphed driver (its eager
   warm-up, the capture's replay and more replays) and of an eager one:
   the profiler's count of kernel-means kernels is the launches reported,
   one forward and two backward per step in every window (the step's two
   ``autograd.grad`` calls); device busy time, idle share and activities
   per step of a replayed and an eager window. The profiles are read from
   the profiler's raw results; in rep's second window those hold the
   same device activities as ``prof.events()``, name for name, with the
   same total time. Then unprofiled windows give steps/s of both; finite metrics, parameters, SN vectors and BN
   statistics changed;
6. determinism, under deterministic algorithms: graphed and eager 'rmb'
   windows fed the same code batches end bitwise equal, two graphed runs
   end bitwise equal, and two successive replays draw different z;
7. trainer: ``Agent.train_device_data`` at full width on a CIFAR-sized
   uint8 dataset from a seed, resident on the card: 1,600 shuffled-epochs
   steps across two epoch boundaries, a checkpoint and a resume by a new
   Agent; under deterministic algorithms 800 straight steps against 400 +
   restore + 400, and graphed against eager (``capture=False``)
   device-data windows, shuffled and uniform, all bitwise; uniform
   sampling;
8. CLI: ``python -m mmdgan_torch.experiments.cifar`` host-fed on synthetic
   data and over a seeded tfrecord resident on the card, side by side;
   both exit 0 and print their throughput line;
9. losses: every distinct loss of the dispatcher on the full-width model
   at b64 bf16 through ``build_multi_step`` (K=16): an eager warm-up
   window, the capture, two timed replays (graphed steps/s); the
   wrappers' counters grow for the repulsive family only; for it and
   four others one replay under the profiler (device busy, idle share,
   activities per step, and the kernel-means launches: 1 forward + 2
   backward per step for the repulsive family, penalised and scaled, 0
   for the others); finite metrics, the final losses, the loss state
   moved for the stateful losses. Then, under deterministic algorithms, graphed and eager
   'rep_gp' windows (double backward inside the graph) end bitwise equal;
10. families, accumulation and imbalanced windows:
   - STL-10 48x48 and CelebA 64x64 at full width, rep b64 bf16, graphed
     K=16 windows on a noise feed: steps/s over 128 timed steps, one
     profiled replay (device busy, idle share, activities, 1 + 2
     kernel-means launches per step), e_kxx;
   - hd512 at full width, rep b64 bf16, ``build_device_data_step`` over a
     seeded 256 x 512 x 512 x 3 uint8 dataset on the card, at
     micro_batches 1 and 8: steps/s, peak memory, 1 + 2 kernel-means
     launches per optimizer step in a profiled replay;
   - a narrow f32 accumulated step (M=4, rep and rmb_gp) on the card
     against the CPU; on a BN-free narrow model the accumulated step
     against the fused one; under deterministic algorithms graphed and
     eager windows bitwise equal for the accumulated step (M=4) and for
     a [1, 5] imbalanced window, whose Adam counts advance by 16 (D) and
     by the steps divisible by 5 (G) per window;
   - the stl, celeba and lsun CLIs on synthetic data, celeba over a
     seeded 64x64 tfrecord on the card with ``--micro-batches 4``, and
     cifar with ``--imbalanced-update 1,5 --steps-per-call 16``, in five
     subprocesses side by side;
11. eval and optimizers:
   - ``python -m mmdgan_torch.experiments.cifar`` in this process with the
     eval path on, full width, rep b64 bf16: 64 steps in graphed K=16
     windows, the 20x20 sprite, IS/FID over 781 x 64 samples per side with
     the random-feature classifier, the CLI's seconds by part (data,
     generation, classifier, host FID), the kernel-means counters at 1 + 2
     per step of the eager and captured windows; then the CLI with
     ``--loss rmb --rep-w0 1 --rep-w1 0`` (training and the sprite) on the
     plain path (0 launches);
   - card vs CPU, TF32 off, rtol 1e-3: the random-feature classifier at
     32x32 and 299x299, MS-SSIM, SWD, the TF1 resize, the MS-SSIM score's
     resize and the GraphDef executor on ``tests/data/narrow_inception.pb``;
     the classifier's images/s on the card;
   - each optimizer (and adam's bf16 slots) through three graphed K=16 windows of
     the narrow f32 model card vs CPU, sgd and momentum decaying their lr
     on the device across the replays; graphed steps/s of the full-width
     model by optimizer.
12. the class-conditional models and the layer catalogue:
   - ``cifar_architecture(conditional=True)`` at full width (cbn
     generator, dck head, 10 classes), rep b64 bf16, host labels,
     graphed K=16: steps/s over 128 timed steps, one profiled replay
     (device busy, idle share, activities, 1 + 2 kernel-means launches
     per step), the cbn and dck parameters moved;
   - same-class device data over a seeded 50,000-row labelled uint8
     array (5,000 per class): 256 batches of each sampler read on the
     card, each one class; steps/s of labelled uniform, same-class
     uniform and same-class shuffled-epochs (class schedule) windows;
     under deterministic algorithms graphed = eager windows and an
     ``Agent.train_device_data(sample_same_class=True)`` resume = a
     straight run, bitwise;
   - card vs CPU, TF32 off, rtol 1e-3: three f32 steps of narrow
     conditional models holding every conditional op, the catalogue
     model's forward and one step, the lrn/k/pooling ops and a
     split/concat/sum Routine;
   - the conditional cifar CLI with ``--sample-same-class`` on synthetic
     data, host-fed over a labelled tfrecord, and from the card, in three
     subprocesses side by side.
13. data parallelism (``mmdgan_torch/parallel``), each part in its own
   processes (``chip_smoke.py --mesh-rank ...``), so no process group
   outlives its part:
   - 13a, a one-rank NCCL group: the full-width CIFAR-10 rep b64 bf16 main
     path through ``DataParallel``, graphed K=16 with the collectives
     captured: three profiled windows (1 + 2 kernel-means launches per
     step, NCCL kernels per step and their device time, idle share),
     steps/s beside the non-mesh window in turns, two mesh runs bitwise
     equal under deterministic algorithms, a mesh window against the
     non-mesh one from the same state within stated bounds;
   - 13c, the same rank: the sharded device-data window (``with_mesh``)
     over phase 12's labelled array, uniform, shuffled epochs,
     same-class (every batch one class) and uniform with an imbalanced
     [1, 5] schedule: steps/s;
   - 13b, two gloo ranks sharing the card (eager windows): the narrow
     rep and rmb_gp steps equal one device at the global batch within
     JAX's mesh bounds, the two replicas bitwise identical;
   - 13d, ``python -m torch.distributed.run --standalone --nproc-per-node
     1 -m mmdgan_torch.experiments.cifar``, host-fed, a chunk with a
     checkpoint, then a resumed one; beside 13b.
14. serving and sharding (``utils/export.py``, ``tools/``,
   ``utils/compilation_cache.py``, the sharded state of
   ``parallel/mesh.py``):
   - 14a, this process: images/s of the full-width CIFAR-10 generator
     (bf16) in-process and exported at batch 64, 256 and 1024, and of
     hd512's at 16 and 64 (``tools/serving_bench.py``, CUDA events), the
     seconds to export; the artifact against in-process generation,
     bitwise in f32 (unconditional and conditional), within 2^-7 in bf16;
     the bf16 artifact loaded in a fresh process that imports torch alone
     (its seconds to the first images);
   - 14b, a one-rank NCCL group: the CIFAR-10 rep b64 bf16 graphed window
     on a ``shard_state(fsdp=True)`` state (gathers and reduce-scatters
     captured): three profiled windows (1 + 2 kernel-means launches per
     step, collectives per step, busy time, activities), steps/s beside
     the non-mesh window in turns, one FSDP window bitwise equal to the
     replicated mesh's under deterministic algorithms, and
     ``export_generator(dp=)`` at the rank; beside it a cold nvcc build
     into a new compilation cache, then, alone, a second process's cache
     hit;
   - 14c, two gloo ranks sharing the card under fsdp: the narrow f32 rep
     and rmb_gp steps equal one device within JAX's mesh bounds, the
     gathered replicas bitwise identical, and the full-width CIFAR-10
     state's persistent parameter + Adam bytes per rank against the
     replicated layout's; 14d, four gloo ranks as a (2, 2) mesh, the
     narrow rep steps likewise; beside them ``python -m
     mmdgan_torch.tools.profile_step --arch cifar`` (a smoke of the tool:
     its times there are not a measurement).
15. real data, the data and checkpoint utilities and the learning tools:
   - 15a: five CIFAR-10 binary batches (50,000 seeded records of 3,073
     bytes) converted by ``data/converters.py`` (``save_label=False``);
     the g++ build of ``csrc/tfrec.cc`` timed (cold or a hit) and a second
     process's load of it; each reader's records/s alone and their first
     256 batches bitwise equal; the main path (CIFAR-10 rep b64 bf16,
     graphed K=16) host-fed from the records by the native and the Python
     reader in turns (steps/s, a profiled replay per turn, 1 + 2
     kernel-means launches per step); then the cifar CLI in this process
     over the records (``--data-dir``, ``--skip-metrics``), its
     metrics.jsonl read back with ``utils/events.py``; every CLI run of
     this script passes ``--use-pallas`` (the kernel pair, as the Python
     API's default) except one: two K=16 windows over the same records
     without it, JAX's default path, whose counters must read [0, 0];
   - 15b: the kernels at SimData's, figure1's and 15e's widths: timed in
     phase 3;
   - 15c: ``SimData`` learning on the card (tests/test_integration.py's
     recipe, 800 f32 steps in graphed windows, one more replay profiled):
     MMD below 0.7 of its start, the mean within 0.25 of mu;
   - 15d: ``tools/figure1.py``'s ``particle_run`` (rep, 600 steps, the
     shell target), its first 10 steps against the CPU at rtol 1e-4;
   - 15e: ``tests/data/tf1_narrow`` (a TF1 bundle written by TF, NCHW)
     read with no TensorFlow into a model on the card, its outputs against
     JAX's committed ones at rtol 1e-3, then 16 steps from it.
16. the last four tools (``mmdgan_torch/tools``):
   - 16a: ``python -m mmdgan_torch.tools.preflight`` exits 0 with a
     healthy line for the GPU (launch latency, bf16 matmul rate,
     pageable and pinned bandwidth both ways);
   - 16b: ``tools/scaling_study.py``'s sweeps on the full-width CIFAR-10
     rep b64 bf16 model: K = 1..64 at batch 64, then batch 16..256 at K=16,
     each point a fresh state, an eager window, the capture and 192 timed
     steps (the tool's default is 384); K = 8, 16 and 32 again, against their first readings; 1 + 2
     kernel-means launches per step in the counters of every eager window
     and capture and in one profiled replay per K; both Markdown tables;
   - 16c: the fake inception graph (``tools/make_fake_inception.py``,
     9.6 MB, 299x299 in, pool_3 2048 wide); a 32-step rmb
     ``tools/quality_smoke.py --ckpt-dir`` run writes a checkpoint, beside
     16d; ``tools/inception_rehearsal.py`` restores it and runs 781 x 64
     real and generated images per side through the graph on the card (IS,
     FID, the classifier's images/s, the seconds by part), its executor
     on the card within a relative 1e-4 of the CPU's;
   - 16d: ``tools/imagenet_prep.py`` ``extract`` on a train tar written
     here, and ``ref-stats`` over three classes of 300 seeded 64x64 rows
     through the fake graph, on the card and on the CPU: every class's
     mean and covariance agree at rtol 1e-3;
   - 16e: ``tools/parity_run.py`` twice under deterministic algorithms
     (16 f32 steps of the full-width CIFAR-10 rep model): the curves
     bitwise equal, the reference formulas within 1.1e-5 of ``gan_loss``;
   - 16f: ``tools/sweep_grid.py``, one cell of 32 graphed steps on its
     blob dataset on the card, beside the checks: finite FID, IS, losses.
17. the five studies (``mmdgan_torch/tools``), each at a cut size that the
   log names:
   - 17a: ``kernel_study`` (both kernels held and timed at d = 256 in
     phase 3): the study's gate (its scalar and gradient, kernel against
     plain) and microbench at (64, 16), (64, 256), (256, 16), (256, 256),
     64 chained iterations per graph (the tool's 512); the CIFAR step with
     ``use_fused_kernel`` on and off for rep and rmb_gp at b64, 64 timed
     steps a reading, on and off in turns twice, the counters at 1 + 2 per
     step of each fused reading and 0 with the kernel off;
   - 17b/17c: ``conv_study`` on ``l1_f64`` (direct, pad8), ``l2_ds``
     (direct, s2d) and ``l7`` (direct, im2col) and ``tc_study`` on cifar's
     ``g4``, hd128's ``g6`` and hd512's ``g8`` (every variant), NCHW and
     ``channels_last``, bf16 b64, each variant gated in float32 with TF32
     off first; then a ``tc`` layer built with ``TC_PS3_MIN_SIZE`` at 64
     (ps3) against the direct route on the card, output and both
     gradients, beside the other checks;
   - 17d: ``hbm_study``'s synthetic, base, pregather and cursor variants on
     cifar over 50,000 seeded rows, 128 timed steps each;
   - 17e: ``export_study`` on cifar at b256: images/s of the in-process,
     exported and weights-as-inputs generators.

The line before the last two is a JSON object of the kernels, the next
the nvidia-smi line, the last ``{"ok": true, "device": {...}}``. Without a
GPU, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import cache, partial
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mmdgan_torch.architectures import (  # noqa: E402
    celeba_architecture,
    cifar_architecture,
    hd_architecture,
    stl_architecture,
)
from mmdgan_torch.data.synthetic import synthetic_image_batches  # noqa: E402
from mmdgan_torch.data.tfrecord import np_to_tfrecords  # noqa: E402
from mmdgan_torch.models.sngan import SNGan  # noqa: E402
from mmdgan_torch.ops import _build, cuda_mmd  # noqa: E402
from mmdgan_torch.ops.losses import LossState  # noqa: E402
from mmdgan_torch.train.optim import OptState, multi_opt_config  # noqa: E402
from mmdgan_torch.train.state import TrainState, loss_state_leaves, tree_leaves, tree_map  # noqa: E402
from mmdgan_torch.models.network import Net, Routine  # noqa: E402
from mmdgan_torch.models.ops import ParametricOp  # noqa: E402
from mmdgan_torch.train.step import (  # noqa: E402
    build_device_data_step,
    build_grad_accum_step,
    build_imbalanced_multi_step,
    build_multi_step,
    build_train_step,
    class_schedule,
    graph_steps,
    init_train_state,
    same_class_tables,
)
from mmdgan_torch.tools.kernel_study import (  # noqa: E402
    kernel_means_backward_bound_ms,
    kernel_means_bound_ms,
)
from mmdgan_torch.tools.profile_step import check_raw_activities, window_timeline  # noqa: E402
from mmdgan_torch.train.trainer import Agent  # noqa: E402

BATCH, SCAN_K = 64, 16              # bench.py's cifar line
AGENT_ROWS = 50000                  # CIFAR-10's training set
WARMUP_CALLS, MEASURE_CALLS = 2, 8
COUNTED_GRAPHED, COUNTED_EAGER = 4, 2   # profiled windows of phase 5's counted run
DATA_WINDOWS = 4                    # phase 7's graphed vs eager device-data windows
# the kernel-means kernels by their names in a profile, and launches per step
KERNEL_EVENTS = {"kernel_means_fwd": 1, "kernel_means_bwd": 2}
KERNEL_SHAPES = [(64, 16), (23, 5), (256, 16)]
# the backward's shapes: the forward's, d = 256, a ragged pair across every
# tile and chunk edge, and the smallest input the wrapper takes; saturated
# inputs at three of them
BACKWARD_SHAPES = KERNEL_SHAPES + [(64, 256), (256, 256), (100, 37), (2, 1)]
SATURATED_SHAPES = [(64, 16), (256, 16), (256, 256)]
GRAPH_REPLAYS = 3                   # replays of a captured backward held to the eager launch
# phase 3's timed shapes beside the main path's (64, 16): phase 16b's smallest
# and largest batch, 15e's (64, 8) and SimData's and figure1's widths, d = 256
TIMED_SHAPES = [(16, 16), (256, 16), (64, 8), (128, 8), (128, 2), (64, 256), (256, 256)]
# phase 4's losses, and phase 9's: every distinct branch of the dispatcher
CPU_CHECK_LOSSES = ("rmb", "hinge", "mmd_t", "cramer", "mgb", "rep_ds", "rmb_ds")
LOSSES = ("logistic", "hinge", "wasserstein", "mmd_g", "mgb", "mmd_t", "cramer", "mmd_g_mix",
          "sgm", "rand_g", "rgb", "rand_g_mix", "sym_rg_mix", "sym_rg", "instance_noise",
          "rep", "rep_gp", "rep_ds", "rmb", "rmb_gp", "rmb_ds", "test")
KERNEL_LOSSES = ("rep", "rep_gp", "rep_ds", "rmb", "rmb_gp", "rmb_ds")
STATEFUL_LOSSES = ("mmd_g_mix", "sgm", "rand_g_mix", "sym_rg_mix", "instance_noise")
PROFILED_LOSSES = KERNEL_LOSSES + ("logistic", "mmd_g", "rand_g_mix", "wasserstein")
HD_SIZE, HD_ROWS, HD_MICRO = 512, 256, (1, 8)   # bench.py's hd512 line
HD_CALLS = 1                        # timed windows of each hd512 run
ACCUM_M = 4                         # the accumulated step of phase 10's checks
IMBALANCED = [1, 5]
EVAL_STEPS, EVAL_BATCHES = 64, 781  # phase 11: the reference protocol's 781 x 64 samples
# (optimizer, bf16 slots, lr): rmsprop and the Adams step every parameter by
# about lr whatever its gradient (rmsprop's first step by 3.16 lr), so rounding
# noise moves the GAN's 48 steps apart on two devices unless lr is small
OPTIMIZER_CASES = (("sgd", False, 1e-2), ("momentum", False, 1e-2), ("rmsprop", False, 1e-5),
                   ("adam", False, 1e-5), ("adam_tf1", False, 1e-5), ("adam", True, 1e-5))
OPT_WINDOWS, OPT_BATCH = 3, 4
OPT_MEASURE_CALLS = 4               # timed windows per optimizer (64 steps)
PLAIN_CALLS = 200                   # timed calls of a plain version (each 0.5-3 ms)
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)


_START = []   # the main process's start: its log lines begin with the seconds since


def log(msg: str) -> None:
    print(f"{time.perf_counter() - _START[0]:7.1f} {msg}" if _START else msg, flush=True)


def scores(b: int, d: int, seed: int, device) -> tuple:
    """Score pairs whose distances straddle both rmb bounds."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        scale = rng.uniform(0.05, 0.5, (b, 1)) * np.sqrt(16.0 / d)
        out.append(torch.tensor((rng.randn(b, d) * scale).astype(np.float32), device=device))
    return tuple(out)


def saturated_scores(b: int, d: int, seed: int, device) -> tuple:
    """The saturated regime (e_kxx near 1): gen rows that are one row plus
    noise at 1e-4 of its scale, whose raw distances sit at 0 up to rounding
    and many come out negative; data rows as in ``scores``."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1, d) * 0.25
    sg = (base + 2.5e-5 * rng.randn(b, d)).astype(np.float32)
    sx = (rng.randn(b, d) * rng.uniform(0.05, 0.5, (b, 1))).astype(np.float32)
    return torch.tensor(sg, device=device), torch.tensor(sx, device=device)


def cotangents(device) -> dict:
    """d(loss)/d(means) of the step's losses (repulsive weights (0, -1)) and
    a random one."""
    return {name: torch.tensor(np.asarray(ct, np.float32), device=device) for name, ct in (
        ("random", np.random.RandomState(3).randn(6)),
        ("loss_gen", [1, -2, 1, 0, 0, 0]),
        ("rep_loss_dis", [-1, 0, 1, 0, 0, 0]),
        ("rmb_loss_dis", [0, 0, 0, -1, 0, 1]))}


def assert_grads_close(got, want, atols, what: str) -> float:
    """rtol 1e-4 / atol 1e-8, plus the mask-rounding term of
    ``kernel_means_backward_atol``; returns the largest |got - want|."""
    err = 0.0
    for name, g, w, extra in zip(("g_gen", "g_x"), got, want, atols):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + extra, err_msg=f"{what}: {name}")
        err = max(err, float((g - w).abs().max()))
    return err


def cuda_ms(fn, calls: int, warmup: int = 20) -> float:
    """Milliseconds per call between CUDA events around ``calls`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(fn, per_graph: int = 100, replays: int = 20) -> float:
    """Device milliseconds per call with the host taken out: ``per_graph``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()   # warm the allocator outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, replays, warmup=2) / per_graph


def check_kernel_means(dev) -> dict:
    """Phase 3: the CUDA kernel against its plain version, then timed."""
    max_err = 0.0
    for i, (b, d) in enumerate(KERNEL_SHAPES):
        sg, sx = scores(b, d, seed=i, device=dev)
        got = cuda_mmd.kernel_means_cuda(sg, sx, 1.0)
        again = cuda_mmd.kernel_means_cuda(sg, sx, 1.0)
        want = cuda_mmd.kernel_means_reference(sg, sx, 1.0)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **VAL_TOL,
                                   err_msg=f"kernel means at {(b, d)}")
        assert torch.equal(got, again), f"kernel means not deterministic at {(b, d)}"
        max_err = max(max_err, float((got - want).abs().max()))

        log(f"[kernels] kernel_means {(b, d)}: max |kernel - plain| = "
            f"{float((got - want).abs().max()):.3e}, deterministic")

    b, d = BATCH, 16
    sg, sx = scores(b, d, seed=0, device=dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: cuda_mmd.kernel_means_cuda(sg, sx, 1.0), 2000)
        plain_ms = cuda_ms(lambda: cuda_mmd.kernel_means_reference(sg, sx, 1.0), PLAIN_CALLS)
        device_ms = graph_ms(lambda: cuda_mmd.kernel_means_cuda(sg, sx, 1.0))
        plain_device_ms = graph_ms(lambda: cuda_mmd.kernel_means_reference(sg, sx, 1.0))
    bound, bound_by, pipe = kernel_means_bound_ms(b, d)
    log(f"[kernels] kernel_means at ({b}, {d}): {ms:.5f} ms/call "
        f"({device_ms:.5f} ms on the device from a CUDA graph), plain {plain_ms:.5f} ms/call "
        f"({plain_device_ms:.5f} ms from a graph), bound {bound:.3e} ms ({pipe}); "
        "no single PyTorch call computes these six means, so no library yardstick")
    return {"name": "kernel_means", "route": "cuda",
            "source": "mmdgan_torch/csrc/kernel_means.cu",
            "replaces": "mmdgan_tpu/ops/pallas_mmd.py:50",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms}


def replayed(fn, replays: int = GRAPH_REPLAYS) -> list:
    """``fn()``'s outputs after each of ``replays`` replays of one CUDA graph
    that captured it (warmed on a side stream first)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    runs = []
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in out])
    return runs


def check_kernel_means_backward(dev) -> dict:
    """Phase 3: the backward kernel against its plain version (the closed
    form) on ordinary scores at BACKWARD_SHAPES and on saturated inputs at
    SATURATED_SHAPES, for each cotangent; two launches bitwise equal, and
    GRAPH_REPLAYS replays of a captured launch bitwise equal to the eager
    one (its tickets reset); the autograd path of ``fused_kernel_means``
    (both kernels) against autograd of the plain means; then timed."""
    max_err = 0.0
    inputs = [(f"{(b, d)}", scores(b, d, seed=i, device=dev))
              for i, (b, d) in enumerate(BACKWARD_SHAPES)]
    inputs += [(f"saturated {(b, d)}", saturated_scores(b, d, seed=5 + i, device=dev))
               for i, (b, d) in enumerate(SATURATED_SHAPES)]
    cts = cotangents(dev)
    for what, (sg, sx) in inputs:
        for name, ct in cts.items():
            got = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
            again = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
            want = cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0)
            torch.cuda.synchronize()
            atols = cuda_mmd.kernel_means_backward_atol(sg, sx, ct, 1.0)
            err = assert_grads_close(got, want, atols, f"backward {what} ct={name}")
            max_err = max(max_err, err)
            assert all(torch.equal(g, h) for g, h in zip(got, again)), (
                f"backward kernel not deterministic at {what} ct={name}")

        ct = cts["random"]
        eager = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
        for i, run in enumerate(replayed(
                lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0))):
            assert all(torch.equal(g, h) for g, h in zip(run, eager)), (
                f"backward replay {i} differs from the eager launch at {what}")
        a, c = sg.clone().requires_grad_(True), sx.clone().requires_grad_(True)
        g_fused = torch.autograd.grad(cuda_mmd.fused_kernel_means(a, c, 1.0), (a, c), ct)
        g_plain = torch.autograd.grad(cuda_mmd.kernel_means_reference(a, c, 1.0), (a, c), ct)
        atols = cuda_mmd.kernel_means_backward_atol(sg, sx, ct)
        assert_grads_close(g_fused, g_plain, atols, f"fused_kernel_means autograd at {what}")
        negative = int((cuda_mmd.raw_distances(sg, sx)[0] < 0).sum())
        log(f"[kernels] kernel_means_backward {what}: {len(cts)} cotangents agree with the "
            f"closed form, deterministic, {GRAPH_REPLAYS} graph replays bitwise equal to the "
            f"eager launch; fused autograd agrees with autograd of the plain "
            f"means (mask-rounding atol {atols[0]:.2e} / {atols[1]:.2e} for the random "
            f"cotangent); {negative} raw gen-gen distances below 0")

    b, d = BATCH, 16
    sg, sx = scores(b, d, seed=0, device=dev)
    ct = cts["loss_gen"]
    a, c = sg.clone().requires_grad_(True), sx.clone().requires_grad_(True)
    ms = cuda_ms(lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0), 2000)
    plain_ms = cuda_ms(lambda: cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0),
                       PLAIN_CALLS)
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(
        cuda_mmd.kernel_means_reference(a, c, 1.0), (a, c), ct), PLAIN_CALLS)
    device_ms = graph_ms(lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0))
    plain_device_ms = graph_ms(lambda: cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0))
    bound, bound_by, pipe = kernel_means_backward_bound_ms(b, d)
    log(f"[kernels] kernel_means_backward at ({b}, {d}): {ms:.5f} ms/call "
        f"({device_ms:.5f} ms on the device from a CUDA graph), plain closed form "
        f"{plain_ms:.5f} ms/call ({plain_device_ms:.5f} ms from a graph), autograd of the plain "
        f"means {autograd_ms:.5f} ms/call, bound {bound:.3e} ms ({pipe}); no single PyTorch "
        "call computes this gradient, so no library yardstick")
    return {"name": "kernel_means_backward", "route": "cuda",
            "source": "mmdgan_torch/csrc/kernel_means.cu",
            "replaces": "mmdgan_tpu/ops/pallas_mmd.py:166",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms}


def narrow_architecture() -> dict:
    """cifar_architecture() at 1/8 of the hidden channels (32x32, d=16)."""
    arch = copy.deepcopy(cifar_architecture())
    for layer in arch["generator"][1:-1] + arch["discriminator"][:-1]:
        layer["out"] //= 8
    arch["generator"][0].update(out=64 * 4 * 4, out_reshape=[64, 4, 4])
    arch["discriminator"][-2]["out_reshape"] = [4 * 4 * 64]
    return arch


def narrow_metrics(device, loss_type: str, micro: int = None, arch: dict = None,
                   n_steps: int = 3) -> list:
    """float32 steps of a narrow model (``narrow_architecture`` unless
    ``arch``) on ``device`` from the state of seed 0: one fused 'rmb' step,
    then ``n_steps`` steps of ``loss_type``, fused or accumulated over ``micro``
    micro-batches, fed RandomState(7)'s batches, z and penalty weights.
    Returns the metrics of steps 1-3, the score means as their difference
    (the score layer's bias has no true gradient: a common shift of all
    scores leaves every distance unchanged, so Adam moves it by rounding
    noise that differs between devices).

    Step 0 is degenerate (the initial power vectors are not normalized, so
    every D layer shrinks the scores to near-duplicates, where Cramér's
    gradient is rounding noise that Adam turns into steps of the learning
    rate); the bounded kernel of 'rmb' takes it well-conditioned, and its
    step normalizes the power vectors."""
    arch = narrow_architecture() if arch is None else arch
    rng = np.random.RandomState(7)
    x = rng.randn(4, 8, 32, 32, 3).clip(-1, 1).astype(np.float32)
    z = rng.randn(4, 8, 128).astype(np.float32)
    uni = rng.uniform(size=(4, 8, 1, 1, 1)).astype(np.float32)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    first, model = (SNGan(arch, loss_type=loss, compute_dtype=torch.float32, device=device)
                    for loss in ("rmb", loss_type))
    steps = [build_train_step(first, opt_d, opt_g, device=device),
             build_train_step(model, opt_d, opt_g, device=device) if micro is None else
             build_grad_accum_step(model, opt_d, opt_g, micro, device=device)]
    ts = init_train_state(first, 0, opt_d, opt_g, device=device)
    metrics = []
    for k in range(1 + n_steps):
        kw = {} if k == 0 or micro is None else {"uni": uni[k]}
        ts, m = steps[min(k, 1)](ts, {"x": x[k]}, code_batch={"x": z[k]}, **kw)
        metrics.append({key: v.item() for key, v in m.items()})
    for m in metrics:
        m["s_x_mean"] -= m.pop("s_gen_mean")
    return metrics[1:]


def tf32_off(fn):
    """``fn()`` with TF32 off in cuDNN and cuBLAS, so that two devices or
    two codes differ only in summation order."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def assert_metrics_close(got: list, want: list, what: str) -> float:
    """rtol 1e-3 / atol 1e-5 on every metric of every step; returns the
    largest relative difference."""
    worst = 0.0
    for k, (mg, mw) in enumerate(zip(got, want), start=1):
        for key in mw:
            np.testing.assert_allclose(mg[key], mw[key], rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {k} {key}, {what}")
            worst = max(worst, abs(mg[key] - mw[key]) / max(abs(mw[key]), 1e-12))
    return worst


def check_against_cpu(dev, loss_type: str, micro: int = None) -> None:
    """Phases 4 and 10: ``narrow_metrics`` on the card (the kernel path) and
    on the CPU (the plain path), TF32 off: steps 1-3 of ``loss_type``,
    fused or accumulated over ``micro`` micro-batches, agree at rtol 1e-3 /
    atol 1e-5 on every step metric."""
    runs = tf32_off(lambda: [narrow_metrics(d, loss_type, micro) for d in ("cpu", dev)])
    worst = assert_metrics_close(runs[1], runs[0], "card vs CPU")
    last = runs[1][-1]
    what = loss_type if micro is None else f"{loss_type} accumulated over M={micro}"
    log(f"[reference] narrow f32 {what}, steps 1-3 card vs CPU agree on {len(last)} metrics "
        f"(largest relative difference {worst:.2e}): step 3 loss_gen {last['loss_gen']:.6f} "
        f"loss_dis {last['loss_dis']:.6f}")


def main_path_setup(dev, loss_type: str, capture: bool = True, arch: dict = None,
                    make_multi=build_multi_step, num_class: int = 0) -> tuple:
    """The full-width model (CIFAR-10 unless ``arch``) at bf16, its train
    state from seed 0, the K-step runner ``make_multi(model, opt_d, opt_g,
    K, capture=...)`` (graphed unless ``capture=False``) and one K-stacked
    batch of noise from seed 0, with labels from seed 0 for a conditional
    model (``num_class`` >= 2)."""
    arch = cifar_architecture() if arch is None else arch
    model = SNGan(arch, num_class=num_class, loss_type=loss_type)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g)
    multi = make_multi(model, opt_d, opt_g, SCAN_K, capture=capture)
    c, h, w = arch["input"][0]
    rng = np.random.RandomState(0)
    batches = {"x": torch.tensor(
        rng.randn(SCAN_K, BATCH, h, w, c).astype(np.float32).clip(-1, 1), device=dev)}
    if num_class >= 2:
        batches["y"] = torch.tensor(rng.randint(0, num_class, (SCAN_K, BATCH, 1)), device=dev)
    return model, ts, multi, batches


def timed_windows(multi, ts, batches, measure: int = MEASURE_CALLS, **kw) -> tuple:
    """WARMUP_CALLS windows (for a fresh graphed driver: the eager warm-up,
    then the capture), then ``measure`` timed; returns (ts, last metrics,
    steps/s)."""
    for _ in range(WARMUP_CALLS):
        ts, m = multi(ts, batches, **kw)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(measure):
        ts, m = multi(ts, batches, **kw)
    torch.cuda.synchronize()
    return ts, m, measure * SCAN_K / (time.perf_counter() - start)


def run_main_path(dev, loss_type: str, card: str) -> tuple:
    """Phase 5 for one loss. Returns the forward and backward kernel-means
    launches the profiler counted and the graphed run's last e_kxx.

    Counted run: a graphed driver from seed 0 runs COUNTED_GRAPHED windows
    (its eager warm-up, the capture with its first replay, then replays)
    and an eager one (``capture=False``) COUNTED_EAGER windows, each window
    under torch.profiler. The profiler records every kernel that runs,
    those of a replayed graph one by one (a capture runs none), so its
    count is the launches made; each window must hold one forward and two
    backward per step. The wrappers' counters, zeroed just before, see
    eager calls and captures: they must equal the eager windows' launches
    plus K forward and 2K backward per capture.
    Timed run: WARMUP_CALLS + MEASURE_CALLS more windows of each driver,
    unprofiled, for steps/s."""
    forward, backward = cuda_mmd.kernel_means_cuda, cuda_mmd.kernel_means_backward_cuda
    model, ts, multi, batches = main_path_setup(dev, loss_type)
    _, ts_eager, eager_multi, _ = main_path_setup(dev, loss_type, capture=False)
    params0 = [p.detach().clone() for p in tree_leaves(ts.params)]
    state0 = [v.clone() for v in tree_leaves(ts.net_state)]
    torch.cuda.reset_peak_memory_stats(dev)
    forward.launches = backward.launches = 0
    # the second window (the capture and its first replay) also holds the
    # profiler's raw reader against prof.events()
    graphed = [_profiled_window(multi, ts, batches, f"{loss_type} graphed window {i}",
                                check_raw=loss_type == "rep" and i == 1)
               for i in range(COUNTED_GRAPHED)]
    eager = [_profiled_window(eager_multi, ts_eager, batches, f"{loss_type} eager window {i}")
             for i in range(COUNTED_EAGER)]
    graphs = multi.graphs
    n_graphed, n_eager = (sum(w["windows"] for w in ws) for ws in (graphed, eager))
    assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, n_graphed - 1), (
        graphs.eager, graphs.captures, graphs.replays)
    counted = [sum(w[kernel] for w in graphed + eager) for kernel in KERNEL_EVENTS]
    # every profiled window holds per_step launches per step (asserted), so
    # the counters see that many per eager window and per capture
    counters = [forward.launches, backward.launches]
    want = [per_step * SCAN_K * (graphs.eager + n_eager + graphs.captures)
            for per_step in KERNEL_EVENTS.values()]
    assert counters == want, f"{loss_type}: counters {counters}, eager windows + capture {want}"

    ts, m, graphed_sps = timed_windows(multi, ts, batches)
    ts_eager, m_eager, eager_sps = timed_windows(eager_multi, ts_eager, batches)
    for k, v in m.items():
        assert torch.isfinite(v).all(), f"{loss_type}: non-finite {k}"
    for what, before, tree in (("parameter", params0, ts.params),
                               ("SN/BN state", state0, ts.net_state)):
        same = sum(torch.equal(a, b) for a, b in zip(before, tree_leaves(tree)))
        assert same == 0, f"{loss_type}: {same} {what} tensors unchanged"
    assert int(ts.step) == (n_graphed + WARMUP_CALLS + MEASURE_CALLS) * SCAN_K
    images = model.generate(ts.params, ts.net_state, torch.Generator(dev).manual_seed(0), 8)
    assert images.shape == (8, 32, 32, 3) and torch.isfinite(images).all()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    e_kxx = float(m["e_kxx"][-1])
    log(f"[main] cifar10 sngan {loss_type} b{BATCH} bf16: graphed {graphed_sps:.2f} steps/s, "
        f"eager {eager_sps:.2f} steps/s ({MEASURE_CALLS * SCAN_K} steps each after "
        f"{WARMUP_CALLS * SCAN_K} warm-up, unprofiled; one CUDA graph launch per {SCAN_K} "
        f"steps), loss_gen={float(m['loss_gen'][-1]):.5f} e_kxx={e_kxx:.5f} (eager run "
        f"e_kxx={float(m_eager['e_kxx'][-1]):.5f}), peak memory {peak:.0f} MiB, "
        f"{graphs.eager} eager window + {graphs.captures} capture + {graphs.replays} replays; "
        f"card: {card}")
    log(f"[profile] {loss_type}: kernel-means launches counted by the profiler in "
        f"{len(graphed)} graphed windows (1 eager warm-up, {len(graphed) - 1} replayed) "
        f"and {len(eager)} eager ones: {counted[0]} kernel_means_fwd, {counted[1]} "
        f"kernel_means_bwd in {(len(graphed) + len(eager)) * SCAN_K} steps; the wrappers' "
        f"counters over the same windows {counters[0]}/{counters[1]} (eager calls and one "
        "capture)")
    _log_profile(graphed[-1], 1e3 / graphed_sps, f"{loss_type} graphed (a replay)")
    _log_profile(eager[-1], 1e3 / eager_sps, f"{loss_type} eager")
    return counted, e_kxx


def _end_state(ts, m) -> list:
    return ts.tensors() + [ts.rng.get_state()] + [m[k] for k in sorted(m)]


def _differ(a: list, b: list) -> int:
    return sum(not torch.equal(x, y) for x, y in zip(a, b))


def check_determinism(dev) -> None:
    """Phase 6, with ``torch.use_deterministic_algorithms`` and
    deterministic cuDNN algorithms, on the 'rmb' main path:
    - graphed and eager windows fed the same K-stacked code batches end
      bitwise equal (4 windows: the graph's eager warm-up, its capture and
      two replays);
    - two graphed runs drawing their own z end bitwise equal;
    - the z of two successive replays differ: a step that draws z from
      the state's generator (as the train step does) and hands it on as
      its code batch is graphed, and the z it drew are read after each
      replay."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    windows = 4
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            codes = {"x": torch.tensor(np.random.RandomState(9).randn(
                SCAN_K, BATCH, 128).astype(np.float32), device=dev)}
            ends = {}
            for name, capture, kw in (("graphed", True, {"code_batches": codes}),
                                      ("eager", False, {"code_batches": codes}),
                                      ("graphed z", True, {}), ("graphed z again", True, {})):
                _, ts, multi, batches = main_path_setup(dev, "rmb", capture=capture)
                for _ in range(windows):
                    ts, m = multi(ts, batches, **kw)
                if capture:
                    assert multi.graphs.replays == windows - 1, multi.graphs.replays
                ends[name] = _end_state(ts, m)
            torch.cuda.synchronize()
            z_runs = _replayed_codes(dev)
        for msg in sorted({str(w.message)[:160] for w in caught}):
            log(f"[determinism] warning: {msg}")
        differ = _differ(ends["graphed"], ends["eager"])
        assert differ == 0, f"determinism: {differ} tensors differ, graphed vs eager windows"
        differ = _differ(ends["graphed z"], ends["graphed z again"])
        assert differ == 0, f"determinism: {differ} tensors differ between two graphed runs"
        assert not torch.equal(z_runs[0], z_runs[1]), "two replays drew the same z"
        log(f"[determinism] rmb b{BATCH} bf16, {windows * SCAN_K} steps under deterministic "
            f"algorithms: graphed and eager windows fed the same z end bitwise equal "
            f"({len(ends['eager'])} tensors); two graphed runs drawing their own z end bitwise "
            f"equal; two successive replays drew different z (max |z1 - z2| "
            f"{float((z_runs[0] - z_runs[1]).abs().max()):.3f})")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _replayed_codes(dev) -> list:
    """The z drawn in the second and third windows of a graphed run (its
    first replay, right after the capture, and the next)."""
    model = SNGan(cifar_architecture(), loss_type="rmb")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g)
    step = build_train_step(model, opt_d, opt_g)
    drawn = []

    def recording_step(ts, batch, do_dis, do_gen):
        code = model.sample_codes(ts.rng, BATCH)
        drawn.append(code["x"])
        return step(ts, batch, do_dis, do_gen, code)

    multi = graph_steps(recording_step, SCAN_K)
    batches = {"x": torch.zeros(SCAN_K, BATCH, 32, 32, 3, device=dev)}
    out = []
    for call in range(3):
        if call == 1:
            drawn.clear()   # the capture records the graph's own z buffers
        ts, _ = multi(ts, batches)
        if call >= 1:
            out.append(torch.stack(drawn).clone())
    assert multi.graphs.replays == 2
    return out


def _profiled_window(multi, ts, batches, what: str, per_step: dict = KERNEL_EVENTS,
                     k: int = SCAN_K, check_raw: bool = False) -> dict:
    """One window (``k`` steps, SCAN_K by default) under torch.profiler. Returns the
    kernel-means launches in it (``per_step`` per step, by default one
    forward and two backward, asserted) and its device timeline: the busy
    time per step (the sum of its kernels' times, and the union of their
    intervals), the span from the first kernel's start to the last one's
    end, the traced wall time, the device activities, and the time by
    kernel name.

    The profiler has been seen to lose one kernel record of a replayed
    window (15 forward launches counted in 16 steps, the window's other
    records intact). Every step of a window runs the same code, and of a
    graph the same captured kernels, so a kernel that does not run is
    missing from every step; a window that counts short is logged and the
    next window of the same K-step function is profiled in its place and
    must count exactly. ``windows`` says how many windows ran.
    ``check_raw``: see ``_profile``."""
    out = _profile(multi, ts, batches, what, k, check_raw)
    out["windows"] = 1
    short = {name: out[name] for name, n in per_step.items() if out[name] < n * k}
    if short:
        log(f"[profile] {what}: the profiler counted {short} in {k} steps "
            f"({out['activities'] * k:.0f} device activities); profiling the next window")
        out = _profile(multi, ts, batches, what, k, check_raw)
        out["windows"] = 2
    for kernel, n in per_step.items():
        assert out[kernel] == n * k, f"{what}: {out[kernel]} {kernel} launches in {k} steps"
    return out


def _profile(multi, ts, batches, what: str, k: int = SCAN_K, check_raw: bool = False) -> dict:
    """One window under torch.profiler, read by ``profile_step.window_timeline``
    (busy, union, span, activities, time and calls by kernel name, the
    kernel-means launches, the host's ``nccl:`` events) and its traced
    wall time per step. ``check_raw``: the device activities that
    ``window_timeline`` reads from the profiler's raw results must be those
    of ``prof.events()``, name for name, with the same total time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        multi(ts, batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    try:
        out = window_timeline(prof, k, torch.device("cuda"), tuple(KERNEL_EVENTS))
    except RuntimeError as e:
        raise AssertionError(f"{e} in the {what}") from None
    out["wall"] = wall_ms / k
    if check_raw:
        start = time.perf_counter()
        same = check_raw_activities(prof, torch.autograd.DeviceType.CUDA)
        log(f"[profile] {what}: the raw results and prof.events() hold the same "
            f"{same['activities']} device activities, name for name, {same['ns']} ns in all "
            f"(prof.events() built in {time.perf_counter() - start:.2f} s)")
    return out


def _log_profile(prof: dict, step_ms: float, what: str) -> None:
    """The device timeline of one profiled window: busy time, the idle
    share inside the kernels' span and against the untraced step time
    ``step_ms`` (the traced wall time includes the profiler's own cost),
    the kernel-means kernels' device time, and the kernels taking most
    time."""
    log(f"[profile] {what}: device busy {prof['busy']:.4f} ms/step (union of kernel intervals "
        f"{prof['union']:.4f}) over a span of {prof['span']:.4f} ms/step from first kernel to "
        f"last: idle {100 * (1 - prof['union'] / prof['span']):.1f}% of the span; against the "
        f"untraced step of {step_ms:.4f} ms idle {100 * (1 - prof['union'] / step_ms):.1f}%; "
        f"traced wall {prof['wall']:.4f} ms/step; {prof['activities']:.0f} device activities "
        "per step")
    for kernel in KERNEL_EVENTS:
        ms = sum(t for name, t in prof["by_name"].items() if kernel in name) / SCAN_K
        log(f"[profile]   kernel means: {kernel} {ms:.5f} ms/step on the device, "
            f"{prof[kernel] / SCAN_K:g} launches/step")
    for name, t in sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {t / SCAN_K:8.4f} ms/step  {name[:100]}")


def run_agent(dev, out_dir: str, name: str, data: dict, max_step: int, sampling: str,
              load_ckpt: bool = False, do_save: bool = True, seed: int = 0) -> tuple:
    """``Agent.train_device_data`` on the full-width rep model at b64
    bf16, K=16, from the state of seed ``seed`` (restored first when
    ``load_ckpt``); returns (ts, steps/s)."""
    model = SNGan(cifar_architecture(), loss_type="rep")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, seed, opt_d, opt_g)
    agent = Agent(name, "t", output_dir=out_dir, load_ckpt=load_ckpt, do_save=do_save,
                  query_step=400, print_loss=False, use_tensorboard=False)
    torch.cuda.synchronize()
    start = time.perf_counter()
    ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=max_step,
                                 step_per_epoch=AGENT_ROWS // BATCH, batch_size=BATCH,
                                 steps_per_call=SCAN_K, sampling=sampling)
    torch.cuda.synchronize()
    return ts, max_step / (time.perf_counter() - start)


def trainer_dataset(dev) -> tuple:
    """A CIFAR-sized 50,000 x 32 x 32 x 3 uint8 dataset from seed 0, on the
    host and resident on the card."""
    data = {"x": np.random.RandomState(0).randint(0, 256, (AGENT_ROWS, 32, 32, 3), np.uint8),
            "y": None}
    return data, torch.tensor(data["x"], device=dev)


def check_trainer(dev, data: dict, data_x) -> None:
    """Phase 7's checks: the training runtime at full width on
    ``trainer_dataset``: shuffled epochs (781 batches each) over 1,600
    steps, which crosses two epoch boundaries, with a checkpoint, then a
    new Agent that restores it and runs 160 more; under deterministic
    algorithms, 800 straight steps against 400 + restore + 400, and graphed
    against eager device-data windows of both samplings
    (``_device_data_ends``), all bitwise; 320 uniform steps; 40 host-fed
    single steps (``Agent.train``), the last 5 traced."""
    mib = data["x"].nbytes / 2**20
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.reset_peak_memory_stats(dev)
        ts, sps = run_agent(dev, out, "long", data, 1600, "shuffled_epochs")
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        assert int(ts.step) == 1600 and all(torch.isfinite(t.float()).all() for t in ts.tensors())
        ts2, sps2 = run_agent(dev, out, "long", data, 160, "shuffled_epochs", load_ckpt=True,
                              seed=5)
        assert int(ts2.step) == 1760
        log(f"[trainer] Agent.train_device_data rep b{BATCH} bf16 K={SCAN_K}, shuffled epochs "
            f"over {AGENT_ROWS} rows ({mib:.1f} MiB uint8 on the card): 1600 steps at "
            f"{sps:.2f} steps/s across epoch boundaries 781 and 1562, checkpoint at 1600; a new "
            f"Agent restored it and ran to step 1760 at {sps2:.2f} steps/s; peak memory "
            f"{peak:.0f} MiB")

        flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            straight, _ = run_agent(dev, out, "straight", data, 800, "shuffled_epochs",
                                    do_save=False)
            run_agent(dev, out, "halves", data, 400, "shuffled_epochs")
            resumed, _ = run_agent(dev, out, "halves", data, 400, "shuffled_epochs",
                                   load_ckpt=True, do_save=False, seed=7)
            torch.cuda.synchronize()
            windows = {sampling: _device_data_ends(dev, data_x, sampling)
                       for sampling in ("shuffled_epochs", "uniform")}
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        differ = _differ(straight.tensors() + [straight.rng.get_state()],
                         resumed.tensors() + [resumed.rng.get_state()])
        assert int(resumed.step) == 800 and differ == 0, (
            f"trainer: {differ} tensors differ, 800 straight vs 400 + restore + 400")
        for sampling, (graphed, eager) in windows.items():
            differ = _differ(graphed, eager)
            assert differ == 0, (f"trainer: {differ} of {len(eager)} tensors differ, graphed vs "
                                 f"eager {sampling} device-data windows")
        ts, sps = run_agent(dev, out, "uniform", data, 320, "uniform", do_save=False)
        assert int(ts.step) == 320 and all(torch.isfinite(t.float()).all() for t in ts.tensors())
        log(f"[trainer] under deterministic algorithms 800 straight steps equal 400 + restore + "
            f"400 bitwise (across the boundary at 781); graphed and eager (capture=False) "
            f"device-data windows end bitwise equal, shuffled epochs and uniform "
            f"({DATA_WINDOWS * SCAN_K} steps each, z and indices drawn in the windows, "
            f"{len(windows['uniform'][0])} tensors); uniform sampling 320 steps at {sps:.2f} "
            "steps/s (each Agent call's steps/s includes the upload, the eager first window, "
            "the capture and the final checkpoint)")
        model = SNGan(cifar_architecture(), loss_type="rep")
        opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
        ts = init_train_state(model, 0, opt_d, opt_g)
        agent = Agent("host", "t", output_dir=out, do_trace=True, do_save=False,
                      print_loss=False, use_tensorboard=False)
        ts = agent.train(build_train_step(model, opt_d, opt_g), ts,
                         synthetic_image_batches(BATCH, 32, 32, 3), max_step=40,
                         step_per_epoch=AGENT_ROWS // BATCH)
        trace = os.path.join(agent.summary_folder, "trace.json")
        assert int(ts.step) == 40 and os.path.getsize(trace) > 0
    log("[trainer] Agent.train, host-fed single steps through the prefetcher: 40 steps, the "
        "last 5 traced by torch.profiler into trace.json")


def trainer_rates(dev, data: dict, data_x) -> None:
    """Phase 7's measurement: the steady-state steps/s of graphed
    device-data windows over ``trainer_dataset``, both samplings."""
    rates = {}
    for sampling in ("shuffled_epochs", "uniform"):
        model = SNGan(cifar_architecture(), loss_type="rep")
        opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
        ts = init_train_state(model, 0, opt_d, opt_g)
        fn = build_device_data_step(model, opt_d, opt_g, SCAN_K, BATCH, sampling=sampling)
        rng = torch.Generator(dev).manual_seed(1)
        _, _, rates[sampling] = timed_windows(lambda ts, _: fn(ts, data_x, None, rng), ts, None)
    log(f"[trainer] graphed device-data windows, steady state ({MEASURE_CALLS * SCAN_K} steps "
        f"after {WARMUP_CALLS * SCAN_K}): shuffled epochs {rates['shuffled_epochs']:.2f} steps/s, "
        f"uniform {rates['uniform']:.2f} steps/s")


def _device_data_ends(dev, data_x, sampling: str) -> tuple:
    """The end states of a graphed and an eager (``capture=False``)
    ``build_device_data_step`` driver, each DATA_WINDOWS windows from the
    state of seed 0 and a sampling generator of seed 1: the graphed one's
    eager warm-up, its capture and replays, whose sampler reads the
    device step inside the graph; z drawn from the state's generator."""
    ends = []
    for capture in (True, False):
        model = SNGan(cifar_architecture(), loss_type="rep")
        opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
        ts = init_train_state(model, 0, opt_d, opt_g)
        fn = build_device_data_step(model, opt_d, opt_g, SCAN_K, BATCH, sampling=sampling,
                                    capture=capture)
        rng = torch.Generator(dev).manual_seed(1)
        for _ in range(DATA_WINDOWS):
            ts, m = fn(ts, data_x, None, rng)
        if capture:
            assert fn.graphs.replays == DATA_WINDOWS - 1, fn.graphs.replays
        ends.append(_end_state(ts, m) + [rng.get_state()])
    return tuple(ends)


def start_clis(runs: list, tmp: str) -> list:
    """Each ``(module, args, what)`` as ``python -m
    mmdgan_torch.experiments.<module> args --out-dir <its own folder>`` in
    a subprocess, all started together (their start-up is host work);
    ``finish_clis`` waits for them."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for i, (module, args, what) in enumerate(runs):
            log_file = open(os.path.join(tmp, f"cli{i}.log"), "w+")
            procs.append((module, what, log_file, subprocess.Popen(
                [sys.executable, "-m", f"mmdgan_torch.experiments.{module}", *args,
                 "--out-dir", os.path.join(tmp, f"run{i}")],
                cwd=repo, stdout=log_file, stderr=subprocess.STDOUT, text=True)))
    except BaseException:
        _stop(procs)
        raise
    return procs


def _stop(procs: list) -> None:
    """Kill what still runs of ``(..., log file, process)`` and close the logs."""
    for *_, log_file, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()


def finish_clis(procs: list) -> None:
    """Each process of ``start_clis`` must exit 0 and print its throughput
    line; every process is ended before this returns."""
    start = time.perf_counter()
    try:
        for module, what, log_file, proc in procs:
            rc = proc.wait(timeout=400)
            log_file.seek(0)
            out = log_file.read()
            assert rc == 0, f"{module} CLI ({what}) exited {rc}:\n{out[-4000:]}"
            lines = [ln for ln in out.splitlines() if "train_steps_per_sec" in ln]
            assert lines, f"{module} CLI ({what}) printed no throughput line"
            log(f"[cli] {module}, {what}: exit 0, {time.perf_counter() - start:.1f} s after "
                f"the wait began; {lines[-1]}")
    finally:
        _stop(procs)


def cli_runs(tmp: str) -> list:
    """Phase 8's two runs of ``python -m mmdgan_torch.experiments.cifar``:
    host-fed on synthetic data, and over a tfrecord of 4,096 seeded images
    (made by the port's writer) resident on the card."""
    x = np.random.RandomState(1).randint(0, 256, (4096, 3, 32, 32), np.uint8)
    np_to_tfrecords(x, None, os.path.join(tmp, "cifar"))
    common = ["--skip-sampling", "--skip-metrics", "--fresh", "--chunks", "1",
              "--query-step", "160", "--use-pallas"]
    # host-fed: 20 graphed windows and 8 single steps
    return [("cifar", common + ["--synthetic-data", "--steps-per-chunk", "328"],
             "synthetic, host-fed"),
            ("cifar", common + ["--device-dataset", "--sampling", "shuffled_epochs",
                                "--data-dir", tmp, "--steps-per-chunk", "320"],
             "tfrecord, on the card")]


def copy_state(ts: TrainState) -> TrainState:
    """A TrainState of new buffers holding ``ts``'s values: a graph
    captured on one is bound to its own buffers, and the full-width init
    takes seconds on the host."""
    clone = lambda t: tree_map(lambda v: v.detach().clone(), t)
    opt = lambda s: OptState(count=s.count.clone(), slots=clone(s.slots))
    rng = torch.Generator(ts.rng.device)
    rng.set_state(ts.rng.get_state())
    return TrainState(params=clone(ts.params), net_state=clone(ts.net_state),
                      loss_state=LossState(*(t.clone() for t in loss_state_leaves(ts.loss_state))),
                      opt_state_dis=opt(ts.opt_state_dis), opt_state_gen=opt(ts.opt_state_gen),
                      step=ts.step.clone(), rng=rng)


def run_losses(dev, card: str) -> list:
    """Phase 9: every distinct loss of the dispatcher on the full-width
    model, b64 bf16, K=16, each from the state of seed 0 with its own
    graphed K-step function: an eager warm-up window, the capture (and its replay),
    two timed replays. The wrappers' counters, which see eager calls and
    captures, must grow by 2K forward and 4K backward launches (the eager
    window and the capture) for the repulsive family and stay put for the
    other losses. For the repulsive family and a few others one more
    replay runs under the profiler (about 3 s of the script per window),
    whose count of kernel-means launches must be 1 forward and 2 backward
    per step, 0 for the others. Returns the launches the profiler counted
    in the repulsive family's windows."""
    forward, backward = cuda_mmd.kernel_means_cuda, cuda_mmd.kernel_means_backward_cuda
    _, template, _, batches = main_path_setup(dev, "rep")
    launches = [0, 0]
    for loss_type in LOSSES:
        model = SNGan(cifar_architecture(), loss_type=loss_type)
        opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
        ts = copy_state(template)
        multi = build_multi_step(model, opt_d, opt_g, SCAN_K)
        before = (forward.launches, backward.launches)
        for _ in range(2):
            ts, m = multi(ts, batches)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(2):
            ts, m = multi(ts, batches)
        torch.cuda.synchronize()
        sps = 2 * SCAN_K / (time.perf_counter() - start)
        kernel_loss = loss_type in KERNEL_LOSSES
        grew = (forward.launches - before[0], backward.launches - before[1])
        assert grew == ((2 * SCAN_K, 4 * SCAN_K) if kernel_loss else (0, 0)), (loss_type, grew)
        replays = 3
        line = ""
        if loss_type in PROFILED_LOSSES:
            expect = {k: (n if kernel_loss else 0) for k, n in KERNEL_EVENTS.items()}
            prof = _profiled_window(multi, ts, batches, f"{loss_type} replayed window", expect)
            replays += prof["windows"]
            if kernel_loss:
                launches = [launches[0] + prof["kernel_means_fwd"],
                            launches[1] + prof["kernel_means_bwd"]]
            line = (f"; a replay: device busy {prof['union']:.4f} ms/step, idle "
                    f"{100 * (1 - prof['union'] / prof['span']):.1f}% of the span, "
                    f"{prof['activities']:.0f} activities/step, kernel means "
                    f"{prof['kernel_means_fwd'] // SCAN_K}+{prof['kernel_means_bwd'] // SCAN_K} "
                    "per step")
        graphs = multi.graphs
        assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, replays), (
            loss_type, graphs.eager, graphs.captures, graphs.replays)
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        assert not bad and all(torch.isfinite(t.float()).all() for t in ts.tensors()), (
            f"{loss_type}: non-finite {bad}")
        state = {f.name: float(v) for f, v in zip(dataclasses.fields(ts.loss_state),
                                                  loss_state_leaves(ts.loss_state))}
        if loss_type in STATEFUL_LOSSES:
            assert state["loss_average"] != 0.0, f"{loss_type}: the loss state did not move"
        log(f"[losses] {loss_type}: graphed {sps:.2f} steps/s (2 replays of {SCAN_K} steps "
            f"after an eager window and the capture), loss_gen {float(m['loss_gen'][-1]):.5f} "
            f"loss_dis {float(m['loss_dis'][-1]):.5f}, {len(m)} metrics finite"
            + (f", loss state {state}" if loss_type in STATEFUL_LOSSES else "")
            + f", counters +{grew[0]}/+{grew[1]}{line}; card: {card}")
    return launches


def check_penalty_determinism(dev) -> None:
    """Phase 9, under deterministic algorithms: graphed and eager 'rep_gp'
    windows (4 each from the state of seed 0, z and the penalty's
    interpolation weights drawn in the windows) end bitwise equal; the
    graphed one holds a double backward per step."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ends = {}
        for name, capture in (("graphed", True), ("eager", False)):
            _, ts, multi, batches = main_path_setup(dev, "rep_gp", capture=capture)
            for _ in range(4):
                ts, m = multi(ts, batches)
            ends[name] = _end_state(ts, m)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    differ = _differ(ends["graphed"], ends["eager"])
    assert differ == 0, f"rep_gp: {differ} tensors differ, graphed vs eager windows"
    log(f"[losses] rep_gp b{BATCH} bf16, {4 * SCAN_K} steps under deterministic algorithms: "
        f"graphed and eager windows end bitwise equal ({len(ends['eager'])} tensors, the "
        "generator's state included)")


def reset_counters() -> None:
    cuda_mmd.kernel_means_cuda.launches = cuda_mmd.kernel_means_backward_cuda.launches = 0


def assert_counted(what: str, windows: int) -> None:
    """The wrappers' counters, zeroed before, after ``windows`` eager
    windows or captures of K optimizer steps: 1 forward and 2 backward
    launches per optimizer step in each."""
    got = [cuda_mmd.kernel_means_cuda.launches, cuda_mmd.kernel_means_backward_cuda.launches]
    want = [n * SCAN_K * windows for n in KERNEL_EVENTS.values()]
    assert got == want, f"{what}: kernel-means counters {got}, want {want}"


def run_family(dev, name: str, arch: dict, card: str) -> list:
    """Phase 10: one family at full width, rep b64 bf16, graphed K=16
    windows on a noise feed from the state of seed 0: the eager warm-up,
    the capture, MEASURE_CALLS timed replays (128 steps); the wrappers'
    counters, zeroed before, show 1 forward and 2 backward launches per
    step of the eager window and of the capture; then one replay under
    the profiler, which must count 1 + 2 per step. Returns the profiler's
    counts."""
    model, ts, multi, batches = main_path_setup(dev, "rep", arch=arch)
    n_params = sum(p.numel() for p in tree_leaves(ts.params))
    reset_counters()
    ts, m, sps = timed_windows(multi, ts, batches)
    assert_counted(name, multi.graphs.eager + multi.graphs.captures)
    prof = _profiled_window(multi, ts, batches, f"{name} replayed window")
    bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
    assert not bad, f"{name}: non-finite {bad}"
    c, h, w = arch["input"][0]
    images = model.generate(ts.params, ts.net_state, torch.Generator(dev).manual_seed(0), 4)
    assert images.shape == (4, h, w, c) and torch.isfinite(images).all()
    log(f"[families] {name} {h}x{w} sngan rep b{BATCH} bf16 ({n_params} parameters): graphed "
        f"{sps:.2f} steps/s ({MEASURE_CALLS * SCAN_K} steps after {WARMUP_CALLS * SCAN_K} "
        f"warm-up, unprofiled), loss_gen={float(m['loss_gen'][-1]):.5f} "
        f"e_kxx={float(m['e_kxx'][-1]):.5f}; a replay: device busy {prof['union']:.4f} ms/step, "
        f"idle {100 * (1 - prof['union'] / prof['span']):.1f}% of the span, "
        f"{prof['activities']:.0f} activities/step, kernel means "
        f"{prof['kernel_means_fwd'] // SCAN_K}+{prof['kernel_means_bwd'] // SCAN_K} per step; "
        f"card: {card}")
    _log_profile(prof, 1e3 / sps, f"{name} graphed (a replay)")
    return [prof["kernel_means_fwd"], prof["kernel_means_bwd"]]


def run_hd512(dev, card: str) -> list:
    """Phase 10: ``hd_architecture(512)`` at full width, rep b64 bf16,
    ``build_device_data_step`` (uniform) over a seeded 256 x 512 x 512 x 3
    uint8 dataset on the card (``bench.py:157-205``), at micro_batches 1
    and 8, each from the state of seed 0 through graphed K=16 windows: the
    eager warm-up, the capture, HD_CALLS timed replays, then one profiled
    replay that must count 1 forward and 2 backward kernel-means launches
    per optimizer step. The peak memory of each run is read after the
    previous run is freed and the peak reset, beside what was allocated
    when the run began (the dataset, what earlier phases hold). A run at
    M=1 that does not fit the card is reported, and M=8 runs alone.
    Returns the profiler's counts."""
    data_x = torch.tensor(np.random.RandomState(0).randint(
        0, 256, (HD_ROWS, HD_SIZE, HD_SIZE, 3), np.uint8), device=dev)
    launches = [0, 0]
    for micro in HD_MICRO:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev) / 2**30
        model = SNGan(hd_architecture(HD_SIZE), loss_type="rep")
        opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
        ts = init_train_state(model, 0, opt_d, opt_g)
        fn = build_device_data_step(model, opt_d, opt_g, SCAN_K, BATCH, micro_batches=micro)
        rng = torch.Generator(dev).manual_seed(1)
        drive = lambda ts, _: fn(ts, data_x, None, rng)   # noqa: E731
        reset_counters()
        try:
            ts, m, sps = timed_windows(drive, ts, None, measure=HD_CALLS)
        except torch.cuda.OutOfMemoryError as e:
            if micro != 1:
                raise
            log(f"[hd512] M=1 does not fit the card: {str(e)[:200]}; M=8 runs alone")
            del ts, fn, drive
            continue
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        assert_counted(f"hd512 M={micro}", fn.graphs.eager + fn.graphs.captures)
        prof = _profiled_window(drive, ts, None, f"hd512 M={micro} replayed window")
        launches = [launches[0] + prof["kernel_means_fwd"], launches[1] + prof["kernel_means_bwd"]]
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        assert not bad and all(torch.isfinite(t.float()).all() for t in ts.tensors()), (
            f"hd512 M={micro}: non-finite {bad}")
        log(f"[hd512] hd_architecture(512) rep b{BATCH} bf16, device-resident "
            f"{HD_ROWS}x{HD_SIZE}x{HD_SIZE}x3 uint8 ({data_x.numel() / 2**20:.0f} MiB), "
            f"micro_batches={micro}: graphed {sps:.3f} steps/s ({HD_CALLS * SCAN_K} steps after "
            f"{WARMUP_CALLS * SCAN_K} warm-up, unprofiled), peak memory {peak:.2f} GiB "
            f"(torch.cuda.max_memory_allocated; {peak - before:.2f} GiB above the "
            f"{before:.2f} GiB allocated when the run began, the dataset among them), "
            f"loss_gen={float(m['loss_gen'][-1]):.5f} "
            f"e_kxx={float(m['e_kxx'][-1]):.5f}; a replay: device busy {prof['union']:.3f} "
            f"ms/step, idle {100 * (1 - prof['union'] / prof['span']):.1f}% of the span, "
            f"{prof['activities']:.0f} activities/step, kernel means "
            f"{prof['kernel_means_fwd'] // SCAN_K}+{prof['kernel_means_bwd'] // SCAN_K} per "
            f"optimizer step; card: {card}")
        _log_profile(prof, 1e3 / sps, f"hd512 M={micro} graphed (a replay)")
        del ts, m, fn, drive
    return launches


def bn_free(arch: dict) -> dict:
    arch = copy.deepcopy(arch)
    for layer in arch["generator"]:
        layer["act_nm"] = None
    return arch


def check_accum_equals_fused(dev) -> None:
    """Phase 10: on the card, a narrow BN-free float32 model: three rep
    steps accumulated over ACCUM_M micro-batches against three fused ones,
    after the same first 'rmb' step, fed the same batches and z, TF32 off:
    every step metric at rtol 1e-3 / atol 1e-5 (cuDNN may sum a batch of 8
    and a micro-batch of 2 in another order)."""
    arch = bn_free(narrow_architecture())
    fused, accum = tf32_off(lambda: [narrow_metrics(dev, "rep", micro, arch)
                                     for micro in (None, ACCUM_M)])
    worst = assert_metrics_close(accum, fused, "accumulated vs fused")
    log(f"[accumulation] narrow BN-free f32 rep on the card, steps 1-3: accumulated over "
        f"M={ACCUM_M} equals the fused step on {len(fused[-1])} metrics (largest relative "
        f"difference {worst:.2e})")


def check_window_determinism(dev) -> list:
    """Phase 10, under deterministic algorithms, the full-width CIFAR-10 rep
    model at b64 bf16: graphed and eager (``capture=False``) windows, 4 each
    from the state of seed 0 (the graph's eager warm-up, its capture and
    two replays; z drawn in the windows), end bitwise equal for the
    accumulated step (M=ACCUM_M) and for an imbalanced [1, 5] window. The
    wrappers' counters show 1 forward and 2 backward launches per
    optimizer step in every eager window and capture; the [1, 5] window's
    Adam counts reach 64 (D) and 13 (G: steps 0, 5, ..., 60)."""
    accum = lambda model, od, og, k, capture: graph_steps(   # noqa: E731
        build_grad_accum_step(model, od, og, ACCUM_M), k, capture)
    imbalanced = lambda model, od, og, k, capture: build_imbalanced_multi_step(   # noqa: E731
        model, od, og, k, IMBALANCED, capture=capture)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ends = {}
    try:
        for name, make_multi in ((f"accumulated M={ACCUM_M}", accum),
                              (f"imbalanced {IMBALANCED}", imbalanced)):
            for capture in (True, False):
                _, ts, multi, batches = main_path_setup(dev, "rep", capture, make_multi=make_multi)
                avg = torch.zeros((), device=dev)
                drive = multi if make_multi is accum else (
                    lambda ts, b, multi=multi: multi(ts, b, None, avg))
                reset_counters()
                for _ in range(4):
                    ts, m = drive(ts, batches)
                torch.cuda.synchronize()
                assert_counted(f"{name} capture={capture}",
                               multi.graphs.eager + multi.graphs.captures if capture else 4)
                if capture:
                    assert multi.graphs.replays == 3, multi.graphs.replays
                if make_multi is imbalanced:
                    counts = (int(ts.opt_state_dis.count), int(ts.opt_state_gen.count))
                    assert counts == (64, 13), f"{name}: Adam counts {counts}"
                    assert torch.equal(m["do_dis"], torch.ones(SCAN_K, device=dev))
                ends[(name, capture)] = _end_state(ts, m) + [avg]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    for name in (f"accumulated M={ACCUM_M}", f"imbalanced {IMBALANCED}"):
        differ = _differ(ends[(name, True)], ends[(name, False)])
        assert differ == 0, f"{name}: {differ} tensors differ, graphed vs eager windows"
        log(f"[determinism] {name}, rep b{BATCH} bf16, {4 * SCAN_K} steps under deterministic "
            f"algorithms: graphed and eager windows end bitwise equal "
            f"({len(ends[(name, False)])} tensors); 1 + 2 kernel-means launches per optimizer "
            "step counted in every eager window and capture"
            + ("; Adam counts D 64, G 13" if name.startswith("imbalanced") else ""))


def family_cli_runs(tmp: str) -> list:
    """Phase 10's five CLI runs: the stl, celeba and lsun CLIs on synthetic
    data (32 steps, two graphed windows); celeba over a tfrecord of 1,024
    seeded 64x64 images resident on the card with ``--micro-batches 4``;
    cifar with ``--imbalanced-update 1,5 --steps-per-call 16``."""
    x = np.random.RandomState(2).randint(0, 256, (1024, 3, 64, 64), np.uint8)
    np_to_tfrecords(x, None, os.path.join(tmp, "celebA_000"))
    common = ["--skip-sampling", "--skip-metrics", "--fresh", "--chunks", "1", "--use-pallas"]
    debug = ["--synthetic-data", "--debug-mode", "true", "--debug-step", "32"]
    return ([(module, common + debug, "synthetic, 32 steps")
             for module in ("stl", "celeba", "lsun")]
            + [("celeba", common + ["--device-dataset", "--micro-batches", "4",
                                    "--num-files", "1", "--data-dir", tmp,
                                    "--steps-per-chunk", "64", "--query-step", "32"],
                "tfrecord on the card, --micro-batches 4, 64 steps"),
               ("cifar", common + ["--synthetic-data", "--imbalanced-update", "1,5",
                                   "--steps-per-call", "16", "--steps-per-chunk", "64",
                                   "--query-step", "32"],
                "synthetic, --imbalanced-update 1,5 in K=16 windows, 64 steps")])


def _cli_records(out: str, run: str) -> dict:
    """The last value of every scalar in the run's metrics.jsonl."""
    recs = {}
    with open(os.path.join(out, "cifar_log", run, "metrics.jsonl")) as f:
        for line in f:
            recs.update({k: v for k, v in json.loads(line).items() if k not in ("step", "time")})
    return recs


def run_eval_cli(dev, card: str) -> list:
    """Phase 11, the main path of this slice: ``python -m
    mmdgan_torch.experiments.cifar`` in this process (so the wrappers'
    counters see its launches) with eval on, at full width, rep b64 bf16:
    one chunk of EVAL_STEPS steps in K=16 graphed windows, the 20x20 sprite
    from the fixed code_x, and IS/FID over EVAL_BATCHES batches of 64 (the
    reference protocol's 49,984 samples per side) with the random-feature
    classifier, each part timed by the CLI (``time/eval_*``). The counters,
    zeroed just before, must show 1 forward and 2 backward kernel-means
    launches per step of the windows that ran eagerly or were captured (a
    replay runs the captured kernels without the wrappers). Then the same
    CLI with ``--loss rmb --rep-w0 1 --rep-w1 0`` (training and the
    sprite), which takes the plain path: no kernel-means launch. Returns
    the counts of the rep run."""
    from mmdgan_torch.experiments.cifar import main as cifar_main

    common = ["--synthetic-data", "--fresh", "--chunks", "1", "--batch-size", str(BATCH),
              "--use-pallas"]
    with tempfile.TemporaryDirectory() as out:
        reset_counters()
        start = time.perf_counter()
        cifar_main(common + ["--steps-per-chunk", str(EVAL_STEPS), "--eval-batches",
                             str(EVAL_BATCHES), "--out-dir", out])
        seconds = time.perf_counter() - start
        counted = [cuda_mmd.kernel_means_cuda.launches,
                   cuda_mmd.kernel_means_backward_cuda.launches]
        run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
        recs = _cli_records(out, run)
        sprite = os.path.join(out, "cifar_log", run, f"cifar_g_{run}_{EVAL_STEPS}_0.png")
        assert os.path.getsize(sprite) > 0, "no sprite"
    windows = counted[0] // SCAN_K
    assert counted == [n * SCAN_K * windows for n in KERNEL_EVENTS.values()] and windows >= 2, (
        f"eval CLI: kernel-means counters {counted}")
    scores = {k: recs[k] for k in ("eval/inception_real", "eval/inception_gen", "eval/fid_xx",
                                   "eval/fid_xg")}
    assert np.isfinite(list(scores.values())).all(), scores
    parts = {k[len("time/eval_"):]: recs[k] for k in recs if k.startswith("time/eval_")}
    images = 2 * EVAL_BATCHES * BATCH
    log(f"[eval] cifar CLI, rep b{BATCH} bf16, {EVAL_STEPS} steps + sprite + IS/FID over "
        f"{EVAL_BATCHES} x {BATCH} = {EVAL_BATCHES * BATCH} samples per side (random-feature "
        f"classifier): {seconds:.1f} s in all; kernel-means counters {counted[0]}/{counted[1]} "
        f"in the {windows} windows that ran eagerly or were captured ({EVAL_STEPS // SCAN_K} "
        f"windows), 1 + 2 per optimizer step; scores {json.dumps(scores)}; card: {card}")
    log(f"[eval] seconds by part: {json.dumps({k: round(v, 4) for k, v in parts.items()})}, "
        f"eval total {sum(parts.values()):.4f} s; classifier {images / parts['classifier']:.0f} "
        f"images/s ({images} images at 32x32, in the eval's batches of {BATCH})")

    with tempfile.TemporaryDirectory() as out:
        reset_counters()
        start = time.perf_counter()
        cifar_main(common + ["--loss", "rmb", "--rep-w0", "1", "--rep-w1", "0",
                             "--steps-per-chunk", str(2 * SCAN_K), "--skip-metrics",
                             "--out-dir", out])
        run = "sngan_rmb_5e-04_2e-04_k1.68_1.0_0.0"
        recs = _cli_records(out, run)
        sprite = os.path.join(out, "cifar_log", run, f"cifar_g_{run}_{2 * SCAN_K}_0.png")
        assert os.path.getsize(sprite) > 0, "no sprite"
    plain = [cuda_mmd.kernel_means_cuda.launches, cuda_mmd.kernel_means_backward_cuda.launches]
    assert plain == [0, 0], f"rmb (1, 0): kernel-means counters {plain}"
    assert np.isfinite(recs["loss_dis"])
    log(f"[eval] cifar CLI --loss rmb --rep-w0 1 --rep-w1 0: {2 * SCAN_K} steps on the plain "
        f"path (kernel-means counters {plain}) and the sprite, "
        f"{time.perf_counter() - start:.1f} s; loss_dis {recs['loss_dis']:.5f}")
    return counted


def _card_vs_cpu(what: str, fn, dev, rtol: float = 1e-3, atol: float = 1e-5) -> float:
    """``fn(device)`` on the card and on the CPU, TF32 off, every output at
    ``rtol`` / ``atol``; returns the largest |card - CPU| as a share of the
    tolerance, atol + rtol |CPU| (1 would be the limit)."""
    got, want = tf32_off(lambda: (fn(dev), fn(torch.device("cpu"))))
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g, np.float64)
        w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w, np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
        worst = max(worst, float(np.max(np.abs(g - w) / (atol + rtol * np.abs(w)))))
    return worst


def _mesh_sampling(device, real: np.ndarray, folder: str) -> list:
    """``SNGan.eval_sampling`` of the full-width float32 CIFAR-10 model of
    seed 0 on ``device`` over MeshCode's sine (1) and feature (2) grids,
    drawn from one CPU generator, with ``real`` images: the generated
    images and both nets' scores, the sprites and the embedding written
    under ``folder``."""
    model = SNGan(cifar_architecture(), compute_dtype=torch.float32, device=device)
    params, state, _ = model.init(0)
    out = []
    for mode in (1, 2):
        got = model.eval_sampling(params, state, "cifar", f"mesh_{device.type}", mesh_num=(4, 4),
                                  mesh_mode=mode, real_batch={"x": real}, do_embedding=True,
                                  generator=torch.Generator().manual_seed(5), output_dir=folder)
        out += [got["x_gen"], got["s_x"], got["s_gen"]]
    return out


def check_metrics_on_card(dev) -> None:
    """Phase 11: the metrics' device code on the card against the CPU, TF32
    off, rtol 1e-3: the random-feature classifier at 32x32 (stride-2 SAME
    pads 0/1) and 299x299, MS-SSIM at an even and an odd size, SWD on
    draws made once on the CPU, the TF1 resize (32 to 299) and the
    MS-SSIM score's resize (32 up and 512 down to 256); the GraphDef
    executor on the committed narrow fixture (``tests/data``); then the
    random-feature classifier's images/s on the card. Beside them,
    ``SNGan.eval_sampling`` over MeshCode grids (``ops/mesh_code.py``,
    which the CLI's fixed ``code_x`` never reaches), card vs CPU."""
    from mmdgan_torch.metrics.graphdef import GraphDefModule
    from mmdgan_torch.metrics.inception import RandomFeatureClassifier, resize_bilinear_tf1
    from mmdgan_torch.metrics.msssim import ms_ssim
    from mmdgan_torch.metrics.scores import resize_linear
    from mmdgan_torch.metrics.swd import (
        draw_directions,
        draw_patch_index,
        laplacian_pyramid,
        sliced_wasserstein_distance,
    )

    rng = np.random.RandomState(11)
    img = lambda n, size, c=3: (rng.rand(n, size, size, c).astype(np.float32) * 2 - 1)
    small, large = img(64, 32), img(4, 299)
    x180, x177 = (img(2, s) for s in (180, 177))
    y180, y177 = (np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.1, -1, 1)
                  for x in (x180, x177))
    big = img(2, 512)
    pyr = laplacian_pyramid(torch.tensor(small[:16]), 3)
    gen = torch.Generator().manual_seed(0)
    draws = [(draw_patch_index(lv.shape, 7, 512, gen, "cpu"),
              draw_patch_index(lv.shape, 7, 512, gen, "cpu"),
              draw_directions(7 * 7 * 3, 64, gen, "cpu")) for lv in pyr]
    t = lambda a, d: torch.tensor(a, device=d)   # noqa: E731
    checks = {
        "random features 32x32": lambda d: RandomFeatureClassifier(device=d)(t(small, d)),
        "random features 299x299": lambda d: RandomFeatureClassifier(device=d)(t(large, d)),
        "ms_ssim 180 and 177": lambda d: [ms_ssim((t(x, d) + 1) * 127.5, (t(y, d) + 1) * 127.5)
                                          for x, y in ((x180, y180), (x177, y177))],
        "swd": lambda d: sliced_wasserstein_distance(
            t(small[:16], d), t(small[16:32], d), num_patches=512, num_dirs=64,
            draws=[tuple(tuple(i.to(d) for i in ix) if isinstance(ix, tuple) else ix.to(d)
                         for ix in lv) for lv in draws]),
        "resize_bilinear_tf1 32 -> 299": lambda d: resize_bilinear_tf1(t(small[:8], d), (299, 299)),
        "ms_ssim score resize 32 -> 256, 512 -> 256": lambda d: [
            resize_linear(t(small[:4], d), 256), resize_linear(t(big, d), 256)],
    }
    for what, fn in checks.items():
        worst = _card_vs_cpu(what, fn, dev)
        log(f"[metrics] {what}: card vs CPU within rtol 1e-3 / atol 1e-5 (the largest "
            f"difference {worst:.3f} of the tolerance)")

    with tempfile.TemporaryDirectory() as folder:
        real = img(16, 32)
        worst = _card_vs_cpu("eval_sampling over MeshCode grids",
                             lambda d: _mesh_sampling(d, real, folder), dev)
        written = sorted(os.path.relpath(os.path.join(root, f), folder)
                         for root, _, files in os.walk(folder) for f in files)
    assert len(written) >= 8, written
    log(f"[metrics] SNGan.eval_sampling over MeshCode's sine and feature grids (4 x 4, the "
        f"full-width CIFAR-10 model of seed 0, f32) with real images, scores and the projector "
        f"embedding: images and scores card vs CPU within rtol 1e-3 / atol 1e-5 (the largest "
        f"difference {worst:.3f} of the tolerance); {len(written)} files written")

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                           "narrow_inception.pb")
    feed = img(16, 32)
    worst = _card_vs_cpu("GraphDef executor", lambda d: GraphDefModule(
        fixture, ["Mul:0"], ["logits:0", "pool_3:0"], device=d)(t(feed, d)), dev)
    log(f"[metrics] GraphDef executor on {os.path.relpath(fixture)} "
        f"({os.path.getsize(fixture)} bytes): logits and pool_3 card vs CPU within rtol 1e-3 / "
        f"atol 1e-5 (the largest difference {worst:.3f} of the tolerance)")

    clf = RandomFeatureClassifier(device=dev)
    batch = t(img(BATCH, 32), dev)
    ms = cuda_ms(lambda: clf(batch), 200, warmup=10)
    log(f"[metrics] random-feature classifier on the card: {ms:.4f} ms per batch of {BATCH} "
        f"at 32x32, {BATCH / ms * 1e3:.0f} images/s (CUDA events over 200 batches)")


def optimizer_windows(device, name: str, bf16: bool, lr: float) -> tuple:
    """The narrow f32 CIFAR model on ``device`` under optimizer ``name``
    (sgd and momentum decaying 0.96 per step): one 'rmb' step (step 0 is
    degenerate), then OPT_WINDOWS K=16 windows of 'rep' through
    ``build_multi_step`` (on the card: the eager warm-up, the capture,
    replays; on the CPU an eager loop), fed RandomState(8)'s batches and z.
    Returns (every step's metrics, the parameters but the score layer's
    bias, the sgd lr read at the final count, the optimizers' counts)."""
    from mmdgan_torch.train.optim import SGD

    rng = np.random.RandomState(8)
    x = rng.randn(SCAN_K, OPT_BATCH, 32, 32, 3).clip(-1, 1).astype(np.float32)
    z = rng.randn(SCAN_K, OPT_BATCH, 128).astype(np.float32)
    opts = multi_opt_config([lr, lr], lr_decay_steps=1, optimizer=name, bf16_moments=bf16)
    first, model = (SNGan(narrow_architecture(), loss_type=loss, compute_dtype=torch.float32,
                          device=device) for loss in ("rmb", "rep"))
    ts = init_train_state(first, 0, *opts, device=device)
    ts, _ = build_train_step(first, *opts, device=device)(ts, {"x": x[0]},
                                                          code_batch={"x": z[0]})
    multi = build_multi_step(model, *opts, SCAN_K, device=device)
    batches, codes = ({"x": torch.tensor(a, device=device)} for a in (x, z))
    metrics = []
    for _ in range(OPT_WINDOWS):
        ts, m = multi(ts, batches, code_batches=codes)
        metrics.append({k: v.cpu().numpy() for k, v in m.items()})
    if device.type == "cuda":
        graphs = multi.graphs   # the capture's call replays it too
        assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, OPT_WINDOWS - 1)
    for m in metrics:
        m["s_x_mean"] = m["s_x_mean"] - m.pop("s_gen_mean")
    params = [p.detach().cpu().numpy() for k, p in _named_leaves(ts.params) if "l8_s" not in k
              or "bias" not in k]
    lr_now = (float(opts[0].lr_at(ts.opt_state_dis.count)) if isinstance(opts[0], SGD)
              else None)
    return metrics, params, lr_now, (int(ts.opt_state_dis.count), int(ts.opt_state_gen.count))


def _named_leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _named_leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [(f"{prefix}/{k}", v)]
    return out


def check_optimizer_windows(dev) -> None:
    """Phase 11: for each optimizer (and bf16 slots for adam),
    ``optimizer_windows`` on the card (graphed) and on the CPU (eager),
    TF32 off: every step's metrics and the final parameters at rtol 1e-3 /
    atol 1e-5, but the gradient norms: where generated scores are
    near-duplicates (early steps), the kernel means' backward on the card
    and its closed form on the CPU keep different pairs at raw distances
    that round across 0 (``kernel_means_backward_atol``), which moved one
    step's generator gradient norm by 1.4e-3 relative. sgd and momentum
    read their lr from the device count inside the replays: a graph that
    froze the lr of its capture would move the parameters by up to
    0.96^-16 of the CPU's steps, and the lr read at the end is
    lr * 0.96^(1 + 16 * OPT_WINDOWS)."""
    for name, bf16, lr in OPTIMIZER_CASES:
        start = time.perf_counter()
        card, cpu = tf32_off(lambda: [optimizer_windows(d, name, bf16, lr)
                                      for d in (dev, torch.device("cpu"))])
        worst = 0.0
        for w, (mg, mc) in enumerate(zip(card[0], cpu[0])):
            for key in mc.keys() - {"grad_norm_dis", "grad_norm_gen"}:
                np.testing.assert_allclose(mg[key], mc[key], rtol=1e-3, atol=1e-5,
                                           err_msg=f"{name} bf16={bf16} window {w} {key}")
        # bf16 slots: one element may round to the neighbouring bfloat16 (2^-8
        # relative) on the two devices, and momentum's trace carries that
        # 1 / (1 - 0.9) = 10 steps
        atol = 1e-5 + (10 * lr * 2 ** -8 if bf16 else 0.0)
        for g, c in zip(card[1], cpu[1]):
            np.testing.assert_allclose(g, c, rtol=1e-3, atol=atol,
                                       err_msg=f"{name} bf16={bf16} parameters")
            worst = max(worst, float(np.max(np.abs(g - c) / (atol + 1e-3 * np.abs(c)))))
        steps = 1 + SCAN_K * OPT_WINDOWS
        assert card[3] == cpu[3] == (steps, steps), (card[3], cpu[3])
        line = ""
        if card[2] is not None:
            want = lr * 0.96 ** steps
            assert abs(card[2] - want) <= 1e-5 * want, (card[2], want)   # float32 pow
            line = f"; lr at count {steps} {card[2]:.6e} = {lr} x 0.96^{steps}"
        log(f"[optim] {name}{' bf16 slots' if bf16 else ''} lr {lr}: {OPT_WINDOWS} K={SCAN_K} "
            f"windows (eager, capture, replay) on the card equal the CPU's eager steps at rtol "
            f"1e-3 / atol 1e-5 on every step's metrics but the gradient norms and on the final "
            f"parameters (atol {atol:.3g}; the largest difference {worst:.3f} of the "
            f"tolerance){line}; "
            f"{time.perf_counter() - start:.1f} s")


def optimizer_steps_per_sec(dev, card: str) -> None:
    """Phase 11: graphed steps/s of the full-width CIFAR rep model, b64 bf16,
    under each optimizer (sgd and momentum decaying), OPT_MEASURE_CALLS
    timed K=16 windows after the warm-up and the capture."""
    rates = {}
    for name, bf16 in (("sgd", False), ("momentum", False), ("rmsprop", False),
                       ("adam", False), ("adam_tf1", False), ("adam", True)):
        model = SNGan(cifar_architecture(), loss_type="rep")
        opts = multi_opt_config([5e-4, 2e-4], optimizer=name, bf16_moments=bf16,
                                target_step=100000)
        ts = init_train_state(model, 0, *opts)
        multi = build_multi_step(model, *opts, SCAN_K)
        rng = np.random.RandomState(0)
        batches = {"x": torch.tensor(rng.randn(SCAN_K, BATCH, 32, 32, 3).astype(np.float32)
                                     .clip(-1, 1), device=dev)}
        ts, m, sps = timed_windows(multi, ts, batches, measure=OPT_MEASURE_CALLS)
        assert all(torch.isfinite(v).all() for v in m.values()), name
        rates[name + (" bf16" if bf16 else "")] = round(sps, 2)
        del model, ts, multi
    log(f"[optim] cifar10 rep b{BATCH} bf16 graphed steps/s by optimizer "
        f"({OPT_MEASURE_CALLS * SCAN_K} steps after {WARMUP_CALLS * SCAN_K}): "
        f"{json.dumps(rates)}; "
        f"card: {card}")


# ----------------------------------------------------------------------
# phase 12: the class-conditional models and the layer catalogue
# ----------------------------------------------------------------------
NUM_CLASS = 10                      # CIFAR-10's classes, 5,000 rows each
SAMPLER_DRAWS = 256                 # batches whose labels are read on the card


def _sn_layer(name: str, out, **kw) -> dict:
    return {"name": name, "out": out, "act": "lrelu", "act_k": 1.3, "w_nm": "s", **kw}


# a narrow 32x32 conditional model holding every conditional op: dcd, cbn,
# tcck, c_bias and bcb in G; cck, c_bias, bcb, dcd and the dck head in D
COND_OPS_ARCH = {
    "input": [(3, 32, 32)],
    "code": [(128, "linear")],
    "generator": [
        {"name": "l1", "out": 32 * 4 * 4, "op": "dcd", "act": "relu", "act_nm": "cbn",
         "out_reshape": [32, 4, 4]},
        {"name": "l2_up", "out": 16, "op": "tcck", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2, "w_nm": "s"},
        {"name": "l3_up", "out": 8, "op": "tc", "act": "relu", "bias": "c_bias",
         "kernel": 4, "strides": 2},
        {"name": "l4_up", "out": 8, "op": "tc", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2},
        {"name": "l5_t32", "out": 3, "act": "tanh", "bias": "bcb"},
    ],
    "discriminator": [
        _sn_layer("l1", 8),
        _sn_layer("l2_ds", 16, op="cck", kernel=4, strides=2),
        _sn_layer("l3_ds", 16, kernel=4, strides=2, bias="c_bias"),
        _sn_layer("l4_ds", 32, kernel=4, strides=2, bias="bcb", out_reshape=[4 * 4 * 32]),
        _sn_layer("l5", 32, op="dcd"),
        {"name": "l6_s", "out": 16, "op": "dck", "act_k": 1.3, "w_nm": "s"},
    ],
}
# the projection head (tests/test_conditional.py's COND_ARCH at 32x32), hinge
COND_PROJECT_ARCH = {
    "input": [(3, 32, 32)],
    "code": [(128, "linear")],
    "generator": copy.deepcopy(COND_OPS_ARCH["generator"]),
    "discriminator": [
        _sn_layer("l1_ds", 8, kernel=4, strides=2),
        _sn_layer("l2_ds", 16, kernel=4, strides=2, out_reshape=[8 * 8 * 16]),
        {"name": "l3_s", "out": 1, "op": "d", "w_nm": "s", "type": "project"},
    ],
}
# a narrow unconditional model through the rest of the catalogue: res,
# res_v1, nl and nl_pool_dist blocks, every scaling method (bil, ps up,
# unpool, bic in G; ps down, avg, max in D), the i and sc ops, an
# asymmetric-SAME, a dilated and a VALID conv
CATALOGUE_ARCH = {
    "input": [(3, 32, 32)],
    "code": [(128, "linear")],
    "generator": [
        {"name": "l1", "out": 32 * 2 * 2, "op": "d", "act": "linear", "out_reshape": [32, 2, 2]},
        {"name": "l2_res", "type": "res", "out": 16, "kernel": [3, 3, 1], "act": "relu",
         "act_nm": "bn", "scale": ["bil", 2]},
        {"name": "l3_ps", "out": 16, "act": "relu", "act_nm": "bn", "scale": ["ps", 2]},
        {"name": "l4_nl", "type": "nl", "out": [4, 4, 16], "kernel": [1, 1, 1],
         "act": "linear", "act_nm": "bn"},
        {"name": "l5_unpool", "out": 8, "act": "relu", "act_nm": "bn", "scale": ["unpool", 2]},
        {"name": "l6_bic", "out": 8, "act": "relu", "scale": ["bic", 2]},
        {"name": "l7_i", "op": "i", "act": "relu", "act_nm": "bn"},
        {"name": "l8_sc", "out": 3, "op": "sc", "act": "tanh"},
    ],
    "discriminator": [
        _sn_layer("l1_asym", 8, kernel=3, strides=2),
        _sn_layer("l2_ps", 4, scale=["ps", -2]),
        _sn_layer("l3_res_v1", 16, type="res_v1", kernel=[3, 3, 1], scale=["avg", -2]),
        _sn_layer("l4_nl", [4, 4, 16], type="nl_pool_dist", kernel=[1, 1, 1], act="linear"),
        _sn_layer("l5_dilated", 16, dilation=2),
        _sn_layer("l6_res", 16, type="res", kernel=[3, 3, 1], scale=["max", -2]),
        _sn_layer("l7_valid", 16, kernel=2, padding="VALID", out_reshape=[16]),
        {"name": "l8_s", "out": 16, "op": "d", "act_k": 1.3, "w_nm": "s"},
    ],
}


def labelled_metrics(device, arch: dict, loss_type: str, num_class: int) -> list:
    """``narrow_metrics`` for a conditional model: float32 steps on
    ``device`` from the state of seed 0 (a first 'rmb' step, or 'hinge' for
    a projection head, then three of ``loss_type``), fed RandomState(7)'s
    batches, labels, z and code labels."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 8, 32, 32, 3).clip(-1, 1).astype(np.float32)
    y = rng.randint(0, num_class, (4, 8, 1))
    z = rng.randn(4, 8, 128).astype(np.float32)
    zy = rng.randint(0, num_class, (4, 8, 1))
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    first_loss = "hinge" if arch["discriminator"][-1].get("type") == "project" else "rmb"
    first, model = (SNGan(arch, num_class=num_class, loss_type=loss,
                          compute_dtype=torch.float32, device=device)
                    for loss in (first_loss, loss_type))
    steps = [build_train_step(first, opt_d, opt_g, device=device),
             build_train_step(model, opt_d, opt_g, device=device)]
    ts = init_train_state(first, 0, opt_d, opt_g, device=device)
    metrics = []
    for k in range(4):
        ts, m = steps[min(k, 1)](ts, {"x": x[k], "y": y[k]}, code_batch={"x": z[k], "y": zy[k]})
        metrics.append({key: v.item() for key, v in m.items()})
    for m in metrics:
        m["s_x_mean"] -= m.pop("s_gen_mean")
    return metrics[1:]


def _forward(device, arch: dict, num_class: int = 0) -> list:
    """G's images and D's train-mode scores of the float32 model of seed 0
    on fixed inputs (and labels)."""
    rng = np.random.RandomState(3)
    model = SNGan(arch, num_class=num_class, compute_dtype=torch.float32, device=device)
    params, state, _ = model.init(0)
    y = None if num_class < 2 else rng.randint(0, num_class, (8, 1))
    code = {"x": rng.randn(8, 128).astype(np.float32), "y": y}
    x = rng.randn(8, 32, 32, 3).clip(-1, 1).astype(np.float32)
    return [model.generate(params, state, code_batch=code).cpu().numpy(),
            model.discriminate(params, state, {"x": x, "y": y}, train=True).detach().cpu().numpy()]


def _small_checks(device) -> list:
    """Outputs of the ops no layer reaches (lrn, the bounded k scalar), the
    pooling ops, and a Routine of split, concat and sum links with its
    gradients, float32, from RandomState(4)."""
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(4, 6, 7, 7).astype(np.float32), device=device)
    out = []
    for design in ({"op": "lrn"}, {"op": "k", "bound": (-0.5, 0.5)},
                   *({"op": op, "kernel": 3, "strides": 2, "padding": pad}
                     for op in ("max", "avg", "sum") for pad in ("SAME", "VALID"))):
        op = ParametricOp(design, (6, 7, 7), compute_dtype=torch.float32)
        params = {"kernel": torch.tensor(0.9, device=device)} if design["op"] == "k" else {}
        out.append(op.apply(params, {}, x)[0].cpu().numpy())
    design = [{"name": "in", "out": 8, "op": "c", "kernel": 3, "act": "relu"},
              {"name": "a", "out": 4, "op": "c", "kernel": 3, "act": "relu"},
              {"name": "b", "out": 4, "op": "c", "kernel": 1, "act": "lrelu"},
              {"name": "cat", "out": 8, "op": "c", "kernel": 3, "act": "linear"},
              {"name": "sum", "out": 3, "op": "c", "kernel": 3, "act": "tanh"}]
    r = Routine(Net(design, net_name="r", compute_dtype=torch.float32))
    r.add_input_layers([6, 7, 7], [0])
    r.link([0], [1, 2], input_fun="split")
    r.link([1, 2], [3], input_fun="concat")
    r.link([3, 0], [4], input_fun="sum")
    r.add_output_layers([4])
    params, _ = r.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(device).requires_grad_(True), params)
    y, _ = r.apply(params, {}, x)
    grads = torch.autograd.grad((y ** 2).sum(), tree_leaves(params))
    return out + [y.detach().cpu().numpy()] + [g.cpu().numpy() for g in grads]


def check_catalogue_on_card(dev) -> None:
    """Phase 12, card vs CPU, TF32 off, rtol 1e-3 / atol 1e-5: three
    float32 steps of the narrow conditional models (every conditional op
    with rep; the projection head with hinge); the catalogue model's
    forward and one rep step (after the first 'rmb' step); the lrn, k and
    pooling ops and a split/concat/sum Routine with its gradients."""
    runs = tf32_off(lambda: {d: [labelled_metrics(d, COND_OPS_ARCH, "rep", NUM_CLASS),
                                 labelled_metrics(d, COND_PROJECT_ARCH, "hinge", NUM_CLASS),
                                 narrow_metrics(d, "rep", arch=CATALOGUE_ARCH, n_steps=1)]
                             for d in ("cpu", dev)})
    names = ("conditional ops", "projection head", "catalogue")
    worst = {what: assert_metrics_close(got, want, f"card vs CPU, {what}")
             for got, want, what in zip(runs[dev], runs["cpu"], names)}
    arrays = tf32_off(lambda: {d: _forward(d, COND_OPS_ARCH, NUM_CLASS)
                               + _forward(d, CATALOGUE_ARCH) + _small_checks(d)
                               for d in ("cpu", dev)})
    for i, (got, want) in enumerate(zip(arrays[dev], arrays["cpu"])):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=f"array {i}")
    log(f"[conditional] card vs CPU, f32, TF32 off, rtol 1e-3: three steps of the conditional "
        f"model with dcd, cbn, tcck, c_bias, bcb, cck and dck (rep) and of the projection head "
        f"(hinge), one of the catalogue model (res, res_v1, nl, nl_pool_dist; bil, ps, unpool, "
        f"bic, avg, max; i, sc; asymmetric-SAME, dilated and VALID convs) agree on every step "
        f"metric (largest relative difference by model: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"); {len(arrays['cpu'])} forward, "
        "op (lrn, k, max/avg/sum SAME and VALID) and split/concat/sum Routine outputs and "
        "gradients agree")


def run_conditional(dev, card: str) -> list:
    """Phase 12a: ``cifar_architecture(conditional=True)`` at full width
    (cbn generator, dck head, 10 classes), rep b64 bf16, host-fed labels
    through graphed K=16 windows from the state of seed 0: the eager
    warm-up, the capture, MEASURE_CALLS timed replays; the wrappers'
    counters show 1 + 2 kernel-means launches per step of the eager window
    and the capture; one profiled replay must count 1 + 2 per step; finite
    metrics; the cbn and dck parameters moved. Returns the profiler's
    counts."""
    arch = cifar_architecture(conditional=True)
    model, ts, multi, batches = main_path_setup(dev, "rep", arch=arch, num_class=NUM_CLASS)
    n_params = sum(p.numel() for p in tree_leaves(ts.params))
    watched = {f"{net}/{scope}/{op}/{leaf}": t.detach().clone()
               for net in ("gen", "dis") for scope, ops in ts.params[net].items()
               for op, leaves in ops.items() for leaf, t in leaves.items()
               if leaf in ("scale", "offset", "c_kernel")}
    assert len(watched) == 7, sorted(watched)   # 3 cbn x (scale, offset) + dck's c_kernel
    reset_counters()
    ts, m, sps = timed_windows(multi, ts, batches)
    assert_counted("conditional cifar10", multi.graphs.eager + multi.graphs.captures)
    prof = _profiled_window(multi, ts, batches, "conditional cifar10 replayed window")
    bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
    assert not bad and all(torch.isfinite(t.float()).all() for t in ts.tensors()), bad
    now = {f"{net}/{scope}/{op}/{leaf}": t
           for net in ("gen", "dis") for scope, ops in ts.params[net].items()
           for op, leaves in ops.items() for leaf, t in leaves.items()}
    still = [k for k, v in watched.items() if torch.equal(v, now[k])]
    assert not still, f"conditional parameters that did not move: {still}"
    images = model.generate(ts.params, ts.net_state, torch.Generator(dev).manual_seed(0),
                            labels=torch.arange(NUM_CLASS, device=dev))
    assert images.shape == (NUM_CLASS, 32, 32, 3) and torch.isfinite(images).all()
    log(f"[conditional] cifar10 conditional (cbn G, dck head, {NUM_CLASS} classes, {n_params} "
        f"parameters) rep b{BATCH} bf16, host labels: graphed {sps:.2f} steps/s "
        f"({MEASURE_CALLS * SCAN_K} steps after {WARMUP_CALLS * SCAN_K} warm-up, unprofiled), "
        f"loss_gen={float(m['loss_gen'][-1]):.5f} e_kxx={float(m['e_kxx'][-1]):.5f}; the 7 "
        f"cbn/dck parameter tensors moved; a replay: device busy {prof['union']:.4f} ms/step, "
        f"idle {100 * (1 - prof['union'] / prof['span']):.1f}% of the span, "
        f"{prof['activities']:.0f} activities/step, kernel means "
        f"{prof['kernel_means_fwd'] // SCAN_K}+{prof['kernel_means_bwd'] // SCAN_K} per step; "
        f"card: {card}")
    _log_profile(prof, 1e3 / sps, "conditional cifar10 graphed (a replay)")
    return [prof["kernel_means_fwd"], prof["kernel_means_bwd"]]


def labelled_dataset(dev) -> tuple:
    """CIFAR-10's shape from seed 0: 50,000 x 32 x 32 x 3 uint8 images and
    [N, 1] labels, 5,000 per class in a shuffled order; host and card."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (AGENT_ROWS, 32, 32, 3), np.uint8)
    y = rng.permutation(np.repeat(np.arange(NUM_CLASS), AGENT_ROWS // NUM_CLASS))
    y = y[:, None].astype(np.int32)
    return x, y, torch.tensor(x, device=dev), torch.tensor(y.astype(np.int64), device=dev)


def _same_class_fn(template, sampling: str, same_class: bool, table, counts,
                   capture: bool = True) -> tuple:
    model = SNGan(cifar_architecture(conditional=True), num_class=NUM_CLASS, loss_type="rep")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    fn = build_device_data_step(model, opt_d, opt_g, SCAN_K, BATCH, same_class=same_class,
                                class_table=table if same_class else None,
                                class_counts=counts if same_class else None,
                                sampling=sampling, capture=capture)
    return model, fn, copy_state(template)


def _scheduled(fn, data_x, data_y, rng, start: int = 0):
    """A caller of ``fn`` that hands each window its rows of the class
    schedule (seed 0), from step ``start`` on."""
    sched = class_schedule(NUM_CLASS, 4096, 0)
    at = [start]

    def drive(ts, _):
        rows = sched[at[0]:at[0] + SCAN_K]
        at[0] += SCAN_K
        return fn(ts, data_x, data_y, rng, schedule=rows)
    return drive


def same_class_setup(dev) -> tuple:
    """``labelled_dataset`` with its same-class tables, and the conditional
    model's state from seed 0."""
    x, y, data_x, data_y = labelled_dataset(dev)
    table, counts = same_class_tables(y, NUM_CLASS)
    template = init_train_state(SNGan(cifar_architecture(conditional=True),
                                      num_class=NUM_CLASS), 0, *multi_opt_config([5e-4, 2e-4]))
    return x, y, data_x, data_y, table, counts, template


def same_class_rates(dev, card: str, setup: tuple) -> None:
    """Phase 12b's measurement: graphed steps/s of labelled uniform (not
    same-class), same-class uniform and same-class shuffled-epochs windows
    of the conditional model over ``labelled_dataset``."""
    _, _, data_x, data_y, table, counts, template = setup
    rates = {}
    for name, sampling, same in (("labelled uniform", "uniform", False),
                                 ("same-class uniform", "uniform", True),
                                 ("same-class shuffled epochs", "shuffled_epochs", True)):
        _, fn, ts = _same_class_fn(template, sampling, same, table, counts)
        rng = torch.Generator(dev).manual_seed(1)
        drive = (_scheduled(fn, data_x, data_y, rng) if sampling == "shuffled_epochs"
                 else lambda ts, _, fn=fn, rng=rng: fn(ts, data_x, data_y, rng))
        ts, m, rates[name] = timed_windows(drive, ts, None)
        assert all(torch.isfinite(v).all() for v in m.values()), name
    log(f"[same-class] graphed device-data windows of the conditional model, steady state "
        f"({MEASURE_CALLS * SCAN_K} steps after {WARMUP_CALLS * SCAN_K}): "
        + ", ".join(f"{k} {v:.2f} steps/s" for k, v in rates.items()) + f"; card: {card}")


def check_same_class_data(dev, setup: tuple) -> None:
    """Phase 12b's checks: same-class sampling over a CIFAR-shaped labelled
    dataset on the card (``labelled_dataset``), the conditional model at
    full width, rep b64 bf16:
    - SAMPLER_DRAWS batches of each sampler, read on the card: every batch
      is one class, its rows' labels are that class, the scheduled one
      takes the schedule's classes, the uniform one each class about a
      tenth of the time;
    - under deterministic algorithms, graphed and eager windows end
      bitwise equal for both same-class samplings, and
      ``Agent.train_device_data(sample_same_class=True)`` under
      shuffled epochs runs 800 straight steps equal to 400 + restore by a
      new Agent + 400 bitwise."""
    x, y, data_x, data_y, table, counts, template = setup
    sched = class_schedule(NUM_CLASS, SAMPLER_DRAWS, 0)
    for sampling in ("uniform", "shuffled_epochs"):
        _, fn, _ = _same_class_fn(template, sampling, True, table, counts)
        sample = fn.sampler(data_x, data_y)
        rng = torch.Generator(dev).manual_seed(2)
        ys = torch.stack([sample(rng, torch.tensor(t, device=dev),
                                 torch.tensor(sched[t], device=dev))["y"]
                          for t in range(SAMPLER_DRAWS)])            # [draws, B, 1]
        assert bool((ys == ys[:, :1]).all()), f"{sampling}: a batch mixes classes"
        first = ys[:, 0, 0].cpu().numpy()
        if sampling == "shuffled_epochs":
            assert np.array_equal(first, sched[:, 0]), "the batches do not follow the schedule"
        else:
            freq = np.bincount(first, minlength=NUM_CLASS) / SAMPLER_DRAWS
            assert np.all(np.abs(freq - 0.1) < 0.07), freq
    log(f"[same-class] {SAMPLER_DRAWS} batches of each sampler read on the card: every batch "
        f"one class ({BATCH} rows whose labels, gathered with them, are that class); the "
        "shuffled-epochs batches follow the class schedule")

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ends = {}
        for sampling in ("uniform", "shuffled_epochs"):
            for capture in (True, False):
                _, fn, ts = _same_class_fn(template, sampling, True, table, counts, capture)
                rng = torch.Generator(dev).manual_seed(1)
                drive = (_scheduled(fn, data_x, data_y, rng) if sampling == "shuffled_epochs"
                         else lambda ts, _, fn=fn, rng=rng: fn(ts, data_x, data_y, rng))
                for _ in range(DATA_WINDOWS):
                    ts, m = drive(ts, None)
                if capture:
                    assert fn.graphs.replays == DATA_WINDOWS - 1, fn.graphs.replays
                ends[(sampling, capture)] = _end_state(ts, m) + [rng.get_state()]
        with tempfile.TemporaryDirectory() as out:
            data = {"x": x, "y": y}
            straight = run_same_class_agent(template, out, "straight", data, 800, do_save=False)
            run_same_class_agent(template, out, "halves", data, 400)
            resumed = run_same_class_agent(template, out, "halves", data, 400, load_ckpt=True,
                                           do_save=False)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    for sampling in ("uniform", "shuffled_epochs"):
        differ = _differ(ends[(sampling, True)], ends[(sampling, False)])
        assert differ == 0, f"same-class {sampling}: {differ} tensors differ, graphed vs eager"
    differ = _differ(straight.tensors() + [straight.rng.get_state()],
                     resumed.tensors() + [resumed.rng.get_state()])
    assert int(resumed.step) == 800 and differ == 0, (
        f"same-class Agent: {differ} tensors differ, 800 straight vs 400 + restore + 400")
    log(f"[same-class] under deterministic algorithms graphed and eager same-class windows end "
        f"bitwise equal, uniform and shuffled epochs ({DATA_WINDOWS * SCAN_K} steps each, "
        f"{len(ends[('uniform', False)])} tensors); Agent.train_device_data("
        f"sample_same_class=True, shuffled epochs): 800 straight steps equal 400 + restore by "
        f"a new Agent + 400 bitwise")


def run_same_class_agent(template, out: str, name: str, data: dict, max_step: int,
                         load_ckpt: bool = False, do_save: bool = True):
    """``Agent.train_device_data`` of the conditional model with
    ``sample_same_class=True`` under shuffled epochs, K=16, from a copy of
    ``template`` (restored first when ``load_ckpt``)."""
    model = SNGan(cifar_architecture(conditional=True), num_class=NUM_CLASS, loss_type="rep")
    model.sample_same_class = True
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    agent = Agent(name, "t", output_dir=out, load_ckpt=load_ckpt, do_save=do_save,
                  query_step=400, print_loss=False, use_tensorboard=False)
    return agent.train_device_data(model, opt_d, opt_g, copy_state(template), data,
                                   max_step=max_step, step_per_epoch=AGENT_ROWS // BATCH,
                                   batch_size=BATCH, steps_per_call=SCAN_K,
                                   sample_same_class=True, sampling="shuffled_epochs")


def conditional_cli_runs(tmp: str) -> list:
    """Phase 12d's three runs of ``python -m mmdgan_torch.experiments.cifar
    --num-class 10 --sample-same-class``: on synthetic labelled data,
    host-fed over a tfrecord of 4,096 seeded labelled images (the
    pipeline's same-class batching), and over the same tfrecord resident on
    the card with ``--device-dataset --sampling shuffled_epochs`` (the class
    schedule)."""
    rng = np.random.RandomState(3)
    np_to_tfrecords(rng.randint(0, 256, (4096, 3, 32, 32), np.uint8),
                    rng.randint(0, NUM_CLASS, 4096), os.path.join(tmp, "cifar"))
    common = ["--skip-sampling", "--skip-metrics", "--fresh", "--chunks", "1",
              "--num-class", str(NUM_CLASS), "--sample-same-class", "--query-step", "32",
              "--steps-per-chunk", "64", "--use-pallas"]
    return [("cifar", common + ["--synthetic-data"], "conditional, synthetic, 64 steps"),
            ("cifar", common + ["--data-dir", tmp],
             "conditional, tfrecord host-fed, same-class batches, 64 steps"),
            ("cifar", common + ["--data-dir", tmp, "--device-dataset", "--sampling",
                                "shuffled_epochs"],
             "conditional, tfrecord on the card, class schedule, 64 steps")]


# ----------------------------------------------------------------------
# phase 13: data parallelism (the mesh), each part in its own processes
# ----------------------------------------------------------------------
MESH_WINDOWS = 4                    # windows of each bitwise mesh run
MESH_STEPS = 3                      # 13b's narrow steps, two ranks against one
MESH_DATA_CALLS = 4                 # 13c's timed windows per sampler
MESH_CLI_STEPS = 64                 # 13d: one chunk, then one more resumed
# 13a, a mesh window against the non-mesh one from the same trained state:
# the first step's losses and gradient norms, then the end state's
# parameters in relative L2 per network
MESH_FIRST_STEP = dict(rtol=1e-3, atol=1e-5)
MESH_PARAM_REL = 1e-2


def _mesh_dp(backend: str, rank: int, world: int, store: str):
    from mmdgan_torch.parallel.mesh import DataParallel, init_distributed

    init_distributed(backend, f"file://{store}", rank, world)
    return DataParallel(device="cuda:0")


def _device_calls(prof: dict, pattern: str) -> tuple:
    """(device activities per step whose name holds ``pattern``, their
    device ms per step) of a profiled window."""
    names = [n for n in prof["calls_by_name"] if pattern in n.lower()]
    return (sum(prof["calls_by_name"][n] for n in names) / SCAN_K,
            sum(prof["by_name"][n] for n in names) / SCAN_K)


def _relative_gap(a: list, b: list) -> float:
    num = sum(float(torch.sum(torch.square(x.float() - y.float()))) for x, y in zip(a, b))
    den = sum(float(torch.sum(torch.square(y.float()))) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def check_mesh_main_path(dp, card: str) -> list:
    """Phase 13a, one NCCL rank: the full-width CIFAR-10 rep b64 bf16 main
    path through ``DataParallel`` (``build_multi_step(..., dp=dp)``,
    graphed K=16, the collectives captured):
    - three profiled windows (the eager warm-up, the capture's replay, a
      replay): 1 + 2 kernel-means launches per step in each, NCCL kernels
      per step and their device time, busy time, idle share;
    - steps/s of the non-mesh and the mesh window in turns (plain, mesh,
      mesh, plain), 128 timed steps each;
    - under deterministic algorithms, two mesh runs drawing their own z
      end bitwise equal (MESH_WINDOWS windows), and one window of the mesh
      against one of the non-mesh step from the same state (MESH_WINDOWS
      non-mesh windows from seed 0), fed the same z: the first step's
      losses and gradient norms within MESH_FIRST_STEP, the end state's
      parameters within MESH_PARAM_REL in relative L2 per network. Only
      the BN moments differ at one rank (cross-replica sums against
      ``torch.mean``/``torch.var``, a rounding apart); bf16 activations
      and the GAN's steps amplify that over a window (from init, the
      per-step losses drifted 8.4% apart by step 7), so the window is
      bounded loosely and its first step tightly.
    Returns the profiler's kernel-means counts."""
    dev = dp.device
    meshed = lambda model, od, og, k, capture=True: build_multi_step(  # noqa: E731
        model, od, og, k, capture=capture, dp=dp)
    _, ts, multi, batches = main_path_setup(dev, "rep", make_multi=meshed)
    dp.replicate(ts)
    reset_counters()
    profs = [_profiled_window(multi, ts, batches, f"mesh window {i}") for i in range(3)]
    assert (multi.graphs.eager, multi.graphs.captures) == (1, 1), (
        multi.graphs.eager, multi.graphs.captures)
    assert_counted("mesh main path", 2)
    counted = [sum(p[k] for p in profs) for k in KERNEL_EVENTS]
    collectives = profs[0]["nccl_ops"] / SCAN_K
    assert collectives > 0, "the eager mesh window issued no NCCL collective"
    nccl, nccl_ms = _device_calls(profs[-1], "nccl")
    copies, copies_ms = _device_calls(profs[-1], "memcpy")

    _, ts_plain, plain, _ = main_path_setup(dev, "rep")
    rates = {}
    for name, drive, state in (("plain", plain, "p"), ("mesh", multi, "m"),
                               ("mesh again", multi, "m"), ("plain again", plain, "p")):
        if state == "p":
            ts_plain, m, rates[name] = timed_windows(drive, ts_plain, batches)
        else:
            ts, m, rates[name] = timed_windows(drive, ts, batches)
        assert all(torch.isfinite(v).all() for v in m.values()), name
    plain_prof = _profiled_window(plain, ts_plain, batches, "non-mesh replay")
    counted = [n + plain_prof[k] for n, k in zip(counted, KERNEL_EVENTS)]
    plain_copies, plain_copies_ms = _device_calls(plain_prof, "memcpy")
    mesh_sps = (rates["mesh"] + rates["mesh again"]) / 2
    plain_sps = (rates["plain"] + rates["plain again"]) / 2
    log(f"[mesh] 13a cifar10 rep b{BATCH} bf16 through DataParallel at 1 NCCL rank, graphed "
        f"K={SCAN_K} (collectives captured): {rates['mesh']:.2f} / {rates['mesh again']:.2f} "
        f"steps/s against the non-mesh window's {rates['plain']:.2f} / "
        f"{rates['plain again']:.2f} in turns ({mesh_sps / plain_sps:.3f}x; "
        f"{MEASURE_CALLS * SCAN_K} steps each); {collectives:g} NCCL collectives per step "
        f"issued in the eager window; a replay: {nccl:g} NCCL kernels/step ({nccl_ms:.5f} "
        f"ms/step), {copies:g} device copies/step ({copies_ms:.5f} ms) against the non-mesh "
        f"replay's {plain_copies:g} ({plain_copies_ms:.5f} ms), device busy "
        f"{profs[-1]['union']:.4f} ms/step against {plain_prof['union']:.4f}, idle "
        f"{100 * (1 - profs[-1]['union'] / profs[-1]['span']):.1f}% of the span (non-mesh "
        f"{100 * (1 - plain_prof['union'] / plain_prof['span']):.1f}%), "
        f"{profs[-1]['activities']:.0f} activities/step against {plain_prof['activities']:.0f}, "
        f"kernel means {profs[-1]['kernel_means_fwd'] // SCAN_K}+"
        f"{profs[-1]['kernel_means_bwd'] // SCAN_K} per step in each of 3 profiled windows; "
        f"card: {card}")
    _log_profile(profs[-1], 1e3 / mesh_sps, "mesh cifar10 rep (a replay)")

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ends = []
            for _ in range(2):
                _, ts, multi, batches = main_path_setup(dev, "rep", make_multi=meshed)
                dp.replicate(ts)
                for _ in range(MESH_WINDOWS):
                    ts, m = multi(ts, batches)
                ends.append(_end_state(ts, m))
            codes = {"x": torch.tensor(np.random.RandomState(9).randn(
                SCAN_K, BATCH, 128).astype(np.float32), device=dev)}
            model, trained, drive, batches = main_path_setup(dev, "rep")
            for _ in range(MESH_WINDOWS):
                trained, _ = drive(trained, batches)
            opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
            pair = [build_multi_step(model, opt_d, opt_g, SCAN_K, dp=mesh)(
                copy_state(trained), batches, code_batches=codes) for mesh in (dp, None)]
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    differ = _differ(*ends)
    assert differ == 0, f"mesh: {differ} tensors differ between two mesh runs"
    (ts_m, m_m), (ts_p, m_p) = pair
    keys = ("loss_gen", "loss_dis", "grad_norm_dis", "grad_norm_gen")
    rel = {k: (torch.abs(m_m[k] - m_p[k]) / torch.abs(m_p[k]).clamp(min=1e-6)).cpu().numpy()
           for k in keys}
    gaps = {net: _relative_gap(tree_leaves(ts_m.params[net]), tree_leaves(ts_p.params[net]))
            for net in ("gen", "dis")}
    log(f"[mesh] 13a under deterministic algorithms: two mesh runs of {MESH_WINDOWS * SCAN_K} "
        f"steps end bitwise equal ({len(ends[0])} tensors); one window of the mesh against "
        f"the non-mesh step from the same trained state (step {MESH_WINDOWS * SCAN_K}) fed the "
        f"same z: first step " + ", ".join(f"{k} {rel[k][0]:.2e}" for k in keys)
        + f" relative (bound rtol {MESH_FIRST_STEP['rtol']}, atol {MESH_FIRST_STEP['atol']}); "
        f"over the window "
        + ", ".join(f"{k} up to {rel[k].max():.2e}" for k in keys[:2])
        + f"; end parameters {gaps['gen']:.2e} (G) / {gaps['dis']:.2e} (D) relative L2 "
        f"(bound {MESH_PARAM_REL})")
    for key in keys:
        np.testing.assert_allclose(m_m[key][0].item(), m_p[key][0].item(), **MESH_FIRST_STEP,
                                   err_msg=f"mesh vs non-mesh, first step's {key}")
    assert max(gaps.values()) < MESH_PARAM_REL, gaps
    return counted


def check_mesh_device_data(dp, card: str) -> None:
    """Phase 13c, one NCCL rank: ``build_device_data_step(...).with_mesh``
    over phase 12's seeded 50,000-row labelled array on the card, the
    full-width CIFAR-10 model (conditional for same-class), rep b64 bf16,
    graphed K=16: every same-class batch one class (SAMPLER_DRAWS read on
    the card), the uniform mesh sampler at one rank the single-device one
    bitwise; steps/s of uniform, shuffled epochs, same-class uniform and
    uniform with ``imbalanced=[1, 5]`` (whose Adam counts advance by 16
    (D) and by the steps divisible by 5 (G) per window)."""
    dev = dp.device
    x, y, data_x, data_y = labelled_dataset(dev)
    table, counts = same_class_tables(y, NUM_CLASS)
    cond = SNGan(cifar_architecture(conditional=True), num_class=NUM_CLASS, loss_type="rep")
    plain = SNGan(cifar_architecture(), loss_type="rep")
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    templates = {m: init_train_state(m, 0, opt_d, opt_g) for m in (cond, plain)}

    def window(model, sampling="uniform", same=False, imbalanced=None):
        fn = build_device_data_step(model, opt_d, opt_g, SCAN_K, BATCH, same_class=same,
                                    class_table=table if same else None,
                                    class_counts=counts if same else None, sampling=sampling)
        return fn, fn.with_mesh(dp, imbalanced=imbalanced)

    single, meshed = window(cond, same=True)
    sample = meshed.sampler(data_x, data_y)
    rng = torch.Generator(dev).manual_seed(2)
    ys = torch.stack([sample(rng, torch.tensor(t, device=dev))["y"]
                      for t in range(SAMPLER_DRAWS)])
    assert bool((ys == ys[:, :1]).all()), "a sharded same-class batch mixes classes"
    single, meshed = window(plain)
    draws = [s(data_x)(torch.Generator(dev).manual_seed(3), torch.tensor(0, device=dev))["x"]
             for s in (single.sampler, meshed.sampler)]
    assert torch.equal(draws[0], draws[1]), "the one-rank mesh sampler is not the device one"

    rates = {}
    for name, model, sampling, same, imbalanced in (
            ("uniform", plain, "uniform", False, None),
            ("shuffled epochs", plain, "shuffled_epochs", False, None),
            ("same-class uniform", cond, "uniform", True, None),
            ("uniform, imbalanced [1, 5]", plain, "uniform", False, IMBALANCED)):
        _, fn = window(model, sampling, same, imbalanced)
        ts = dp.replicate(copy_state(templates[model]))
        rng = torch.Generator(dev).manual_seed(1)
        labels = data_y if same else None
        if imbalanced is None:
            drive = lambda ts, _, fn=fn, rng=rng, labels=labels: fn(ts, data_x, labels, rng)  # noqa: E731
        else:
            avg = torch.zeros((), device=dev)
            drive = lambda ts, _, fn=fn, rng=rng, avg=avg: fn(ts, data_x, None, rng, avg)  # noqa: E731
        counts0 = (int(ts.opt_state_dis.count), int(ts.opt_state_gen.count))
        ts, m, rates[name] = timed_windows(drive, ts, None, measure=MESH_DATA_CALLS)
        assert all(torch.isfinite(v).all() for v in m.values()), name
        if imbalanced is not None:
            steps = (WARMUP_CALLS + MESH_DATA_CALLS) * SCAN_K
            got = (int(ts.opt_state_dis.count) - counts0[0],
                   int(ts.opt_state_gen.count) - counts0[1])
            assert got == (steps, len(range(0, steps, IMBALANCED[1]))), got
        assert fn.graphs.captures == 1, (name, fn.graphs.captures)
    log(f"[mesh] 13c sharded device data (with_mesh) at 1 NCCL rank over the seeded "
        f"{AGENT_ROWS}-row labelled array, graphed K={SCAN_K}, steady state "
        f"({MESH_DATA_CALLS * SCAN_K} steps after {WARMUP_CALLS * SCAN_K}): "
        + ", ".join(f"{k} {v:.2f} steps/s" for k, v in rates.items())
        + f"; {SAMPLER_DRAWS} same-class batches read on the card, each one class; the "
        f"one-rank uniform sampler equals the device one bitwise; card: {card}")


def mesh_gloo_rank(rank: int, world: int, store: str, out: str, card: str) -> None:
    """Phase 13b, one of two gloo ranks sharing the card: the narrow f32
    model (BN generator) through a ``DataParallel`` step for rep and for
    rmb_gp (the witness penalty's double backward through the
    collectives), MESH_STEPS SGD steps at a global batch of BATCH on
    RandomState(7)'s batches, z and penalty weights, TF32 off; rank 0 runs
    the single-device step at the global batch beside it and holds the
    mesh to it within JAX's mesh bounds (losses rtol 2e-4 / atol 1e-5,
    parameters rtol 2e-3 / atol 1e-6). Each rank saves its end state for
    the bitwise comparison; a gloo mesh's window runs eagerly.

    cuDNN is off in this process: its f32 algorithms differ between a
    batch of 32 rows and one of 64, and in rmb_gp's double backward that
    moved parameters near zero by more than JAX's per-element bounds admit
    (2.6e-6 on a weight of 4.4e-4, NVIDIA H100 80GB HBM3 at 700 W);
    PyTorch's GEMM-based convolutions leave the comparison to the mesh's
    own summation order."""
    torch.backends.cudnn.enabled = False
    dp = _mesh_dp("gloo", rank, world, store)
    rng = np.random.RandomState(7)
    x = rng.randn(MESH_STEPS, BATCH, 32, 32, 3).clip(-1, 1).astype(np.float32)
    z = rng.randn(MESH_STEPS, BATCH, 128).astype(np.float32)
    uni = rng.uniform(size=(MESH_STEPS, BATCH, 1, 1, 1)).astype(np.float32)
    saved = {}

    def run(loss: str, mesh) -> tuple:
        model = SNGan(narrow_architecture(), loss_type=loss, compute_dtype=torch.float32,
                      device=dp.device)
        opt_d, opt_g = multi_opt_config([1e-2, 1e-2], optimizer="sgd")
        ts = init_train_state(model, 0, opt_d, opt_g, device=dp.device)
        step = build_train_step(model, opt_d, opt_g, device=dp.device, dp=mesh)
        losses = []
        for k in range(MESH_STEPS):
            rows = x[k] if mesh is None else dp.local_rows(torch.tensor(x[k]))
            ts, m = step(ts, {"x": rows}, code_batch={"x": z[k]},
                         uni=uni[k] if loss == "rmb_gp" else None)
            losses.append([m["loss_gen"].item(), m["loss_dis"].item()])
        return ts, np.asarray(losses), (build_multi_step(model, opt_d, opt_g, 2, dp=mesh)
                                        if mesh is not None else None)

    worst = {}
    for loss in ("rep", "rmb_gp"):
        ts, losses, multi = tf32_off(lambda: run(loss, dp))
        saved[loss] = [t.detach().cpu() for t in ts.tensors()] + [ts.rng.get_state()]
        ts, _ = multi(ts, {"x": torch.tensor(x[:2, :BATCH // world], device=dp.device)})
        assert (multi.graphs.eager, multi.graphs.captures) == (0, 0), "a gloo window captured"
        if rank == 0:
            ts1, losses1, _ = tf32_off(lambda: run(loss, None))
            np.testing.assert_allclose(losses, losses1, rtol=2e-4, atol=1e-5, err_msg=loss)
            got = saved[loss]
            want = [t.detach().cpu() for t in ts1.tensors()]
            n_state = len(tree_leaves(ts1.params)) + len(tree_leaves(ts1.net_state))
            for a, b in zip(got[:n_state], want[:n_state]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=1e-6,
                                           err_msg=loss)
            worst[loss] = float(np.max(np.abs(losses - losses1) / np.maximum(np.abs(losses1),
                                                                              1e-6)))
    torch.save(saved, os.path.join(out, f"gloo{rank}.pt"))
    if rank == 0:
        log(f"[mesh] 13b two gloo ranks sharing the card, narrow f32 (BN generator), "
            f"{MESH_STEPS} SGD steps at a global batch of {BATCH}: rep and rmb_gp equal the "
            f"single-device step within JAX's mesh bounds (largest relative loss gap "
            f"{worst['rep']:.2e} rep, {worst['rmb_gp']:.2e} rmb_gp); the gloo mesh's window "
            f"ran eagerly; card: {card}")
    dp.barrier()
    torch.distributed.destroy_process_group()


def mesh_nccl_rank(store: str, out: str, card: str) -> None:
    """Phases 13a and 13c in one process holding a one-rank NCCL group;
    writes the kernel-means counts of 13a."""
    dp = _mesh_dp("nccl", 0, 1, store)
    counted = check_mesh_main_path(dp, card)
    check_mesh_device_data(dp, card)
    with open(os.path.join(out, "nccl.json"), "w") as f:
        json.dump(counted, f)
    torch.distributed.destroy_process_group()


def _mesh_process(args: list, log_path: str) -> tuple:
    log_file = open(log_path, "w+")
    proc = subprocess.Popen(args, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=log_file, stderr=subprocess.STDOUT, text=True)
    return log_file, proc


def _wait_all(procs: list, timeout: int) -> list:
    """Wait for every (what, log file, process); relay each log; every
    process ends before this returns. Returns the logs."""
    logs = []
    try:
        for what, log_file, proc in procs:
            proc.wait(timeout=timeout)
            log_file.seek(0)
            text = log_file.read()
            logs.append(text)
            for line in text.splitlines():
                # a rank's lines start with its own seconds (mesh_rank_main)
                m = re.match(r"\s*([\d.]+) (\[(mesh|fsdp|profile)\].*)", line)
                if m:
                    log(f"{m.group(2)} ({m.group(1)} s into {what})")
            assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n{text[-4000:]}"
    finally:
        _stop(procs)
    return logs


def mesh_cli_commands(tmp: str) -> list:
    """Phase 13d's two commands: ``python -m torch.distributed.run
    --standalone --nproc-per-node 1 -m mmdgan_torch.experiments.cifar``,
    host-fed (synthetic), one chunk of MESH_CLI_STEPS steps with a
    checkpoint, then the same command again, which restores it on its rank
    and runs MESH_CLI_STEPS more."""
    common = ["--synthetic-data", "--skip-sampling", "--skip-metrics", "--chunks", "1",
              "--steps-per-chunk", str(MESH_CLI_STEPS), "--query-step", "32",
              "--out-dir", os.path.join(tmp, "cli"), "--use-pallas"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "mmdgan_torch.experiments.cifar"]
    return [cmd + common + ["--fresh"], cmd + common]


def run_mesh_nccl(card: str) -> list:
    """Phase 13a and 13c in one process holding a one-rank NCCL group,
    alone on the card (both time things). Returns 13a's kernel-means
    counts."""
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        _wait_all([("13a/13c NCCL rank", *_mesh_process(
            [sys.executable, me, "--mesh-rank", "nccl", "0", "1", os.path.join(tmp, "nccl"),
             tmp, card], os.path.join(tmp, "nccl.log")))], timeout=400)
        with open(os.path.join(tmp, "nccl.json")) as f:
            return json.load(f)


def start_mesh_smokes(card: str, tmp: str):
    """Phase 13b and 13d, which time nothing: 13b's two gloo ranks and
    13d's torchrun CLI side by side. A thread starts the resumed CLI when
    the fresh one ends, while this process runs its checks: started by the
    waiting function instead, it ran after the checks and made their block
    24.2 s longer (PERF.md §6). Returns the function that waits for
    them and checks them; every process ends before it returns."""
    me = os.path.abspath(__file__)
    first, again = mesh_cli_commands(tmp)
    gloo = [(f"13b gloo rank {r}", *_mesh_process(
        [sys.executable, me, "--mesh-rank", "gloo", str(r), "2", os.path.join(tmp, "gloo"),
         tmp, card], os.path.join(tmp, f"gloo{r}.log"))) for r in range(2)]
    cli, errors = [], []

    def chain():
        try:
            for i, (what, cmd) in enumerate((("13d torchrun cifar CLI", first),
                                             ("13d torchrun cifar CLI, resumed", again))):
                cli.extend(_wait_all([(what, *_mesh_process(
                    cmd, os.path.join(tmp, f"cli{i}.log")))], timeout=400))
        except BaseException as e:   # raised again by finish
            errors.append(e)

    thread = threading.Thread(target=chain)
    thread.start()

    def finish() -> None:
        try:
            _wait_all(gloo, timeout=400)
        finally:
            thread.join()
        if errors:
            raise errors[0]
        ranks = [torch.load(os.path.join(tmp, f"gloo{r}.pt"), weights_only=False)
                 for r in range(2)]
        for loss in ranks[0]:
            differ = [i for i, (a, b) in enumerate(zip(ranks[0][loss], ranks[1][loss]))
                      if not torch.equal(a, b)]
            assert not differ, f"13b {loss}: tensors {differ} of the state differ between ranks"
        for i, text in enumerate(cli):
            lines = [ln for ln in text.splitlines() if "train_steps_per_sec" in ln]
            assert lines and "Devices: 1 (cuda:0" in text and "nccl mesh" in text, text[-3000:]
            if i:
                assert f"restored checkpoint at step {MESH_CLI_STEPS}" in text, text[-3000:]
            log(f"[mesh] 13d torchrun cifar CLI ({'resumed' if i else 'fresh'}, "
                f"{MESH_CLI_STEPS} host-fed steps through DataParallel): {lines[-1]}")
        ckpts = sorted(os.listdir(os.path.join(tmp, "cli", "cifar_ckpt",
                                               "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0")))
        assert set(ckpts) == {f"ckpt-{MESH_CLI_STEPS}.pt", f"ckpt-{2 * MESH_CLI_STEPS}.pt"}, ckpts
        log(f"[mesh] 13b the two gloo ranks' end states are bitwise identical ("
            f"{len(ranks[0]['rep'])} tensors each for rep and rmb_gp, the generator included); "
            f"13d wrote ckpt-{MESH_CLI_STEPS} and, resumed, ckpt-{2 * MESH_CLI_STEPS}; "
            f"card: {card}")

    return finish


SERVE_BATCHES, SERVE_HD_BATCHES = (64, 256, 1024), (16, 64)
SERVE_CALLS, SERVE_HD_CALLS = 64, 8
SERVE_BF16_ATOL = 2.0 ** -7         # one bf16 step at 1.0; images lie in [-1, 1]
FSDP_STEPS = 3                      # 14c/14d narrow steps, sharded ranks against one device
FSDP_MIN_SIZE = 64                  # the narrow models' split: every leaf of 64 elements up

LOAD_SCRIPT = """
import json, sys, time
import numpy as np
import torch
from torch.export.passes import move_to_device_pass
z = torch.tensor(np.load(sys.argv[2]), device="cuda")     # CUDA up before the clock starts
start = time.perf_counter()
module = move_to_device_pass(torch.export.load(sys.argv[1]), torch.device("cuda", 0)).module()
loaded = time.perf_counter()
with torch.no_grad():
    out = module(z)
torch.cuda.synchronize()
first = time.perf_counter()
with torch.no_grad():
    module(z)
torch.cuda.synchronize()
assert not [m for m in sys.modules if m.startswith("mmdgan")]
np.save(sys.argv[3], out.float().cpu().numpy())
print(json.dumps({"load_s": loaded - start, "first_call_s": first - loaded,
                  "second_call_s": time.perf_counter() - first}))
"""

CACHE_SCRIPT = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from mmdgan_torch.ops import _build, cuda_mmd
from mmdgan_torch.utils.compilation_cache import enable_compilation_cache
enable_compilation_cache(sys.argv[2])
_build.BUILD_DIR = Path(sys.argv[3])        # not the checkout's build/: measure the cache alone
if sys.argv[4] == "hit":
    _build._nvcc = None                     # a hit runs no compiler
start = time.perf_counter()
path = _build.build(cuda_mmd.SOURCE)
cuda_mmd._library()
print(json.dumps({"seconds": time.perf_counter() - start, "path": str(path)}))
"""


def _json_tail(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def check_serving(dev, card: str, tmp: str) -> None:
    """Phase 14a: the serving path on the card.
    - ``serving_bench.bench``: images/s of the full-width CIFAR-10
      generator (seed 0, bf16) in-process and exported, at SERVE_BATCHES,
      and of hd512's at SERVE_HD_BATCHES, CUDA events over the calls;
      the seconds to export each;
    - the exported artifact against in-process generation on the card:
      bitwise in float32 (the unconditional and the conditional CIFAR-10
      generators), within SERVE_BF16_ATOL in bf16;
    - the bf16 b64 artifact loaded in a fresh process that imports torch
      alone: the seconds from ``torch.export.load`` to the first images,
      which equal the in-process ones within the bf16 bound."""
    from mmdgan_torch.tools import serving_bench
    from mmdgan_torch.utils.export import export_generator, load_exported

    records = (serving_bench.bench("cifar", list(SERVE_BATCHES), dev, calls=SERVE_CALLS)
               + serving_bench.bench("hd512", list(SERVE_HD_BATCHES), dev,
                                     calls=SERVE_HD_CALLS))
    for r in records:
        (b, model_ips), = r["model_img_per_sec"].items()
        export_ips = r["export_img_per_sec"][b]
        log(f"[serving] {r['arch']} b{b} bf16: in-process {model_ips:.1f} images/s, exported "
            f"{export_ips:.1f} ({export_ips / model_ips:.3f}x; in turns "
            f"{r['turns']['model'][0]:.1f}, {r['turns']['export'][0]:.1f}, "
            f"{r['turns']['export'][1]:.1f}, {r['turns']['model'][1]:.1f}); export "
            f"{r['export_s']:.2f} s; card: {card}")
    z = torch.randn(BATCH, 128, generator=torch.Generator().manual_seed(5))
    errs = {}
    for name, dtype, num_class in (("f32", torch.float32, 0), ("f32 conditional",
                                                                torch.float32, NUM_CLASS),
                                   ("bf16", torch.bfloat16, 0)):
        model = SNGan(cifar_architecture(conditional=num_class >= 2), num_class=num_class,
                      loss_type="rep", compute_dtype=dtype)
        params, state, _ = model.init(0)
        y = (torch.arange(BATCH).remainder(NUM_CLASS).reshape(BATCH, 1).int()
             if num_class else None)
        path = os.path.join(tmp, f"serve_{dtype}_{num_class}.pt2")
        export_generator(model, params, state, BATCH, path)
        fn = load_exported(path)
        zz = z.to(dev)
        got = fn(zz) if y is None else fn(zz, y)
        want = model.generate(params, state, code_batch={"x": zz, "y": y})
        errs[name] = float((got - want).abs().max())
        if dtype == torch.float32:
            assert torch.equal(got, want), f"{name}: the artifact differs by {errs[name]:.3e}"
        else:
            assert errs[name] <= SERVE_BF16_ATOL, (name, errs[name])
            np.save(os.path.join(tmp, "z.npy"), z.numpy())
            proc = subprocess.run([sys.executable, "-c", LOAD_SCRIPT, path,
                                   os.path.join(tmp, "z.npy"), os.path.join(tmp, "out.npy")],
                                  capture_output=True, text=True, timeout=300, cwd=tmp)
            assert proc.returncode == 0, proc.stderr[-3000:]
            fresh_times = _json_tail(proc.stdout)
            fresh = float(np.abs(np.load(os.path.join(tmp, "out.npy"))
                                 - want.float().cpu().numpy()).max())
            assert fresh <= SERVE_BF16_ATOL, fresh
    log(f"[serving] the artifact against in-process generation on the card, full-width "
        f"CIFAR-10 b{BATCH}: f32 bitwise ({errs['f32']:.1e}), f32 conditional bitwise "
        f"({errs['f32 conditional']:.1e}), bf16 max |diff| {errs['bf16']:.3e} (bound "
        f"{SERVE_BF16_ATOL}); the bf16 artifact in a fresh process importing torch alone, "
        f"CUDA up first: torch.export.load and the move to the card "
        f"{fresh_times['load_s']:.3f} s, the first call {fresh_times['first_call_s']:.3f} s, "
        f"the second {fresh_times['second_call_s']:.4f} s, max |diff| {fresh:.3e}; card: "
        f"{card}")


def _cache_process(tmp: str, kind: str) -> subprocess.Popen:
    """A process that builds the kernels with the compilation cache in
    ``tmp/cache`` (and an empty ``build/``): ``cold`` runs nvcc, ``hit``
    must not."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, "-c", CACHE_SCRIPT, repo,
                             os.path.join(tmp, "cache"), os.path.join(tmp, "no_build"), kind],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp)


def _cache_seconds(proc: subprocess.Popen, kind: str) -> dict:
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"cache {kind}: {err[-3000:]}"
    return _json_tail(out)


def check_fsdp_main_path(dp, card: str, tmp: str) -> list:
    """Phase 14b, one NCCL rank: the full-width CIFAR-10 rep b64 bf16 main
    path on a state sharded by ``shard_state(fsdp=True)`` (default
    ``min_size``), graphed K=16 with the gathers and reduce-scatters
    captured:
    - three profiled windows (the eager warm-up, the capture's replay, a
      replay): 1 + 2 kernel-means launches per step in each, collectives
      per step in the eager window, busy time, activities, idle share;
    - steps/s of the non-mesh and the FSDP window in turns (plain, fsdp,
      fsdp, plain);
    - under deterministic algorithms one FSDP window against one window
      of the replicated mesh from the same state, fed the same z: the
      state and the metrics bitwise (at one rank the gather and the
      reduce-scatter are copies), the gradient norms within rtol 1e-5
      (the sharded norm sums the shards' squares, a rounding apart);
    - ``export_generator(dp=)`` of the gathered generator at this rank:
      its rows equal in-process generation within the bf16 bound.
    Returns the profiler's kernel-means counts."""
    from mmdgan_torch.utils.export import export_generator, load_exported

    dev = dp.device
    meshed = lambda model, od, og, k, capture=True: build_multi_step(  # noqa: E731
        model, od, og, k, capture=capture, dp=dp)
    model, ts, multi, batches = main_path_setup(dev, "rep", make_multi=meshed)
    template = copy_state(ts)
    ts = dp.shard_state(ts, fsdp=True)
    assert dp._is_fsdp_layout(ts) and ts.layout.sharded_leaves > 0
    reset_counters()
    profs = [_profiled_window(multi, ts, batches, f"fsdp window {i}") for i in range(3)]
    assert (multi.graphs.eager, multi.graphs.captures) == (1, 1), (
        multi.graphs.eager, multi.graphs.captures)
    assert_counted("fsdp main path", 2)
    counted = [sum(p[k] for p in profs) for k in KERNEL_EVENTS]
    collectives = profs[0]["nccl_ops"] / SCAN_K
    copies, copies_ms = _device_calls(profs[-1], "memcpy")
    _, ts_plain, plain, _ = main_path_setup(dev, "rep")
    rates = {}
    for name, drive, state in (("plain", plain, "p"), ("fsdp", multi, "f"),
                               ("fsdp again", multi, "f"), ("plain again", plain, "p")):
        if state == "p":
            ts_plain, m, rates[name] = timed_windows(drive, ts_plain, batches)
        else:
            ts, m, rates[name] = timed_windows(drive, ts, batches)
        assert all(torch.isfinite(v).all() for v in m.values()), name
    plain_prof = _profiled_window(plain, ts_plain, batches, "non-mesh replay")
    counted = [n + plain_prof[k] for n, k in zip(counted, KERNEL_EVENTS)]
    plain_copies, plain_copies_ms = _device_calls(plain_prof, "memcpy")
    fsdp_sps = (rates["fsdp"] + rates["fsdp again"]) / 2
    plain_sps = (rates["plain"] + rates["plain again"]) / 2
    log(f"[fsdp] 14b cifar10 rep b{BATCH} bf16, shard_state(fsdp=True) at 1 NCCL rank "
        f"({ts.layout.sharded_leaves} leaves split), graphed K={SCAN_K}: {rates['fsdp']:.2f} / "
        f"{rates['fsdp again']:.2f} steps/s against the non-mesh window's {rates['plain']:.2f} / "
        f"{rates['plain again']:.2f} in turns ({fsdp_sps / plain_sps:.3f}x; "
        f"{MEASURE_CALLS * SCAN_K} steps each); {collectives:g} NCCL collectives per step issued "
        f"in the eager window; a replay: {copies:g} device copies/step ({copies_ms:.5f} ms) "
        f"against {plain_copies:g} ({plain_copies_ms:.5f} ms), device busy "
        f"{profs[-1]['union']:.4f} ms/step against {plain_prof['union']:.4f}, idle "
        f"{100 * (1 - profs[-1]['union'] / profs[-1]['span']):.1f}% of the span (non-mesh "
        f"{100 * (1 - plain_prof['union'] / plain_prof['span']):.1f}%), "
        f"{profs[-1]['activities']:.0f} activities/step against {plain_prof['activities']:.0f}, "
        f"kernel means {profs[-1]['kernel_means_fwd'] // SCAN_K}+"
        f"{profs[-1]['kernel_means_bwd'] // SCAN_K} per step in each of 3 profiled windows; "
        f"card: {card}")
    _log_profile(profs[-1], 1e3 / fsdp_sps, "fsdp cifar10 rep (a replay)")

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    codes = {"x": torch.tensor(np.random.RandomState(9).randn(
        SCAN_K, BATCH, 128).astype(np.float32), device=dev)}
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ends = []
            for fsdp in (True, False):
                state = dp.shard_state(copy_state(template), fsdp=fsdp)
                state, m = build_multi_step(model, opt_d, opt_g, SCAN_K, dp=dp)(
                    state, batches, code_batches=codes)
                whole = state.layout.gathered(state) if fsdp else state
                norms = {k: m.pop(k) for k in ("grad_norm_dis", "grad_norm_gen")}
                ends.append((_end_state(whole, m), norms))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    differ = _differ(ends[0][0], ends[1][0])
    assert differ == 0, f"fsdp: {differ} tensors differ from the replicated mesh window"
    for k in ends[0][1]:
        torch.testing.assert_close(ends[0][1][k], ends[1][1][k], rtol=1e-5, atol=0)
    whole = ts.layout.gathered(ts)
    path = export_generator(model, whole.params, whole.net_state, BATCH,
                            os.path.join(tmp, "dp.pt2"), dp=dp)
    z = torch.randn(BATCH, 128, generator=torch.Generator().manual_seed(6)).to(dev)
    got = load_exported(path)(dp.local_rows(z))
    want = model.generate(whole.params, whole.net_state, code_batch={"x": z})
    err = float((got - want[:got.shape[0]]).abs().max())
    assert got.shape[0] == dp.local_batch_size(BATCH) and err <= SERVE_BF16_ATOL, err
    log(f"[fsdp] 14b under deterministic algorithms one FSDP window equals one window of the "
        f"replicated mesh from the same state, fed the same z, bitwise ({len(ends[0][0])} "
        f"tensors, the gradient norms within rtol 1e-5); export_generator(dp=) at 1 NCCL "
        f"rank: {got.shape[0]} rows, max |diff| "
        f"{err:.3e} against in-process generation (bound {SERVE_BF16_ATOL})")
    return counted


def state_bytes(ts) -> int:
    """Bytes of the parameters and optimizer slots a rank keeps between
    steps, summed from the state's tensors (not from the allocator)."""
    slots = [t for o in (ts.opt_state_dis, ts.opt_state_gen) for t in o.tensors()[1:]]
    return sum(t.numel() * t.element_size() for t in tree_leaves(ts.params) + slots)


def sharded_gloo_rank(rank: int, world: int, store: str, out: str, card: str,
                      layout: str) -> None:
    """Phase 14c (``layout`` 'fsdp', two ranks) or 14d ('2d', four ranks as a
    (2, 2) mesh), gloo ranks sharing the card, cuDNN off as in 13b: the
    narrow f32 model's rep (and, under fsdp, rmb_gp) steps on a state
    sharded with ``min_size`` FSDP_MIN_SIZE, FSDP_STEPS SGD steps at a
    global batch of BATCH on RandomState(7)'s batches, z and penalty
    weights, TF32 off; rank 0 holds the gathered end state to the
    single-device step within JAX's mesh bounds (losses rtol 2e-4 / atol
    1e-5, parameters rtol 2e-3 / atol 1e-6). Under fsdp, the full-width
    CIFAR-10 state's persistent parameter and Adam bytes on this rank,
    sharded and replicated. Each rank saves its gathered end state for the
    bitwise comparison."""
    from mmdgan_torch.parallel.mesh import make_mesh_2d

    torch.backends.cudnn.enabled = False
    dp = _mesh_dp("gloo", rank, world, store)
    if layout == "2d":
        dp = type(dp)(make_mesh_2d(2, world // 2), device="cuda:0")
    rng = np.random.RandomState(7)
    x = rng.randn(FSDP_STEPS, BATCH, 32, 32, 3).clip(-1, 1).astype(np.float32)
    z = rng.randn(FSDP_STEPS, BATCH, 128).astype(np.float32)
    uni = rng.uniform(size=(FSDP_STEPS, BATCH, 1, 1, 1)).astype(np.float32)
    saved, worst, split = {}, {}, {}

    def run(loss: str, mesh) -> tuple:
        model = SNGan(narrow_architecture(), loss_type=loss, compute_dtype=torch.float32,
                      device=dp.device)
        opt_d, opt_g = multi_opt_config([1e-2, 1e-2], optimizer="sgd")
        ts = init_train_state(model, 0, opt_d, opt_g, device=dp.device)
        if mesh is not None:
            ts = mesh.shard_state(ts, min_size=FSDP_MIN_SIZE, fsdp=layout == "fsdp")
            split[loss] = ts.layout.sharded_leaves
        step = build_train_step(model, opt_d, opt_g, device=dp.device, dp=mesh)
        losses = []
        for k in range(FSDP_STEPS):
            rows = x[k] if mesh is None else mesh.local_rows(torch.tensor(x[k]))
            ts, m = step(ts, {"x": rows}, code_batch={"x": z[k]},
                         uni=uni[k] if loss == "rmb_gp" else None)
            losses.append([m["loss_gen"].item(), m["loss_dis"].item()])
        return (ts if mesh is None else ts.layout.gathered(ts)), np.asarray(losses)

    for loss in ("rep", "rmb_gp") if layout == "fsdp" else ("rep",):
        ts, losses = tf32_off(lambda: run(loss, dp))
        saved[loss] = [t.detach().cpu() for t in ts.tensors()] + [ts.rng.get_state()]
        if rank == 0:
            ts1, losses1 = tf32_off(lambda: run(loss, None))
            np.testing.assert_allclose(losses, losses1, rtol=2e-4, atol=1e-5, err_msg=loss)
            n_state = len(tree_leaves(ts1.params)) + len(tree_leaves(ts1.net_state))
            for a, b in zip(saved[loss][:n_state], ts1.tensors()[:n_state]):
                np.testing.assert_allclose(a.numpy(), b.detach().cpu().numpy(), rtol=2e-3,
                                           atol=1e-6, err_msg=loss)
            worst[loss] = float(np.max(np.abs(losses - losses1)
                                       / np.maximum(np.abs(losses1), 1e-6)))
    if layout == "fsdp":
        model = SNGan(cifar_architecture(), loss_type="rep")
        opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
        full = init_train_state(model, 0, opt_d, opt_g)
        replicated = state_bytes(full)
        sharded = dp.shard_state(full, fsdp=True)
        saved["bytes"] = (state_bytes(sharded), replicated, sharded.layout.sharded_leaves,
                          len(tree_leaves(sharded.params)))
    torch.save(saved, os.path.join(out, f"{layout}{rank}.pt"))
    if rank == 0:
        what = ("14c two gloo ranks, shard_state(fsdp=True)" if layout == "fsdp" else
                f"14d four gloo ranks as a (2, {world // 2}) mesh, state split over 'model'")
        log(f"[fsdp] {what}, sharing the card, narrow f32, {FSDP_STEPS} SGD steps at a global "
            f"batch of {BATCH}: " + ", ".join(
                f"{loss} ({split[loss]} leaves split) equals the single-device step within "
                f"JAX's mesh bounds (largest relative loss gap {gap:.2e})"
                for loss, gap in worst.items()) + f"; card: {card}")
    dp.barrier()
    torch.distributed.destroy_process_group()


def fsdp_nccl_rank(store: str, out: str, card: str) -> None:
    """Phase 14b in one process holding a one-rank NCCL group; writes the
    kernel-means counts."""
    dp = _mesh_dp("nccl", 0, 1, store)
    counted = check_fsdp_main_path(dp, card, out)
    with open(os.path.join(out, "fsdp.json"), "w") as f:
        json.dump(counted, f)
    torch.distributed.destroy_process_group()


def run_serving(dev, card: str) -> None:
    """Phase 14a, in this process (it times things)."""
    with tempfile.TemporaryDirectory() as tmp:
        check_serving(dev, card, tmp)


def run_fsdp_nccl(card: str, tmp: str) -> list:
    """Phase 14b's NCCL rank alone on the card (it times things), a cold
    nvcc build into a new compilation cache in ``tmp`` on the host beside
    it; then a second process's hit of that cache, alone. Returns 14b's
    kernel-means counts."""
    me = os.path.abspath(__file__)
    gc.collect()
    torch.cuda.empty_cache()
    cold = _cache_process(tmp, "cold")   # nvcc on the host, beside 14b
    try:
        _wait_all([("14b NCCL rank", *_mesh_process(
            [sys.executable, me, "--mesh-rank", "fsdp-nccl", "0", "1",
             os.path.join(tmp, "nccl"), tmp, card], os.path.join(tmp, "nccl.log")))],
            timeout=400)
    finally:
        builds = {"cold": _cache_seconds(cold, "cold")}
    builds["hit"] = _cache_seconds(_cache_process(tmp, "hit"), "hit")
    assert builds["cold"]["path"] == builds["hit"]["path"]
    assert builds["hit"]["path"].startswith(os.path.join(tmp, "cache"))
    log(f"[cache] {cuda_mmd.SOURCE}: a cold nvcc build into a new compilation cache "
        f"{builds['cold']['seconds']:.2f} s (beside 14b), a second process with the same "
        f"cache {builds['hit']['seconds']:.4f} s (nvcc disabled in it, alone); card: {card}")
    with open(os.path.join(tmp, "fsdp.json")) as f:
        return json.load(f)



def start_sharding_smokes(card: str, tmp: str):
    """Phase 14's parts that time nothing, side by side: the step profiler
    (a smoke of the tool: beside the other checks its times are not a
    measurement), 14c's two gloo ranks and 14d's four. Returns the function
    that waits for them and checks them; every process ends before it
    returns."""
    me = os.path.abspath(__file__)
    procs = [("14 profile_step", *_mesh_process(
        [sys.executable, "-m", "mmdgan_torch.tools.profile_step", "--arch", "cifar",
         "--calls", "2", "--top", "5"], os.path.join(tmp, "profile.log")))]
    for layout, world in (("fsdp", 2), ("2d", 4)):
        procs += [(f"14 {layout} gloo rank {r}", *_mesh_process(
            [sys.executable, me, "--mesh-rank", f"{layout}-gloo", str(r), str(world),
             os.path.join(tmp, layout), tmp, card],
            os.path.join(tmp, f"{layout}{r}.log"))) for r in range(world)]

    def finish() -> None:
        text = _wait_all(procs, timeout=400)[0]
        top = [ln for ln in text.splitlines() if ln.startswith("|") and "kernel" not in ln
               and not ln.startswith("|---")]
        assert top and "steps/s unprofiled" in text, text[-3000:]
        log(f"[profile_step] python -m mmdgan_torch.tools.profile_step --arch cifar --calls 2 "
            f"ran its three tables (beside the other checks and processes, so its times are "
            f"not a measurement): top kernel {top[0]}")
        for layout, world in (("fsdp", 2), ("2d", 4)):
            ranks = [torch.load(os.path.join(tmp, f"{layout}{r}.pt"), weights_only=False)
                     for r in range(world)]
            for loss in [k for k in ranks[0] if k != "bytes"]:
                for r in range(1, world):
                    differ = [i for i, (a, b) in enumerate(zip(ranks[0][loss], ranks[r][loss]))
                              if not torch.equal(a, b)]
                    assert not differ, f"14 {layout} {loss}: tensors {differ} differ, rank {r}"
            if layout == "fsdp":
                sizes = [rk["bytes"] for rk in ranks]
                log(f"[fsdp] 14c full-width CIFAR-10 under shard_state(fsdp=True) at 2 gloo "
                    f"ranks ({sizes[0][2]} of {sizes[0][3]} parameter leaves split): persistent "
                    f"parameter + Adam bytes per rank {sizes[0][0]} / {sizes[1][0]} against "
                    f"{sizes[0][1]} replicated ({sizes[0][0] / sizes[0][1]:.4f}x)")
            log(f"[fsdp] 14 {layout}: the {world} gloo ranks' gathered end states are bitwise "
                f"identical; card: {card}")

    return finish


# ----------------------------------------------------------------------
# phase 15: real CIFAR-format data, SimData, figure1, a TF1 checkpoint
# ----------------------------------------------------------------------

CIFAR_FILES, CIFAR_PER_FILE = 5, 10000      # data_batch_{1..5}.bin, 3,073 bytes a record
READER_WINDOWS = 8                  # timed host-fed windows per reader and turn
COMPARE_BATCHES = 256               # batches held bitwise between the two readers
CLI_STEPS = 64                      # the CLI's chunk over the converted records
SIM_STEPS, SIM_BATCH = 800, 128     # tests/test_integration.py:46-75
FIG1_STEPS, FIG1_CHECK = 600, 10
TF1_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                           "tf1_narrow")
TF1_TRAIN_STEPS = 16
# tests/test_integration.py:17-36: 2-D data as 1x1 images with 2 channels
SIM_ARCH = {
    "input": [(2, 1, 1)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 32, "op": "d", "act": "relu", "act_nm": None, "in_reshape": [8]},
        {"name": "l2", "out": 32, "op": "d", "act": "relu"},
        {"name": "l3", "out": 2, "op": "d", "act": "linear", "out_reshape": [2, 1, 1]},
    ],
    "discriminator": [
        {"name": "l1", "out": 32, "op": "d", "act": "lrelu", "w_nm": "s", "act_k": 2.0,
         "in_reshape": [2]},
        {"name": "l2", "out": 32, "op": "d", "act": "lrelu", "w_nm": "s", "act_k": 2.0},
        {"name": "l3", "out": 8, "op": "d", "w_nm": "s", "act_k": 2.0},
    ],
}


NATIVE_BUILD_SCRIPT = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from mmdgan_torch.ops import _build
from mmdgan_torch.data import native
_build.BUILD_DIR = Path(sys.argv[2])        # not the checkout's build/
built = not _build.library_path(native.SOURCE).exists()
start = time.perf_counter()
native.get_lib()
print(json.dumps({"seconds": time.perf_counter() - start, "built": built}))
"""


def counters() -> list:
    return [cuda_mmd.kernel_means_cuda.launches, cuda_mmd.kernel_means_backward_cuda.launches]


def write_cifar_binaries(folder: str, seed: int = 0) -> list:
    """CIFAR_FILES files in the CIFAR-10 binary format (a label byte, then
    3,072 CHW pixel bytes, per record), seeded."""
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(CIFAR_FILES):
        rows = np.empty((CIFAR_PER_FILE, 3073), np.uint8)
        rows[:, 0] = rng.randint(0, 10, CIFAR_PER_FILE)
        rows[:, 1:] = rng.randint(0, 256, (CIFAR_PER_FILE, 3072), dtype=np.uint8)
        path = os.path.join(folder, f"data_batch_{i + 1}.bin")
        rows.tofile(path)
        paths.append(path)
    return paths


def cifar_pipe(folder: str, use_native: bool, **kw):
    """The cifar CLI's pipeline over ``cifar.tfrecords`` (uint8 batches,
    scaled on the card)."""
    from mmdgan_torch.data.pipeline import ReadTFRecords

    return ReadTFRecords("cifar", batch_size=BATCH, file_folder=folder, device_decode=True,
                         use_native=use_native, **kw).shape2image(3, 32, 32)


def host_windows(multi, ts, batches, windows: int) -> tuple:
    """``windows`` K-step windows fed K host batches each from the iterator
    ``batches``; returns (ts, last metrics, steps/s)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(windows):
        ts, m = multi(ts, {"x": np.stack([next(batches)["x"] for _ in range(SCAN_K)])})
    torch.cuda.synchronize()
    return ts, m, windows * SCAN_K / (time.perf_counter() - start)


def check_real_cifar(dev, card: str, tmp: str) -> list:
    """15a: the CIFAR-10 binary batches converted by the port and read back
    by both readers into the main path. Returns the kernel-means launches
    of its training (the wrappers' counters over eager windows and
    captures, the profiler's over replays, the CLI's counters)."""
    from mmdgan_torch.data import converters, native
    from mmdgan_torch.experiments.cifar import main as cifar_main
    from mmdgan_torch.utils.events import read_metrics_jsonl

    existed = _build.library_path(native.SOURCE).exists()
    start = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - start
    cold, hit = (_json_tail(subprocess.run(
        [sys.executable, "-c", NATIVE_BUILD_SCRIPT, os.path.dirname(os.path.abspath(__file__)),
         os.path.join(tmp, "native_build")], capture_output=True, text=True, timeout=300,
        check=True, env={k: v for k, v in os.environ.items() if k != _build.CACHE_ENV}).stdout)
        for _ in range(2))
    assert cold["built"] and not hit["built"], (cold, hit)
    log(f"[data] native reader {native.SOURCE}: in this process {build_s:.3f} s "
        f"({'loaded from build/' if existed else 'g++ into build/'}); into an empty directory "
        f"in a fresh process g++ -O3 took {cold['seconds']:.3f} s, a second process loads it "
        f"in {hit['seconds']:.4f} s; flags {' '.join(_build.HOST_FLAGS)}")

    start = time.perf_counter()
    files = write_cifar_binaries(tmp)
    written = time.perf_counter() - start
    start = time.perf_counter()
    converters.binary_image_to_tfrecords(files, os.path.join(tmp, "cifar"),
                                         CIFAR_FILES * CIFAR_PER_FILE, (3, 32, 32),
                                         save_label=False)
    converted = time.perf_counter() - start
    size = sum(os.path.getsize(f) for f in files)
    log(f"[data] {CIFAR_FILES} CIFAR-10 binary batches, {size:,} bytes, written in "
        f"{written:.2f} s, converted to cifar.tfrecords "
        f"({os.path.getsize(os.path.join(tmp, 'cifar.tfrecords')):,} bytes) in {converted:.2f} s "
        "(binary_image_to_tfrecords, save_label=False)")

    rates = {}
    for use_native in (True, False):
        pipe = cifar_pipe(tmp, use_native, num_epoch=1)
        start = time.perf_counter()
        n = sum(1 for _ in pipe._iter_raw())
        rates[use_native] = n / (time.perf_counter() - start)
        assert n == CIFAR_FILES * CIFAR_PER_FILE, n
    got = cifar_pipe(tmp, True).next_batch()
    want = cifar_pipe(tmp, False).next_batch()
    for i in range(COMPARE_BATCHES):
        a, b = next(got)["x"], next(want)["x"]
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), f"batch {i} differs"
    got.close()
    want.close()
    log(f"[data] records/s alone (decode to uint8 HWC, one pass of 50,000): native "
        f"{rates[True]:,.0f}, Python {rates[False]:,.0f} ({rates[True] / rates[False]:.2f}x); "
        f"the first {COMPARE_BATCHES} batches of b{BATCH} (shuffle buffer 10,000) bitwise equal")

    reset_counters()
    model, ts, multi, _ = main_path_setup(dev, "rep")
    sps = {True: [], False: []}
    launches = [0, 0]
    for turn in range(2):
        for use_native in (True, False):
            batches = cifar_pipe(tmp, use_native, seed=turn).next_batch()
            if turn == 0 and use_native:   # the graph's eager warm-up and its capture
                ts, _, _ = host_windows(multi, ts, batches, WARMUP_CALLS)
            ts, m, rate = host_windows(multi, ts, batches, READER_WINDOWS)
            sps[use_native].append(rate)
            what = f"15a {'native' if use_native else 'Python'} reader, turn {turn}"
            prof = _profiled_window(multi, ts, {"x": np.stack(
                [next(batches)["x"] for _ in range(SCAN_K)])}, what)
            launches = [launches[0] + prof["kernel_means_fwd"],
                        launches[1] + prof["kernel_means_bwd"]]
            log(f"[data] {what}, a replay: device busy {prof['union']:.4f} ms/step over a span "
                f"of {prof['span']:.4f} (idle {100 * (1 - prof['union'] / prof['span']):.1f}%), "
                f"idle {100 * (1 - prof['union'] * rate / 1e3):.1f}% of the untraced step; "
                f"{prof['activities']:.0f} activities/step")
            batches.close()
            bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
            assert not bad, f"{what}: non-finite {bad}"
    assert counters() == [n * SCAN_K * 2 for n in KERNEL_EVENTS.values()], counters()
    launches = [a + b for a, b in zip(launches, counters())]
    log(f"[data] cifar10 rep b{BATCH} bf16 graphed K={SCAN_K}, host-fed from the converted "
        f"records (uint8 batches, {READER_WINDOWS * SCAN_K} steps per turn, in turns): native "
        f"reader {', '.join(f'{v:.2f}' for v in sps[True])} steps/s, Python reader "
        f"{', '.join(f'{v:.2f}' for v in sps[False])} steps/s; e_kxx "
        f"{float(m['e_kxx'][-1]):.5f}; kernel means 1 + 2 per step in a profiled replay of "
        f"each turn; card: {card}")

    out = os.path.join(tmp, "cli")
    reset_counters()
    start = time.perf_counter()
    cifar_main(["--data-dir", tmp, "--skip-metrics", "--fresh", "--chunks", "1",
                "--steps-per-chunk", str(CLI_STEPS), "--query-step", str(SCAN_K),
                "--out-dir", out, "--use-pallas"])
    seconds = time.perf_counter() - start
    cli = counters()
    windows = cli[0] // SCAN_K
    assert cli == [n * SCAN_K * windows for n in KERNEL_EVENTS.values()] and windows >= 2, cli
    run = "sngan_rep_5e-04_2e-04_k1.68_0.0_-1.0"
    recs = read_metrics_jsonl(os.path.join(out, "cifar_log", run))
    rows = np.isfinite(recs["loss_gen"])
    steps = recs["step"][rows].astype(int).tolist()
    assert steps == list(range(SCAN_K, CLI_STEPS + 1, SCAN_K)), steps
    assert np.isfinite(recs["loss_dis"][rows]).all() and np.isfinite(recs["loss_gen"][rows]).all()
    log(f"[data] python -m mmdgan_torch.experiments.cifar --data-dir (the converted records, "
        f"native reader) --use-pallas: {CLI_STEPS} steps and the sprite in {seconds:.1f} s; "
        f"metrics.jsonl read back by utils/events.py: loss rows at steps {steps}, finite; last "
        f"loss_gen {recs['loss_gen'][rows][-1]:.5f}; kernel-means counters {cli[0]}/{cli[1]} "
        f"in {windows} eager or captured windows")

    # without --use-pallas the CLI takes JAX's default path, the plain kernel means
    plain_out = os.path.join(tmp, "cli_plain")
    reset_counters()
    start = time.perf_counter()
    cifar_main(["--data-dir", tmp, "--skip-metrics", "--skip-sampling", "--fresh", "--chunks",
                "1", "--steps-per-chunk", str(2 * SCAN_K), "--query-step", str(SCAN_K),
                "--out-dir", plain_out])
    seconds = time.perf_counter() - start
    plain = counters()
    assert plain == [0, 0], f"CLI without --use-pallas: kernel-means counters {plain}"
    recs = read_metrics_jsonl(os.path.join(plain_out, "cifar_log", run))
    rows = np.isfinite(recs["loss_gen"])
    steps = recs["step"][rows].astype(int).tolist()
    assert steps == [SCAN_K, 2 * SCAN_K], steps
    assert np.isfinite(recs["loss_dis"][rows]).all()
    log(f"[data] the same CLI without --use-pallas (JAX's default path, the plain kernel "
        f"means): {2 * SCAN_K} steps in {seconds:.1f} s; loss rows at steps {steps}, finite; "
        f"last loss_gen {recs['loss_gen'][rows][-1]:.5f}; kernel-means counters "
        f"{plain[0]}/{plain[1]}")
    return [a + b for a, b in zip(launches, cli)]


def check_kernel_shapes(dev, kernels: list, shapes: list, seed: int) -> None:
    """Both kernels against their plain versions at ``shapes`` (scores from
    ``seed`` + i), with phase 3's tolerances, and timed (CUDA events; a
    replayed graph): phase 3 at TIMED_SHAPES."""
    cts = cotangents(dev)
    for i, (b, d) in enumerate(shapes):
        sg, sx = scores(b, d, seed=seed + i, device=dev)
        got = cuda_mmd.kernel_means_cuda(sg, sx, 1.0)
        want = cuda_mmd.kernel_means_reference(sg, sx, 1.0)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **VAL_TOL,
                                   err_msg=f"kernel means at {(b, d)}")
        assert torch.equal(got, cuda_mmd.kernel_means_cuda(sg, sx, 1.0))
        fwd_err = float((got - want).abs().max())
        bwd_err = 0.0
        for name, ct in cts.items():
            g = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
            w = cuda_mmd.kernel_means_backward_reference(sg, sx, ct, 1.0)
            atols = cuda_mmd.kernel_means_backward_atol(sg, sx, ct, 1.0)
            bwd_err = max(bwd_err, assert_grads_close(g, w, atols, f"backward {(b, d)} {name}"))
            again = cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)
            assert all(torch.equal(x, y) for x, y in zip(g, again))
        ct = cts["loss_gen"]
        with torch.no_grad():
            timed = {
                "fwd": (cuda_ms(lambda: cuda_mmd.kernel_means_cuda(sg, sx, 1.0), 2000),
                        graph_ms(lambda: cuda_mmd.kernel_means_cuda(sg, sx, 1.0)),
                        cuda_ms(lambda: cuda_mmd.kernel_means_reference(sg, sx, 1.0),
                                PLAIN_CALLS),
                        graph_ms(lambda: cuda_mmd.kernel_means_reference(sg, sx, 1.0)),
                        kernel_means_bound_ms(b, d)),
                "bwd": (cuda_ms(lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0),
                                2000),
                        graph_ms(lambda: cuda_mmd.kernel_means_backward_cuda(sg, sx, ct, 1.0)),
                        cuda_ms(lambda: cuda_mmd.kernel_means_backward_reference(
                            sg, sx, ct, 1.0), PLAIN_CALLS),
                        graph_ms(lambda: cuda_mmd.kernel_means_backward_reference(
                            sg, sx, ct, 1.0)),
                        kernel_means_backward_bound_ms(b, d))}
        for kernel, err, (ms, dev_ms, plain, plain_dev, (bound, by, pipe)) in zip(
                kernels, (fwd_err, bwd_err), timed.values()):
            kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
            kernel.setdefault("shapes", []).append(
                {"b": b, "d": d, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                 "plain_device_ms": plain_dev, "bound_ms": bound, "bound_by": by,
                 "max_abs_err": err})
            log(f"[kernels] {kernel['name']} at ({b}, {d}): agrees with its plain version "
                f"(max |err| {err:.3e}), deterministic; {ms:.5f} ms/call ({dev_ms:.5f} ms on "
                f"the device from a CUDA graph), plain {plain:.5f} ms/call ({plain_dev:.5f} "
                f"ms from a graph), bound {bound:.3e} ms ({pipe})")


def check_simdata(dev, card: str) -> list:
    """15c: tests/test_integration.py's recipe on the card through graphed
    K=16 windows, float32; its asserts. Returns the kernel-means launches:
    the wrappers' counters over the eager warm-up window and the capture,
    and the profiler's over one more replayed window."""
    from mmdgan_torch.data.simdata import SimData
    from mmdgan_torch.ops.distance import get_squared_dist
    from mmdgan_torch.ops.kernels import mixture_mmd_g

    sim = SimData("normal", mu=[0.5, -0.3], std_or_cov=[0.4, 0.2], batch_size=SIM_BATCH,
                  seed=1)
    model = SNGan(SIM_ARCH, loss_type="rep", compute_dtype=torch.float32)
    opt_d, opt_g = multi_opt_config([2e-3, 1e-3])
    ts = init_train_state(model, 0, opt_d, opt_g)
    multi = build_multi_step(model, opt_d, opt_g, SCAN_K)
    target = torch.tensor(sim(512), device=dev)
    window = lambda: {"x": np.stack([sim(SIM_BATCH).reshape(SIM_BATCH, 1, 1, 2)
                                     for _ in range(SCAN_K)])}

    def mmd():
        x = model.generate(ts.params, ts.net_state, torch.Generator(dev).manual_seed(123),
                           256, clip=False).reshape(256, 2)
        d = get_squared_dist(x, target, mode="xxxyyy")
        return float(mixture_mmd_g(*d, 256, sigma=[0.1, 0.5, 1.0])), x.mean(0).cpu().numpy()

    before, _ = mmd()
    reset_counters()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(SIM_STEPS // SCAN_K):
        ts, m = multi(ts, window())
    torch.cuda.synchronize()
    rate = SIM_STEPS / (time.perf_counter() - start)
    assert_counted("15c SimData (the eager warm-up window and the capture)", 2)
    after, mean = mmd()
    assert np.isfinite(after) and after < 0.7 * before, (before, after)
    np.testing.assert_allclose(mean, [0.5, -0.3], atol=0.25)
    prof = _profiled_window(multi, ts, window(), "15c SimData replay")
    launches = [a + prof[k] for a, k in zip(counters(), KERNEL_EVENTS)]
    log(f"[simdata] rep on SimData normal, dense ARCH, B={SIM_BATCH}, scores d=8, f32, "
        f"{SIM_STEPS} steps in graphed K={SCAN_K} windows ({rate:.1f} steps/s, host batches): "
        f"MMD to the target {before:.5f} -> {after:.5f} ({after / before:.3f} of the start, "
        f"bound 0.7), generated mean {mean.round(4).tolist()} (mu [0.5, -0.3], atol 0.25); "
        f"loss_gen {float(m['loss_gen'][-1]):.5f}; kernel means {launches[0]} + "
        f"{launches[1]} launches (the counters over the eager window and the capture, the "
        f"profiler over a replay: {prof['kernel_means_fwd'] // SCAN_K} + "
        f"{prof['kernel_means_bwd'] // SCAN_K} per step, device busy {prof['union']:.4f} "
        f"ms/step); card: {card}")
    return launches


def check_figure1(dev, card: str) -> list:
    """15d: figure1's particles on the card (rep, the fused route at
    (128, 2)): FIG1_STEPS steps, the first FIG1_CHECK against the CPU's
    plain path at rtol 1e-4. Returns the wrappers' counts of the run."""
    from mmdgan_torch.tools.figure1 import particle_run

    reset_counters()
    start = time.perf_counter()
    run = particle_run("rep", FIG1_STEPS, target="shell", device=dev)
    seconds = time.perf_counter() - start
    launches = counters()
    want = particle_run("rep", FIG1_CHECK, target="shell", device="cpu")
    np.testing.assert_allclose(run["particles"][:FIG1_CHECK + 1], want["particles"], rtol=1e-4,
                               atol=1e-6, err_msg="figure1 card vs CPU")
    assert np.isfinite(run["loss"]).all()
    assert launches == [FIG1_STEPS, FIG1_STEPS], launches
    log(f"[figure1] 128 particles, rep, shell target, lr 2: {FIG1_STEPS} steps on the card in "
        f"{seconds:.2f} s, the first {FIG1_CHECK} within rtol 1e-4 of the CPU's plain path; "
        f"loss {run['loss'][0]:.5f} -> {run['loss'][-1]:.5f}; kernel means "
        f"{launches[0]} + {launches[1]} launches (one backward per step: only the particles "
        f"take a gradient); card: {card}")
    return launches


def check_tf1_checkpoint(dev, card: str) -> list:
    """15e: the committed TF1 bundle read with no TensorFlow into a port
    model on the card, its outputs against JAX's committed ones at rtol
    1e-3, then TF1_TRAIN_STEPS eager steps from it. Returns the wrappers'
    counts of those steps."""
    from mmdgan_torch.utils.tf1_import import import_reference_checkpoint

    with open(os.path.join(TF1_FIXTURE, "architecture.json")) as f:
        arch = json.load(f)
    want = np.load(os.path.join(TF1_FIXTURE, "jax_outputs.npz"))
    model = SNGan(arch, loss_type="rep", compute_dtype=torch.float32)
    opt_d, opt_g = multi_opt_config([5e-4, 2e-4])
    ts = init_train_state(model, 0, opt_d, opt_g)
    start = time.perf_counter()
    params, state = import_reference_checkpoint(model, ts.params, ts.net_state,
                                                os.path.join(TF1_FIXTURE, "model.ckpt"))
    seconds = time.perf_counter() - start
    gen = model.generate(params, state, code_batch={"x": want["z"]}, clip=False)
    scores_eval = model.discriminate(params, state, want["x"])
    errs = []
    for name, got, ref in (("generate", gen, want["gen"]),
                           ("discriminate", scores_eval, want["dis_eval"])):
        np.testing.assert_allclose(got.detach().cpu().numpy(), ref, rtol=1e-3, atol=1e-5,
                                   err_msg=f"TF1 import on the card: {name}")
        errs.append(float(np.abs(got.detach().cpu().numpy() - ref).max()))
    ts = TrainState(params=params, net_state=state, loss_state=ts.loss_state,
                    opt_state_dis=ts.opt_state_dis, opt_state_gen=ts.opt_state_gen, step=0,
                    rng=ts.rng)
    multi = build_multi_step(model, opt_d, opt_g, TF1_TRAIN_STEPS, capture=False)
    c, h, w = arch["input"][0]
    x = np.random.RandomState(4).randn(TF1_TRAIN_STEPS, BATCH, h, w, c).clip(-1, 1)
    reset_counters()
    ts, m = multi(ts, {"x": x.astype(np.float32)})
    launches = counters()
    assert launches == [n * TF1_TRAIN_STEPS for n in KERNEL_EVENTS.values()], launches
    assert all(torch.isfinite(v).all() for v in m.values()) and int(ts.step) == TF1_TRAIN_STEPS
    log(f"[tf1] {TF1_FIXTURE[len(os.path.dirname(TF1_FIXTURE)) + 1:]} (NCHW, written by TF) read "
        f"by utils/tf_bundle.py and imported in {seconds:.3f} s; generate / discriminate on the "
        f"card against JAX's import: max |err| {errs[0]:.2e} / {errs[1]:.2e} (rtol 1e-3); "
        f"{TF1_TRAIN_STEPS} eager rep steps from it at b{BATCH}, loss_gen "
        f"{float(m['loss_gen'][-1]):.5f}, kernel means {launches[0]} + {launches[1]}; "
        f"card: {card}")
    return launches


def run_real_data_and_tools(dev, card: str) -> list:
    """Phase 15; returns its kernel-means launches, [forward, backward]."""
    with tempfile.TemporaryDirectory() as tmp:
        parts = [check_real_cifar(dev, card, tmp)]
    parts += [check_simdata(dev, card), check_figure1(dev, card), check_tf1_checkpoint(dev, card)]
    return [sum(p[i] for p in parts) for i in range(2)]


# ----------------------------------------------------------------------
# phase 16: the last four tools (preflight, the scaling study, the fake
# inception graph with the rehearsal, ImageNet prep)
# ----------------------------------------------------------------------

SWEEP_STEPS = 192                   # 16b: timed steps per point (the tool's default 384)
SWEEP_REPEAT = (8, 16, 32)          # 16b: K points timed again after the sweep, for the noise
QUALITY_STEPS = 32                  # 16c: the quality_smoke run that writes the checkpoint
PARITY_STEPS = 16                   # 16e: parity_run's steps, twice
SWEEP_GRID_STEPS = 32               # 16f: sweep_grid's one cell
REHEARSAL_BATCHES = 781             # 16c: the reference protocol, 781 x 64 per side
IMAGENET_CLASSES, IMAGENET_ROWS, IMAGENET_SIDE = 3, 300, 64   # 16d: 300 = 4 x 64 + 44
STATS_TOL = dict(rtol=1e-3, atol=1e-5)
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def write_fake_inception(pb: str) -> None:
    """16c's graph: ``tools/make_fake_inception.py`` writes it and its twin."""
    from mmdgan_torch.tools import make_fake_inception

    start = time.perf_counter()
    make_fake_inception.write(pb, seed=0)
    log(f"[rehearsal] make_fake_inception: {os.path.getsize(pb)} bytes written in "
        f"{time.perf_counter() - start:.2f} s (the twin beside it)")


def run_preflight(card: str) -> None:
    """16a: ``mmdgan_torch/tools/preflight.py`` must exit 0 with a healthy
    line for the GPU."""
    # run as a script, so the parent imports neither the package nor torch
    out = subprocess.run([sys.executable, os.path.join("mmdgan_torch", "tools", "preflight.py"),
                          "--timeout", "300"], cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=400)
    assert out.returncode == 0, f"preflight exited {out.returncode}: {out.stdout}{out.stderr}"
    line = _json_tail(out.stdout)
    assert line["healthy"] and line["platform"] == "gpu", line
    log(f"[preflight] {json.dumps(line)}; card: {card}")


def run_scaling_study(dev, card: str) -> list:
    """16b: ``tools/scaling_study.py``'s two sweeps (cifar10 rep, full
    width, bf16, the tool's ``setup`` and ``timed``): K at batch 64, then
    the batch at K=16, each point a fresh state and graphed window timed
    over SWEEP_STEPS steps; then the K points of SWEEP_REPEAT again,
    which say how far two readings of one point differ. The wrappers'
    counters, zeroed before each point, show 1 + 2 kernel-means launches
    per step of its eager window and its capture; after the K sweep's
    points one more replay runs under the profiler, which must count 1 + 2
    per step too. Returns the launches: the counters', and the profiler's
    in the replays."""
    from mmdgan_torch.tools import scaling_study as study

    launches, k_rows, batch_rows = [0, 0], [], []

    def point(batch: int, k: int, profiled: bool) -> tuple:
        gc.collect()
        torch.cuda.empty_cache()
        step, ts, batches = study.setup("cifar", "rep", batch, k, dev)
        reset_counters()
        ts, sps = study.timed(step, ts, batches, k, SWEEP_STEPS)
        want = [n * k * 2 for n in KERNEL_EVENTS.values()]
        assert counters() == want, f"16b K={k} b{batch}: counters {counters()}, want {want}"
        assert (step.graphs.eager, step.graphs.captures) == (1, 1), step.graphs.eager
        got, prof = counters(), None
        if profiled:
            prof = _profiled_window(step, ts, batches, f"16b K={k} replay", k=k)
            got = [g + prof[name] for g, name in zip(got, KERNEL_EVENTS)]
        launches[0] += got[0]
        launches[1] += got[1]
        return sps, prof

    for k in study.K_SWEEP:
        sps, prof = point(BATCH, k, True)
        k_rows.append((k, sps))
        log(f"[scaling] K={k} b{BATCH}: {sps:.2f} steps/s; a replay: device busy "
            f"{prof['union']:.4f} ms/step, idle {100 * (1 - prof['union'] / prof['span']):.1f}% "
            f"of the span, against the untraced step of {1e3 / sps:.4f} ms idle "
            f"{100 * (1 - prof['union'] * sps / 1e3):.1f}%, kernel means "
            f"{prof['kernel_means_fwd'] // k}+{prof['kernel_means_bwd'] // k} per step")
    for b in study.BATCH_SWEEP:
        sps, _ = point(b, SCAN_K, False)
        batch_rows.append((b, sps))
        log(f"[scaling] b{b} K={SCAN_K}: {sps:.2f} steps/s, {sps * b:.1f} images/s")
    sweep = dict(k_rows)
    for k in SWEEP_REPEAT:
        sps, _ = point(BATCH, k, False)
        log(f"[scaling] K={k} b{BATCH} again: {sps:.2f} steps/s against {sweep[k]:.2f} in the "
            f"sweep ({100 * (sps / sweep[k] - 1):+.2f}%)")
    for line in (study.K_TABLE.splitlines() + [study.k_row(*r) for r in k_rows] + [""]
                 + study.BATCH_TABLE.splitlines() + [study.batch_row(*r) for r in batch_rows]):
        log(f"[scaling] {line}")
    log(f"[scaling] cifar10 rep bf16, {SWEEP_STEPS} timed steps per point after an eager "
        f"window and the capture; kernel means {launches[0]} + {launches[1]} launches "
        f"(counters over the eager windows and captures, the profiler over one replay per K); "
        f"card: {card}")
    return launches


def start_quality_smoke(tmp: str):
    """16c's first part, which times nothing: ``tools/quality_smoke.py --loss
    rmb`` for QUALITY_STEPS graphed steps in a process, writing its
    checkpoint to tmp/ckpt. Returns the function that waits for it."""
    proc = ("16c quality_smoke --ckpt-dir", *_mesh_process(
        [sys.executable, "-m", "mmdgan_torch.tools.quality_smoke", "--loss", "rmb",
         "--steps", str(QUALITY_STEPS), "--eval-every", str(QUALITY_STEPS),
         "--eval-batches", "2", "--ckpt-dir", os.path.join(tmp, "ckpt"),
         "--out", os.path.join(tmp, "quality_smoke")], os.path.join(tmp, "quality_smoke.log")))

    def finish() -> None:
        text = _wait_all([proc], timeout=600)[0]
        assert "RESUMABLE" in text, text[-3000:]

    return finish


def check_parity_run(dev, card: str) -> None:
    """16e: ``tools/parity_run.py`` on the card, under deterministic
    algorithms, twice: PARITY_STEPS float32 steps of the full-width CIFAR-10
    rep model from seed 0; the two loss curves bitwise equal (the tool's
    ``--compare`` says MATCH), and the loss recomputed from D's scores by the
    tool's numpy copy of the reference formulas within 1.1e-5 of
    ``gan_loss`` on the card (the CPU test's atol 1e-6 and rtol 1e-5 of a
    loss below 1)."""
    from mmdgan_torch.tools import parity_run

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            paths = [os.path.join(tmp, f"run_{i}.json") for i in range(2)]
            runs = [parity_run.run(PARITY_STEPS, 0, path, 4, str(dev), "float32")
                    for path in paths]
            rc = parity_run.compare(*paths)
    finally:
        torch.use_deterministic_algorithms(False)
    curves = [[c["loss_gen"] for c in r["curve"]] for r in runs]
    assert rc == 0 and curves[0] == curves[1], curves
    errs = [r["max_reference_formula_error"] for r in runs]
    assert max(errs) < 1.1e-5 and np.isfinite(curves[0]).all(), errs
    log(f"[parity_run] {PARITY_STEPS} f32 steps of the full-width CIFAR-10 rep model twice "
        f"under deterministic algorithms: loss curves bitwise equal (final loss_gen "
        f"{curves[0][-1]:.6f}); reference formulas against gan_loss on the card, largest "
        f"difference {max(errs):.2e}; card: {card}")


def start_sweep_grid(tmp: str):
    """16f, which times nothing: ``tools/sweep_grid.py`` in a process, one
    cell (rep, k 64, both lr 2e-4) of SWEEP_GRID_STEPS graphed bf16 steps on
    its blob dataset resident on the card, scored with FID and IS over two
    batches. Returns the function that waits for it and reads the cell."""
    out = os.path.join(tmp, "sweep_grid")
    proc = ("16f sweep_grid", *_mesh_process(
        [sys.executable, "-m", "mmdgan_torch.tools.sweep_grid", "--losses", "rep", "--k-grid",
         "64", "--lr-grid", "2e-4", "--steps", str(SWEEP_GRID_STEPS), "--eval-batches", "2",
         "--device-dataset", "512", "--out", out], os.path.join(tmp, "sweep_grid.log")))

    def finish() -> None:
        _wait_all([proc], timeout=300)
        with open(os.path.join(out, "cells.jsonl")) as f:
            cells = [json.loads(line) for line in f]
        assert len(cells) == 1 and cells[0]["steps"] == SWEEP_GRID_STEPS, cells
        cell = cells[0]
        assert all(np.isfinite(cell[k]) for k in ("fid", "is", "loss_gen", "loss_dis")), cell
        assert all(os.path.getsize(os.path.join(out, f)) > 0 for f in ("grid.md", "grid.csv"))
        log(f"[sweep_grid] one cell (rep, k 64, lr 2e-4 / 2e-4), {SWEEP_GRID_STEPS} graphed "
            f"bf16 steps on the card: FID {cell['fid']}, IS {cell['is']}, loss_gen "
            f"{cell['loss_gen']}, {cell['seconds']} s; grid.md and grid.csv written")

    return finish


def run_rehearsal(card: str, tmp: str, pb: str) -> None:
    """16c: ``tools/inception_rehearsal.py`` in this process over the
    checkpoint, at the reference protocol (781 x 64 per side) through the
    fake inception graph at 299x299 on the card, its cross-check (the
    executor on the card against the CPU's, JAX's gate 1e-4) on."""
    from mmdgan_torch.tools import inception_rehearsal

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = inception_rehearsal.main(
            ["--pb", pb, "--ckpt-dir", os.path.join(tmp, "ckpt"), "--batch", str(BATCH),
             "--eval-batches", str(REHEARSAL_BATCHES)])
    text = out.getvalue()
    line = _json_tail(text)
    assert rc == 0 and line["samples"] == REHEARSAL_BATCHES * BATCH, text[-2000:]
    assert line["ckpt_step"] == QUALITY_STEPS, line
    scores = [line[k] for k in ("is_x", "is_g", "fid_xx", "fid_xg")]
    assert all(np.isfinite(scores)) and line["crosscheck_max_rel_diff"] < 1e-4, line
    log(f"[rehearsal] {text.strip().splitlines()[0]}")
    log(f"[rehearsal] {json.dumps(line)}")
    log(f"[rehearsal] {REHEARSAL_BATCHES} x {BATCH} per side through the fake inception at "
        f"299x299 on the card: IS(x) {line['is_x']:.4f}, IS(g) {line['is_g']:.4f}, FID(x, x) "
        f"{line['fid_xx']:.4f}, FID(x, g) {line['fid_xg']:.4f}; classifier "
        f"{line['classifier_images_per_sec']:.1f} images/s (the TF1 resize from 32 included), "
        f"eval {line['eval_seconds']:.2f} s by part {json.dumps(line['seconds_by_part'])}; "
        f"cross-check card vs CPU max relative difference "
        f"{line['crosscheck_max_rel_diff']:.3e} (gate 1e-4); card: {card}")


def check_imagenet_prep(dev, card: str, tmp: str, pb: str) -> None:
    """16d: ``tools/imagenet_prep.py``. ``extract`` on a train tar written
    here with tarfile (one inner tar per class) gives the class folders and
    their files; ``ref-stats`` over IMAGENET_CLASSES per-class record files
    of IMAGENET_ROWS seeded 64x64 rows (``np_to_tfrecords``, the
    ``imagenet_{cls:03d}`` names) through the fake inception, on the card
    and on the CPU: every class's mean and covariance agree at rtol 1e-3.
    (``tfrecords`` needs PIL, which the card's machine lacks; the CPU tests
    hold it to JAX's bytes.)"""
    import tarfile

    from mmdgan_torch.tools import imagenet_prep

    rng = np.random.RandomState(16)
    want, outer = {}, os.path.join(tmp, "train.tar")
    with tarfile.open(outer, "w") as tar:
        for cls in range(IMAGENET_CLASSES):
            wnid, inner = f"n0{cls:07d}", io.BytesIO()
            with tarfile.open(fileobj=inner, mode="w") as t:
                for i in range(2):
                    data = rng.bytes(64)
                    info = tarfile.TarInfo(f"{wnid}_{i}.JPEG")
                    info.size = len(data)
                    t.addfile(info, io.BytesIO(data))
                    want[os.path.join(wnid, info.name)] = data
            info = tarfile.TarInfo(f"{wnid}.tar")
            info.size = len(inner.getvalue())
            tar.addfile(info, io.BytesIO(inner.getvalue()))
    train = os.path.join(tmp, "train")
    with contextlib.redirect_stdout(io.StringIO()):
        imagenet_prep.extract_train(outer, train)
    got = {os.path.relpath(os.path.join(d, f), train): Path(d, f).read_bytes()
           for d, _, files in os.walk(train) for f in files}
    assert got == want, sorted(got)

    data = os.path.join(tmp, "imagenet")
    os.makedirs(data)
    for cls in range(IMAGENET_CLASSES):
        x = rng.randint(0, 256, (IMAGENET_ROWS, 3, IMAGENET_SIDE, IMAGENET_SIDE), np.uint8)
        np_to_tfrecords(x, np.full(IMAGENET_ROWS, cls), os.path.join(data, f"imagenet_{cls:03d}"))
    stats, seconds = {}, {}
    for where in (dev, "cpu"):
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            paths = imagenet_prep.ref_stats(data, 0, IMAGENET_CLASSES, BATCH, pb, device=where)
        seconds[str(where)] = time.perf_counter() - start
        stats[str(where)] = [dict(np.load(p)) for p in paths]
    worst = 0.0
    for cls, (card_stats, cpu_stats) in enumerate(zip(*stats.values())):
        for key in ("mean", "cov"):
            np.testing.assert_allclose(card_stats[key], cpu_stats[key], **STATS_TOL,
                                       err_msg=f"16d class {cls} {key}: card vs CPU")
            gap = np.abs(card_stats[key] - cpu_stats[key])
            worst = max(worst, float((gap / (STATS_TOL["atol"] + STATS_TOL["rtol"]
                                             * np.abs(cpu_stats[key]))).max()))
        assert card_stats["mean"].shape == (2048,) and card_stats["cov"].shape == (2048, 2048)
    n = IMAGENET_CLASSES * IMAGENET_ROWS
    log(f"[imagenet] extract: {IMAGENET_CLASSES} class tars unpacked, {len(want)} files "
        f"bitwise; ref-stats over {IMAGENET_CLASSES} classes of {IMAGENET_ROWS} "
        f"{IMAGENET_SIDE}x{IMAGENET_SIDE} rows (the last batch of 44 included) through the "
        f"fake inception: card {seconds[str(dev)]:.2f} s ({n / seconds[str(dev)]:.1f} images/s "
        f"with the record reads and the host statistics), CPU {seconds['cpu']:.2f} s; every "
        f"class's pool3 mean and covariance card vs CPU within rtol 1e-3 / atol 1e-5 (the "
        f"largest difference {worst:.3f} of the tolerance); card: {card}")


# ----------------------------------------------------------------------
# phase 17: the five studies that asked the TPU's questions, asked of the
# H100 (kernel, conv, tc, device-data sampling, export), at a cut size
# ----------------------------------------------------------------------

STUDY_ITERS = 64                    # 17a: chained iterations per graph (the tool's 512)
STUDY_REPEAT = 3                    # 17a-17c: timed replays per reading (the tools' 5, 7, 7)
STUDY_STEPS = 64                    # 17a: timed steps per step A/B reading (the tool's 512)
STUDY_AB = ("rep", "rmb_gp")        # 17a: the step A/B at b64, on/off in turns twice
CONV_CUT = {"l1_f64": ("direct", "pad8"), "l2_ds": ("direct", "s2d"), "l7": ("direct", "im2col")}
TC_CUT = ("g4 16x16 128->64", "g6", "g8")
STUDY_INNER = (20, 5)               # 17b/17c: calls per graph below / at 128x128 (the tools' 200, 25)
HBM_CUT, HBM_STEPS = ("synthetic", "base", "pregather", "cursor"), 128   # 17d (the tool's 512)
EXPORT_BATCH, EXPORT_CALLS = 256, 16    # 17e: cifar (the tool's default celeba, lsun at b1024, 64)


def run_kernel_study(dev, card: str) -> list:
    """17a: ``tools/kernel_study.py`` at a cut size (phase 3 holds and times
    both kernels at d = 256): the study's gate (its scalar and gradient,
    kernel against plain) and its microbench at all four (B, d),
    STUDY_ITERS chained iterations per graph; then the CIFAR step with
    ``use_fused_kernel`` on and off for STUDY_AB at b64, STUDY_STEPS timed
    steps, in turns twice. The wrappers' counters, zeroed after the gates,
    count n + 1 launches per timed capture (its eager warm-up and its n
    captured iterations) and 1 + 2 per step of each fused reading's eager
    window and capture, none with the kernel off. Returns those launches."""
    from mmdgan_torch.tools import kernel_study as study

    rows, launches = [], [0, 0]
    for b, d in study.MICRO_SHAPES:
        err = study.gate(b, d, dev)
        reset_counters()
        row = study.micro_row(b, d, STUDY_ITERS, dev, STUDY_REPEAT)
        n = STUDY_ITERS + 1
        assert counters() == [2 * n, n], f"17a ({b}, {d}): counters {counters()}"
        launches = [a + c for a, c in zip(launches, counters())]
        rows.append(row)
        log(f"[kernel_study] ({b}, {d}): gate passed (gradient max |err| {err:.3e}); "
            f"bound {row['bound_by']}")
    for line in study.MICRO_TABLE.splitlines() + [study.format_micro(r) for r in rows]:
        log(f"[kernel_study] {line}")
    for loss in STUDY_AB:
        reset_counters()
        readings = study.step_readings(loss, BATCH, STUDY_STEPS, 2, dev)
        # each fused reading's eager window and capture; none with the kernel off
        want = [n * SCAN_K * 2 * len(readings[True]) for n in KERNEL_EVENTS.values()]
        assert counters() == want, f"17a {loss}: counters {counters()}, want {want}"
        launches = [a + c for a, c in zip(launches, counters())]
        on, off = readings[True], readings[False]
        log(f"[kernel_study] {loss} b{BATCH}, {STUDY_STEPS} timed steps a reading, in turns "
            f"(on, off, off, on): kernel on {', '.join(f'{v:.2f}' for v in on)}, off "
            f"{', '.join(f'{v:.2f}' for v in off)} steps/s; on/off "
            f"{100 * (np.mean(on) / np.mean(off) - 1):+.2f}%")
    log(f"[kernel_study] kernel means {launches[0]} + {launches[1]} launches (counters: "
        f"captures with their warm-ups, the fused readings' eager windows and captures); "
        f"card: {card}")
    return launches


def run_conv_studies(dev, card: str) -> None:
    """17b/17c: ``tools/conv_study.py`` on CONV_CUT's shapes and variants and
    ``tools/tc_study.py`` on TC_CUT's shapes (every variant), in NCHW and
    ``channels_last``, bf16, batch 64, each variant gated first in float32
    inside ``tf32_off`` (cuDNN's and cuBLAS's TF32 both off; the tools'
    own gates switch both off and restore them too) and then timed with the
    flags as the train step has them, STUDY_INNER calls per graph."""
    from mmdgan_torch.tools import conv_study, tc_study

    for name, keep in CONV_CUT.items():
        shape = next(sh for sh in conv_study.SHAPES if sh[0].startswith(name))
        cin, k, s = shape[3], shape[5], shape[6]
        x, w = conv_study.shape_inputs(shape, dev, BATCH)
        fns = {v: conv_study.variants(cin, k, s)[v] for v in keep}
        errs = tf32_off(lambda: conv_study.gate(fns, (x, w, s), conv_study.GATE, shape[0]))
        res = conv_study.time_shape(shape, fns, x, w, STUDY_INNER[0], STUDY_REPEAT)
        for layout in conv_study.LAYOUTS:
            for row in conv_study.table_rows(shape[0], res[layout]):
                log(f"[conv_study] {layout} {row}")
        d_cl, d_nchw = res["channels_last"]["direct"], res["nchw"]["direct"]
        log(f"[conv_study] {shape[0]}: gate {json.dumps(errs)} (relative, f32, TF32 off); "
            f"direct channels_last vs NCHW fwd x{d_nchw['fwd_us'] / d_cl['fwd_us']:.3f}, "
            f"fwd+bwd x{d_nchw['fwdbwd_us'] / d_cl['fwdbwd_us']:.3f}")
    for shape in conv_study.select(tc_study.SHAPES, ",".join(TC_CUT)):
        x, w = tc_study.shape_inputs(shape, dev, BATCH)
        errs = tf32_off(lambda: conv_study.gate(tc_study.GATED, (x, w), tc_study.GATE, shape[0]))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = tc_study.time_shape(shape, x, w, STUDY_INNER[shape[1] >= 128], STUDY_REPEAT)
        for line in out.getvalue().splitlines():
            log(f"[tc_study] {line}")
        d_cl, d_nchw = res["channels_last"]["direct"], res["nchw"]["direct"]
        log(f"[tc_study] {shape[0]}: gate {json.dumps(errs)} (relative, f32, TF32 off); direct "
            f"channels_last vs NCHW fwd x{d_nchw['fwd_us'] / d_cl['fwd_us']:.3f}, fwd+bwd "
            f"x{d_nchw['fwdbwd_us'] / d_cl['fwdbwd_us']:.3f}; ps3 vs direct (NCHW) fwd "
            f"x{res['nchw']['ps3']['fwd_speedup']:.3f}, fwd+bwd "
            f"x{res['nchw']['ps3']['fwdbwd_speedup']:.3f}")
    log(f"[conv_study] {len(CONV_CUT)} conv and {len(TC_CUT)} tc shapes, bf16 b{BATCH}, "
        f"{STUDY_INNER} calls per graph, median of {STUDY_REPEAT} replays; card: {card}")


def run_hbm_study(dev, card: str) -> None:
    """17d: ``tools/hbm_study.py``'s HBM_CUT variants on cifar at full width,
    b64 K=16 over its 50,000 seeded rows, HBM_STEPS timed steps each."""
    from mmdgan_torch.tools import hbm_study

    rates = {}
    for v in HBM_CUT:
        gc.collect()
        torch.cuda.empty_cache()
        call, ts = hbm_study.make_variant(v, "cifar", dev)
        rates[v] = hbm_study.measure(call, ts, HBM_STEPS)
        del call, ts
    line = {"arch": "cifar", "steps": HBM_STEPS, "steps_per_sec": rates}
    log(f"[hbm_study] {json.dumps(line)}; cursor / base {rates['cursor'] / rates['base']:.4f}, "
        f"base / synthetic {rates['base'] / rates['synthetic']:.4f}; card: {card}")


def run_export_study(dev, card: str) -> None:
    """17e: ``tools/export_study.py`` on cifar at EXPORT_BATCH,
    EXPORT_CALLS calls per surface."""
    from mmdgan_torch.tools import export_study

    line = export_study.study("cifar", EXPORT_BATCH, dev, EXPORT_CALLS)
    assert set(line["img_per_sec"]) == {"model", "exp", "exp_args"}, line
    log(f"[export_study] {json.dumps(line)}; card: {card}")


def check_tc_gate_on_card(dev) -> None:
    """17c's check: a ``tc`` layer (16 -> 32 channels at 64x64, spectral
    norm) built with ``TC_PS3_MIN_SIZE`` at 64 runs ``conv_transpose_ps3``
    and agrees with the same layer built at the default gate (the direct
    route), float32, TF32 off: the output within 2e-5 and the gradients by
    the input and the kernel within 2e-4, relative to their largest
    entries."""
    from mmdgan_torch.models import ops
    from mmdgan_torch.tools.conv_study import relative_error

    design = {"op": "tc", "out": 32, "kernel": 4, "strides": 2, "padding": "SAME",
              "w_nm": "s", "act_k": 1.5}
    direct = ops.ParametricOp(design, (16, 64, 64), compute_dtype=torch.float32)
    old, ops.TC_PS3_MIN_SIZE = ops.TC_PS3_MIN_SIZE, 64
    try:
        ps3 = ops.ParametricOp(design, (16, 64, 64), compute_dtype=torch.float32)
    finally:
        ops.TC_PS3_MIN_SIZE = old
    assert ps3.tc_ps3 and not direct.tc_ps3
    params, state = direct.init(torch.Generator().manual_seed(0))
    params = {k: v.to(dev) for k, v in params.items()}
    state = {k: v.to(dev) for k, v in state.items()}
    rng = np.random.RandomState(17)
    x = torch.tensor(rng.randn(BATCH, 16, 64, 64).astype(np.float32), device=dev)
    ct = torch.tensor(rng.randn(BATCH, 32, 128, 128).astype(np.float32), device=dev)

    def run(op):
        xg = x.clone().requires_grad_(True)
        kg = params["kernel"].clone().requires_grad_(True)
        y, _ = op.apply({"kernel": kg}, state, xg)
        return (y.detach(),) + torch.autograd.grad(y, (xg, kg), ct)

    got, want = tf32_off(lambda: (run(ps3), run(direct)))
    errs = [relative_error(g, w) for g, w in zip(got, want)]
    assert errs[0] < 2e-5 and max(errs[1:]) < 2e-4, errs
    log(f"[tc_study] a tc layer at 64x64 with TC_PS3_MIN_SIZE = 64 (ps3) against the direct "
        f"route on the card, f32, TF32 off: output {errs[0]:.2e}, d/dx {errs[1]:.2e}, "
        f"d/dkernel {errs[2]:.2e} relative")


def mesh_rank_main(argv: list) -> int:
    """``chip_smoke.py --mesh-rank KIND RANK WORLD STORE OUT CARD``: one
    rank of phase 13 (``nccl``, run by ``run_mesh_nccl``; ``gloo``, by
    ``start_mesh_smokes``) or of phase 14 (``fsdp-nccl``, run by
    ``run_fsdp_nccl``; ``fsdp-gloo``, ``2d-gloo``, by
    ``start_sharding_smokes``)."""
    kind, rank, world, store, out, card = argv
    _START.append(time.perf_counter())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.build(cuda_mmd.SOURCE)
    if kind == "nccl":
        mesh_nccl_rank(store, out, card)
    elif kind == "gloo":
        mesh_gloo_rank(int(rank), int(world), store, out, card)
    elif kind == "fsdp-nccl":
        fsdp_nccl_rank(store, out, card)
    else:
        sharded_gloo_rank(int(rank), int(world), store, out, card, kind.split("-")[0])
    return 0


PHASES = tuple(range(3, 18))


def parse_phases(argv: list) -> set:
    """``--phases 3,15,16`` (default: every phase); phase 3 always runs, as
    the kernels line needs it."""
    if not argv:
        return set(PHASES)
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(f"usage: chip_smoke.py [--phases N,N,...] (phases {PHASES[0]}-"
                         f"{PHASES[-1]})")
    chosen = {int(v) for v in argv[1].split(",") if v}
    if not chosen <= set(PHASES):
        raise SystemExit(f"chip_smoke.py: phases {sorted(chosen - set(PHASES))} do not exist")
    return chosen | {3}


def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace, chosen before
    # its first call (phase 6)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_main(sys.argv[2:])
    chosen = parse_phases(sys.argv[1:])
    _START.append(time.perf_counter())
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 Gram products, as the reference
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")

    existed = _build.library_path(cuda_mmd.SOURCE).exists()
    start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:   # ptxas -v beside the build
        usage = pool.submit(_build.resource_usage, cuda_mmd.SOURCE)
        _build.build(cuda_mmd.SOURCE)
        cuda_mmd._library()
        log(f"[build] {cuda_mmd.SOURCE}: {time.perf_counter() - start:.2f} s "
            f"({'loaded from build/' if existed else 'nvcc sm_90a'})")
        for line in usage.result():
            log(f"[build] {line}")

    seconds, launches = {}, []

    def phase(name, fn, counted: bool = False):
        """Run phase ``name`` if its number was chosen; ``counted``: it
        returns its kernel-means launches, [forward, backward], which the
        kernels line sums."""
        if int(name.split()[0]) not in chosen:
            return None
        start = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - start, 1)
        if counted:
            launches.append(out)
        return out

    def main_path():
        runs = {loss: run_main_path(dev, loss, card) for loss in ("rep", "rmb")}
        return [sum(counted[i] for counted, _ in runs.values()) for i in range(2)]

    def families():
        runs = [run_family(dev, name, arch, card)
                for name, arch in (("stl10", stl_architecture()),
                                   ("celeba", celeba_architecture()))]
        return [sum(r[i] for r in runs) for i in range(2)]

    def shapes():
        kernels = [check_kernel_means(dev), check_kernel_means_backward(dev)]
        check_kernel_shapes(dev, kernels, TIMED_SHAPES, seed=20)
        return kernels

    # phases 7 and 12b's datasets, each built once for its timed part and
    # its checks
    trainer_data = cache(lambda: trainer_dataset(dev))
    same_class_data = cache(lambda: same_class_setup(dev))

    with tempfile.TemporaryDirectory() as tmp:
        # the parts that time things, alone on the card
        kernels = phase("3 kernels", shapes)
        phase("5 main", main_path, counted=True)
        phase("7 trainer steps/s", lambda: trainer_rates(dev, *trainer_data()))
        phase("9 losses", lambda: run_losses(dev, card), counted=True)
        phase("10 families", families, counted=True)
        phase("10 hd512", lambda: run_hd512(dev, card), counted=True)
        phase("11 eval cli", lambda: run_eval_cli(dev, card), counted=True)
        phase("11 metrics", lambda: check_metrics_on_card(dev))
        phase("11 optimizer steps/s", lambda: optimizer_steps_per_sec(dev, card))
        phase("12 conditional", lambda: run_conditional(dev, card), counted=True)
        phase("12 same-class steps/s", lambda: same_class_rates(dev, card, same_class_data()))
        phase("13 mesh NCCL", lambda: run_mesh_nccl(card), counted=True)
        phase("14 serving", lambda: run_serving(dev, card))
        os.makedirs(os.path.join(tmp, "14"))
        phase("14 fsdp NCCL", lambda: run_fsdp_nccl(card, os.path.join(tmp, "14")),
              counted=True)
        phase("15 real data and tools", lambda: run_real_data_and_tools(dev, card),
              counted=True)
        phase("16 preflight", lambda: run_preflight(card))
        phase("16 scaling", lambda: run_scaling_study(dev, card), counted=True)
        pb = os.path.join(tmp, "fake_inception_v1.pb")
        phase("16 fake inception", lambda: write_fake_inception(pb))
        phase("17 kernel study", lambda: run_kernel_study(dev, card), counted=True)
        phase("17 conv and tc studies", lambda: run_conv_studies(dev, card))
        phase("17 hbm study", lambda: run_hbm_study(dev, card))
        phase("17 export study", lambda: run_export_study(dev, card))

        # the checks, which time nothing, in this process beside the phases'
        # subprocesses that time nothing either
        start, pending = time.perf_counter(), []

        def beside(name, begin):
            if int(name.split()[0]) in chosen:
                folder = os.path.join(tmp, name.replace(" ", "_"))
                os.makedirs(folder, exist_ok=True)
                pending.append((name, begin(folder)))

        try:
            beside("8 cli", lambda d: partial(finish_clis, start_clis(cli_runs(d), d)))
            beside("10 cli", lambda d: partial(finish_clis, start_clis(family_cli_runs(d), d)))
            beside("12 cli", lambda d: partial(finish_clis,
                                               start_clis(conditional_cli_runs(d), d)))
            beside("13 gloo and cli", lambda d: start_mesh_smokes(card, d))
            beside("14 gloo and profile_step",
                   lambda d: start_sharding_smokes(card, os.path.join(tmp, "14")))
            beside("16 quality_smoke", lambda d: start_quality_smoke(tmp))
            beside("16 sweep_grid", start_sweep_grid)
            phase("4 reference",
                  lambda: [check_against_cpu(dev, loss) for loss in CPU_CHECK_LOSSES])
            phase("6 determinism", lambda: check_determinism(dev))
            phase("7 trainer checks", lambda: check_trainer(dev, *trainer_data()))
            phase("9 rep_gp determinism", lambda: check_penalty_determinism(dev))
            phase("10 accumulation checks", lambda: [
                check_against_cpu(dev, loss, micro=ACCUM_M) for loss in ("rep", "rmb_gp")]
                + [check_accum_equals_fused(dev)])
            phase("10 window determinism", lambda: check_window_determinism(dev))
            phase("11 optimizer windows", lambda: check_optimizer_windows(dev))
            phase("12 same-class checks", lambda: check_same_class_data(dev, same_class_data()))
            phase("12 card vs CPU", lambda: check_catalogue_on_card(dev))
            phase("16 imagenet prep", lambda: check_imagenet_prep(dev, card, tmp, pb))
            phase("16 parity_run", lambda: check_parity_run(dev, card))
            phase("17 tc gate on the card", lambda: check_tc_gate_on_card(dev))
        finally:
            errors = []
            for name, finish in pending:
                try:
                    finish()
                except BaseException as e:   # every group is waited for, then raised
                    errors.append(e)
                seconds[name] = round(time.perf_counter() - start, 1)
            if errors:
                raise errors[0]
        seconds["checks and subprocesses"] = round(time.perf_counter() - start, 1)
        phase("16 rehearsal", lambda: run_rehearsal(card, tmp, pb))
    for i, kernel in enumerate(kernels):
        kernel["launches"] = sum(counted[i] for counted in launches)

    log(f"[timing] seconds by phase: {json.dumps(seconds)}")
    log(f"[phases] ran {', '.join(map(str, sorted(chosen)))} of {PHASES[0]}-{PHASES[-1]}; "
        f"the kernels line sums their launches")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
