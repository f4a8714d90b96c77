"""Agent: the training runtime (``mmdgan_tpu/train/trainer.py:45-840``).

The loop around the train step: run folders, host-fed and
device-resident training, checkpoints, guards, summaries, profiling.

- Checkpoints of the whole TrainState (``utils/checkpoint.py``):
  max_to_keep=2 (graph_func.py:708-717), a save at the end of every run
  and on divergence (``_abnormal_save``, :948-973); ``restore`` writes the
  latest into the given state in place.
- Divergence guards: NaN raises, a loss above 30000 stops early (:856,
  :962), checked where the host syncs: every ``nan_check_step`` steps and
  at query steps, not every step, so the device queue stays deep.
- SIGTERM finishes the step window, checkpoints and returns
  (``_PreemptionGuard``).
- ``train`` runs the host-fed step one call per step (any update
  schedule, decided on the host); with ``steps_per_call`` K > 1 it runs
  ``_train_multi``, K steps per CUDA graph launch (``graph_steps``, or
  ``imbalanced_scan`` for an imbalanced schedule, whose flags are then
  computed on the device). ``train_device_data`` uploads the dataset once
  and runs graphed windows that take their batches on the device, the
  accumulated step among them (``micro_batches``).
- ``do_trace``: ``torch.profiler`` over the end of every loop (the last 5
  single steps, the last 2 K-step windows, or every window of a call of
  fewer than 3), written to the summary folder: ``trace.json``, a chrome
  trace that holds the port's spans beside the kernels, and ``spans.json``,
  the spans' records and counters (``utils/spans.py``).
- Spans (``utils/spans.py``, recorded while any profiler runs):
  ``agent.call`` around each training call, ``agent.upload`` (the
  device-data copy), ``agent.feed_wait`` (each wait on the prefetcher),
  ``agent.guard`` (``_check``'s sync) and ``agent.report`` (summaries).
- ``debug_mode=None`` prints the model description and returns without
  running (:1195-1204); ``True`` caps a run at ``debug_step``.

Labels ride in the batches (``{'x', 'y'}``) of both loops; a conditional
model takes them, and ``sample_same_class`` draws each device-data batch
from one class.

Data parallelism (``dp``, a ``parallel.DataParallel``) threads through all
three loops: the state is placed by ``dp.ensure_placed`` (replicated from
rank 0, or kept in the sharded layout it came in: ``shard_state(fsdp=True)``
or a 2-D mesh's), every rank feeds its own rows (host-fed: its pipeline
shard; device data: its shard of the dataset), checkpoints, summaries and
``_abnormal_save`` are written by rank 0 behind a barrier, and every rank
restores. A sharded state's checkpoints and parameter histograms hold the
whole state, gathered by every rank first. The guards read the replicated
metrics, so every rank decides alike.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from mmdgan_torch.data.prefetch import prefetch
from mmdgan_torch.ops.losses import HIST_RANGES
from mmdgan_torch.train.state import TrainState
from mmdgan_torch.train.step import (
    EpochPermuter,
    build_device_data_step,
    class_schedule,
    graph_steps,
    imbalanced_scan,
    same_class_tables,
)
from mmdgan_torch.utils import checkpoint, spans
from mmdgan_torch.utils.folders import prepare_folder
from mmdgan_torch.utils.summary import MetricWriter

LOSS_DIVERGENCE_BOUND = 30000.0  # graph_func.py:962


class _PreemptionGuard:
    """Scoped SIGTERM handler for training loops: inside the guard,
    SIGTERM sets ``requested`` instead of killing the process, so the loop
    finishes the step window in flight, checkpoints and returns; a rerun
    with ``load_ckpt=True`` resumes. Installs only in the main thread
    (signals are main-thread-only); the previous handler is restored on
    exit."""

    def __init__(self, enabled: bool = True):
        self.requested = False
        self._enabled = enabled
        self._prev = None
        self._installed = False

    def __enter__(self):
        import signal
        import threading

        if self._enabled and threading.current_thread() is threading.main_thread():
            def _handler(signum, frame):
                self.requested = True
                print("Agent: SIGTERM received — checkpointing at the "
                      "next step-window boundary.", flush=True)

            self._prev = signal.signal(signal.SIGTERM, _handler)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            import signal

            # signal.signal() returns None when the previous handler was
            # installed outside Python; restoring None raises TypeError
            signal.signal(signal.SIGTERM, self._prev if self._prev is not None else signal.SIG_DFL)
        return False


def split_host_metrics(metrics_host: Dict, take_last: bool):
    """Split a dict of host step metrics into (scalars, hists): ``hist/*``
    keys carry fixed-bin counts ([K, nbins] when stacked, ``take_last``
    picks the last step); everything else is a scalar (or a [K] stack)."""
    scalars, hists = {}, {}
    for k, v in metrics_host.items():
        a = np.asarray(v)
        if k.startswith("hist/"):
            hists[k] = a[-1] if take_last else a
        else:
            scalars[k] = float(a[-1]) if take_last else float(a)
    return scalars, hists


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The metrics on the host (a sync point): one copy of the scalars,
    one per ``hist/*`` stack."""
    keys = [k for k in metrics if not k.startswith("hist/")]
    out = dict(zip(keys, torch.stack([metrics[k].float() for k in keys]).cpu().numpy()))
    out.update({k: v.cpu().numpy() for k, v in metrics.items() if k.startswith("hist/")})
    return out


class _Trace:
    """``do_trace``'s profiler over the end of one loop: ``start(due)``
    starts it the first time ``due`` holds (with ``do_trace`` only, and
    forgets the spans recorded before); leaving the block stops it and
    writes ``trace.json`` and ``spans.json`` into ``folder``."""

    def __init__(self, enabled: bool, device: torch.device, folder: str):
        self.enabled, self.device, self.folder = enabled, device, folder
        self.profiler = None

    def start(self, due: bool = True) -> None:
        if self.enabled and due and self.profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            spans.clear()
            self.profiler = profile(activities=activities)
            self.profiler.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.profiler.stop()
            self.profiler.export_chrome_trace(os.path.join(self.folder, "trace.json"))
            with open(os.path.join(self.folder, "spans.json"), "w") as f:
                json.dump({"records": [r._asdict() for r in spans.records()],
                           "counters": spans.counters()}, f)
        return False


class Agent:
    def __init__(
        self,
        filename: str,
        sub_folder: str,
        load_ckpt: bool = False,
        do_trace: bool = False,
        do_save: bool = True,
        debug_mode: Optional[bool] = False,
        debug_step: int = 400,
        query_step: int = 1000,
        imbalanced_update: Union[None, Sequence[int], str] = None,
        print_loss: bool = True,
        nan_check_step: int = 100,
        output_dir: Optional[str] = None,
        use_tensorboard: bool = True,
        max_to_keep: int = 2,
        param_hist_step: int = 0,
        handle_preemption: bool = True,
    ):
        """``param_hist_step``: per-variable parameter histograms every N
        steps (my_sngan.py:309-313), 0 = off. ``handle_preemption``: treat
        SIGTERM as a request to stop cleanly (``_PreemptionGuard``)."""
        self.filename = filename
        self.sub_folder = sub_folder
        self.load_ckpt = load_ckpt
        self.do_trace = do_trace
        self.do_save = do_save
        self.debug_mode = debug_mode
        self.debug_step = debug_step
        self.query_step = max(int(query_step), 1)
        self.imbalanced_update = imbalanced_update
        self.print_loss = print_loss
        self.nan_check_step = max(int(nan_check_step), 1)
        self.ckpt_folder, self.summary_folder, self.save_path = prepare_folder(
            filename, sub_folder=sub_folder, set_folder=output_dir)
        self.use_tensorboard = use_tensorboard
        self._writer: Optional[MetricWriter] = None
        self._dp = None     # the mesh of the running loop
        self.max_to_keep = max_to_keep
        self.param_hist_step = int(param_hist_step)
        self.handle_preemption = bool(handle_preemption)
        self._last_param_hist = None
        self._windows: Dict = {}

    @property
    def writer(self) -> MetricWriter:
        """The run's metric writer, opened on first use (a mesh rank other
        than 0 never opens it)."""
        if self._writer is None:
            self._writer = MetricWriter(self.summary_folder, use_tensorboard=self.use_tensorboard)
        return self._writer

    @property
    def is_main(self) -> bool:
        """Whether this process writes summaries: no mesh, or its rank 0."""
        return self._dp is None or self._dp.is_main

    def _use_mesh(self, dp, ts: TrainState, step: Optional[Callable] = None) -> TrainState:
        """Enter a loop on ``dp`` (None: one device): the step must have
        been built with it, and the state is placed on the mesh
        (``ensure_placed``: a sharded state keeps its layout)."""
        self._dp = dp
        if dp is None:
            if getattr(step, "dp", None) is not None:
                raise ValueError("the step was built with a mesh: pass its dp to the Agent")
            return ts
        if step is not None:
            dp.compile_step(step, out_state_like=ts)
        return dp.ensure_placed(ts)

    # ------------------------------------------------------------------
    # summaries
    # ------------------------------------------------------------------
    def _write_query(self, gstep: int, scalars: Dict, hists: Dict,
                     ts: Optional[TrainState] = None):
        """One query step's summaries: scalars, the step's ``hist/*``
        histograms over their fixed ranges (``HIST_RANGES``), and the
        per-variable parameter histograms of ``ts`` when given."""
        self.writer.scalars(gstep, scalars)
        for k, counts in hists.items():
            self.writer.histogram(gstep, k, counts, *HIST_RANGES[k])
        if ts is not None:
            self.write_param_histograms(ts, gstep)

    def write_param_histograms(self, ts: TrainState, step: int):
        """Per-variable parameter histograms (my_sngan.py:309-313)."""
        for net in ("gen", "dis"):
            for scope, ops in ts.params[net].items():
                for op_name, leaves in ops.items():
                    for name, leaf in leaves.items():
                        self.writer.raw_histogram(step, f"params/{scope}/{op_name}/{name}",
                                                  leaf.detach().cpu().numpy())

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save(self, ts: TrainState, step: Optional[int] = None):
        if not self.do_save:
            return
        step = int(ts.step) if step is None else int(step)
        checkpoint.save(self.ckpt_folder, ts, step, self.max_to_keep, dp=self._dp)

    def restore(self, ts: TrainState, step: Optional[int] = None) -> TrainState:
        """Write the checkpoint of ``step`` (the latest by default) into
        ``ts`` in place; returns ``ts``, unchanged if there is none."""
        target = checkpoint.get_ckpt(self.ckpt_folder, step)
        if target is None:
            print(f"Agent: no checkpoint found in {self.ckpt_folder}; starting from scratch.")
            return ts
        checkpoint.restore_into(ts, checkpoint.ckpt_path(self.ckpt_folder, target))
        print(f"Agent: restored checkpoint at step {target} from {self.ckpt_folder}.")
        return ts

    # ------------------------------------------------------------------
    def _update_flags(self, global_step: int, mmd_average: float, rng: np.random.RandomState):
        """(do_dis, do_gen) for this step (graph_func.py:850-942); the
        reference's op_list is [dis_op, gen_op] (my_sngan.py:426)."""
        iu = self.imbalanced_update
        if iu is None:
            return True, True
        if isinstance(iu, (list, tuple)):
            return global_step % iu[0] == 0, global_step % iu[1] == 0
        if iu == "dynamic":
            # probabilistic D update (graph_func.py:916-919)
            do_dis = global_step < 1000 or rng.uniform() < 0.1 / max(mmd_average, 0.1)
            return bool(do_dis), True
        raise ValueError("Imbalanced_update not identified.")

    def _check(self, ts: TrainState, step: int, metrics: Dict, take_last: bool):
        """Sync and read the metrics; raise on NaN, return None after a
        loss above the bound (the run must stop), else (scalars, hists)."""
        with spans.span("agent.guard"):
            vals, hists = split_host_metrics(_to_host(metrics), take_last)
            loss_vals = [vals["loss_gen"], vals["loss_dis"]]
            if any(np.isnan(loss_vals)):
                self._abnormal_save(ts, step, vals)
                raise FloatingPointError(f"Model diverged with loss = {loss_vals} at step {step}")
            if any(np.greater(loss_vals, LOSS_DIVERGENCE_BOUND)):
                self._abnormal_save(ts, step, vals)
                warnings.warn("Training stopped early as loss diverged.")
                return None
            return vals, hists

    def _report(self, ts, step, vals, hists, steps_done, start, step_per_epoch, force_print):
        with spans.span("agent.report"):
            hist_ts = None
            if self.param_hist_step > 0 and (self._last_param_hist is None or step -
                                             self._last_param_hist >= self.param_hist_step):
                # every rank: gathering a sharded state is a collective
                self._last_param_hist = step
                hist_ts = ts if ts.layout is None else ts.layout.gathered(ts)
            if not self.is_main:
                return
            self._write_query(step, vals, hists, hist_ts)
            if self.print_loss or force_print:
                epoch = (step - 1) // max(step_per_epoch, 1)
                speed = steps_done / (time.time() - start)
                print(f"global step {step} epoch {epoch}: loss_gen {vals['loss_gen']:.4f} "
                      f"loss_dis {vals['loss_dis']:.4f} ({speed:.2f} steps/s)", flush=True)

    def _after_window(self, ts, metrics, start_step, call, num_calls, k, start,
                      step_per_epoch, force_print) -> bool:
        """Guards and summaries after window ``call`` of K steps, where a
        sync is due: a nan-check or query boundary crossed, or the last
        window. False when the run must stop."""
        gstep = start_step + (call + 1) * k
        last = call == num_calls - 1
        query = gstep % self.query_step < k or last
        if query or gstep // self.nan_check_step != (gstep - k) // self.nan_check_step:
            checked = self._check(ts, gstep, metrics, take_last=True)
            if checked is None:
                return False
            if query:
                self._report(ts, gstep, *checked, (call + 1) * k, start, step_per_epoch,
                             force_print)
        return True

    def _finish(self, ts: TrainState, ran: int, start: float, summary_image_fn) -> TrainState:
        """Checkpoint, final image summary (my_sngan.py:459-463), timing."""
        final_step = int(ts.step)
        if self.do_save:
            self.save(ts, final_step)
        if not self.is_main:
            return ts
        if summary_image_fn is not None:
            self.writer.images(final_step, "Ig", summary_image_fn(ts).cpu().numpy())
        duration = time.time() - start
        print(f"Training for {ran} steps took {duration:.3f} sec "
              f"({ran / max(duration, 1e-9):.2f} steps/s).", flush=True)
        self.writer.flush()
        return ts

    # ------------------------------------------------------------------
    @spans.spanned("agent.call")
    def train(
        self,
        train_step: Callable,
        ts: TrainState,
        data_iter: Iterable[Dict],
        max_step: int,
        step_per_epoch: int,
        dp=None,
        summary_image_fn: Optional[Callable] = None,
        model_description: Optional[str] = None,
        force_print: bool = False,
        steps_per_call: int = 1,
    ) -> TrainState:
        """Run the host-fed training loop; returns the final TrainState.

        :param train_step: from ``build_train_step``, or a function of its
            signature
        :param data_iter: yields host batches {'x': [B,H,W,C], 'y': ...}
            (under a mesh, the rank's ``dp.local_batch_size(B)`` rows)
        :param dp: the mesh the step was built with (``dp=`` of its
            builder), or None for one device
        :param summary_image_fn: fn(ts) -> [N,H,W,C] images for the final
            summary (my_sngan.py:459-463)
        :param steps_per_call: K > 1 runs K steps per CUDA graph launch
            (``_train_multi``), with any update schedule
        """
        if steps_per_call > 1 and self.debug_mode is not None:
            return self._train_multi(train_step, ts, data_iter, max_step, step_per_epoch,
                                     summary_image_fn, steps_per_call, force_print, dp)
        if self.debug_mode is None:
            print(model_description or "Agent: debug_mode=None, nothing to run.")
            return ts
        if self.debug_mode:
            max_step = min(max_step, self.debug_step)
        ts = self._use_mesh(dp, ts, train_step)
        if self.load_ckpt:
            ts = self.restore(ts)

        start_step = int(ts.step)
        host_rng = np.random.RandomState(start_step + 12345)
        mmd_average = 0.0
        start = time.time()
        device_it = prefetch(data_iter, ts.step.device, size=2)
        with _Trace(self.do_trace, ts.step.device, self.summary_folder) as trace, \
                _PreemptionGuard(self.handle_preemption) as guard:
            for local_step in range(max_step):
                global_step = start_step + local_step
                with spans.span("agent.feed_wait"):
                    batch = next(device_it)
                do_dis, do_gen = self._update_flags(global_step, mmd_average, host_rng)
                trace.start(local_step >= max_step - 5)
                ts, metrics = train_step(ts, batch, do_dis, do_gen)
                s = global_step + 1
                if (s % self.nan_check_step == 0 or s % self.query_step == 0
                        or local_step == max_step - 1 or self.imbalanced_update == "dynamic"):
                    checked = self._check(ts, s, metrics, take_last=False)
                    if checked is None:
                        return ts
                    vals, hists = checked
                    mmd_average = 0.99 * mmd_average + 0.01 * vals["loss_gen"]
                    if s % self.query_step == 0 or local_step == max_step - 1:
                        self._report(ts, s, vals, hists, local_step + 1, start,
                                     step_per_epoch, force_print)
                if guard.requested:
                    break
        return self._finish(ts, max_step, start, summary_image_fn)

    def _train_multi(self, train_step, ts, data_iter, max_step, step_per_epoch,
                     summary_image_fn, k, force_print, dp=None) -> TrainState:
        """K steps per CUDA graph launch (``graph_steps``), then the steps
        below one window singly (``mmdgan_tpu/train/trainer.py:396-507``).
        An imbalanced schedule runs in ``imbalanced_scan`` windows, whose
        flags come from the step count or, for ``'dynamic'``, from a
        generator seeded ``start_step + 98765`` and an average of loss_gen
        on the device, both made anew by every call (the reference's
        average restarts with each run); the remainder's flags are decided
        on the host from that average."""
        if self.debug_mode:
            max_step = min(max_step, self.debug_step)
        iu = self.imbalanced_update
        window = (id(train_step), k, tuple(iu) if isinstance(iu, (list, tuple)) else iu)
        if window not in self._windows:
            self._windows[window] = (train_step, graph_steps(train_step, k) if iu is None
                                     else imbalanced_scan(train_step, k, iu))
        multi = self._windows[window][1]
        ts = self._use_mesh(dp, ts, train_step)
        if self.load_ckpt:
            ts = self.restore(ts)
        dev = ts.step.device
        start_step = int(ts.step)
        start = time.time()
        num_calls = max_step // k
        remainder = max_step - num_calls * k
        sched_rng = torch.Generator(dev).manual_seed(start_step + 98765)
        mmd_avg = torch.zeros((), device=dev)

        def stacked_host_batches():
            data_it = iter(data_iter)
            while True:
                host = [next(data_it) for _ in range(k)]
                yield {key: (np.stack([b[key] for b in host])
                             if host[0].get(key) is not None else None)
                       for key in host[0]}

        device_it = prefetch(stacked_host_batches(), dev, size=2)
        with _Trace(self.do_trace, dev, self.summary_folder) as trace:
            with _PreemptionGuard(self.handle_preemption) as guard:
                for call in range(num_calls):
                    trace.start(call >= num_calls - 2)
                    with spans.span("agent.feed_wait"):
                        batches = next(device_it)
                    if iu is None:
                        ts, metrics = multi(ts, batches)
                    else:
                        ts, metrics = multi(ts, batches, sched_rng, mmd_avg)
                    if not self._after_window(ts, metrics, start_step, call, num_calls, k,
                                              start, step_per_epoch, force_print):
                        return ts
                    if guard.requested:
                        break
            # the steps below one window run singly, on the rows of the next
            # stacked batch (the prefetch thread owns the host iterator)
            if remainder and not guard.requested:
                trace.start()
                with spans.span("agent.feed_wait"):
                    batches = next(device_it)
                host_rng = np.random.RandomState(start_step + 12345)
                average = float(mmd_avg)
                for i in range(remainder):
                    do_dis, do_gen = self._update_flags(start_step + num_calls * k + i,
                                                        average, host_rng)
                    ts, metrics = train_step(ts, {key: None if v is None else v[i]
                                                  for key, v in batches.items()},
                                             do_dis, do_gen)
        return self._finish(ts, max_step, start, summary_image_fn)

    @spans.spanned("agent.call")
    def train_device_data(
        self,
        model,
        opt_dis,
        opt_gen,
        ts: TrainState,
        data: dict,
        max_step: int,
        step_per_epoch: int,
        batch_size: int,
        steps_per_call: int = 16,
        summary_image_fn=None,
        force_print: bool = False,
        seed: int = 0,
        sample_same_class: bool = False,
        sampling: str = "uniform",
        sampling_seed: Optional[int] = None,
        micro_batches: int = 1,
        dp=None,
    ) -> TrainState:
        """Training over a dataset resident in device memory: ``data``
        ({'x': [N,H,W,C] uint8 or float, 'y': [N, 1] int labels or None},
        e.g. from ``ReadTFRecords.load_all``) is uploaded once, and the
        batches are taken on the device inside each graphed K-step window
        (``build_device_data_step``): no host-to-device copy per step.
        Same guards, summaries and checkpoints as ``train``.

        ``sampling``: ``"uniform"`` (with replacement, indices from a
        generator seeded ``seed + 54321`` per call, as JAX's key) or
        ``"shuffled_epochs"`` (contiguous slices of a dataset permuted at
        every epoch boundary crossed by a window, in place). The
        permutations derive from ``sampling_seed`` (default ``seed``) and
        the epoch alone, so a resumed run replays them bitwise; chunked
        callers that vary ``seed`` pass a fixed ``sampling_seed``. A
        boundary crossed inside a window keeps the previous layout for
        the rest of that window. ``micro_batches`` M > 1 runs the
        accumulated step (``build_grad_accum_step``) in the same windows.

        ``sample_same_class`` draws every batch from one class (labels in
        ``data['y']``; ``mmdgan_tpu/train/trainer.py:535-770`` without the
        mesh): the class tables are built once per call; under
        ``shuffled_epochs`` each window gets its rows of ``class_schedule``
        (from ``sampling_seed``, regenerated from the step a resumed run
        starts at) as device data, and each class walks its own
        without-replacement epochs, permuted on the device.

        ``dp``: a mesh shards the dataset (``build_device_data_step``'s
        ``with_mesh``): ``data`` holds this rank's rows (the multi-process
        contract: each rank loads its own shard), each rank samples
        ``batch_size / N`` of them per step; its class tables index its
        rows, and shuffled epochs permute them by the rank's own stream
        (``EpochPermuter.sharded``)."""
        if self.debug_mode is None:
            print("Agent: debug_mode=None, nothing to run.")
            return ts
        host_y = None if data.get("y") is None else np.asarray(data["y"])
        if sample_same_class and host_y is None:
            raise ValueError("sample_same_class needs labels in data['y']")
        if self.debug_mode:
            max_step = min(max_step, self.debug_step)
        k = steps_per_call
        shuffled = sampling == "shuffled_epochs"
        scheduled = shuffled and sample_same_class
        if sampling_seed is None:
            sampling_seed = seed
        dev = ts.step.device
        ranks = 1 if dp is None else dp.size
        table = counts = None
        if sample_same_class:
            table, counts = same_class_tables(host_y, model.num_class)

        def get_fn(num_steps):
            tkey = None if table is None else (table.tobytes(), counts.tobytes())
            key = (id(model), id(opt_dis), id(opt_gen), num_steps, batch_size, sampling,
                   micro_batches, sample_same_class, tkey,
                   sampling_seed if scheduled else None, id(dp))
            if key not in self._windows:
                fn_ = build_device_data_step(
                    model, opt_dis, opt_gen, num_steps, batch_size,
                    same_class=sample_same_class, class_table=table, class_counts=counts,
                    sampling=sampling, sampler_seed=sampling_seed,
                    micro_batches=micro_batches, device=dev)
                self._windows[key] = ((model, opt_dis, opt_gen, dp),
                                      fn_ if dp is None else fn_.with_mesh(dp))
            return self._windows[key][1]

        fn = get_fn(k)
        ts = self._use_mesh(dp, ts)
        if self.load_ckpt:
            ts = self.restore(ts)
        with spans.span("agent.upload"):
            data_x = torch.tensor(np.asarray(data["x"]), device=dev)   # a copy: permuted in place
            data_y = (None if host_y is None
                      else torch.tensor(host_y.astype(np.int64), device=dev))
        rng = torch.Generator(dev).manual_seed(seed + 54321)
        start_step = int(ts.step)
        start = time.time()
        if shuffled and not scheduled:
            n_batches = data_x.shape[0] // (batch_size // ranks)
            if n_batches < 1:
                raise ValueError(f"{data_x.shape[0]} rows hold no batch of {batch_size // ranks}")
            permuter = (EpochPermuter.single_device(data_x.shape[0], sampling_seed)
                        if dp is None else
                        EpochPermuter.sharded(data_x.shape[0], ranks, sampling_seed, dp.rank))
            # a resumed run jumps straight to its epoch's layout
            permuter.advance(start_step // n_batches, [data_x, data_y])
        if max_step < k:
            k = max_step
            fn = get_fn(k)
        num_calls = max_step // k if k else 0
        remainder = max_step - num_calls * k
        # one global class draw per step, regenerated from the seed: a
        # resumed run continues every class's stream where it stopped
        sched = (class_schedule(model.num_class, start_step + max_step, sampling_seed)
                 if scheduled else None)

        def invoke(fn_, off, n):
            rows = None if sched is None else sched[off:off + n]
            return fn_(ts, data_x, data_y, rng, schedule=rows)

        with _Trace(self.do_trace, dev, self.summary_folder) as trace:
            with _PreemptionGuard(self.handle_preemption) as guard:
                for call in range(num_calls):
                    trace.start(call >= num_calls - 2)
                    if shuffled and not scheduled:
                        permuter.advance((start_step + call * k) // n_batches, [data_x, data_y])
                    ts, metrics = invoke(fn, start_step + call * k, k)
                    if not self._after_window(ts, metrics, start_step, call, num_calls, k,
                                              start, step_per_epoch, force_print):
                        return ts
                    if guard.requested:
                        break
            if remainder and not guard.requested:
                trace.start()
                if shuffled and not scheduled:
                    permuter.advance((start_step + num_calls * k) // n_batches,
                                     [data_x, data_y])
                ts, _ = invoke(get_fn(remainder), start_step + num_calls * k, remainder)
        return self._finish(ts, int(ts.step) - start_step, start, summary_image_fn)

    def _abnormal_save(self, ts, step, vals):
        """Checkpoint on divergence (graph_func.py:948-973)."""
        if self.do_save:
            try:
                self.save(ts, step)
            except Exception as e:  # keep the original error primary
                warnings.warn(f"abnormal_save failed: {e}")
        warnings.warn(f"Abnormal state at step {step}: {vals}")

