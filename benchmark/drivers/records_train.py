"""Host-fed training from CIFAR-format records, as the CLI runs it without
``--device-dataset``: seeded CIFAR-10 binary records (a label byte, then
3072 CHW bytes) converted in set-up by ``data/converters.py``
``binary_image_to_tfrecords``, read by ``ReadTFRecords`` through the
native reader (``csrc/tfrec.cc``) with uint8 batches decoded on the card,
fed through the Agent's prefetcher into ``Agent.train`` with graphed
K-step windows of ``build_train_step``.

The benchmark hands the Agent its own iterator over the reader's batches
(``Feed``): it times each ``next()`` (the reader's batches not yet there
when the Agent's feeding thread asks) and keeps the batches the check
needs. The check's steps run through the window's own agent, step and
feed: single-step calls of ``Agent.train``, one of one step (on the first
batch it takes; Adam's slots after it give the first gradient) and one of
two, then one call of ``warm_steps[0]`` steps in K-step windows, the
window function the timed call replays, on the batches it takes in
order. That call is also the first warming call: its graphs are captured
there and kept for the window (the Agent keeps a host-fed window's graphs across calls). After
the window, every kept batch (the check's and every ``keep_every``-th of
the window) is held row by row to the seeded bytes, and the reference
follows the check's steps on their rows.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Iterator

import numpy as np
import torch

from benchmark import trace
from benchmark.drivers import _port
from benchmark.drivers.device_train import _metrics
from benchmark.harness import compare
from benchmark.reference import check, mmdgan


class Feed:
    """The iterator handed to ``Agent.train``: the reader's batches, the
    seconds each ``next()`` waited, and the batches kept by index."""

    def __init__(self, batches: Iterator[Dict]):
        self._it = batches
        self.count = 0
        self.wait_s = 0.0
        self.keep_every = 0
        self.kept: Dict[int, np.ndarray] = {}

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        start = time.perf_counter()
        batch = next(self._it)
        self.wait_s += time.perf_counter() - start
        if self.keep_every and self.count % self.keep_every == 0:
            self.kept[self.count] = batch["x"].copy()
        self.count += 1
        return batch


def write_records(images_chw: np.ndarray, labels: np.ndarray, folder: str) -> str:
    """CIFAR-10's binary format: per record a label byte, then the CHW
    pixel bytes."""
    path = os.path.join(folder, "data_batch.bin")
    np.concatenate([labels[:, None], images_chw.reshape(len(images_chw), -1)], axis=1).tofile(path)
    return path


def row_key(chw: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(chw).tobytes(), digest_size=16).digest()


def reader_misses(kept: Dict[int, np.ndarray], images_chw: np.ndarray) -> int:
    """Rows of the kept NHWC uint8 batches that are no seeded record."""
    known = {row_key(img) for img in images_chw}
    return sum(row_key(row.transpose(2, 0, 1)) not in known
               for batch in kept.values() for row in batch)


def run(r) -> None:
    from mmdgan_torch.data.converters import binary_image_to_tfrecords
    from mmdgan_torch.data.pipeline import ReadTFRecords
    from mmdgan_torch.train.step import build_train_step, init_train_state
    from mmdgan_torch.train.trainer import Agent

    cfg, mix = r.cfg, r.mix
    dev = torch.device(r.device)
    s = _port.seeds(r.seed)
    b, k = cfg["batch_size"], mix["steps_per_call"]
    rows = cfg["dataset"]["rows"]
    h, w, c = cfg["dataset"]["shape_hwc"]
    specs = mmdgan.leaf_specs(cfg["architecture"])
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        with r.spans("setup.model", sync=r.sync):
            model, opt_d, opt_g = _port.build(cfg, dev)
            ts = init_train_state(model, s["init"], opt_d, opt_g, device=dev)
            state0 = _port.make_state(cfg, specs, s["weights"], dev)
            _port.write_state(ts, state0)
            ts.rng.manual_seed(s["z"])
            step = build_train_step(model, opt_d, opt_g, device=dev)
        with r.spans("setup.records", sync=r.sync):
            images = _port.make_images([rows, c, h, w], s["data"], dev)
            labels = np.random.default_rng(s["data"]).integers(0, 10, rows, dtype=np.uint8)
            binary = write_records(images, labels, tmp)
            binary_image_to_tfrecords([binary], os.path.join(tmp, "records"), rows, (c, h, w),
                                      save_label=False)
            os.remove(binary)
            reader = ReadTFRecords("records", batch_size=b, file_repeat=mix["file_repeat"],
                                   file_folder=tmp, use_native=True, device_decode=True)
            feed = Feed(reader.shape2image(c, h, w).next_batch())
        kw = dict(step_per_epoch=rows // b)

        agent = Agent("bench", "run", do_save=False, output_dir=tmp, use_tensorboard=False)
        check_steps = mix["warm_steps"][0]
        with r.spans("setup.check", sync=r.sync):
            feed.keep_every = 1
            first = feed.count
            ts = agent.train(step, ts, feed, max_step=1, steps_per_call=1, **kw)
            mu1 = {n: _port.leaf(ts, n, "mu").detach().to("cpu", torch.float32, copy=True)
                   for n, v in specs.items() if v["group"] == "param"}
            second = feed.count
            ts = agent.train(step, ts, feed, max_step=2, steps_per_call=1, **kw)
            state3 = _port.read_state(ts, specs)
        with r.spans("setup.capture", sync=r.sync):
            third = feed.count
            ts = agent.train(step, ts, feed, max_step=check_steps, steps_per_call=k, **kw)
        with r.spans("setup.check", sync=r.sync):
            feed.keep_every = 0
            state_end = _port.read_state(ts, specs)
            reported = _metrics(agent.writer.jsonl_path)
            check_rows = [feed.kept[i] for i in [first, second, second + 1]
                          + list(range(third, third + check_steps))]
        with r.spans("setup.rate", sync=r.sync):
            ts = agent.train(step, ts, feed, max_step=mix["warm_steps"][1], steps_per_call=k,
                             **kw)
        rate = mix["warm_steps"][1] / r.spans.seconds["setup.rate"]

        start_step, wait0, start_batch = int(ts.step), feed.wait_s, feed.count
        feed.keep_every = mix["keep_every"]
        if r.trace:
            windows = mix["trace_windows"] + 3
            r.setup_done()
            with trace.profiler(dev) as prof:
                ts = agent.train(step, ts, feed, max_step=windows * k, steps_per_call=k, **kw)
                r.sync()
            device_events, host_events = trace.activities(prof)
            r.stretch = trace.graph_stretch(device_events, host_events, 1,
                                            mix["trace_windows"], k)
            if r.stretch is None:
                print("benchmark: no stretch of replayed windows in the trace", file=sys.stderr)
        else:
            max_step = max(k, int(round(r.seconds * rate / k)) * k)
            r.setup_done()
            r.sync()
            t0 = time.perf_counter()
            ts = agent.train(step, ts, feed, max_step=max_step, steps_per_call=k, **kw)
            r.sync()
            seconds = time.perf_counter() - t0
        steps = int(ts.step) - start_step
        r.attempted = steps
        r.counters["data_wait_s_per_step"] = (feed.wait_s - wait0) / max(steps, 1)
        if not r.trace:
            _port.report_train(r, steps, seconds)
        window_rows = {i: x for i, x in feed.kept.items() if i >= start_batch}

        del agent, ts, model, opt_d, opt_g, step, feed, reader
        _port.release(r, dev)
        misses = reader_misses({**dict(enumerate(check_rows)), **window_rows}, images)
        gz = torch.Generator(dev).manual_seed(s["z"])
        code = cfg["architecture"]["code"][0][0]
        batches = np.stack(check_rows)
        draws = [(i, torch.randn(b, code, generator=gz, device=dev))
                 for i in range(len(check_rows))]
        end = check.START + check_steps
        program = ({i: reported[i] for i in (1, check.START, end)}, mu1,
                   {check.START: state3, end: state_end})
        reference = check.follow(cfg, specs, state0, batches, draws, dev)
        compare(r, {"reader_misses": misses,
                    **check.train_gaps(cfg, specs, state0, program, reference)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
