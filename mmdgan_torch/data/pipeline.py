"""ReadTFRecords: the training input pipeline, the port's own pure-numpy
copy of ``mmdgan_tpu/data/pipeline.py:44-333`` (``input_func.py:721-965``):

  parse tf.Example -> decode raw uint8 -> float32 -> x/127.5 - 1
  -> reshape NHWC -> [skip] -> shuffle(buffer) -> batch -> repeat
  (-> same-class batching via a per-class queue, the group_by_window
   equivalent, input_func.py:905-916)

A background thread decodes and batches ahead (``prefetch.background``).
``shape2image(..., resize=(h, w))`` resizes on the host with the
align-corners bilinear matrices of ``models/scaling.py`` (float batches
only, as in JAX). ``shard`` restricts a pipeline to one rank's share of
the records (the mesh's per-process feeding).

Records are read by the host library of ``data/native.py`` (``use_native``,
the default, as in JAX), or by the Python codec of ``data/tfrecord.py``
with ``use_native=False``; both give bitwise-equal batches. Where JAX falls
back to the Python codec when the library does not build
(``mmdgan_tpu/data/pipeline.py:132-143``), the port raises: a reader
quietly many times slower is a fault to see, not to hide (ROADMAP C7).
"""

from __future__ import annotations

import os
from random import shuffle as list_shuffle
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from mmdgan_torch.data.prefetch import background
from mmdgan_torch.data.tfrecord import TFRecordReader, parse_example
from mmdgan_torch.models.scaling import resize_matrix


def _resolve_filenames(filename, file_folder, file_repeat, shuffle_file):
    if isinstance(filename, str):
        names = [os.path.join(file_folder, filename + ".tfrecords")]
    else:
        names = [os.path.join(file_folder, f + ".tfrecords") for f in filename]
    for f in names:
        if not os.path.isfile(f):
            raise FileNotFoundError(f"File {f} does not exist.")
    if file_repeat > 1:
        names = names * int(file_repeat)
    if shuffle_file:
        list_shuffle(names)
    return names


class ReadTFRecords:
    def __init__(
        self,
        filename: Union[str, Sequence[str]],
        num_features: Optional[int] = None,
        num_labels: int = 0,
        batch_size: int = 64,
        skip_count: int = 0,
        file_repeat: int = 1,
        num_epoch: Optional[int] = None,
        file_folder: Optional[str] = None,
        buffer_size: int = 10000,
        shuffle_file: bool = False,
        seed: Optional[int] = 0,
        use_native: bool = True,
        device_decode: bool = False,
    ):
        """:param filename: base name(s); '.tfrecords' appended
        (input_func.py:748-758)."""
        if file_folder is None:
            from mmdgan_torch.config import get_config
            file_folder = get_config().data_dir
        self.filenames = _resolve_filenames(filename, file_folder, file_repeat, shuffle_file)
        self.num_features = num_features
        self.num_labels = num_labels
        self.batch_size = batch_size
        self.skip_count = skip_count
        self.num_epoch = num_epoch
        self.buffer_size = buffer_size
        self.rng = np.random.RandomState(seed)
        self.use_native = use_native
        # device_decode: emit uint8 batches (reshaped/transposed only) and
        # let the device do x/127.5-1 (the train step decodes uint8
        # batches, the same float32 op): 4x fewer bytes to the device
        self.device_decode = device_decode
        # one rank's share (shard): (num_shards, shard_index) or None
        self._shard: Optional[tuple] = None
        # image shaping (shape2image, input_func.py:826-868)
        self._image_shape: Optional[tuple] = None
        self.batch_shape = [batch_size, num_features]

    def shard(self, num_shards: Optional[int] = None,
              shard_index: Optional[int] = None) -> "ReadTFRecords":
        """Restrict this pipeline to one rank's shard of the dataset
        (``mmdgan_tpu/data/pipeline.py:89-113``). Defaults to the process
        group's world size and rank (1 and 0 outside a group). With at
        least ``num_shards`` files the split is per file (disjoint files
        per rank); otherwise records are dealt round-robin (every rank
        reads all bytes and keeps 1/num_shards of the records). Pair with
        ``batch_size = DataParallel.local_batch_size(global_batch)``."""
        if num_shards is None or shard_index is None:
            import torch.distributed as dist

            joined = dist.is_available() and dist.is_initialized()
            num_shards = dist.get_world_size() if joined else 1
            shard_index = dist.get_rank() if joined else 0
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        if num_shards == 1:
            return self
        if len(self.filenames) >= num_shards:
            self.filenames = self.filenames[shard_index::num_shards]
        else:
            self._shard = (num_shards, shard_index)
        return self

    def shape2image(self, channels: int, height: int, width: int, resize=None,
                    transpose: bool = False):
        """Declare that x holds a C,H,W uint8 image; batches come out NHWC,
        the layout of the port's public functions.

        :param transpose: swap H and W (the reference's image_transpose
            for datasets like MNIST, my_sngan.py:72-78, :358-359).
        :param resize: (h, w) to resize each image to on the host
            (input_func.py:846-850, tf.image.resize_images with
            align_corners=True); not with ``device_decode``.
        """
        if resize is not None and self.device_decode:
            raise ValueError("device_decode does not support host-side resize; "
                             "use device_decode=False for resized pipelines")
        self._resize = None if resize is None else tuple(resize)
        self._image_shape = (channels, height, width)
        self._transpose_hw = transpose
        self.batch_shape = [self.batch_size, height, width, channels]
        return self

    # ------------------------------------------------------------------
    def _iter_raw(self) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over all files (of this rank's shard), yielding decoded
        examples."""
        records = lambda path: map(parse_example, TFRecordReader(path))
        if self.use_native:
            from mmdgan_torch.data import native
            try:
                native.get_lib()
            except Exception as e:
                raise RuntimeError(
                    f"the native record reader did not build ({e}); pass use_native=False "
                    "for the Python reader") from e
            # the read buffer sized from the known record size
            capacity = None
            if self._image_shape is not None:
                capacity = int(np.prod(self._image_shape)) + 256
            elif self.num_features is not None:
                capacity = self.num_features * 8 + 256
            records = lambda path: native.NativeRecordIterator(path, capacity=capacity)
        i = 0
        for path in self.filenames:
            for record in records(path):
                if self._shard is not None:
                    n, k = self._shard
                    keep = i % n == k
                    i += 1
                    if not keep:
                        continue
                yield self._decode(record)

    def _decode(self, ex: Dict) -> Dict[str, np.ndarray]:
        x = ex["x"]
        if isinstance(x, (bytes, bytearray)):  # raw uint8 payload
            x = np.frombuffer(x, np.uint8)
        out = {"x": x}
        if self.num_labels > 0:
            y = ex.get("y")
            if isinstance(y, (bytes, bytearray)):
                y = np.frombuffer(y, np.uint8).astype(np.int32)
            else:
                y = np.asarray(y, np.int64).astype(np.int32)
            out["y"] = y[: self.num_labels]
        return out

    def _shape_x(self, x: np.ndarray) -> np.ndarray:
        """CHW uint8 -> HWC, scaled to float32 in [-1, 1] unless
        ``device_decode`` (input_func.py:826-868)."""
        if self._image_shape is None:
            x = x.astype(np.float32)
            return x if self.num_features is None else x.reshape(self.num_features)
        x = x.reshape(self._image_shape).transpose(1, 2, 0)
        if self._transpose_hw:
            x = x.transpose(1, 0, 2)  # swap H and W (image_transpose)
        if self.device_decode:
            return x
        x = x.astype(np.float32) / 127.5 - 1.0
        if self._resize is not None:
            wh = resize_matrix(x.shape[0], self._resize[0], "linear")
            ww = resize_matrix(x.shape[1], self._resize[1], "linear")
            x = np.einsum("pw,owc->opc", ww, np.einsum("oh,hwc->owc", wh, x))
        return x

    # ------------------------------------------------------------------
    def _sample_stream(self) -> Iterator[Dict[str, np.ndarray]]:
        """skip -> shuffle-buffer -> repeat (scheduler, input_func.py:871-928)."""
        epoch = 0
        buf: List[Dict[str, np.ndarray]] = []
        while self.num_epoch is None or epoch < self.num_epoch:
            # dataset.skip() precedes repeat() in the reference
            # (input_func.py:871-928), so the first skip_count records are
            # held out EVERY epoch, not just the first pass.
            skipped = 0
            for ex in self._iter_raw():
                if skipped < self.skip_count:
                    skipped += 1
                    continue
                if self.buffer_size > 1:
                    buf.append(ex)
                    if len(buf) >= self.buffer_size:
                        idx = self.rng.randint(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        yield buf.pop()
                else:
                    yield ex
            epoch += 1
        # drain the buffer at end of finite epochs
        self.rng.shuffle(buf)
        yield from buf

    def _batches(self, sample_same_class: bool) -> Iterator[Dict[str, np.ndarray]]:
        stream = self._sample_stream()
        if sample_same_class and self.num_labels > 0:
            # group_by_window equivalent: queue per class, emit full batches
            class_queues: Dict[int, list] = {}
            for ex in stream:
                cls = int(ex["y"][0])
                q = class_queues.setdefault(cls, [])
                q.append(ex)
                if len(q) >= self.batch_size:
                    yield self._stack(q[: self.batch_size])
                    del q[: self.batch_size]
        else:
            batch = []
            for ex in stream:
                batch.append(ex)
                if len(batch) == self.batch_size:
                    yield self._stack(batch)
                    batch = []

    def _stack(self, examples) -> Dict[str, np.ndarray]:
        xs = np.stack([self._shape_x(e["x"]) for e in examples])
        out = {"x": xs}
        if self.num_labels > 0:
            out["y"] = np.stack([e["y"] for e in examples]).astype(np.int32)
        else:
            out["y"] = None
        return out

    def load_all(self, limit: Optional[int] = None) -> Dict[str, Optional[np.ndarray]]:
        """Materialize the whole dataset (one pass, file order) as numpy
        arrays, for a dataset resident in device memory
        (``build_device_data_step``): uploaded once, sampled on the device.
        Images come back uint8 NHWC when ``device_decode`` (4x less device
        memory), else f32 in [-1, 1]."""
        xs, ys = [], []
        for ex in self._iter_raw():
            xs.append(self._shape_x(ex["x"]))
            if self.num_labels > 0:
                ys.append(ex["y"])
            if limit is not None and len(xs) >= limit:
                break
        out = {"x": np.stack(xs), "y": None}
        if ys:
            out["y"] = np.stack(ys).astype(np.int32)
        return out

    def next_batch(
        self, sample_same_class: bool = False, prefetch: int = 4
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Iterator of host batches, decoded ``prefetch`` ahead in a
        background thread."""
        return background(self._batches(sample_same_class), prefetch)
