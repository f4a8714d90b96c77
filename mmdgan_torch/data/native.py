"""ctypes bindings of the port's host record reader (``csrc/tfrec.cc``), the
counterpart of ``mmdgan_tpu/data/native.py``.

``get_lib`` builds the library with g++ at first use (``ops/_build.py``:
``build/`` or the compilation cache, named by a hash of the source and
flags) and loads it; importing this module builds nothing. The records are
byte for byte those of ``data/tfrecord.py``'s Python codec, which the
pipeline keeps behind ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from mmdgan_torch.ops import _build

SOURCE = "tfrec.cc"
_U8P = ctypes.POINTER(ctypes.c_uint8)
_lib = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if its file is missing; raises when
    it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        lib.tfrec_open.restype = ctypes.c_void_p
        lib.tfrec_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tfrec_close.argtypes = [ctypes.c_void_p]
        lib.tfrec_read_batch.restype = ctypes.c_int
        lib.tfrec_read_batch.argtypes = [
            ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.tfrec_writer_open.restype = ctypes.c_void_p
        lib.tfrec_writer_open.argtypes = [ctypes.c_char_p]
        lib.tfrec_write_batch.restype = ctypes.c_int64
        lib.tfrec_write_batch.argtypes = [
            ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.tfrec_writer_close.restype = ctypes.c_int
        lib.tfrec_writer_close.argtypes = [ctypes.c_void_p]
        lib.tfrec_crc32c.restype = ctypes.c_uint32
        lib.tfrec_crc32c.argtypes = [_U8P, ctypes.c_int64]
        lib.tfrec_masked_crc32c.restype = ctypes.c_uint32
        lib.tfrec_masked_crc32c.argtypes = [_U8P, ctypes.c_int64]
        _lib = lib
        return lib


class NativeReader:
    """Bulk reader: fills the caller's batch buffers in one C call."""

    def __init__(self, path: str, verify_crc: bool = False):
        self.lib = get_lib()
        self.handle = self.lib.tfrec_open(path.encode(), int(verify_crc))
        if not self.handle:
            raise IOError(f"tfrec_open failed for {path}")
        self.path = path

    def read_batch(self, batch: int, x_capacity: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x [n, x_capacity] uint8, x_lens [n] int64, y [n] int32, -1 where
        a record has no label); n < batch at the end of the file."""
        x = np.empty((batch, x_capacity), np.uint8)
        lens = np.empty(batch, np.int64)
        y = np.empty(batch, np.int32)
        n = self.lib.tfrec_read_batch(
            self.handle, x.ctypes.data_as(_U8P), x_capacity,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), batch)
        if n < 0:
            raise IOError(f"native tfrecord parse error in {self.path}")
        return x[:n], lens[:n], y[:n]

    def close(self):
        if self.handle:
            self.lib.tfrec_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeRecordIterator:
    """The decoded examples of one file, ``{'x': bytes, 'y': int64 [1]}``
    (no 'y' for an unlabelled record), read ``BULK`` at a time.

    The read buffer starts at ``capacity`` bytes per record (the pipeline
    passes the known record size); a larger record doubles it and the file
    is read again from the start, skipping what was already yielded. The
    records of one dataset are near one size, so that happens at most once.
    """

    DEFAULT_CAPACITY = 64 << 10
    BULK = 256

    def __init__(self, path: str, verify_crc: bool = False, capacity: Optional[int] = None):
        self.path = path
        self.verify_crc = verify_crc
        self.capacity = capacity or self.DEFAULT_CAPACITY

    def __iter__(self):
        yielded = 0
        while True:
            reader = NativeReader(self.path, self.verify_crc)
            try:
                to_skip = yielded
                while to_skip > 0:
                    x, _, _ = reader.read_batch(min(self.BULK, to_skip), self.capacity)
                    if len(x) == 0:
                        return
                    to_skip -= len(x)
                while True:
                    x, lens, y = reader.read_batch(self.BULK, self.capacity)
                    if len(x) == 0:
                        return
                    longest = int(lens.max())
                    if longest > self.capacity:
                        while self.capacity < longest:
                            self.capacity *= 2
                        break   # read again with the larger buffer
                    # shrink toward the records' size: a large buffer costs
                    # allocation bandwidth on every bulk read
                    self.capacity = max(2 * longest, 4096)
                    for i in range(len(x)):
                        out = {"x": x[i, :int(lens[i])].tobytes()}
                        if y[i] >= 0:
                            out["y"] = np.asarray([y[i]], np.int64)
                        yield out
                        yielded += 1
            finally:
                reader.close()


class NativeWriter:
    """Bulk writer: n examples per C call, byte-identical to
    ``TFRecordWriter.write_example({'x': ..., 'y': [...]})``."""

    def __init__(self, path: str):
        self.lib = get_lib()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.handle = self.lib.tfrec_writer_open(path.encode())
        if not self.handle:
            raise IOError(f"tfrec_writer_open failed for {path}")
        self.path = path

    def write_batch(self, x: np.ndarray, y: Optional[np.ndarray] = None):
        """x: [n, bytes_per_record] uint8, one record's raw bytes per row;
        y: optional [n] int64 labels."""
        x = np.ascontiguousarray(x, np.uint8)
        if x.ndim != 2:
            raise ValueError("x must be [n, bytes_per_record]")
        y_ptr = None
        if y is not None:
            y = np.ascontiguousarray(y, np.int64).ravel()
            if len(y) != len(x):
                raise ValueError(f"{len(y)} labels for {len(x)} records")
            y_ptr = y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        n = self.lib.tfrec_write_batch(self.handle, x.ctypes.data_as(_U8P), x.shape[1],
                                       x.shape[0], y_ptr)
        if n != len(x):
            raise IOError(f"native tfrecord write error in {self.path}")

    def close(self):
        if self.handle:
            rc = self.lib.tfrec_writer_close(self.handle)
            self.handle = None
            if rc != 0:
                raise IOError(f"close failed for {self.path}")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def crc32c_native(data: bytes) -> int:
    """crc32c (Castagnoli) of ``data``, computed by the library."""
    arr = np.frombuffer(bytes(data), np.uint8)
    if len(arr) == 0:
        arr = np.zeros(1, np.uint8)
    return get_lib().tfrec_crc32c(arr.ctypes.data_as(_U8P), len(data))
