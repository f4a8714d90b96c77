"""A reader of TensorFlow's checkpoint V2 bundle, with no TensorFlow: what
``tf.train.load_checkpoint`` gives for the reference's TF1 checkpoints.

A bundle ``<prefix>`` is two kinds of file:

- ``<prefix>.index``: a LevelDB table (table/format.md of LevelDB). Its
  48-byte footer holds the block handles of the metaindex and the index
  block, then the magic number; the index block maps the last key of each
  data block to that block's handle; a block holds prefix-compressed
  entries (shared, unshared and value lengths as varints, the key's
  unshared bytes, the value) and ends with its restart offsets and their
  count; each block is followed by a compression byte and a crc. The
  value under the empty key is the ``BundleHeaderProto``; under each
  tensor's name, its ``BundleEntryProto`` (dtype, shape, shard, offset,
  size, masked crc32c of the bytes), field numbers of
  tensorflow/core/protobuf/tensor_bundle.proto.
- ``<prefix>.data-<shard>-of-<num_shards>``: the tensors' bytes, little
  endian, at the entries' offsets.

TF writes the index uncompressed; a compressed block raises and says so,
as does a string tensor. Every tensor read is held to its crc32c, which
the host library of ``data/native.py`` computes.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from mmdgan_torch.data.tfrecord import _read_varint
from mmdgan_torch.metrics.graph_proto import DT_BFLOAT16, DTYPES, _fields, _signed, parse_shape

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
DT_STRING = 7


@dataclasses.dataclass
class BundleEntry:
    dtype: int = 0
    shape: Tuple[int, ...] = ()
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0
    sliced: bool = False


def parse_entry(buf: bytes) -> BundleEntry:
    e = BundleEntry()
    for field, _, v in _fields(buf):
        if field == 1:
            e.dtype = v
        elif field == 2:
            e.shape = tuple(parse_shape(v))
        elif field == 3:
            e.shard_id = _signed(v)
        elif field == 4:
            e.offset = _signed(v)
        elif field == 5:
            e.size = _signed(v)
        elif field == 6:
            e.crc32c = struct.unpack("<I", v)[0]
        elif field == 7:
            e.sliced = True
    return e


def _handle(buf: bytes, pos: int) -> Tuple[Tuple[int, int], int]:
    """A BlockHandle (offset, size) at ``pos``; returns it and the next pos."""
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def _block(data: bytes, handle: Tuple[int, int], path: str) -> bytes:
    """A block's contents, its trailer checked."""
    offset, size = handle
    if offset + size + 5 > len(data):
        raise ValueError(f"{path}: block at {offset} runs past the end of the file")
    kind = data[offset + size]
    if kind != 0:
        raise NotImplementedError(
            f"{path}: block at {offset} is compressed (type {kind}); only the uncompressed "
            "tables TensorFlow writes are read")
    return data[offset:offset + size]


def _entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of each entry of a block, keys rebuilt from their shared
    prefixes."""
    restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        size, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + size]
        pos += size


class TFBundle:
    """The tensors of a checkpoint bundle, read on demand.

    :param prefix: the checkpoint's prefix (``.../model.ckpt-1000``), or a
        directory, whose ``checkpoint`` file names the latest prefix
    """

    def __init__(self, prefix: str):
        if os.path.isdir(prefix):
            prefix = latest_checkpoint(prefix)
        self.prefix = prefix
        path = prefix + ".index"
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < FOOTER_BYTES:
            raise ValueError(f"{path}: too short for a table footer")
        footer = data[-FOOTER_BYTES:]
        if struct.unpack("<Q", footer[-8:])[0] != TABLE_MAGIC:
            raise ValueError(f"{path}: not a LevelDB table (bad magic number)")
        _, pos = _handle(footer, 0)            # the metaindex: unused
        index, _ = _handle(footer, pos)
        self.entries: Dict[str, BundleEntry] = {}
        self.num_shards = 1
        for _, value in _entries(_block(data, index, path)):
            block, _ = _handle(value, 0)
            for key, entry in _entries(_block(data, block, path)):
                if key == b"":
                    for field, _, v in _fields(entry):
                        if field == 1:
                            self.num_shards = v
                else:
                    self.entries[key.decode()] = parse_entry(entry)
        self._shards: Dict[int, bytes] = {}

    def names(self) -> List[str]:
        return sorted(self.entries)

    def shape_map(self) -> Dict[str, Tuple[int, ...]]:
        return {name: e.shape for name, e in self.entries.items()}

    def _shard(self, shard_id: int) -> bytes:
        if shard_id not in self._shards:
            path = f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"
            with open(path, "rb") as f:
                self._shards[shard_id] = f.read()
        return self._shards[shard_id]

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor ``name``, its bytes checked against the entry's crc32c."""
        from mmdgan_torch.data import native

        e = self.entries[name]
        if e.sliced:
            raise NotImplementedError(f"{name}: partitioned variables are not read")
        if e.dtype == DT_STRING:
            raise NotImplementedError(f"{name}: string tensors are not read")
        raw = self._shard(e.shard_id)[e.offset:e.offset + e.size]
        if len(raw) != e.size:
            raise ValueError(f"{name}: {len(raw)} of its {e.size} bytes in the data file")
        got = _masked(native.crc32c_native(raw))
        if got != e.crc32c:
            raise ValueError(f"{name}: crc32c {got:#010x} of its bytes, the index says "
                             f"{e.crc32c:#010x}: the checkpoint is corrupt")
        if e.dtype == DT_BFLOAT16:
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            return bits.view(np.float32).reshape(e.shape)
        if e.dtype not in DTYPES:
            raise NotImplementedError(f"{name}: tensor dtype {e.dtype} is not read")
        dtype = np.dtype(DTYPES[e.dtype])
        return np.frombuffer(raw, dtype.newbyteorder("<")).astype(dtype).reshape(e.shape)

    def tensors(self) -> Dict[str, np.ndarray]:
        """Every tensor of the bundle, by name."""
        return {name: self.get_tensor(name) for name in self.names()}


def _masked(crc: int) -> int:
    """crc32c's mask (rotate right by 15, add a constant), as TF stores it."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def latest_checkpoint(folder: str) -> str:
    """The prefix named by ``model_checkpoint_path`` in ``<folder>/checkpoint``."""
    with open(os.path.join(folder, "checkpoint")) as f:
        for line in f:
            if line.startswith("model_checkpoint_path:"):
                name = line.split(":", 1)[1].strip().strip('"')
                return name if os.path.isabs(name) else os.path.join(folder, name)
    raise FileNotFoundError(f"no model_checkpoint_path in {folder}/checkpoint")
