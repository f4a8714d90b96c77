"""TFRecord container + tf.Example wire format, dependency-free: the
port's own copy of ``mmdgan_tpu/data/tfrecord.py``.

The reference stores images as raw uint8 bytes under feature key 'x' with
optional int64 labels under 'y' (input_func.py:778-823); the files are
byte for byte those of the JAX package's writer.

- TFRecord framing: [uint64 length][uint32 masked-crc32c(length)]
  [payload][uint32 masked-crc32c(payload)].
- tf.Example protobuf subset: Example > Features > map<string, Feature>,
  Feature = BytesList | FloatList | Int64List.

The JAX package's C++ record reader (``native.py``) is not ported
(ROADMAP A10): this pure-Python reader is the port's only one.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# ---------------------------------------------------------------------------

def _crc_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """Byte-wise table crc32c over Python ints (a tuple lookup per byte)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# protobuf wire helpers (subset needed for tf.Example)
# ---------------------------------------------------------------------------

def _write_varint(out: bytearray, value: int):
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delim(out: bytearray, field: int, payload: bytes):
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


# ---------------------------------------------------------------------------
# tf.Example encode
# ---------------------------------------------------------------------------

FeatureValue = Union[bytes, Sequence[int], Sequence[float], np.ndarray]


def _encode_feature(value: FeatureValue) -> bytes:
    """Feature { BytesList=1 | FloatList=2 | Int64List=3 }."""
    out = bytearray()
    if isinstance(value, (bytes, bytearray)):
        bl = bytearray()
        _write_len_delim(bl, 1, bytes(value))  # BytesList.value = 1
        _write_len_delim(out, 1, bytes(bl))
    else:
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            packed = arr.astype("<f4").tobytes()
            fl = bytearray()
            _write_varint(fl, _tag(1, 2))  # FloatList.value packed
            _write_varint(fl, len(packed))
            fl += packed
            _write_len_delim(out, 2, bytes(fl))
        else:
            il = bytearray()
            body = bytearray()
            for v in arr.astype(np.int64).ravel():
                _write_varint(body, int(v) & 0xFFFFFFFFFFFFFFFF)
            _write_varint(il, _tag(1, 2))  # Int64List.value packed
            _write_varint(il, len(body))
            il += body
            _write_len_delim(out, 3, bytes(il))
    return bytes(out)


def make_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize {'x': raw_bytes, 'y': [label]} into a tf.Example proto."""
    feats = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _write_len_delim(entry, 1, key.encode())        # map key
        _write_len_delim(entry, 2, _encode_feature(value))  # map value
        _write_len_delim(feats, 1, bytes(entry))        # Features.feature
    example = bytearray()
    _write_len_delim(example, 1, bytes(feats))          # Example.features
    return bytes(example)


# ---------------------------------------------------------------------------
# tf.Example decode
# ---------------------------------------------------------------------------

def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _decode_feature(buf: bytes) -> Union[bytes, np.ndarray]:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        ln, pos = _read_varint(buf, pos)
        body = buf[pos:pos + ln]
        pos += ln
        if field == 1:  # BytesList
            p2 = 0
            vals = []
            while p2 < len(body):
                t2, p2 = _read_varint(body, p2)
                l2, p2 = _read_varint(body, p2)
                vals.append(body[p2:p2 + l2])
                p2 += l2
            return vals[0] if len(vals) == 1 else vals
        if field == 2:  # FloatList
            p2 = 0
            vals = []
            while p2 < len(body):
                t2, p2 = _read_varint(body, p2)
                f2, w2 = t2 >> 3, t2 & 7
                if w2 == 2:  # packed
                    l2, p2 = _read_varint(body, p2)
                    vals.append(np.frombuffer(body, "<f4", count=l2 // 4, offset=p2))
                    p2 += l2
                else:  # unpacked float
                    vals.append(np.frombuffer(body, "<f4", count=1, offset=p2))
                    p2 += 4
            return np.concatenate(vals) if vals else np.zeros(0, np.float32)
        if field == 3:  # Int64List
            p2 = 0
            vals = []
            while p2 < len(body):
                t2, p2 = _read_varint(body, p2)
                w2 = t2 & 7
                if w2 == 2:  # packed
                    l2, p2 = _read_varint(body, p2)
                    end = p2 + l2
                    while p2 < end:
                        v, p2 = _read_varint(body, p2)
                        vals.append(np.int64(np.uint64(v).astype(np.int64)))
                else:
                    v, p2 = _read_varint(body, p2)
                    vals.append(np.int64(np.uint64(v).astype(np.int64)))
            return np.asarray(vals, np.int64)
    raise ValueError("empty Feature")


def parse_example(buf: bytes) -> Dict[str, Union[bytes, np.ndarray]]:
    """Parse a serialized tf.Example into {key: bytes | ndarray}."""
    out: Dict[str, Union[bytes, np.ndarray]] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # Example.features
            ln, pos = _read_varint(buf, pos)
            feats = buf[pos:pos + ln]
            pos += ln
            p1 = 0
            while p1 < len(feats):
                t1, p1 = _read_varint(feats, p1)
                l1, p1 = _read_varint(feats, p1)
                entry = feats[p1:p1 + l1]
                p1 += l1
                # map entry: key=1 (string), value=2 (Feature)
                key = None
                val = None
                p2 = 0
                while p2 < len(entry):
                    t2, p2 = _read_varint(entry, p2)
                    f2, w2 = t2 >> 3, t2 & 7
                    l2, p2 = _read_varint(entry, p2)
                    if f2 == 1:
                        key = entry[p2:p2 + l2].decode()
                    elif f2 == 2:
                        val = _decode_feature(entry[p2:p2 + l2])
                    p2 += l2
                if key is not None:
                    out[key] = val
        else:
            pos = _skip_field(buf, pos, wire)
    return out


# ---------------------------------------------------------------------------
# record-level IO
# ---------------------------------------------------------------------------

class TFRecordWriter:
    """Write TFRecord files compatible with tf.data readers."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def write_example(self, features: Dict[str, FeatureValue]):
        self.write(make_example(features))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class TFRecordReader:
    """Iterate raw records of a TFRecord file (no crc verification by
    default — matches tf.data's default)."""

    def __init__(self, path: str, verify_crc: bool = False):
        self.path = path
        self.verify_crc = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    return
                (length,) = struct.unpack("<Q", header)
                crc_h = f.read(4)
                payload = f.read(length)
                crc_p = f.read(4)
                if len(payload) < length or len(crc_p) < 4:
                    raise EOFError(f"truncated record in {self.path}")
                if self.verify_crc:
                    if struct.unpack("<I", crc_h)[0] != masked_crc32c(header):
                        raise ValueError(f"bad header crc in {self.path}")
                    if struct.unpack("<I", crc_p)[0] != masked_crc32c(payload):
                        raise ValueError(f"bad payload crc in {self.path}")
                yield payload

    def examples(self) -> Iterator[Dict[str, Union[bytes, np.ndarray]]]:
        for record in self:
            yield parse_example(record)


def np_to_tfrecords(x: np.ndarray, y, out_path: str) -> str:
    """Write an [N, ...] uint8 array (+ optional int labels) as
    ``<out_path>.tfrecords``, one example per row: its raw bytes under 'x',
    its label under 'y' (``mmdgan_tpu/data/converters.py:33``, one shard).
    Returns the file's path."""
    if x.dtype != np.uint8:
        raise TypeError("the reference format stores raw uint8 bytes")
    path = f"{out_path}.tfrecords"
    with TFRecordWriter(path) as w:
        for i in range(x.shape[0]):
            feats = {"x": x[i].tobytes()}
            if y is not None:
                feats["y"] = np.asarray([int(y[i])], np.int64)
            w.write_example(feats)
    return path
