"""A writer of TensorFlow's GraphDef protobuf, dependency-free: the
counterpart of ``graph_proto.py``'s reader, for graphs the port builds
itself (``tools/make_fake_inception.py``).

A graph is a list of :class:`Node` (name, op, inputs, attributes) and the
``versions.producer`` it claims. An attribute is one of AttrValue's
``oneof`` members, written as ``(kind, value)`` with kind ``"list"`` (a
``list.i`` of ints), ``"s"`` (str or bytes), ``"i"``, ``"f"``, ``"b"``,
``"type"`` (a ``types.proto`` DataType number) or ``"tensor"`` (a numpy
array or scalar).

The bytes are those of protobuf's ``SerializeToString(deterministic=True)``:
fields in field-number order, packed repeated scalars, a oneof member
written even at its default, a map's entries in that
method's key order (``map_key_order``) with both key and value present,
and tensors laid out as ``tf.make_tensor_proto`` lays them out (``tensor_content`` for more than one element, else the typed
value field; the shape always present).

Field numbers are those of tensorflow/core/framework/{graph, node_def,
attr_value, tensor, tensor_shape, types, versions}.proto.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mmdgan_torch.data.tfrecord import _write_varint

DT_FLOAT, DT_INT32 = 1, 3
_NUMPY_TYPES = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int32): DT_INT32}


@dataclasses.dataclass
class Node:
    name: str
    op: str
    input: List[str] = dataclasses.field(default_factory=list)
    attr: Dict[str, Tuple[str, object]] = dataclasses.field(default_factory=dict)


def _map_key_cmp(a: bytes, b: bytes) -> int:
    """The order of a map's string keys in deterministic serialization:
    bytewise ascending, except that a key comes after every longer key it
    is a prefix of ("Tidx" before "T"). That is what protobuf's upb
    runtime writes: it sorts as ``std::string::compare`` does and fills
    its buffer back to front, so a prefix tie comes out longest first."""
    n = min(len(a), len(b))
    if a[:n] != b[:n]:
        return -1 if a[:n] < b[:n] else 1
    return len(b) - len(a)


map_key_order = functools.cmp_to_key(lambda a, b: _map_key_cmp(a.encode(), b.encode()))


def _varint(field: int, value: int) -> bytes:
    out = bytearray()
    _write_varint(out, field << 3)
    _write_varint(out, value & 0xFFFFFFFFFFFFFFFF)   # int64: two's complement
    return bytes(out)


def _delimited(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    return bytes(out) + payload


def _packed_varints(field: int, values: Sequence[int]) -> bytes:
    if not len(values):
        return b""
    out = bytearray()
    for v in values:
        _write_varint(out, int(v) & 0xFFFFFFFFFFFFFFFF)
    return _delimited(field, bytes(out))


def encode_tensor(value) -> bytes:
    """A TensorProto of a float32 or int32 array, as ``make_tensor_proto``
    writes it: dtype (1), tensor_shape (2, dims as Dim.size), then
    tensor_content (4) for more than one element, else float_val (5,
    packed) or int_val (7, packed)."""
    arr = np.asarray(value)
    dtype = _NUMPY_TYPES[arr.dtype]
    shape = b"".join(_delimited(2, _varint(1, d) if d else b"") for d in arr.shape)
    out = _varint(1, dtype) + _delimited(2, shape)
    if arr.size > 1:
        return out + _delimited(4, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    if dtype == DT_FLOAT:
        return out + _delimited(5, struct.pack("<f", float(arr.reshape(-1)[0])))
    return out + _packed_varints(7, [int(arr.reshape(-1)[0])])


def encode_attr(kind: str, value) -> bytes:
    """An AttrValue with one oneof member set."""
    if kind == "list":
        return _delimited(1, _packed_varints(3, value))
    if kind == "s":
        return _delimited(2, value.encode() if isinstance(value, str) else bytes(value))
    if kind == "i":
        return _varint(3, int(value))
    if kind == "f":
        return (4 << 3 | 5).to_bytes(1, "little") + struct.pack("<f", float(value))
    if kind == "b":
        return _varint(5, int(bool(value)))
    if kind == "type":
        return _varint(6, int(value))
    if kind == "tensor":
        return _delimited(8, encode_tensor(value))
    raise ValueError(f"GraphDef writer: attribute kind {kind!r} is not supported")


def encode_node(node: Node) -> bytes:
    out = _delimited(1, node.name.encode()) + _delimited(2, node.op.encode())
    out += b"".join(_delimited(3, name.encode()) for name in node.input)
    for key in sorted(node.attr, key=map_key_order):
        entry = _delimited(1, key.encode()) + _delimited(2, encode_attr(*node.attr[key]))
        out += _delimited(5, entry)
    return out


def encode_graph_def(nodes: Sequence[Node], producer: int) -> bytes:
    """The serialized GraphDef: its nodes (1), then ``versions`` (4) with
    ``producer`` (VersionDef field 1)."""
    return b"".join(_delimited(1, encode_node(n)) for n in nodes) + _delimited(
        4, _varint(1, producer))
