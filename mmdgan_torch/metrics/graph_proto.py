"""A reader of TensorFlow's GraphDef protobuf, dependency-free: the messages
the GraphDef executor needs (GraphDef, NodeDef, AttrValue and its
ListValue, TensorProto, TensorShapeProto), parsed from the wire format on
the protobuf helpers of ``data/tfrecord.py``.

The parsed messages read as the protobuf classes do where the executor
reads them: ``node.name``, ``node.op``, ``node.input``, ``node.attr[key]``
(a missing key gives a default ``AttrValue``, as protobuf's map does) and
``attr.s``/``.i``/``.f``/``.b``/``.type``/``.list.i``/``.tensor``; fields
the executor never reads (shapes in attributes, versions, the function
library) are skipped.
``make_ndarray`` is ``tf.make_ndarray``'s rule: ``tensor_content`` when
present, else the typed values, the last repeated to fill the shape.

Field numbers are those of tensorflow/core/framework/{graph, node_def,
attr_value, tensor, tensor_shape, types}.proto.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mmdgan_torch.data.tfrecord import _read_varint

# types.proto DataType -> numpy
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16, 6: np.int8,
          9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16, 22: np.uint32,
          23: np.uint64}
DT_BFLOAT16 = 14


def _signed(v: int, bits: int = 64) -> int:
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a message: an int
    for a varint, bytes for a length-delimited field or a fixed32/64."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"protobuf: wire type {wire} of field {field} is not supported")
        yield field, wire, value


def _varints(wire: int, value) -> List[int]:
    """A repeated varint field's values, packed or not."""
    if wire == 0:
        return [value]
    out, pos = [], 0
    while pos < len(value):
        v, pos = _read_varint(value, pos)
        out.append(v)
    return out


def _fixed(wire: int, value, fmt: str) -> List:
    """A repeated fixed-width field's values, packed or not."""
    return list(np.frombuffer(value, fmt)) if wire == 2 else [struct.unpack(fmt, value)[0]]


def parse_shape(buf: bytes) -> List[int]:
    """TensorShapeProto's dims (``repeated Dim dim = 2``, Dim.size = 1)."""
    dims = []
    for field, _, value in _fields(buf):
        if field == 2:
            size = 0
            for f, _, v in _fields(value):
                if f == 1:
                    size = _signed(v)
            dims.append(size)
    return dims


@dataclasses.dataclass
class Tensor:
    dtype: int = 0
    shape: List[int] = dataclasses.field(default_factory=list)
    content: bytes = b""
    values: List = dataclasses.field(default_factory=list)


# TensorProto's typed value fields: field number -> "int", "uint" or a struct format
_VALUE_FIELDS = {5: "<f4", 6: "<f8", 7: "int", 10: "int", 11: "int", 13: "int",
                 16: "uint", 17: "uint"}


def parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    for field, wire, value in _fields(buf):
        if field == 1:
            t.dtype = value
        elif field == 2:
            t.shape = parse_shape(value)
        elif field == 4:
            t.content = bytes(value)
        elif field in _VALUE_FIELDS:
            fmt = _VALUE_FIELDS[field]
            if fmt == "int":
                t.values += [_signed(v) for v in _varints(wire, value)]
            elif fmt == "uint":
                t.values += _varints(wire, value)
            else:
                t.values += _fixed(wire, value, fmt)
        elif field == 8:
            raise NotImplementedError("GraphDef reader: string tensors are not supported")
    return t


def make_ndarray(t: Tensor) -> np.ndarray:
    """``tf.make_ndarray`` of a parsed TensorProto."""
    shape = tuple(t.shape)
    count = int(np.prod(shape)) if shape else 1
    if t.dtype in (DT_BFLOAT16, 19):
        # bfloat16 / half travel as 16-bit patterns (tensor_content, half_val)
        bits = (np.frombuffer(t.content, "<u2") if t.content
                else np.asarray(t.values, np.uint32).astype(np.uint16))
        if t.dtype == 19:
            values = bits.view(np.float16)
        else:
            values = (bits.astype(np.uint32) << 16).view(np.float32)
    elif t.dtype in DTYPES:
        dtype = DTYPES[t.dtype]
        if t.content:
            return np.frombuffer(t.content, np.dtype(dtype).newbyteorder("<")).astype(
                dtype).reshape(shape)
        values = np.asarray(t.values).astype(dtype)
    else:
        raise NotImplementedError(f"GraphDef reader: tensor dtype {t.dtype} is not supported")
    if values.size == 0:
        return np.zeros(shape, values.dtype)
    if values.size != count:
        values = np.pad(values, (0, count - values.size), "edge")
    return values.reshape(shape)


@dataclasses.dataclass
class ListValue:
    s: List[bytes] = dataclasses.field(default_factory=list)
    i: List[int] = dataclasses.field(default_factory=list)
    f: List[float] = dataclasses.field(default_factory=list)
    b: List[bool] = dataclasses.field(default_factory=list)


def parse_list(buf: bytes) -> ListValue:
    out = ListValue()
    for field, wire, value in _fields(buf):
        if field == 2:
            out.s.append(bytes(value))
        elif field == 3:
            out.i += [_signed(v) for v in _varints(wire, value)]
        elif field == 4:
            out.f += [float(v) for v in _fixed(wire, value, "<f4")]
        elif field == 5:
            out.b += [bool(v) for v in _varints(wire, value)]
    return out


@dataclasses.dataclass
class AttrValue:
    s: bytes = b""
    i: int = 0
    f: float = 0.0
    b: bool = False
    type: int = 0
    tensor: Optional[Tensor] = None
    list: ListValue = dataclasses.field(default_factory=ListValue)


def parse_attr(buf: bytes) -> AttrValue:
    a = AttrValue()
    for field, _, value in _fields(buf):
        if field == 1:
            a.list = parse_list(value)
        elif field == 2:
            a.s = bytes(value)
        elif field == 3:
            a.i = _signed(value)
        elif field == 4:
            a.f = struct.unpack("<f", value)[0]
        elif field == 5:
            a.b = bool(value)
        elif field == 6:
            a.type = value
        elif field == 8:
            a.tensor = parse_tensor(value)
    return a


class AttrMap(dict):
    """``node.attr``: a missing key reads as a default AttrValue."""

    def __missing__(self, key):
        return AttrValue()


@dataclasses.dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    attr: AttrMap = dataclasses.field(default_factory=AttrMap)


def parse_node(buf: bytes) -> NodeDef:
    node = NodeDef()
    for field, _, value in _fields(buf):
        if field == 1:
            node.name = bytes(value).decode()
        elif field == 2:
            node.op = bytes(value).decode()
        elif field == 3:
            node.input.append(bytes(value).decode())
        elif field == 5:   # map<string, AttrValue> entry { key = 1; value = 2; }
            key, attr = "", AttrValue()
            for f, _, v in _fields(value):
                if f == 1:
                    key = bytes(v).decode()
                elif f == 2:
                    attr = parse_attr(v)
            node.attr[key] = attr
    return node


@dataclasses.dataclass
class GraphDef:
    node: List[NodeDef] = dataclasses.field(default_factory=list)


def parse_graph_def(buf: bytes) -> GraphDef:
    """A serialized GraphDef (the bytes of a frozen ``.pb``)."""
    return GraphDef([parse_node(value) for field, _, value in _fields(bytes(buf))
                     if field == 1])


def nodes_by_name(gd: GraphDef) -> Dict[str, NodeDef]:
    return {n.name: n for n in gd.node}
