"""Minimal ONNX reader: protobuf *wire format* parsed directly.

The environment ships neither the ``onnx`` package nor onnxruntime, but
the reference treats ONNX as a first-class model format
(tensor_filter_onnxruntime.cc; tests/test_models/models/*.onnx). This
module decodes the subset of the ONNX protobuf schema the importer needs
(ModelProto → GraphProto → NodeProto/TensorProto/AttributeProto) straight
from the wire encoding — varints, length-delimited fields — with no
generated code. Field numbers follow the public onnx.proto schema
(github.com/onnx/onnx, onnx/onnx.proto; stable since IR v3).

The port's own copy of the JAX package's ``tools/onnx_lite.py``: the
same file gives the same :class:`Graph`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType → numpy (onnx.proto enum)
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, off: int) -> Tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message body.
    value: int for varint/fixed, memoryview for length-delimited."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        fnum, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, off = _read_varint(buf, off)
        elif wt == 1:  # fixed64
            v = int.from_bytes(buf[off:off + 8], "little")
            off += 8
        elif wt == 2:  # length-delimited
            ln, off = _read_varint(buf, off)
            v = buf[off:off + ln]
            off += ln
        elif wt == 5:  # fixed32
            v = int.from_bytes(buf[off:off + 4], "little")
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, v


@dataclass
class Attribute:
    name: str = ""
    type: int = 0  # AttributeProto.AttributeType
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional["Tensor"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)


@dataclass
class Tensor:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = 0
    raw: bytes = b""
    floats: List[float] = field(default_factory=list)
    ints32: List[int] = field(default_factory=list)
    ints64: List[int] = field(default_factory=list)
    doubles: List[float] = field(default_factory=list)

    def to_numpy(self) -> np.ndarray:
        dt = DTYPES.get(self.data_type)
        if dt is None:
            raise NotImplementedError(f"onnx dtype {self.data_type}")
        if self.raw:
            a = np.frombuffer(self.raw, dtype=dt)
        elif self.floats:
            a = np.asarray(self.floats, np.float32).astype(dt)
        elif self.ints64:
            a = np.asarray(self.ints64, np.int64).astype(dt)
        elif self.ints32:
            # int32_data carries int32 AND narrow types (u8/i8/u16/i16/f16).
            # float16 is stored as raw bit patterns, not numeric values.
            if self.data_type == 10:  # FLOAT16: bit-reinterpret, don't convert
                a = (np.asarray(self.ints32, np.int64).astype(np.uint16)
                     .view(np.float16))
            else:
                a = np.asarray(self.ints32, np.int64).astype(dt)
        elif self.doubles:
            a = np.asarray(self.doubles, np.float64).astype(dt)
        else:
            a = np.zeros(0, dt)
        return a.reshape(self.dims) if self.dims else a.reshape(())


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    dims: List[int] = field(default_factory=list)  # 0 = dynamic


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Attribute] = field(default_factory=dict)


@dataclass
class Graph:
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, Tensor] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


def _parse_tensor(buf: memoryview) -> Tensor:
    t = Tensor()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:  # dims (repeated int64, varint or packed)
            if wt == 0:
                t.dims.append(v)
            else:
                off = 0
                while off < len(v):
                    d, off = _read_varint(v, off)
                    t.dims.append(d)
        elif fnum == 2:
            t.data_type = v
        elif fnum == 4:  # float_data (packed fixed32)
            t.floats.extend(np.frombuffer(bytes(v), "<f4").tolist()
                            if wt == 2 else
                            [np.frombuffer(v.to_bytes(4, "little"), "<f4")[0]])
        elif fnum == 5:  # int32_data (packed varint, sign-extended to 64 bits)
            if wt == 0:
                t.ints32.append(_signed(v))
            else:
                off = 0
                while off < len(v):
                    d, off = _read_varint(v, off)
                    t.ints32.append(_signed(d))
        elif fnum == 7:  # int64_data
            if wt == 0:
                t.ints64.append(_signed(v))
            else:
                off = 0
                while off < len(v):
                    d, off = _read_varint(v, off)
                    t.ints64.append(_signed(d))
        elif fnum == 8:
            t.name = bytes(v).decode("utf-8")
        elif fnum == 9:
            t.raw = bytes(v)
        elif fnum == 10:  # double_data (packed fixed64)
            t.doubles.extend(np.frombuffer(bytes(v), "<f8").tolist())
    return t


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(buf: memoryview) -> Attribute:
    a = Attribute()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            a.name = bytes(v).decode("utf-8")
        elif fnum == 2:
            a.f = np.frombuffer(v.to_bytes(4, "little"), "<f4")[0]
        elif fnum == 3:
            a.i = _signed(v)
        elif fnum == 4:
            a.s = bytes(v)
        elif fnum == 5:
            a.t = _parse_tensor(v)
        elif fnum == 7:  # floats (packed fixed32)
            a.floats.extend(np.frombuffer(bytes(v), "<f4").tolist()
                            if wt == 2 else
                            [np.frombuffer(v.to_bytes(4, "little"), "<f4")[0]])
        elif fnum == 8:  # ints
            if wt == 0:
                a.ints.append(_signed(v))
            else:
                off = 0
                while off < len(v):
                    d, off = _read_varint(v, off)
                    a.ints.append(_signed(d))
        elif fnum == 20:
            a.type = v
    return a


def _parse_node(buf: memoryview) -> Node:
    n = Node()
    for fnum, _wt, v in _fields(buf):
        if fnum == 1:
            n.inputs.append(bytes(v).decode("utf-8"))
        elif fnum == 2:
            n.outputs.append(bytes(v).decode("utf-8"))
        elif fnum == 3:
            n.name = bytes(v).decode("utf-8")
        elif fnum == 4:
            n.op_type = bytes(v).decode("utf-8")
        elif fnum == 5:
            a = _parse_attr(v)
            n.attrs[a.name] = a
    return n


def _parse_value_info(buf: memoryview) -> ValueInfo:
    vi = ValueInfo()
    for fnum, _wt, v in _fields(buf):
        if fnum == 1:
            vi.name = bytes(v).decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _fields(v3):
                                if f4 == 1:  # Dimension
                                    dim = 0
                                    for f5, _w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim = v5
                                    vi.dims.append(dim)
    return vi


def _parse_graph(buf: memoryview) -> Graph:
    g = Graph()
    for fnum, _wt, v in _fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(v))
        elif fnum == 5:
            t = _parse_tensor(v)
            g.initializers[t.name] = t
        elif fnum == 11:
            g.inputs.append(_parse_value_info(v))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def load(path: str) -> Graph:
    """Parse an .onnx file's graph (ModelProto field 7)."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    graph = None
    for fnum, _wt, v in _fields(buf):
        if fnum == 7:
            graph = _parse_graph(v)
    if graph is None:
        raise ValueError(f"{path}: no graph in ModelProto")
    # model inputs exclude initializers (older exporters list both)
    init = set(graph.initializers)
    graph.inputs = [i for i in graph.inputs if i.name not in init]
    return graph
