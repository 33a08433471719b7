"""Runtime-built protobuf schema for tensor frames.

Wire-compatible *in spirit* with the reference's nnstreamer.proto (Tensor /
Tensors messages, ext/nnstreamer/include/nnstreamer.proto) but our own
schema: dtype ids follow types.DTYPE_WIRE_IDS (bfloat16 included), frames
carry pts, and the schema is registered into the default descriptor pool at
import — no protoc/codegen step (the env bakes the protobuf runtime only).
The JAX package registers the same file: whichever package comes second
finds it in the pool, and both serialize through the same message classes.

Schema (package nnstpu):
  message Tensor     { string name=1; uint32 dtype=2; repeated uint32 dim=3;
                       bytes data=4; }
  message TensorFrame{ uint32 num=1; int32 rate_n=2; int32 rate_d=3;
                       uint32 format=4; repeated Tensor tensor=5;
                       int64 pts=6; }
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from nnstreamer_tpu_torch.buffer import Buffer, materialize_tensors
from nnstreamer_tpu_torch.types import (
    DTYPE_WIRE_IDS,
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
)

_FMT_IDS = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1, TensorFormat.SPARSE: 2}
_FMT_BY_ID = {v: k for k, v in _FMT_IDS.items()}


def _build_file_descriptor() -> descriptor_pb2.FileDescriptorProto:
    f = descriptor_pb2.FileDescriptorProto()
    f.name = "nnstpu_tensor.proto"
    f.package = "nnstpu"
    f.syntax = "proto3"

    t = f.message_type.add()
    t.name = "Tensor"
    for i, (fname, ftype, label) in enumerate(
        [
            ("name", descriptor_pb2.FieldDescriptorProto.TYPE_STRING, 1),
            ("dtype", descriptor_pb2.FieldDescriptorProto.TYPE_UINT32, 1),
            ("dim", descriptor_pb2.FieldDescriptorProto.TYPE_UINT32, 3),
            ("data", descriptor_pb2.FieldDescriptorProto.TYPE_BYTES, 1),
        ],
        start=1,
    ):
        fd = t.field.add()
        fd.name = fname
        fd.number = i
        fd.type = ftype
        fd.label = label  # 1=optional, 3=repeated

    m = f.message_type.add()
    m.name = "TensorFrame"
    fields = [
        ("num", descriptor_pb2.FieldDescriptorProto.TYPE_UINT32, 1, None),
        ("rate_n", descriptor_pb2.FieldDescriptorProto.TYPE_INT32, 1, None),
        ("rate_d", descriptor_pb2.FieldDescriptorProto.TYPE_INT32, 1, None),
        ("format", descriptor_pb2.FieldDescriptorProto.TYPE_UINT32, 1, None),
        ("tensor", descriptor_pb2.FieldDescriptorProto.TYPE_MESSAGE, 3, ".nnstpu.Tensor"),
        ("pts", descriptor_pb2.FieldDescriptorProto.TYPE_INT64, 1, None),
    ]
    for i, (fname, ftype, label, tname) in enumerate(fields, start=1):
        fd = m.field.add()
        fd.name = fname
        fd.number = i
        fd.type = ftype
        fd.label = label
        if tname:
            fd.type_name = tname
    return f


_pool = descriptor_pool.Default()
try:
    _file_desc = _pool.Add(_build_file_descriptor())
except Exception:  # already registered (re-import)
    _file_desc = _pool.FindFileByName("nnstpu_tensor.proto")

TensorMsg = message_factory.GetMessageClass(
    _file_desc.message_types_by_name["Tensor"]
)
TensorFrameMsg = message_factory.GetMessageClass(
    _file_desc.message_types_by_name["TensorFrame"]
)


def frame_to_bytes(
    buf: Buffer, config: Optional[TensorsConfig] = None
) -> bytes:
    """Buffer → serialized TensorFrame."""
    msg = TensorFrameMsg()
    info = config.info if config is not None else None
    static_known = (
        info is not None
        and info.format == TensorFormat.STATIC
        and info.num_tensors == len(buf.tensors)
    )
    msg.format = _FMT_IDS[info.format] if info is not None else 0
    msg.rate_n = config.rate_n if config is not None else -1
    msg.rate_d = config.rate_d if config is not None else -1
    msg.pts = buf.pts
    # torch tensors (on the card or the host) to numpy, one batched copy
    for i, t in enumerate(materialize_tensors(buf.tensors)):
        tm = msg.tensor.add()
        if isinstance(t, (bytes, bytearray, memoryview)):
            raw = bytes(t)
            tm.dtype = DTYPE_WIRE_IDS.index(
                info[i].dtype) if static_known else 5  # uint8
            dims = info[i].dims if static_known else (len(raw),)
            tm.dim.extend(dims)
            tm.data = raw
        else:
            a = np.ascontiguousarray(np.asarray(t))
            ti = (
                info[i]
                if static_known and info[i].is_fixed()
                else TensorInfo.from_np_shape(a.shape, a.dtype)
            )
            tm.dtype = DTYPE_WIRE_IDS.index(ti.dtype)
            tm.dim.extend(ti.dims)
            tm.data = a.tobytes()
        if static_known and info[i].name:
            tm.name = info[i].name
    msg.num = len(msg.tensor)
    return msg.SerializeToString()


def frame_from_bytes(data: bytes) -> Tuple[Buffer, TensorsConfig]:
    """Serialized TensorFrame → (Buffer, TensorsConfig)."""
    msg = TensorFrameMsg()
    msg.ParseFromString(data)
    tensors: List[np.ndarray] = []
    infos: List[TensorInfo] = []
    for tm in msg.tensor:
        if tm.dtype >= len(DTYPE_WIRE_IDS):
            raise ValueError(f"bad dtype id {tm.dtype}")
        ti = TensorInfo(
            dims=tuple(tm.dim) or (len(tm.data),),
            dtype=DTYPE_WIRE_IDS[tm.dtype],
            name=tm.name or None,
        )
        want = ti.size
        if want and len(tm.data) != want:
            raise ValueError(
                f"tensor payload {len(tm.data)}B != expected {want}B for "
                f"{ti.to_string()}"
            )
        arr = np.frombuffer(tm.data, dtype=ti.dtype.np_dtype).copy()
        tensors.append(arr.reshape(ti.np_shape()))
        infos.append(ti)
    cfg = TensorsConfig(
        info=TensorsInfo(tensors=infos, format=_FMT_BY_ID.get(msg.format, TensorFormat.STATIC)),
        rate_n=msg.rate_n,
        rate_d=msg.rate_d,
    )
    buf = Buffer(tensors=tensors, pts=msg.pts)
    return buf, cfg
