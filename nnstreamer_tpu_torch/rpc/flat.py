"""FlatBuffers (flexbuffers) wire format for tensor frames.

Reference counterpart: the flatbuf converter/decoder subplugins and gRPC
flatbuf IDL (ext/nnstreamer/include/nnstreamer.fbs). We use the schema-less
flexbuffers encoding from the same library family — self-describing like
the reference's flatbuf path, no generated code:

  { "num": N, "rate_n": n, "rate_d": d, "format": f, "pts": p,
    "name": [..], "dtype": [..], "dim": [[...], ...], "data": [blob, ...] }

A copy of the JAX package's codec; the same frame gives the same bytes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from flatbuffers import flexbuffers

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


def frame_to_flex(buf: Buffer, config: Optional[TensorsConfig] = None) -> bytes:
    info = config.info if config is not None else None
    static_known = (
        info is not None
        and info.format == TensorFormat.STATIC
        and info.num_tensors == len(buf.tensors)
    )
    names: List[str] = []
    dtypes: List[int] = []
    dims: List[List[int]] = []
    blobs: List[bytes] = []
    # torch tensors (on the card or the host) to numpy, one batched copy
    for i, t in enumerate(materialize_tensors(buf.tensors)):
        if isinstance(t, (bytes, bytearray, memoryview)):
            raw = bytes(t)
            if static_known:
                dtypes.append(DTYPE_WIRE_IDS.index(info[i].dtype))
                dims.append(list(info[i].dims))
            else:
                dtypes.append(5)  # raw bytes → uint8 wire id
                dims.append([len(raw)])
            blobs.append(raw)
        else:
            a = np.ascontiguousarray(np.asarray(t))
            ti = (
                info[i]
                if static_known and info[i].is_fixed()
                else TensorInfo.from_np_shape(a.shape, a.dtype)
            )
            dtypes.append(DTYPE_WIRE_IDS.index(ti.dtype))
            dims.append(list(ti.dims))
            blobs.append(a.tobytes())
        names.append((info[i].name or "") if static_known else "")

    b = flexbuffers.Builder()
    with b.Map():
        b.Key("num")
        b.UInt(len(blobs))
        b.Key("rate_n")
        b.Int(config.rate_n if config is not None else -1)
        b.Key("rate_d")
        b.Int(config.rate_d if config is not None else -1)
        b.Key("format")
        b.UInt(_FMT_IDS[info.format] if info is not None else 0)
        b.Key("pts")
        b.Int(buf.pts)
        b.Key("name")
        with b.Vector():
            for n in names:
                b.String(n)
        b.Key("dtype")
        with b.Vector():
            for d in dtypes:
                b.UInt(d)
        b.Key("dim")
        with b.Vector():
            for dl in dims:
                with b.Vector():
                    for d in dl:
                        b.UInt(d)
        b.Key("data")
        with b.Vector():
            for blob in blobs:
                b.Blob(blob)
    return bytes(b.Finish())


def frame_from_flex(data: bytes) -> Tuple[Buffer, TensorsConfig]:
    root = flexbuffers.GetRoot(bytearray(data)).AsMap
    num = root["num"].AsInt
    names = [v.AsString for v in root["name"].AsVector]
    dtypes = [v.AsInt for v in root["dtype"].AsVector]
    dims = [[d.AsInt for d in v.AsVector] for v in root["dim"].AsVector]
    blobs = [bytes(v.AsBlob) for v in root["data"].AsVector]
    if not (len(names) == len(dtypes) == len(dims) == len(blobs) == num):
        raise ValueError("inconsistent flexbuffer frame")
    tensors: List[np.ndarray] = []
    infos: List[TensorInfo] = []
    for name, dt, dim, blob in zip(names, dtypes, dims, blobs):
        if dt >= len(DTYPE_WIRE_IDS):
            raise ValueError(f"bad dtype id {dt}")
        ti = TensorInfo(dims=tuple(dim) or (len(blob),),
                        dtype=DTYPE_WIRE_IDS[dt], name=name or None)
        want = ti.size
        if want and len(blob) != want:
            raise ValueError(
                f"tensor payload {len(blob)}B != expected {want}B for {ti.to_string()}"
            )
        arr = np.frombuffer(blob, dtype=ti.dtype.np_dtype).copy()
        tensors.append(arr.reshape(ti.np_shape()))
        infos.append(ti)
    cfg = TensorsConfig(
        info=TensorsInfo(
            tensors=infos, format=_FMT_BY_ID.get(root["format"].AsInt, TensorFormat.STATIC)
        ),
        rate_n=root["rate_n"].AsInt,
        rate_d=root["rate_d"].AsInt,
    )
    return Buffer(tensors=tensors, pts=root["pts"].AsInt), cfg
