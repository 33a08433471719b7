"""Binary meta header for flexible & sparse tensors.

The reference prefixes each tensor payload in a *flexible* or *sparse* stream
with a self-describing ``GstTensorMetaInfo`` header (magic / version / type /
dimension[16] / format / media_type / extra union, tensor_typedef.h:310-326;
pack/parse helpers ``gst_tensor_meta_info_*`` in
nnstreamer_plugin_api_util_impl.c, used in the filter hot loop at
tensor_filter.c:706-708,906-917). We keep the same wire *shape* — fixed-size
little-endian header followed by payload — with our own magic/version since
this is a new framework.

Layout (little-endian, 96 bytes):
  u32 magic      0x54505553 ("TPUS")
  u32 version    1
  u32 dtype      wire id (types.DTYPE_WIRE_IDS index)
  u32 format     0=static 1=flexible 2=sparse
  u32 media_type reserved (0)
  u32[16] dims   innermost-first, unused trail 0-padded
  u32 nnz        sparse only: number of non-zero elements (else 0)
  u32 reserved×2

Sparse payload (tensor_typedef.h:294-297, gsttensor_sparseutil.c:21-110):
  header(with nnz) + values[nnz] (dtype) + indices[nnz] (uint32, flat index).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from nnstreamer_tpu_torch.types import (
    DTYPE_WIRE_IDS,
    NNS_TENSOR_RANK_LIMIT,
    TensorFormat,
    TensorInfo,
)

META_MAGIC = 0x54505553
META_VERSION = 1

# --- nntrace per-buffer span context (GstMeta-style attachment) -----------

#: Buffer.meta key carrying the TraceContext — lives alongside the
#: residency tag ("residency") the device lane stamps; rewraps
#: (Buffer.with_tensors) copy meta, so the context follows the frame
#: through transforms/filters.
TRACE_CTX_META = "trace_ctx"


@dataclass
class TraceContext:
    """Per-buffer nntrace span context: the buffer's stable id plus the
    monotonic stack of spans currently open ON this buffer (name, t0
    entries — pushed as each traced chain enters, discarded on exit).
    A buffer crossing a queue is visible to two streaming threads at
    once (upstream's exit races downstream's entry), so exits discard
    their OWN entry rather than LIFO-popping — list append/remove are
    GIL-atomic, and the stack reliably drains to empty once every chain
    holding the buffer returns. Allocated ONLY when span tracing is
    enabled; the hot path without spans never touches it
    (guard-tested)."""

    buffer_id: int
    stack: List[Tuple[str, float]] = field(default_factory=list)

    def push(self, name: str, t0: float) -> Tuple[str, float]:
        entry = (name, t0)
        self.stack.append(entry)
        return entry

    def discard(self, entry: Tuple[str, float]) -> None:
        try:
            self.stack.remove(entry)
        except ValueError:
            pass  # already removed (defensive: double-exit)

    @property
    def depth(self) -> int:
        return len(self.stack)


def ensure_trace_ctx(buf) -> TraceContext:
    """The buffer's TraceContext, created on first use (span mode only —
    call sites gate on the tracer's span ring being enabled). Foreign
    buffers without a meta dict get a throwaway context (spans still
    emit, the context just doesn't ride the buffer)."""
    meta = getattr(buf, "meta", None)
    if not isinstance(meta, dict):
        return TraceContext(buffer_id=int(getattr(buf, "seqnum", 0)))
    ctx = meta.get(TRACE_CTX_META)
    if ctx is None:
        ctx = TraceContext(buffer_id=int(getattr(buf, "seqnum", 0)))
        meta[TRACE_CTX_META] = ctx
    return ctx


_HEADER_FMT = "<5I16I3I"
HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 96

_FORMAT_IDS = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1, TensorFormat.SPARSE: 2}
_FORMAT_BY_ID = {v: k for k, v in _FORMAT_IDS.items()}


def pack_header(
    info: TensorInfo,
    fmt: TensorFormat = TensorFormat.FLEXIBLE,
    nnz: int = 0,
) -> bytes:
    """Serialize a tensor's meta header (gst_tensor_meta_info_append_header)."""
    if not info.is_fixed():
        raise ValueError(f"cannot serialize unfixed tensor info: {info.to_string()}")
    dims = list(info.dims) + [0] * (NNS_TENSOR_RANK_LIMIT - len(info.dims))
    return struct.pack(
        _HEADER_FMT,
        META_MAGIC,
        META_VERSION,
        DTYPE_WIRE_IDS.index(info.dtype),
        _FORMAT_IDS[fmt],
        0,
        *dims,
        nnz,
        0,
        0,
    )


def parse_header(data: bytes) -> Tuple[TensorInfo, TensorFormat, int]:
    """Parse a meta header → (info, format, nnz)
    (gst_tensor_meta_info_parse_header)."""
    if len(data) < HEADER_SIZE:
        raise ValueError(f"buffer too small for meta header: {len(data)} < {HEADER_SIZE}")
    vals = struct.unpack(_HEADER_FMT, bytes(data[:HEADER_SIZE]))
    magic, version, dtype_id, fmt_id, _media = vals[:5]
    if magic != META_MAGIC:
        raise ValueError(f"bad meta magic 0x{magic:08x}")
    if version != META_VERSION:
        raise ValueError(f"unsupported meta version {version}")
    raw = vals[5 : 5 + NNS_TENSOR_RANK_LIMIT]
    dims_list = []
    for d in raw:
        if d == 0:
            break
        dims_list.append(d)
    while len(dims_list) > 1 and dims_list[-1] == 1:
        dims_list.pop()
    dims = tuple(dims_list) or (1,)
    nnz = vals[5 + NNS_TENSOR_RANK_LIMIT]
    info = TensorInfo(dims=dims, dtype=DTYPE_WIRE_IDS[dtype_id])
    return info, _FORMAT_BY_ID[fmt_id], nnz


def wrap_flexible(arr: np.ndarray, info: TensorInfo) -> bytes:
    """tensor → header+payload bytes for a flexible stream."""
    return pack_header(info, TensorFormat.FLEXIBLE) + np.ascontiguousarray(arr).tobytes()


def unwrap_flexible(data: bytes) -> Tuple[np.ndarray, TensorInfo]:
    info, fmt, _ = parse_header(data)
    if fmt not in (TensorFormat.FLEXIBLE, TensorFormat.STATIC):
        raise ValueError(f"not a flexible tensor: {fmt}")
    payload = np.frombuffer(bytes(data[HEADER_SIZE:]), dtype=info.dtype.np_dtype)
    # copy() so the result is writable (frombuffer over bytes is read-only),
    # consistent with sparse_decode
    return payload.reshape(info.np_shape()).copy(), info


def sparse_encode(arr: np.ndarray, info: TensorInfo) -> bytes:
    """Dense → sparse payload (gst_tensor_sparse_from_dense,
    gsttensor_sparseutil.c:21-110): header(nnz) + values + uint32 flat indices."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    idx = np.flatnonzero(flat)
    if idx.size > np.iinfo(np.uint32).max:
        raise ValueError("tensor too large for sparse uint32 indices")
    values = flat[idx]
    return (
        pack_header(info, TensorFormat.SPARSE, nnz=int(idx.size))
        + values.tobytes()
        + idx.astype(np.uint32).tobytes()
    )


def sparse_decode(data: bytes) -> Tuple[np.ndarray, TensorInfo]:
    """Sparse payload → dense tensor (gst_tensor_sparse_to_dense)."""
    info, fmt, nnz = parse_header(data)
    if fmt != TensorFormat.SPARSE:
        raise ValueError(f"not a sparse tensor: {fmt}")
    from nnstreamer_tpu_torch.types import element_count

    esize = info.dtype.size
    payload = bytes(data[HEADER_SIZE:])
    total = element_count(info.dims)
    if nnz > total:
        raise ValueError(f"sparse nnz {nnz} exceeds element count {total}")
    if len(payload) < nnz * (esize + 4):
        raise ValueError(
            f"sparse payload too small: {len(payload)} < {nnz * (esize + 4)}"
        )
    values = np.frombuffer(payload[: nnz * esize], dtype=info.dtype.np_dtype)
    indices = np.frombuffer(payload[nnz * esize : nnz * esize + nnz * 4], dtype=np.uint32)
    if nnz and int(indices.max()) >= total:
        raise ValueError(f"sparse index {int(indices.max())} out of range {total}")
    dense = np.zeros(total, dtype=info.dtype.np_dtype)
    dense[indices] = values
    return dense.reshape(info.np_shape()), info
