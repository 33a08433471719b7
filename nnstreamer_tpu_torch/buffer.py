"""Stream buffers: one frame of tensors flowing through the pipeline.

The reference's unit of flow is a GstBuffer holding up to 16 GstMemory
chunks (+extra packing beyond 16) with pts/dts/duration and attached GstMeta
(gst_tensor_buffer_get_nth_memory / append_memory,
nnstreamer_plugin_api_impl.c; GstMetaQuery in tensor_meta.h:30-40).

Tensors are numpy arrays or torch tensors on the host path and torch
tensors on a CUDA device on the device path: a filter's output can flow to
the next element without leaving device memory. This module is the one
device seam (the counterpart of the JAX package's ``buffer.py``): every
element asks :func:`is_device_array` which path it is on and crosses to the
host through :func:`materialize_tensors`. Metadata is an open dict;
timestamps are integer nanoseconds like GstClockTime.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.types import (
    NNS_TENSOR_SIZE_LIMIT,
    TensorDType,
    TensorsInfo,
)

CLOCK_TIME_NONE: int = -1

_buffer_ids = itertools.count()


class ShardedBatch(list):
    """One tensor placed over the dp rows of a ``shard=dp`` mesh: the list
    of its row groups' tensors, group i on mesh row i (the sharded
    serve-batch placement, serving/scheduler.py). The served filter takes
    the groups as they are (filters/cuda_filter.py); any other element
    reads it as the rows concatenated. Shape, dtype and bytes are the
    whole tensor's."""

    @property
    def shape(self) -> tuple:
        return ((sum(int(t.shape[0]) for t in self),)
                + tuple(self[0].shape[1:]))

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)

    @property
    def is_cuda(self) -> bool:
        return all(t.is_cuda for t in self)


def is_device_array(x: Any) -> bool:
    """True for a torch tensor on a CUDA device (or a batch sharded over
    CUDA devices) — the single predicate shared by every element that
    branches host vs device paths."""
    return isinstance(x, (torch.Tensor, ShardedBatch)) and x.is_cuda


def is_backend_tensor(x: Any) -> bool:
    """True for any torch tensor: a tensor a filter backend made on its
    device, not yet brought to a host array. It is the counterpart of the
    JAX package's ``is_device_array`` (a ``jax.Array`` on any device, the
    CPU included) for the filter's fetch window and the tracer's crossing
    counts, so a line run with ``accelerator=true:cpu`` windows and counts
    as it does on the card. On the CPU such a crossing moves nothing."""
    return isinstance(x, (torch.Tensor, ShardedBatch))


def _device_of(parts: Sequence[Any]) -> Optional[torch.device]:
    """Where a concatenation of ``parts`` stays: the CUDA device of any
    CUDA part, else the CPU when any part is a torch tensor (the backend's
    tensors on the CPU stay torch, as they do on the card), else None."""
    for p in parts:
        if is_device_array(p):
            return p.device
    if any(isinstance(p, torch.Tensor) for p in parts):
        return torch.device("cpu")
    return None


def as_torch(x: Any) -> torch.Tensor:
    """``x`` as a torch tensor where it lies: a tensor as it is, an array
    through ``torch.from_numpy`` (contiguous, no copy when it already is)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _as_tensor(p: Any, device: torch.device) -> torch.Tensor:
    return as_torch(p).to(device)


def concat_tensors(parts: Sequence[Any], axis: int = 0) -> Any:
    """Concatenate tensors, staying torch (``torch.cat``, on the device)
    when any part is a torch tensor; host numpy otherwise."""
    dev = _device_of(parts)
    if dev is not None:
        return torch.cat([_as_tensor(p, dev) for p in parts], dim=axis)
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)


def stack_tensors(parts: Sequence[Any], axis: int = 0) -> Any:
    """Stack tensors along a fresh axis — the no-leading-dim sibling of
    :func:`concat_tensors`. Stays torch (``torch.stack``, on the device)
    when any part is a torch tensor, so device parts never round-trip
    through the host."""
    dev = _device_of(parts)
    if dev is not None:
        return torch.stack([_as_tensor(p, dev) for p in parts], dim=axis)
    return np.stack([np.asarray(p) for p in parts], axis=axis)


def materialize_tensors(tensors: Sequence[Any]) -> List[Any]:
    """Bring every tensor to the host as numpy with ONE batched
    device→host transfer: every CUDA tensor is copied non-blocking into a
    pinned host tensor, then each stream involved is synchronised once.
    Host torch tensors become numpy views; numpy and bytes pass through.
    A per-tensor ``.cpu()`` loop here would synchronise once per tensor."""
    out = [torch.cat([p.to(t[0].device) for p in t], dim=0)
           if isinstance(t, ShardedBatch) else t for t in tensors]
    pending = []
    for i, t in enumerate(out):
        if is_device_array(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            pending.append((i, host, t.device))
        elif isinstance(t, torch.Tensor):
            out[i] = _host_numpy(t)
    for dev in {d for _, _, d in pending}:
        torch.cuda.current_stream(dev).synchronize()
    for i, host, _ in pending:
        out[i] = _host_numpy(host)
    return out


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (a view); bfloat16, which numpy lacks, as
    ``ml_dtypes.bfloat16`` over the same bits (the types mapping's)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(TensorDType.BFLOAT16.np_dtype)
    return t.numpy()


def dtype_name(t: Any) -> str:
    """Element type name of a numpy array or torch tensor ('float32',
    'uint8', ...) — the spelling TensorDType accepts."""
    if isinstance(t, (torch.Tensor, ShardedBatch)):
        return str(t.dtype).replace("torch.", "")
    return np.dtype(t.dtype).name


def nbytes_of(tensors: Sequence[Any]) -> int:
    """Total payload bytes of a tensor set. numpy arrays and torch tensors
    expose ``nbytes``; raw byte payloads are their length."""
    total = 0
    for t in tensors:
        if isinstance(t, memoryview):
            total += t.nbytes
        elif isinstance(t, (bytes, bytearray)):
            total += len(t)
        else:
            nb = getattr(t, "nbytes", None)
            total += int(nb) if nb is not None else np.asarray(t).nbytes
    return total


def residency_of(tensors: Sequence[Any]) -> str:
    """'device' (all CUDA tensors), 'host' (none), or 'mixed'."""
    if not tensors:
        return "host"
    dev = sum(1 for t in tensors if is_device_array(t))
    if dev == 0:
        return "host"
    return "device" if dev == len(tensors) else "mixed"


@dataclass
class Buffer:
    """One frame: a list of tensors + timing + metadata."""

    tensors: List[Any] = field(default_factory=list)  # np.ndarray | torch.Tensor | bytes
    pts: int = CLOCK_TIME_NONE  # presentation timestamp, ns
    dts: int = CLOCK_TIME_NONE
    duration: int = CLOCK_TIME_NONE
    meta: Dict[str, Any] = field(default_factory=dict)  # GstMeta analogue
    seqnum: int = field(default_factory=lambda: next(_buffer_ids))

    def __post_init__(self):
        if len(self.tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(
                f"{len(self.tensors)} tensors > NNS_TENSOR_SIZE_LIMIT={NNS_TENSOR_SIZE_LIMIT}"
            )

    # -- accessors (gst_tensor_buffer_get_count/get_nth_memory parity) -----
    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def __len__(self) -> int:
        return len(self.tensors)

    def __getitem__(self, i: int):
        return self.tensors[i]

    def append(self, tensor) -> None:
        """gst_tensor_buffer_append_memory (used in the filter hot loop,
        tensor_filter.c:921)."""
        if len(self.tensors) >= NNS_TENSOR_SIZE_LIMIT:
            raise ValueError("tensor count limit reached")
        self.tensors.append(tensor)

    def as_numpy(self) -> List[np.ndarray]:
        """Materialize all tensors on host (ONE batched device→host
        transfer for every device tensor). bytes payloads (flexible/octet
        streams) become uint8 arrays."""
        out = []
        for t in materialize_tensors(self.tensors):
            if isinstance(t, (bytes, bytearray, memoryview)):
                # copy() → writable, consistent with meta.unwrap_flexible
                out.append(np.frombuffer(bytes(t), dtype=np.uint8).copy())
            else:
                out.append(np.asarray(t))
        return out

    def residency(self) -> str:
        """'device' | 'host' | 'mixed' — where this buffer's tensors live
        right now. Attribute reads only, no transfer."""
        return residency_of(self.tensors)

    def derive_info(self) -> TensorsInfo:
        """Static TensorsInfo from the frames. Reads shape/dtype attributes
        only — no device→host transfer."""
        from nnstreamer_tpu_torch.types import TensorInfo

        infos = []
        for t in self.tensors:
            if isinstance(t, (bytes, bytearray, memoryview)):
                nbytes = t.nbytes if isinstance(t, memoryview) else len(t)
                infos.append(TensorInfo(dims=(nbytes,), dtype="uint8"))
            elif hasattr(t, "shape") and hasattr(t, "dtype"):
                infos.append(TensorInfo.from_np_shape(tuple(t.shape), dtype_name(t)))
            else:
                a = np.asarray(t)
                infos.append(TensorInfo.from_np_shape(a.shape, a.dtype))
        return TensorsInfo(tensors=infos)

    def with_tensors(self, tensors: Sequence[Any]) -> "Buffer":
        """New buffer carrying ``tensors`` but this buffer's timing/meta."""
        nb = Buffer(
            tensors=list(tensors),
            pts=self.pts,
            dts=self.dts,
            duration=self.duration,
            meta=dict(self.meta),
        )
        born = getattr(self, "_nns_born_t", None)
        if born is not None:
            # tracer interlatency stamp survives rewraps so src_latency
            # measures from the true source, not the last transform
            nb._nns_born_t = born
        return nb

    def copy(self) -> "Buffer":
        return self.with_tensors(list(self.tensors))

    def total_bytes(self) -> int:
        n = 0
        for t in self.tensors:
            if isinstance(t, (bytes, bytearray, memoryview)):
                n += t.nbytes if isinstance(t, memoryview) else len(t)
            elif hasattr(t, "nbytes"):
                n += int(t.nbytes)  # no device→host transfer
            else:
                n += int(np.asarray(t).nbytes)
        return n

    def __repr__(self) -> str:
        shapes = []
        for t in self.tensors:
            if isinstance(t, (bytes, bytearray, memoryview)):
                shapes.append(f"bytes[{len(t)}]")
            else:
                a = t if hasattr(t, "shape") else np.asarray(t)
                shapes.append(f"{getattr(a, 'dtype', '?')}{tuple(a.shape)}")
        return f"Buffer(pts={self.pts}, tensors=[{', '.join(shapes)}])"


@dataclass
class Event:
    """In-band stream events (GstEvent analogue). Types used by the runtime:
    'eos', 'caps', 'segment', 'qos' (throttling, tensor_filter.c:512),
    'custom' (e.g. model RELOAD_MODEL, nnstreamer_plugin_api_filter.h:351-357).
    """

    type: str
    data: Dict[str, Any] = field(default_factory=dict)


EOS = Event("eos")
