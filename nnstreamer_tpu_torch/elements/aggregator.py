"""tensor_aggregator — temporal batching (counterpart of the JAX package's
``elements/aggregator.py``; gsttensor_aggregator.c:1081, props :171-213):
collect ``frames_in``-frame buffers until ``frames_out`` frames are held,
emit them concatenated along ``frames_dim``, then flush ``frames_flush``
frames (0 = flush all ⇒ non-overlapping windows).

Torch tensors (on the card or on the CPU) are split and concatenated with
``torch.split``/``torch.cat`` and stay where they are; numpy arrays with
numpy. The long-context line windows a feature stream this way before
``stream_transformer``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer, materialize_tensors, nbytes_of
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    element_register,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsConfig, TensorsInfo


@element_register
class TensorAggregator(Element):
    ELEMENT_NAME = "tensor_aggregator"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "frames_in": Prop("int"),
        "frames_out": Prop("int"),
        "frames_flush": Prop("int", doc="0 = flush all"),
        "frames_dim": Prop("int"),
        "concat": Prop("bool"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.frames_in = int(self.properties.get("frames_in", 1))
        self.frames_out = int(self.properties.get("frames_out", 1))
        self.frames_flush = int(self.properties.get("frames_flush", 0))
        self.frames_dim = int(self.properties.get("frames_dim", 3))
        self.concat = bool(self.properties.get("concat", True))
        if self.frames_in <= 0 or self.frames_out <= 0:
            raise ElementError(self.name, "frames-in/frames-out must be positive")
        self._window: Deque = deque()  # per-frame arrays or tensors
        self._pts: Deque = deque()

    # -- residency negotiation (memory:HBM lane) ---------------------------
    # device in → device out (window and concat stay on the device), so
    # residency flows THROUGH this element; when it is the last
    # device-capable element before a host-only consumer it becomes the
    # materialization boundary (chain() below)
    DEVICE_TRANSPARENT = True

    def accepts_device(self, pad: Pad) -> bool:
        return True

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        cfg = caps.to_config()
        if cfg.info.num_tensors > 1:
            raise ElementError(
                self.name,
                "tensor_aggregator operates on single-tensor streams; "
                "use tensor_demux to select one tensor first",
            )
        if cfg.info.num_tensors == 0:  # flexible stream: caps pass through
            return caps
        t = cfg.info[0]
        k = self.frames_dim
        dims = list(t.dims) + [1] * max(0, k + 1 - len(t.dims))
        per_buf = dims[k]
        if self.frames_in > 1 and per_buf % self.frames_in == 0:
            per_frame = per_buf // self.frames_in
        else:
            per_frame = per_buf
        dims[k] = per_frame * self.frames_out
        info = TensorsInfo(tensors=[TensorInfo(tuple(dims), t.dtype)])
        rate_n, rate_d = cfg.rate_n, cfg.rate_d
        if rate_n > 0:
            flush = self.frames_flush if self.frames_flush > 0 else self.frames_out
            rate_d = rate_d * flush
            rate_n = rate_n * self.frames_in
        return Caps.from_config(TensorsConfig(info, rate_n, rate_d))

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        a = buf.tensors[0]
        is_torch = isinstance(a, torch.Tensor)
        if not is_torch:
            a = np.asarray(a)
        k = self.frames_dim
        r = max(a.ndim, k + 1)
        a = a.reshape((1,) * (r - a.ndim) + tuple(a.shape))
        axis = r - 1 - k
        # split the incoming buffer into frames_in frames along the dim
        if self.frames_in == 1:
            frames = [a]
        elif is_torch:
            if a.shape[axis] % self.frames_in:
                raise ElementError(self.name, f"{a.shape[axis]} frames along "
                                   f"dim {k} do not split into frames-in="
                                   f"{self.frames_in}")
            frames = torch.split(a, a.shape[axis] // self.frames_in, dim=axis)
        else:
            frames = np.split(a, self.frames_in, axis=axis)
        for f in frames:
            self._window.append(f)
            self._pts.append(buf.pts)
        ret = FlowReturn.OK
        while len(self._window) >= self.frames_out:
            group = list(self._window)[: self.frames_out]
            if not self.concat:
                out = group[0]
            elif is_torch:
                out = torch.cat(group, dim=axis)
            else:
                out = np.concatenate(group, axis=axis)
            if (is_torch and self.src_pads
                    and self.src_pads[0].device_ok is False):
                # residency boundary: downstream is host-only — fetch the
                # whole window here, once (the aggregator is the fetch
                # amortizer on this line)
                self._record_crossing("d2h", nbytes=nbytes_of([out]))
                out = materialize_tensors([out])[0]
            pts = self._pts[0]
            flush = self.frames_flush if self.frames_flush > 0 else self.frames_out
            for _ in range(min(flush, len(self._window))):
                self._window.popleft()
                self._pts.popleft()
            r2 = self.push(Buffer(tensors=[out], pts=pts, meta=dict(buf.meta)))
            if r2 == FlowReturn.ERROR:
                ret = r2
        return ret

    def on_eos(self) -> None:
        self._window.clear()
        self._pts.clear()
