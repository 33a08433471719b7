"""tensor_repo: in-process tensor repository enabling cyclic (recurrent)
pipelines by pairing tensor_reposink → tensor_reposrc without a pad link (counterpart of
the JAX package's ``elements/repo.py``). The sink stores host copies: fed the
backend's tensors it brings them over in one batched transfer and records
one ``d2h`` crossing.

Reference parity: gsttensor_repo.h:40-65 (global hash of slots with
mutex+cond), gsttensor_reposink.c:466 / gsttensor_reposrc.c:373. Tested by
the reference's RNN/LSTM recurrence suites (tests/nnstreamer_repo_rnn,
tests/nnstreamer_repo_lstm).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)


class _RepoSlot:
    def __init__(self):
        self.lock = lockwitness.make_lock("repo.slot")
        self.cond = lockwitness.make_condition(self.lock)
        self.buf: Optional[Buffer] = None
        self.eos = False


class TensorRepo:
    """Global slot table (gst_tensor_repo singleton analogue)."""

    def __init__(self):
        self._slots: Dict[int, _RepoSlot] = {}
        self._lock = lockwitness.make_lock("repo.table")

    def slot(self, idx: int) -> _RepoSlot:
        with self._lock:
            return self._slots.setdefault(idx, _RepoSlot())

    def set_data(self, idx: int, buf: Buffer) -> None:
        s = self.slot(idx)
        with s.cond:
            s.buf = buf
            s.cond.notify_all()

    def get_data(self, idx: int, timeout: float = 5.0) -> Optional[Buffer]:
        s = self.slot(idx)
        with s.cond:
            if s.buf is None and not s.eos:
                s.cond.wait(timeout)
            buf, s.buf = s.buf, None
            return buf

    def set_eos(self, idx: int) -> None:
        s = self.slot(idx)
        with s.cond:
            s.eos = True
            s.cond.notify_all()

    def reset(self, idx: Optional[int] = None) -> None:
        with self._lock:
            if idx is None:
                self._slots.clear()
            else:
                self._slots.pop(idx, None)


repo = TensorRepo()


@element_register
class TensorRepoSink(Element):
    """Writes each buffer into repo slot ``slot-index``."""

    ELEMENT_NAME = "tensor_reposink"
    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {"slot_index": Prop("int")}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.slot = int(self.properties.get("slot_index", 0))

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        buf = self._fetch_to_host(buf)
        repo.set_data(self.slot, buf.with_tensors(buf.as_numpy()))
        return FlowReturn.OK

    def on_eos(self) -> None:
        repo.set_eos(self.slot)


@element_register
class TensorRepoSrc(SourceElement):
    """Reads buffers from repo slot ``slot-index``; emits ``initial-value``
    (zeros of dims/type props) first so the cycle can start."""

    ELEMENT_NAME = "tensor_reposrc"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "slot_index": Prop("int"),
        "caps": Prop("caps"),
        "initial_dim": Prop("str", doc="zeros emitted before the cycle"),
        "initial_type": Prop("str"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.slot = int(self.properties.get("slot_index", 0))
        self._first = True

    def start(self) -> None:
        self._first = True
        s = repo.slot(self.slot)
        with s.cond:
            s.eos = False

    def negotiate(self) -> Optional[Caps]:
        caps = self.properties.get("caps")
        if isinstance(caps, str):
            return Caps.from_string(caps)
        return caps

    def create(self) -> Optional[Buffer]:
        if self._first and self.properties.get("initial_dim"):
            self._first = False
            from nnstreamer_tpu_torch.types import TensorDType, TensorInfo, parse_dimension

            dims = parse_dimension(str(self.properties["initial_dim"]))
            dt = TensorDType.from_any(str(self.properties.get("initial_type", "float32")))
            info = TensorInfo(dims, dt)
            return Buffer(tensors=[np.zeros(info.np_shape(), dt.np_dtype)])
        while True:
            buf = repo.get_data(self.slot, timeout=0.1)
            if buf is not None:
                return buf
            s = repo.slot(self.slot)
            with s.cond:
                if s.eos:
                    return None
            if self.pipeline is not None and not self.pipeline._running.is_set():
                return None
