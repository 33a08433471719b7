"""datareposrc / datareposink — MLOps data-repository file elements (L7).

Parity: gst/datarepo/gstdatareposrc.c and gstdatareposink.c: a raw sample
file plus a JSON descriptor with ``gst_caps``, ``total_samples`` and either
``sample_size`` (static tensors) or ``sample_offset``/``tensor_size``/
``tensor_count`` arrays (flexible), deterministic sample ranges
(start/stop-sample-index), epoch repetition and optional shuffling
(gstdatareposrc.c:15-21, JSON read :1442-1506; sink JSON write
gstdatareposink.c:736-751).

The same JSON schema is read and written so src↔sink round-trips and
checkpoint/resume of a training corpus is deterministic (SURVEY.md §5
checkpoint/resume: datareposrc supports reproducible feeding).
Counterpart of the JAX package's ``elements/datarepo_elements.py``, copied
with its imports pointed at this package: both packages read and write the
same bytes in the same order.
"""

from __future__ import annotations

import json
import random
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)

log = get_logger("element.datarepo")


@element_register
class DataRepoSrc(SourceElement):
    """Props: location, json, start-sample-index, stop-sample-index, epochs
    (0 = forever), is-shuffle."""

    ELEMENT_NAME = "datareposrc"
    PROPERTY_SCHEMA = {
        "location": Prop("str", required=True),
        "json": Prop("str", required=True, doc="JSON descriptor path"),
        "start_sample_index": Prop("int"),
        "stop_sample_index": Prop("int"),
        "epochs": Prop("int", doc="0 = forever"),
        "is_shuffle": Prop("bool"),
        "seed": Prop("int"),
        "caps": Prop("caps"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fh = None
        self._caps: Optional[Caps] = None
        self._order: List[int] = []
        self._pos = 0
        self._epoch = 0

    def start(self) -> None:
        loc = self.properties.get("location")
        meta_path = self.properties.get("json")
        if not loc or not meta_path:
            raise ElementError(self.name, "datareposrc needs location= and json=")
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        if "gst_caps" not in meta:
            raise ElementError(self.name, f"{meta_path}: missing gst_caps")
        self._caps = Caps.from_string(meta["gst_caps"])
        self._total = int(meta.get("total_samples", 0))
        if self._total <= 0:
            raise ElementError(self.name, f"{meta_path}: missing/zero total_samples")
        self._sample_size = int(meta.get("sample_size", 0))
        self._offsets = meta.get("sample_offset")
        self._tensor_sizes = meta.get("tensor_size")
        self._tensor_counts = meta.get("tensor_count")
        if not self._sample_size and not self._offsets:
            raise ElementError(
                self.name, f"{meta_path}: needs sample_size or sample_offset[]"
            )
        if self._offsets and not self._sample_size:
            if not self._tensor_sizes or not self._tensor_counts:
                raise ElementError(
                    self.name,
                    f"{meta_path}: flexible repo needs tensor_size[] and "
                    "tensor_count[] alongside sample_offset[]",
                )
            # per-sample base index into tensor_size[] (O(1) reads)
            self._tensor_base = [0]
            for c in self._tensor_counts[:-1]:
                self._tensor_base.append(self._tensor_base[-1] + int(c))
        self._fh = open(loc, "rb")
        start = int(self.properties.get("start_sample_index", 0))
        stop = int(self.properties.get("stop_sample_index", self._total - 1))
        if not (0 <= start <= stop < self._total):
            raise ElementError(
                self.name,
                f"bad sample range [{start}, {stop}] for {self._total} samples",
            )
        self._range = list(range(start, stop + 1))
        self._epochs = int(self.properties.get("epochs", 1))
        self._shuffle = bool(self.properties.get("is_shuffle", False))
        self._rng = random.Random(int(self.properties.get("seed", 0)))
        self._epoch = 0
        self._begin_epoch()

    def _begin_epoch(self) -> None:
        self._order = list(self._range)
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def stop(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def negotiate(self) -> Optional[Caps]:
        return self._caps

    def _read_static(self, idx: int) -> List[np.ndarray]:
        cfg = self._caps.to_config()
        self._fh.seek(idx * self._sample_size)
        raw = self._fh.read(self._sample_size)
        if len(raw) != self._sample_size:
            raise ElementError(self.name, f"short read at sample {idx}")
        tensors, off = [], 0
        for info in cfg.info:
            nbytes = info.size
            arr = np.frombuffer(raw[off : off + nbytes], dtype=info.dtype.np_dtype)
            tensors.append(arr.reshape(info.np_shape()))
            off += nbytes
        return tensors

    def _read_flexible(self, idx: int) -> List[np.ndarray]:
        # flexible repo: per-sample offset + per-tensor sizes
        count = int(self._tensor_counts[idx])
        self._fh.seek(int(self._offsets[idx]))
        tensors = []
        # tensor_size is indexed by cumulative tensor number (sink writes one
        # entry per tensor in stream order); bases precomputed in start()
        base = self._tensor_base[idx]
        for i in range(count):
            nbytes = int(self._tensor_sizes[base + i])
            tensors.append(np.frombuffer(self._fh.read(nbytes), dtype=np.uint8))
        return tensors

    def create(self) -> Optional[Buffer]:
        if self._pos >= len(self._order):
            self._epoch += 1
            if self._epochs and self._epoch >= self._epochs:
                return None
            self._begin_epoch()
        idx = self._order[self._pos]
        self._pos += 1
        tensors = (
            self._read_static(idx) if self._sample_size else self._read_flexible(idx)
        )
        return Buffer(tensors=tensors)


@element_register
class DataRepoSink(Element):
    """Props: location, json. Writes samples and the JSON descriptor
    (gstdatareposink.c JSON write at EOS)."""

    ELEMENT_NAME = "datareposink"
    PROPERTY_SCHEMA = {
        "location": Prop("str", required=True),
        "json": Prop("str", required=True),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fh = None
        self._count = 0
        self._sample_size = 0
        self._caps_str = ""
        self._flexible = False
        self._offsets: List[int] = []
        self._tensor_sizes: List[int] = []
        self._tensor_counts: List[int] = []

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def start(self) -> None:
        loc = self.properties.get("location")
        if not loc or not self.properties.get("json"):
            raise ElementError(self.name, "datareposink needs location= and json=")
        self._fh = open(loc, "wb")
        self._count = 0

    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._caps_str = str(caps)
        self._flexible = "flexible" in self._caps_str

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._caps_str == "" and pad.caps is not None:
            self._on_sink_caps(pad, pad.caps)
        sizes = []
        offset = self._fh.tell()
        for t in buf.tensors:
            raw = (
                bytes(t)
                if isinstance(t, (bytes, bytearray, memoryview))
                else np.ascontiguousarray(np.asarray(t)).tobytes()
            )
            self._fh.write(raw)
            sizes.append(len(raw))
        if self._flexible:
            self._offsets.append(offset)
            self._tensor_sizes.extend(sizes)
            self._tensor_counts.append(len(buf.tensors))
        elif self._count == 0:
            self._sample_size = sum(sizes)
        self._count += 1
        return FlowReturn.OK

    def on_eos(self) -> None:
        if self._fh is None:
            return
        self._fh.flush()
        meta = {"gst_caps": self._caps_str, "total_samples": self._count}
        if self._flexible:
            meta["sample_offset"] = self._offsets
            meta["tensor_size"] = self._tensor_sizes
            meta["tensor_count"] = self._tensor_counts
        else:
            meta["sample_size"] = self._sample_size
        with open(self.properties["json"], "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=1)

    def stop(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
