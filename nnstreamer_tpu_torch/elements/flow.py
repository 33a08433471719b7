"""Data-driven flow control: tensor_if, tensor_crop, tensor_rate
(counterpart of the JAX package's ``elements/flow.py``).

Reference parity:
  tensor_if   (gsttensor_if.c:1236, ops gsttensor_if.h:61-70): per-buffer
              condition on a compared value extracted from the tensors;
              then/else actions passthrough / skip / fill-zero; registerable
              python callback conditions (tensor_if.h:22-77 custom ABI).
  tensor_crop (gsttensor_crop.c:840): crop the ``raw`` stream using crop
              coords arriving on a second ``info`` stream (flexible output).
  tensor_rate (gsttensor_rate.c:997): framerate control by drop/duplicate +
              QoS throttling events sent upstream (:452).

tensor_if and tensor_crop read values on the host: fed the backend's
tensors (``buffer.is_backend_tensor``) they bring them over in one batched
transfer, record one ``d2h`` crossing and pass the host copy on, so the
frame crosses once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer, Event
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import TensorFormat, TensorsConfig, TensorsInfo

_OPS = {
    "eq": lambda v, a, b: v == a,
    "ne": lambda v, a, b: v != a,
    "gt": lambda v, a, b: v > a,
    "ge": lambda v, a, b: v >= a,
    "lt": lambda v, a, b: v < a,
    "le": lambda v, a, b: v <= a,
    "range_inclusive": lambda v, a, b: a <= v <= b,
    "range_exclusive": lambda v, a, b: a < v < b,
}


def register_if_condition(name: str, fn) -> None:
    """nnstreamer_if_custom_register parity: fn(list[np.ndarray]) -> bool."""
    registry.register(registry.IF_CONDITION, name)(fn)


def unregister_if_condition(name: str) -> bool:
    return registry.unregister(registry.IF_CONDITION, name)


@element_register
class TensorIf(Element):
    """Props: compared-value (A_VALUE|TENSOR_AVERAGE_VALUE|CUSTOM),
    compared-value-option ('d0:d1:...:tensorN' index for A_VALUE, or the
    custom condition name), supplied-value 'v[,v2]', operator (eq/ne/gt/...),
    then / else (PASSTHROUGH|SKIP|FILL_WITH_ZERO)."""

    ELEMENT_NAME = "tensor_if"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "compared_value": Prop("enum", enum=("A_VALUE",
                                             "TENSOR_AVERAGE_VALUE",
                                             "CUSTOM")),
        "compared_value_option": Prop("str"),
        "operator": Prop("enum", enum=tuple(_OPS)),
        "supplied_value": Prop("str", doc="'v' or 'v1,v2' for ranges"),
        "then": Prop("enum", enum=("PASSTHROUGH", "SKIP",
                                   "FILL_WITH_ZERO")),
        "else": Prop("enum", enum=("PASSTHROUGH", "SKIP",
                                   "FILL_WITH_ZERO")),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.cv = str(self.properties.get("compared_value", "A_VALUE")).upper()
        self.cv_opt = str(self.properties.get("compared_value_option", "0"))
        self.op = str(self.properties.get("operator", "eq")).lower()
        sv = str(self.properties.get("supplied_value", "0"))
        parts = [float(x) for x in sv.split(",")]
        self.sv1 = parts[0]
        self.sv2 = parts[1] if len(parts) > 1 else None
        self.then_action = str(self.properties.get("then", "PASSTHROUGH")).upper()
        self.else_action = str(self.properties.get("else", "SKIP")).upper()
        if self.op not in _OPS and self.cv != "CUSTOM":
            raise ElementError(self.name, f"unknown operator {self.op!r}")

    def _evaluate(self, buf: Buffer) -> bool:
        arrs = buf.as_numpy()  # buf holds host tensors (see chain)
        if self.cv == "CUSTOM":
            fn = registry.get(registry.IF_CONDITION, self.cv_opt)
            if fn is None:
                raise ElementError(self.name, f"no custom if condition {self.cv_opt!r}")
            return bool(fn(arrs))
        if self.cv == "TENSOR_AVERAGE_VALUE":
            ti = int(self.cv_opt) if self.cv_opt else 0
            v = float(np.mean(arrs[ti]))
        else:  # A_VALUE: 'd0:d1:d2:d3:tensor-index' innermost-first
            idx = [int(x) for x in self.cv_opt.split(":")]
            ti = idx[-1] if len(idx) > 1 else 0
            coords = idx[:-1] if len(idx) > 1 else idx
            a = arrs[ti]
            np_idx = tuple(reversed(coords))[-a.ndim:] if coords else (0,) * a.ndim
            np_idx = (0,) * (a.ndim - len(np_idx)) + np_idx
            v = float(a[np_idx])
        return bool(_OPS[self.op](v, self.sv1, self.sv2))

    def _act(self, action: str, buf: Buffer) -> FlowReturn:
        if action == "PASSTHROUGH":
            return self.push(buf)
        if action == "SKIP":
            return FlowReturn.DROPPED
        if action == "FILL_WITH_ZERO":
            return self.push(buf.with_tensors([np.zeros_like(np.asarray(t)) for t in buf.tensors]))
        raise ElementError(self.name, f"unknown action {action!r}")

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        buf = self._fetch_to_host(buf)
        return self._act(self.then_action if self._evaluate(buf) else self.else_action, buf)


@element_register
class TensorCrop(Element):
    """Two sink pads: ``raw`` (tensor stream) + ``info`` (crop coords —
    tensors of [x, y, w, h] per region, innermost-first dims 4:N). Output is
    flexible (per-buffer shapes vary with region size)."""

    ELEMENT_NAME = "tensor_crop"
    SINK_TEMPLATE = "other/tensors"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._lock = lockwitness.make_lock("flow.crop")
        self._pending_raw: List[Buffer] = []
        self._pending_info: List[Buffer] = []

    def _setup_pads(self) -> None:
        self.add_sink_pad("raw")
        self.add_sink_pad("info")
        self.add_src_pad("src")

    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        if pad.name == "raw":
            cfg = caps.to_config()
            out = TensorsConfig(
                TensorsInfo(format=TensorFormat.FLEXIBLE), cfg.rate_n, cfg.rate_d
            )
            self.src_pad.push_event(Event("caps", {"caps": Caps.from_config(out)}))

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        with self._lock:
            (self._pending_raw if pad.name == "raw" else self._pending_info).append(buf)
            if not (self._pending_raw and self._pending_info):
                return FlowReturn.OK
            raw = self._pending_raw.pop(0)
            info = self._pending_info.pop(0)
        raw, info = self._fetch_to_host(raw), self._fetch_to_host(info)
        frame = np.asarray(raw.tensors[0])  # np HWC (innermost-first c:w:h)
        regions = np.asarray(info.tensors[0]).reshape(-1, 4).astype(np.int64)
        crops = []
        h, w = frame.shape[0], frame.shape[1]
        for x, y, cw, ch in regions:
            # intersect the requested rect with the frame (ends from the
            # ORIGINAL origin, so negative x/y shrink rather than shift)
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(w, int(x) + int(cw)), min(h, int(y) + int(ch))
            crops.append(frame[y0:max(y0, y1), x0:max(x0, x1)])
        return self.push(raw.with_tensors(crops))


@element_register
class TensorRate(Element):
    """Framerate adjust by drop/duplicate. Props: framerate='n/d',
    throttle=true sends QoS events upstream so producers drop work early
    (gsttensor_rate.c:27-36,452). Stats props: in, out, drop, dup."""

    ELEMENT_NAME = "tensor_rate"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "framerate": Prop("str", doc="'n/d' or plain fps"),
        "throttle": Prop("bool", doc="send QoS events upstream"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        fr = str(self.properties.get("framerate", ""))
        if "/" in fr:
            n, d = fr.split("/")
            self.rate_n, self.rate_d = int(n), int(d)
        elif fr:
            self.rate_n, self.rate_d = int(float(fr)), 1
        else:
            self.rate_n = self.rate_d = 0
        self.throttle = bool(self.properties.get("throttle", True))
        self._next_ts = 0
        self._last_buf: Optional[Buffer] = None
        self.stats: Dict[str, int] = {"in": 0, "out": 0, "drop": 0, "dup": 0}

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        if self.rate_n <= 0:
            return caps
        cfg = caps.to_config()
        cfg = TensorsConfig(cfg.info, self.rate_n, self.rate_d)
        return Caps.from_config(cfg)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self.stats["in"] += 1
        if self.rate_n <= 0:
            self.stats["out"] += 1
            return self.push(buf)
        interval = int(1e9 * self.rate_d / self.rate_n)
        ts = buf.pts if buf.pts >= 0 else self._next_ts
        if ts < self._next_ts:
            self.stats["drop"] += 1
            if self.throttle:
                self.send_upstream_event(
                    Event("qos", {"earliest": self._next_ts})
                )
            return FlowReturn.DROPPED
        # emit (and duplicate if we fell behind more than one interval)
        while self._next_ts + interval <= ts and self._last_buf is not None:
            dup = self._last_buf.copy()
            dup.pts = self._next_ts
            self.stats["dup"] += 1
            self.stats["out"] += 1
            self.push(dup)
            self._next_ts += interval
        out = buf.copy()
        out.pts = self._next_ts
        out.duration = interval
        self._next_ts += interval
        self._last_buf = buf
        self.stats["out"] += 1
        return self.push(out)

    def get_property(self, key: str):
        key = key.replace("-", "_")
        if key in self.stats:
            return self.stats[key]
        return super().get_property(key)
