"""Stream combination elements: tensor_mux, tensor_demux, tensor_merge,
tensor_split, join, round_robin (counterpart of the JAX package's
``elements/mux.py``).

Reference parity:
  tensor_mux   (gsttensor_mux.c:665)   N×tensors → 1 frame (tensor list
               concat) with GstCollectPads time-sync policies
  tensor_demux (gsttensor_demux.c:680) 1 → N streams, tensorpick selection
  tensor_merge (gsttensor_merge.c:894) N single tensors → 1 tensor, concat
               along a dimension (linear mode)
  tensor_split (gsttensor_split.c:725) 1 tensor → N slices (tensorseg)
  join         (gst/join/gstjoin.c:775) N→1 first-come forwarding, no sync

Sync policies (nnstreamer_plugin_api_impl.c:20-25): slowest (default —
wait for a fresh buffer on every pad), nosync (emit on any arrival using
the latest from other pads), basepad (pad-0 arrivals drive emission),
refresh (like basepad but any pad refreshes).

Device tensors: mux, demux, join and round_robin pass tensors through
untouched, so a CUDA tensor stays on the card. Merge and split compute on
the host: fed the backend's tensors (``buffer.is_backend_tensor``) they
bring them over in one batched transfer and record one ``d2h`` crossing,
as the JAX package's elements do with device arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer, Event
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import TensorInfo, TensorsConfig, TensorsInfo


class _SyncCombiner(Element):
    """Shared sync-policy machinery for mux/merge (collectpads analogue).

    Upstream branches run on different threads; arrivals are serialized by
    a lock, pending buffers kept per pad, and a combined frame emitted when
    the active policy is satisfied."""

    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "sync_mode": Prop("enum",
                          enum=("slowest", "nosync", "basepad", "refresh"),
                          doc="collect-pads time-sync policy"),
    }

    #: per-pad FIFO bound for the slowest policy (collectpads buffering)
    MAX_QUEUED = 64

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._sync = str(self.properties.get("sync_mode", "slowest"))
        self._latest: Dict[str, Buffer] = {}
        self._fifos: Dict[str, list] = {}
        self._clock = lockwitness.make_lock("mux.clock")
        self._space = lockwitness.make_condition(self._clock)
        self._pad_configs: Dict[str, TensorsConfig] = {}

    def _setup_pads(self) -> None:
        self.add_src_pad("src")

    def request_pad(self, name: str = "sink_%u") -> Pad:
        return self._request_indexed_pad(name, "sink", self.add_sink_pad)

    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._pad_configs[pad.name] = caps.to_config()
        if len(self._pad_configs) == len(self.sink_pads):
            out = self._combined_caps()
            if out is not None:
                for sp in self.src_pads:
                    sp.push_event(Event("caps", {"caps": out}))

    def _combined_caps(self) -> Optional[Caps]:
        raise NotImplementedError

    def _combine(self, bufs: List[Buffer]) -> Buffer:
        raise NotImplementedError

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        names = [p.name for p in self.sink_pads]
        if self._sync == "slowest":
            # collectpads: per-pad FIFO with backpressure; emit one aligned
            # set whenever every pad has a queued buffer
            with self._space:
                fifo = self._fifos.setdefault(pad.name, [])
                while len(fifo) >= self.MAX_QUEUED:
                    if not self._space.wait(timeout=5.0):
                        raise ElementError(self.name, f"sink pad {pad.name} stalled")
                fifo.append(buf)
                sets = []
                while all(self._fifos.get(n) for n in names):
                    sets.append([self._fifos[n].pop(0) for n in names])
                self._space.notify_all()
            ret = FlowReturn.OK
            for s in sets:
                r = self.push(self._combine(s))
                if r == FlowReturn.ERROR:
                    ret = r
            return ret
        with self._clock:
            self._latest[pad.name] = buf
            if self._sync == "nosync" or self._sync == "refresh":
                ready = all(n in self._latest for n in names)
            elif self._sync == "basepad":
                ready = pad.name == names[0] and all(n in self._latest for n in names)
            else:
                raise ElementError(self.name, f"unknown sync_mode {self._sync!r}")
            if not ready:
                return FlowReturn.OK
            out = self._combine([self._latest[n] for n in names])
        return self.push(out)


@element_register
class TensorMux(_SyncCombiner):
    """Concatenate the tensor *lists* of N streams into one frame."""

    ELEMENT_NAME = "tensor_mux"
    DEVICE_TRANSPARENT = True  # regroups tensors, never touches payloads

    def _combined_caps(self) -> Optional[Caps]:
        tensors: List[TensorInfo] = []
        rate_n = rate_d = -1
        for p in self.sink_pads:
            cfg = self._pad_configs.get(p.name)
            if cfg is None:
                return None
            tensors.extend(cfg.info.tensors)
            if cfg.rate_n >= 0:
                rate_n, rate_d = cfg.rate_n, cfg.rate_d
        return Caps.from_config(TensorsConfig(TensorsInfo(tensors=tensors), rate_n, rate_d))

    def _combine(self, bufs: List[Buffer]) -> Buffer:
        tensors = [t for b in bufs for t in b.tensors]
        # timestamp policy: earliest pts of the combined set
        pts = min((b.pts for b in bufs if b.pts >= 0), default=-1)
        out = Buffer(tensors=tensors, pts=pts)
        for b in bufs:
            out.meta.update(b.meta)
        return out


@element_register
class TensorMerge(_SyncCombiner):
    """Concatenate N single tensors along a dimension (mode=linear,
    option=<dim 0..3> in the reference's innermost-first numbering)."""

    ELEMENT_NAME = "tensor_merge"
    PROPERTY_SCHEMA = {
        "mode": Prop("str", doc="linear (reference parity)"),
        "option": Prop("int", doc="concat dim, innermost-first"),
    }

    def _dim(self) -> int:
        return int(self.properties.get("option", 0))

    def _combined_caps(self) -> Optional[Caps]:
        infos = []
        rate_n = rate_d = -1
        for p in self.sink_pads:
            cfg = self._pad_configs.get(p.name)
            if cfg is None or cfg.info.num_tensors != 1:
                return None
            infos.append(cfg.info[0])
            if cfg.rate_n >= 0:
                rate_n, rate_d = cfg.rate_n, cfg.rate_d
        if len({i.dtype for i in infos}) > 1:
            # the reference requires matching types on all merge pads
            raise ElementError(
                self.name,
                f"merge pads disagree on dtype: {[i.dtype.value for i in infos]}",
            )
        k = self._dim()
        base = list(infos[0].dims)
        while len(base) <= k:
            base.append(1)
        total = 0
        for inf in infos:
            d = list(inf.dims) + [1] * (len(base) - len(inf.dims))
            total += d[k]
        base[k] = total
        out = TensorInfo(tuple(base), infos[0].dtype)
        return Caps.from_config(TensorsConfig(TensorsInfo(tensors=[out]), rate_n, rate_d))

    def _combine(self, bufs: List[Buffer]) -> Buffer:
        k = self._dim()
        # host-math combiner: ONE batched fetch over every pad's tensor,
        # never a serial round trip per pad
        tensors = self._fetch_to_host(
            Buffer(tensors=[b.tensors[0] for b in bufs])).tensors
        arrs = [np.asarray(t) for t in tensors]
        r = max(a.ndim for a in arrs + [np.empty((0,) * (k + 1))])
        arrs = [a.reshape((1,) * (r - a.ndim) + a.shape) for a in arrs]
        axis = r - 1 - k  # innermost-first dim k ↔ np axis
        out = np.concatenate(arrs, axis=axis)
        pts = min((b.pts for b in bufs if b.pts >= 0), default=-1)
        return Buffer(tensors=[out], pts=pts)


@element_register
class TensorDemux(Element):
    """1 multi-tensor stream → N streams. ``tensorpick`` selects/reorders:
    'tensorpick=0,2' or grouped '0:1,2' (tensors 0+1 to pad 0, 2 to pad 1)."""

    ELEMENT_NAME = "tensor_demux"
    SINK_TEMPLATE = "other/tensors"
    DEVICE_TRANSPARENT = True  # selects tensors, never touches payloads
    PROPERTY_SCHEMA = {
        "tensorpick": Prop("str", doc="'0,2' or grouped '0:1,2'"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._groups: Optional[List[List[int]]] = None
        pick = self.properties.get("tensorpick")
        if pick:
            self._groups = [
                [int(i) for i in grp.split(":")] for grp in str(pick).split(",")
            ]
        self._config: Optional[TensorsConfig] = None

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def request_pad(self, name: str = "src_%u") -> Pad:
        pad = self._request_indexed_pad(name, "src", self.add_src_pad)
        if self._config is not None:
            idx = self.src_pads.index(pad)
            caps = self._pad_caps(idx)
            if caps is not None:
                pad.caps = caps.fixate() if not caps.is_fixed() else caps
        return pad

    def _group(self, idx: int, n_tensors: int) -> List[int]:
        if self._groups is not None:
            return self._groups[idx] if idx < len(self._groups) else []
        return [idx] if idx < n_tensors else []

    def _pad_caps(self, idx: int) -> Optional[Caps]:
        cfg = self._config
        sel = self._group(idx, cfg.info.num_tensors)
        if not sel:
            return None
        info = TensorsInfo(tensors=[cfg.info.tensors[i] for i in sel])
        return Caps.from_config(TensorsConfig(info, cfg.rate_n, cfg.rate_d))

    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._config = caps.to_config()
        for i, sp in enumerate(self.src_pads):
            c = self._pad_caps(i)
            if c is not None:
                sp.push_event(Event("caps", {"caps": c}))

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        n = buf.num_tensors
        ret = FlowReturn.OK
        for i, sp in enumerate(self.src_pads):
            sel = self._group(i, n)
            if not sel:
                continue
            r = sp.push(buf.with_tensors([buf.tensors[j] for j in sel]))
            if r == FlowReturn.ERROR:
                ret = r
        return ret


@element_register
class TensorSplit(Element):
    """Split one tensor along a dimension into N streams.
    Props: tensorseg='s0,s1,...' sizes along ``dimension`` (default 0,
    innermost-first). Mirrors gsttensor_split.c tensorseg."""

    ELEMENT_NAME = "tensor_split"
    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "tensorseg": Prop("str", required=True,
                          doc="'s0,s1,…' sizes along dimension"),
        "dimension": Prop("int"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        seg = self.properties.get("tensorseg")
        if not seg:
            raise ElementError(self.name, "tensor_split needs tensorseg=s0,s1,...")
        self._sizes = [int(s) for s in str(seg).split(",")]
        self._dim = int(self.properties.get("dimension", 0))
        self._config: Optional[TensorsConfig] = None
        for i in range(len(self._sizes)):  # pads known only after props
            self.add_src_pad(f"src_{i}")

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def split_out_caps(self, cfg: TensorsConfig) -> Optional[list]:
        """Per-src-pad out caps for a given sink config (shared by live
        negotiation and the nnlint static dry run)."""
        if cfg.info.num_tensors != 1:
            return None
        base = cfg.info[0]
        k = self._dim
        out = []
        for i in range(len(self.src_pads)):
            dims = list(base.dims) + [1] * (max(0, k + 1 - len(base.dims)))
            dims[k] = self._sizes[i]
            info = TensorsInfo(tensors=[TensorInfo(tuple(dims), base.dtype)])
            out.append(Caps.from_config(
                TensorsConfig(info, cfg.rate_n, cfg.rate_d)))
        return out

    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        cfg = caps.to_config()
        self._config = cfg
        caps_list = self.split_out_caps(cfg)
        if caps_list is not None:
            for sp, c in zip(self.src_pads, caps_list):
                sp.push_event(Event("caps", {"caps": c}))

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        a = np.asarray(self._fetch_to_host(buf).tensors[0])  # host slicing
        k = self._dim
        axis = a.ndim - 1 - k
        if axis < 0:
            raise ElementError(self.name, f"dimension {k} out of range for ndim {a.ndim}")
        if sum(self._sizes) != a.shape[axis]:
            raise ElementError(
                self.name,
                f"tensorseg {self._sizes} does not sum to dim size {a.shape[axis]}",
            )
        ret = FlowReturn.OK
        off = 0
        for i, s in enumerate(self._sizes):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(off, off + s)
            off += s
            r = self.src_pads[i].push(buf.with_tensors([a[tuple(sl)]]))
            if r == FlowReturn.ERROR:
                ret = r
        return ret


@element_register
class Join(Element):
    """N→1 first-come forwarding without synchronization (gstjoin.c)."""

    ELEMENT_NAME = "join"
    DEVICE_TRANSPARENT = True

    def _setup_pads(self) -> None:
        self.add_src_pad("src")

    def request_pad(self, name: str = "sink_%u") -> Pad:
        return self._request_indexed_pad(name, "sink", self.add_sink_pad)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        return self.push(buf)


@element_register
class RoundRobin(Element):
    """1→N round-robin distributor — the inverse of join.

    No reference equivalent (its branch parallelism is tee/demux fan-out,
    SURVEY.md §2.6 item 2); this element alternates micro-batches across
    N tensor_filter instances (shared-tensor-filter-key → one model) so
    their dispatches overlap on one card. Pair with join for first-come
    fan-in.
    """

    ELEMENT_NAME = "round_robin"
    ALIASES = ("tensor_distribute",)
    DEVICE_TRANSPARENT = True

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")
        self._next = 0

    def request_pad(self, name: str = "src_%u") -> Pad:
        return self._request_indexed_pad(name, "src", self.add_src_pad)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if not self.src_pads:
            return FlowReturn.OK
        i = self._next
        self._next = (self._next + 1) % len(self.src_pads)
        return self.push(buf, i)
