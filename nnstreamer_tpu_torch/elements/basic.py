"""Generic stream elements: app source, tensor_sink, queue (thread
boundary), tee, capsfilter, identity, file I/O, video test source
(counterpart of the JAX package's ``elements/basic.py``).

These are the L0 GStreamer elements the reference assumes exist
(appsrc/appsink/filesrc/filesink/queue/tee/videotestsrc used throughout its
tests) plus the reference's own tensor_sink (gsttensor_sink.c: appsink-like
sink emitting new-data signals).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis import lockwitness, sanitizer
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import (
    CLOCK_TIME_NONE,
    Buffer,
    Event,
    is_backend_tensor,
    materialize_tensors,
    nbytes_of,
)
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)

log = get_logger("elements")


@element_register
class AppSrc(SourceElement):
    """Application-fed source. push_buffer()/end_of_stream() from any thread.

    Props: caps (Caps or caps string), is_live, max_buffers."""

    ELEMENT_NAME = "appsrc"
    PROPERTY_SCHEMA = {
        "caps": Prop("caps", doc="stream caps"),
        "is_live": Prop("bool"),
        "max_buffers": Prop("int", doc="0 = unbounded feed queue"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q: "_queue.Queue" = _queue.Queue(
            maxsize=int(self.properties.get("max_buffers", 0) or 0)
        )

    def push_buffer(self, buf_or_tensors, pts: int = CLOCK_TIME_NONE) -> None:
        if not isinstance(buf_or_tensors, Buffer):
            tensors = buf_or_tensors if isinstance(buf_or_tensors, (list, tuple)) else [buf_or_tensors]
            buf_or_tensors = Buffer(tensors=list(tensors), pts=pts)
        self._q.put(buf_or_tensors)

    def end_of_stream(self) -> None:
        self._q.put(None)

    def negotiate(self) -> Optional[Caps]:
        caps = self.properties.get("caps")
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        return caps

    def create(self) -> Optional[Buffer]:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except _queue.Empty:
                if self.pipeline is not None and not self.pipeline._running.is_set():
                    return None


@element_register
class TensorSink(Element):
    """Terminal sink emitting new-data callbacks and collecting results.

    Parity: tensor_sink (gsttensor_sink.c:644 LoC) — ``new-data`` signal,
    ``emit-signal``/``sync`` props. Also usable as generic appsink/fakesink.
    """

    ELEMENT_NAME = "tensor_sink"
    ALIASES = ("appsink", "fakesink")
    PROPERTY_SCHEMA = {
        "collect": Prop("bool", doc="keep buffers in .collected"),
        "max_buffers": Prop("int"),
        "materialize": Prop("bool",
                            doc="false = hand device buffers to the app"),
        "emit_signal": Prop("bool"),
        "sync": Prop("bool"),
        "silent": Prop("bool"),
    }

    #: retention cap for collected[] and the pull queue — prevents unbounded
    #: growth in long-running pipelines (override with max-buffers prop;
    #: production pipelines should use callbacks + collect=false)
    DEFAULT_MAX_BUFFERS = 4096

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.callbacks: List[Callable[[Buffer], None]] = []
        self.collected: List[Buffer] = []
        self._collect = bool(self.properties.get("collect", True))
        self._max = int(self.properties.get("max_buffers", self.DEFAULT_MAX_BUFFERS))
        self._q: "_queue.Queue" = _queue.Queue(maxsize=self._max)

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def connect_new_data(self, cb: Callable[[Buffer], None]) -> None:
        self.callbacks.append(cb)

    def accepts_device(self, pad: Pad) -> bool:
        # materialize=false: the app wants raw (possibly device-resident)
        # buffers — this sink is a device-capable consumer; the default
        # materializing sink is the host-only consumer that pulls the
        # pipeline's materialization boundary upstream
        return not self.properties.get("materialize", True)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        # sinks synchronize async device work by materializing on host unless
        # the app asked for raw (possibly device-resident) buffers
        if self.properties.get("materialize", True):
            if any(is_backend_tensor(t) for t in buf.tensors):
                # on a planned line the boundary upstream has fetched; the
                # backend's tensors that still reach the sink (an
                # unplanned graph) cross here, billed
                self._record_crossing("d2h", nbytes=nbytes_of(
                    [t for t in buf.tensors if is_backend_tensor(t)]))
            # as_numpy brings every device tensor over in ONE batched
            # device→host transfer
            buf = buf.with_tensors(buf.as_numpy())
        for cb in self.callbacks:
            cb(buf)
        if self._collect:
            self.collected.append(buf)
            if len(self.collected) > self._max:
                del self.collected[0]
        try:
            self._q.put_nowait(buf)
        except _queue.Full:  # appsink drop=true semantics: discard oldest
            try:
                self._q.get_nowait()
            except _queue.Empty:
                pass
            try:
                self._q.put_nowait(buf)
            except _queue.Full:
                pass
        return FlowReturn.OK

    def pull(self, timeout: Optional[float] = 5.0) -> Optional[Buffer]:
        """Blocking appsink-style pull; timeout<=0 polls without blocking."""
        try:
            if timeout is not None and timeout <= 0:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None


@element_register
class QueueElement(Element):
    """Thread boundary with a bounded buffer queue — the stage-parallelism
    construct (SURVEY.md §2.6 item 1). Props: max_size_buffers (default 16),
    leaky ('no'|'downstream': drop newest when full, for live QoS)."""

    ELEMENT_NAME = "queue"
    ALIASES = ("queue2",)
    DEVICE_TRANSPARENT = True  # thread boundary; tensor payloads untouched
    PROPERTY_SCHEMA = {
        "max_size_buffers": Prop("int", doc="bounded depth (default 16)"),
        "leaky": Prop("enum", enum=("no", "downstream"),
                      doc="downstream = drop newest when full"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q: "_queue.Queue" = _queue.Queue(
            maxsize=int(self.properties.get("max_size_buffers", 16))
        )
        self._thread: Optional[threading.Thread] = None
        self._alive = False
        self._pending = 0
        self._plock = lockwitness.make_lock("queue.pending")

    def start(self) -> None:
        self._alive = True
        self._thread = threading.Thread(target=self._loop, name=f"q:{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._alive = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # drop anything left
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        # enqueue stamp rides the item so the pop side can report queue
        # residency to the tracer (GstShark interlatency role: parked
        # time is where pipeline p50 hides when proctimes look innocent)
        item = ("buf", buf, time.perf_counter())
        with self._plock:
            self._pending += 1
        if self.properties.get("leaky") == "downstream":
            try:
                self._q.put_nowait(item)
            except _queue.Full:
                with self._plock:
                    self._pending -= 1
                return FlowReturn.OK  # leak (drop) newest
        else:
            self._q.put(item)  # backpressure: block upstream thread
        return FlowReturn.OK

    def _on_sink_event(self, pad: Pad, event: Event) -> None:
        if event.type == "caps":  # caps handled synchronously by Pad
            return
        with self._plock:
            self._pending += 1
        self._q.put(("evt", event, 0.0))

    def _loop(self) -> None:
        while self._alive:
            try:
                kind, item, t_enq = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            try:
                if kind == "buf":
                    tracer = (getattr(self.pipeline, "tracer", None)
                              if self.pipeline else None)
                    if tracer is not None:
                        t_deq = time.perf_counter()
                        tracer.record_residency(
                            f"queue:{self.name}", t_deq - t_enq)
                        if tracer.spans is not None:
                            # queue-wait span on the edge's own virtual
                            # track, async-id'd by buffer: parked entries
                            # overlap freely while the element processes
                            tracer.spans.emit(
                                "queue-wait", "queue", t_enq, t_deq,
                                track=f"queue:{self.name}",
                                aid=getattr(item, "seqnum", id(item)),
                                args={"queue": self.name})
                    self.push(item)
                else:
                    for sp in self.src_pads:
                        sp.push_event(item)
            except Exception as e:  # noqa: BLE001 — worker thread must report, not die silently
                log.exception("queue %s downstream error", self.name)
                self.post_error(e)
                self._alive = False
            finally:
                with self._plock:
                    self._pending -= 1

    def is_idle(self) -> bool:
        with self._plock:
            return self._pending == 0


@element_register
class Tee(Element):
    """1→N fan-out; request src pads src_%u (branch parallelism,
    SURVEY.md §2.6 item 2)."""

    ELEMENT_NAME = "tee"
    DEVICE_TRANSPARENT = True  # copy() shares tensor payloads
    #: tee taps may legitimately leave src pads unlinked (nnlint NNST002
    #: exemption — declared, so subclasses keep it)
    MAY_DANGLE_SRC = True
    #: every branch receives a shallow copy sharing the SAME tensor
    #: objects (routers like round_robin send each buffer to one branch)
    DUPLICATES_BUFFERS = True

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def request_pad(self, name: str = "src_%u") -> Pad:
        pad = self._request_indexed_pad(name, "src", self.add_src_pad)
        # propagate already-negotiated caps to late-linked branches
        if self.sink_pad.caps is not None:
            pad.caps = self.sink_pad.caps
        return pad

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if sanitizer.active():
            # every branch shares these tensors: freeze host arrays and
            # record torch tensors' version counters, so an in-place write
            # downstream is attributed (NNST600) instead of silently
            # corrupting sibling branches
            sanitizer.freeze_buffer(buf)
        ret = FlowReturn.OK
        for sp in self.src_pads:
            r = sp.push(buf.copy())
            if r == FlowReturn.ERROR:
                ret = r
        return ret


@element_register
class CapsFilter(Element):
    """Pass-through that constrains negotiation (gst capsfilter).
    Prop: caps (Caps or string)."""

    ELEMENT_NAME = "capsfilter"
    DEVICE_TRANSPARENT = True
    PROPERTY_SCHEMA = {"caps": Prop("caps", required=True)}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        caps = self.properties.get("caps")
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        self.caps_prop: Optional[Caps] = caps
        if caps is not None:
            self.sink_pad.template = caps
            self.src_pad.template = caps

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        if self.caps_prop is None:
            return caps
        out = caps.intersect(self.caps_prop)
        if out.is_empty():
            from nnstreamer_tpu_torch.log import ElementError

            raise ElementError(self.name, f"caps {caps} rejected by filter {self.caps_prop}")
        return out.fixate() if not out.is_fixed() else out


@element_register
class Identity(Element):
    """Pass-through; prop sleep_time (ns between buffers) for tests.
    (``tensor_debug``, elements/iio_debug.py, is the inspecting one.)"""

    ELEMENT_NAME = "identity"
    DEVICE_TRANSPARENT = True
    PROPERTY_SCHEMA = {
        "sleep_time": Prop("number", doc="ns between buffers"),
        "silent": Prop("bool"),
    }

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        st = self.properties.get("sleep_time")
        if st:
            time.sleep(st / 1e9)
        if not self.properties.get("silent", True):
            log.warning("[%s] %r", self.name, buf)
        return self.push(buf)


@element_register
class FileSrc(SourceElement):
    """Reads a file and emits its bytes as one buffer (prop: location,
    blocksize=-1 for whole file)."""

    ELEMENT_NAME = "filesrc"
    PROPERTY_SCHEMA = {
        "location": Prop("str", required=True),
        "blocksize": Prop("int", doc="-1 = whole file"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fh = None
        self._done = False

    def start(self) -> None:
        self._fh = open(self.properties["location"], "rb")
        self._done = False

    def stop(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def create(self) -> Optional[Buffer]:
        if self._done:
            return None
        bs = int(self.properties.get("blocksize", -1))
        data = self._fh.read() if bs <= 0 else self._fh.read(bs)
        if not data:
            return None
        if bs <= 0:
            self._done = True
        return Buffer(tensors=[data])


@element_register
class FileSink(Element):
    """Appends every incoming tensor's raw bytes to a file (prop: location).
    The golden-test workhorse (SSAT callCompareTest pattern,
    tests/nnstreamer_filter_tensorflow2_lite/runTest.sh:10-60)."""

    ELEMENT_NAME = "filesink"
    PROPERTY_SCHEMA = {"location": Prop("str", required=True)}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fh = None

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def start(self) -> None:
        self._fh = open(self.properties["location"], "wb")

    def stop(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        tensors = buf.tensors
        if any(is_backend_tensor(t) for t in tensors):
            self._record_crossing("d2h", nbytes=nbytes_of(
                [t for t in tensors if is_backend_tensor(t)]))
            tensors = materialize_tensors(tensors)  # one pipelined fetch
        for t in tensors:
            if isinstance(t, (bytes, bytearray, memoryview)):
                self._fh.write(bytes(t))
            else:
                self._fh.write(np.ascontiguousarray(np.asarray(t)).tobytes())
        return FlowReturn.OK

    def on_eos(self) -> None:
        if self._fh:
            self._fh.flush()


@element_register
class VideoTestSrc(SourceElement):
    """Synthetic video frames for tests/benches. Props: num_buffers,
    width/height (or caps), format (RGB|GRAY8), pattern (smpte|solid|counter),
    fps."""

    ELEMENT_NAME = "videotestsrc"
    SRC_TEMPLATE = "video/x-raw"
    PROPERTY_SCHEMA = {
        "num_buffers": Prop("int"),
        "width": Prop("int"),
        "height": Prop("int"),
        "format": Prop("enum", enum=("RGB", "GRAY8")),
        "pattern": Prop("enum", enum=("smpte", "solid", "counter")),
        "fps": Prop("int"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._i = 0

    def negotiate(self) -> Caps:
        w = int(self.properties.get("width", 320))
        h = int(self.properties.get("height", 240))
        fmt = self.properties.get("format", "RGB")
        fps = int(self.properties.get("fps", 30))
        return Caps.from_string(
            f"video/x-raw,format={fmt},width={w},height={h},framerate={fps}/1"
        )

    def create(self) -> Optional[Buffer]:
        n = int(self.properties.get("num_buffers", 10))
        if 0 <= n <= self._i:
            return None
        w = int(self.properties.get("width", 320))
        h = int(self.properties.get("height", 240))
        fmt = self.properties.get("format", "RGB")
        ch = 1 if fmt == "GRAY8" else 3
        pattern = self.properties.get("pattern", "counter")
        if pattern == "solid":
            frame = np.full((h, w, ch), self._i % 256, dtype=np.uint8)
        else:  # counter: deterministic, frame-varying
            base = (np.arange(h * w * ch, dtype=np.int64) + self._i) % 256
            frame = base.reshape(h, w, ch).astype(np.uint8)
        fps = int(self.properties.get("fps", 30))
        buf = Buffer(tensors=[frame], pts=int(self._i * 1e9 / fps),
                     duration=int(1e9 / fps))
        self._i += 1
        return buf
