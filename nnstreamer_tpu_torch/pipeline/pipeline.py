"""Pipeline container: element graph, state management, streaming threads, bus.

GStreamer parity: GstPipeline + GstBus. Sources run in their own streaming
threads (one per source, started on PLAYING); ``queue`` elements add further
thread boundaries. The bus carries out-of-band messages (error / eos /
element messages) to the application thread.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nnstreamer_tpu_torch import meta as meta_mod
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.buffer import Event
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, SourceElement, State

log = get_logger("pipeline")


@dataclass
class Message:
    type: str  # 'eos' | 'error' | element-defined
    data: dict = field(default_factory=dict)


#: fault-record ring capacity — under sustained injected faults the
#: ledger must stay bounded for the life of the pipeline; the counters
#: below stay monotonic so regression detection never loses events
FAULT_RING_SIZE = 256


class Bus:
    def __init__(self):
        self._q: "_queue.Queue[Message]" = _queue.Queue()
        self._eos_evt = threading.Event()
        self._error: Optional[Message] = None
        # fault-domain record: every policy action (drop/retry/restart/
        # abort, watchdog trips, backend fallback) attributed to its
        # element — the error *dispatcher's* ledger. Bounded ring: the
        # last FAULT_RING_SIZE entries keep the detail, the monotonic
        # (element, action) counters keep the totals (tracer/doctor and
        # the rollout canary read the counters, never the ring length)
        self._faults: deque = deque(maxlen=FAULT_RING_SIZE)
        self._fault_counts: Dict[tuple, int] = {}
        self._fault_seq = 0
        self._faults_lock = lockwitness.make_lock("pipeline.faults")

    def reset(self) -> None:
        """Clear sticky EOS/error state (called on pipeline restart)."""
        self._eos_evt.clear()
        self._error = None
        with self._faults_lock:
            self._faults.clear()
            self._fault_counts.clear()
            self._fault_seq = 0

    def record_fault(self, element: str, action: str, error=None,
                     **detail) -> None:
        rec = {"element": element, "action": action, "time": time.monotonic()}
        if error is not None:
            rec["error"] = str(error)
        rec.update(detail)
        with self._faults_lock:
            self._faults.append(rec)
            key = (element, action)
            self._fault_counts[key] = self._fault_counts.get(key, 0) + 1
            self._fault_seq += 1

    @property
    def fault_record(self) -> List[dict]:
        """The ring's surviving entries (most recent FAULT_RING_SIZE)."""
        with self._faults_lock:
            return list(self._faults)

    def fault_counts(self, element: Optional[str] = None) -> Dict[str, int]:
        """Monotonic per-action totals, optionally scoped to one element.
        Unlike :attr:`fault_record` these never lose events to the ring."""
        with self._faults_lock:
            out: Dict[str, int] = {}
            for (el, action), n in self._fault_counts.items():
                if element is not None and el != element:
                    continue
                key = action if element is not None else f"{el}:{action}"
                out[key] = out.get(key, 0) + n
            return out

    def fault_total(self, element: Optional[str] = None) -> int:
        """Monotonic total fault count (optionally one element's) — the
        rollout canary's regression baseline reads this, not the ring."""
        with self._faults_lock:
            return sum(n for (el, _a), n in self._fault_counts.items()
                       if element is None or el == element)

    def post(self, mtype: str, data: Optional[dict] = None) -> None:
        msg = Message(mtype, data or {})
        if mtype == "eos":
            self._eos_evt.set()
        if mtype == "error" and self._error is None:
            self._error = msg
            self._eos_evt.set()  # unblock waiters on fatal errors
        self._q.put(msg)

    def pop(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def wait_eos(self, timeout: Optional[float] = None) -> bool:
        """Block until EOS (or error) reaches the bus."""
        return self._eos_evt.wait(timeout)

    @property
    def error(self) -> Optional[Message]:
        return self._error


class Pipeline:
    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.elements: Dict[str, Element] = {}
        self.bus = Bus()
        self._threads: List[threading.Thread] = []
        self._running = threading.Event()
        self.state = State.NULL
        self._eos_lock = lockwitness.make_lock("pipeline.eos")
        self._sinks_eos: set = set()
        self._sources_done = 0
        self._n_sources = 0
        self._n_sinks = 0
        self.tracer = None  # set by trace.attach()
        # transform fusion into adjacent tensor_filter backends: 'auto'
        # (default — fuse every bit-parity-eligible chain at the PLAYING
        # transition) | 'off'. NNSTPU_FUSION=off disables globally;
        # per-element `fusion=off` opts single elements out.
        self.fusion: str = "auto"
        # whole-chain filter→filter fusion: 'auto' (default — compose every
        # NNST450 chain into its head at the PLAYING transition) | 'off'.
        # NNSTPU_CHAIN_FUSION=off disables globally; per-element
        # `chain-fusion=off` opts single filters out. Rides the `fusion`
        # gate: fusion=off disables chain fusion too.
        self.chain_fusion: str = "auto"
        self._abort_lock = lockwitness.make_lock("pipeline.abort")
        self._aborting = False

    # -- graph construction ------------------------------------------------
    def add(self, *elements: Element) -> None:
        for e in elements:
            if e.name in self.elements:
                raise ValueError(f"duplicate element name {e.name!r}")
            self.elements[e.name] = e
            e.pipeline = self

    def get(self, name: str) -> Element:
        return self.elements[name]

    def __getitem__(self, name: str) -> Element:
        return self.elements[name]

    def link(self, *elements: Element) -> None:
        """Link a chain a!b!c using first free src/sink pads (request pads on
        demand for tee/mux-style elements)."""
        for up, down in zip(elements, elements[1:]):
            src = self._free_src_pad(up)
            sink = self._free_sink_pad(down)
            src.link(sink)

    @staticmethod
    def _free_src_pad(e: Element):
        for p in e.src_pads:
            if p.peer is None and not p.reserved:
                return p
        return e.request_pad("src_%u")

    @staticmethod
    def _free_sink_pad(e: Element):
        for p in e.sink_pads:
            if p.peer is None and not p.reserved:
                return p
        return e.request_pad("sink_%u")

    # -- state -------------------------------------------------------------
    def set_state(self, target: State) -> None:
        if target == self.state:
            return
        if self.state == State.ERROR:
            # ERROR is only left downward: full reset to NULL (elements
            # release resources), then climb to the target from scratch —
            # otherwise set_state's direction heuristic would take the
            # shutdown path for play() and never restart the sources
            self._stop_sources()
            for e in self._topo_order(reverse=False):
                e.change_state(State.NULL)
            self.state = State.NULL
            if target == State.NULL:
                return
        going_up = target.value > self.state.value
        # sinks-first downstream->upstream on the way up (so downstream is
        # ready before sources start), sources-first on the way down
        order = self._topo_order(reverse=going_up)
        if going_up:
            for e in order:
                e.change_state(target)
            if target == State.PLAYING:
                # NNSTPU_TRACE_SPANS=1 with no tracer attached: auto-attach
                # a span-enabled one, so the env var alone turns the span
                # flight-recorder on (trace.attach is idempotent — an
                # app-attached tracer just gains spans)
                from nnstreamer_tpu_torch import trace as _trace

                if os.environ.get(_trace.SPAN_ENV, "") == "1":
                    _trace.attach(self, spans=True)
                # PLAYING transition, pre-data: fuse eligible
                # tensor_transform runs into adjacent filters' backends
                # and negotiate per-pad device residency (the memory:HBM
                # lane + single materialization boundary). Runs before
                # the sources start, so no buffer is in flight while
                # element roles change.
                from nnstreamer_tpu_torch.pipeline.planner import plan_pipeline

                plan_pipeline(self)
                self._start_sources()
        else:
            self._stop_sources()
            for e in order:
                e.change_state(target)
        self.state = target

    def play(self) -> None:
        self.set_state(State.PLAYING)

    def stop(self) -> None:
        self.set_state(State.NULL)

    def _topo_order(self, reverse: bool = False) -> List[Element]:
        """Elements ordered sources→sinks (or reversed)."""
        elems = list(self.elements.values())
        order: List[Element] = []
        seen = set()

        def visit(e: Element):
            if id(e) in seen:
                return
            seen.add(id(e))
            for sp in e.sink_pads:
                if sp.peer is not None:
                    visit(sp.peer.element)
            order.append(e)

        for e in elems:
            visit(e)
        return list(reversed(order)) if reverse else order

    # -- fatal error dispatch ----------------------------------------------
    def post_fatal(self, element: str, err: Exception,
                   backtrace: Optional[str] = None) -> None:
        """The ``abort`` half of the error dispatcher: post a fatal bus
        message with the element attribution and a backtrace attached
        (GST_ELEMENT_ERROR_BTRACE parity, nnstreamer_log.h:25-80), then
        transition the pipeline to ERROR with EOS-style draining of the
        healthy branches (aggregators flush partial state, sinks see a
        real end-of-stream instead of a wedged graph)."""
        from nnstreamer_tpu_torch.log import format_backtrace

        self.bus.post("error", {
            "element": element, "error": err,
            "backtrace": backtrace or format_backtrace(err)})
        with self._abort_lock:
            if self._aborting:
                return
            self._aborting = True
        # draining pushes events through the graph — never from the
        # failing streaming thread (it may hold locks mid-chain)
        threading.Thread(target=self._abort_drain, name=f"abort:{self.name}",
                         daemon=True).start()

    def _abort_drain(self) -> None:
        self._running.clear()  # sources stop producing
        for e in list(self.elements.values()):
            if not isinstance(e, SourceElement):
                continue
            for sp in e.src_pads:
                try:
                    sp.push_event(Event("eos"))
                except Exception:  # noqa: BLE001 — a branch wedged mid-fault
                    log.exception("abort drain: EOS through %s failed", e.name)
        self.state = State.ERROR

    # -- streaming threads -------------------------------------------------
    def _start_sources(self) -> None:
        self.bus.reset()
        with self._abort_lock:
            self._aborting = False
        with self._eos_lock:
            self._sinks_eos.clear()
            self._sources_done = 0
        # terminal sinks (no src pads) gate bus EOS; EOS must traverse the
        # graph — including queue threads — before run() tears anything down
        self._n_sinks = sum(1 for e in self.elements.values() if not e.src_pads)
        sources = [e for e in self.elements.values() if isinstance(e, SourceElement)]
        self._n_sources = len(sources)
        self._running.set()
        for e in sources:
            t = threading.Thread(
                target=self._source_loop, args=(e,), name=f"src:{e.name}", daemon=True
            )
            self._threads.append(t)
            t.start()

    def _stop_sources(self) -> None:
        self._running.clear()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    def _source_loop(self, src: SourceElement) -> None:
        try:
            caps = src.negotiate()
            if caps is not None:
                for sp in src.src_pads:
                    sp.push_event(Event("caps", {"caps": caps}))
        except Exception as e:  # noqa: BLE001 — negotiation is pre-data: fatal
            log.exception("source %s failed to negotiate", src.name)
            self.post_fatal(getattr(e, "element", src.name), e)
            return
        consec_errors = 0
        while self._running.is_set():
            tracer = self.tracer
            spans = tracer.spans if tracer is not None else None
            t_produce = time.perf_counter() if spans is not None else 0.0
            try:
                buf = src.create()
            except Exception as e:  # noqa: BLE001 — source's on-error policy
                consec_errors += 1
                if self._dispatch_source_error(src, e, consec_errors):
                    continue
                return
            consec_errors = 0
            if buf is None:
                if not self._running.is_set():
                    return  # teardown unblock, not a real end-of-stream
                self._send_src_eos(src)
                return
            if spans is not None:
                # source-produce span: create() wall time, including any
                # wait for data (appsrc pop) — the buffer acquires its
                # trace context here, at the stream's true origin
                ctx = meta_mod.ensure_trace_ctx(buf)
                spans.emit(src.name, "source", t_produce,
                           time.perf_counter(),
                           args={"buf": ctx.buffer_id})
            t_push = time.perf_counter() if spans is not None else 0.0
            try:
                ret = src.push(buf)
            except ElementError as e:
                self.post_fatal(e.element, e)
                return
            except Exception as e:  # noqa: BLE001
                log.exception("source %s crashed pushing", src.name)
                self.post_fatal(src.name, e)
                return
            finally:
                if spans is not None:
                    # the source's push into the graph: downstream chain
                    # spans nest inside, so this span's SELF time is the
                    # per-frame pad/dispatch plumbing no chain owns
                    # (attributed to python_dispatch in the roll-up)
                    spans.emit("src-emit", "emit", t_push,
                               time.perf_counter(),
                               args={"element": src.name})
            if ret == FlowReturn.ERROR:
                # downstream already dispatched its own policy (abort posts
                # the attributed fatal) — don't double-post, just stop
                # feeding this branch
                if self.bus.error is None:
                    self.bus.post("error", {
                        "element": src.name,
                        "error": RuntimeError("downstream flow error")})
                return
            if ret == FlowReturn.EOS:
                self._send_src_eos(src)
                return

    def _dispatch_source_error(self, src: SourceElement, err: Exception,
                               consec: int) -> bool:
        """Apply the source's ``on-error`` policy to a create() failure.
        Returns True when the streaming loop should keep going."""
        kind, retries = src.error_policy()
        log.warning("[%s] create error (policy=%s): %s", src.name, kind, err)
        if kind == "drop":
            src.error_stats["dropped"] += 1
            src._note_fault("drop", err, policy=kind,
                            count=src.error_stats["dropped"])
            # pace the loop: a permanently failing create() under drop
            # must not spin a core / flood the fault record
            time.sleep(float(src.properties.get(
                "retry_backoff_ms", src.DEFAULT_RETRY_BACKOFF_MS)) / 1e3)
            return True
        if kind == "retry":
            if consec > retries:
                src._abort_with(err, policy=kind)
                return False
            delay = float(src.properties.get(
                "retry_backoff_ms", src.DEFAULT_RETRY_BACKOFF_MS)) / 1e3
            delay *= 2 ** (consec - 1)
            src.error_stats["retries"] += 1
            src._note_fault("retry", err, policy=kind, attempt=consec,
                            backoff_s=delay)
            time.sleep(delay)
            return self._running.is_set()
        if kind == "restart":
            try:
                src._restart_for_error()
            except Exception as e2:  # noqa: BLE001 — restart itself failed
                src._abort_with(e2, policy=kind)
                return False
            src.error_stats["restarts"] += 1
            src._note_fault("restart", err, policy=kind)
            return self._running.is_set()
        src._abort_with(err, policy=kind)
        return False

    def _send_src_eos(self, src: SourceElement) -> None:
        for sp in src.src_pads:
            sp.push_event(Event("eos"))
        with self._eos_lock:
            self._sources_done += 1
            all_done = self._sources_done >= self._n_sources
        # no-sink pipelines (tap/unlinked tails): sources finishing is the
        # only EOS signal available
        if all_done and self._n_sinks == 0:
            self.bus.post("eos")

    def _sink_got_eos(self, sink: Element) -> None:
        """A terminal sink saw EOS (called off Element._on_sink_event)."""
        with self._eos_lock:
            self._sinks_eos.add(sink.name)
            done = len(self._sinks_eos) >= self._n_sinks > 0
        if done:
            self.bus.post("eos")

    # -- convenience -------------------------------------------------------
    def run(self, timeout: Optional[float] = None) -> None:
        """play() then block until EOS; raises on bus error. For batch
        (file→file) pipelines and tests."""
        self.play()
        try:
            if not self.bus.wait_eos(timeout):
                raise TimeoutError(f"pipeline {self.name!r} did not reach EOS in {timeout}s")
            err = self.bus.error
            if err is not None:
                e = err.data.get("error")
                raise e if isinstance(e, Exception) else RuntimeError(str(err.data))
        finally:
            self.stop()

    def query_latency(self) -> int:
        """Pipeline LATENCY query analogue: the worst-case source→sink path
        latency in ns (GST_QUERY_LATENCY accumulates along each path and
        sinks take the max; parallel branches do NOT add). tensor_filter
        contributes when latency-report=1 (tensor_filter.c:1381-1421)."""
        memo: dict = {}

        def path_latency(e) -> int:
            if e.name in memo:
                return memo[e.name]
            own = e.query_latency()
            downstream = [
                sp.peer.element
                for sp in e.src_pads
                if sp.peer is not None and sp.peer.element is not None
            ]
            best = max((path_latency(d) for d in downstream), default=0)
            memo[e.name] = own + best
            return memo[e.name]

        sources = [
            e
            for e in self.elements.values()
            if not any(sp.peer is not None for sp in e.sink_pads)
        ]
        return max((path_latency(s) for s in sources), default=0)

    def wait_idle(self, timeout: float = 10.0, poll: float = 0.005) -> None:
        """Wait until queue elements are drained (test helper — parity with
        tests/unittest_util.c pipeline poll helpers)."""
        from nnstreamer_tpu_torch.elements.basic import QueueElement

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(q.is_idle() for q in self.elements.values()
                   if isinstance(q, QueueElement)):
                return
            time.sleep(poll)
        raise TimeoutError("pipeline did not go idle")
