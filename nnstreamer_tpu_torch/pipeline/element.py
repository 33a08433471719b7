"""Element / Pad primitives — the GstElement/GstPad analogue we own.

Semantics mirrored from the reference's host substrate (SURVEY.md §1 L0):
  - pads have a direction and template caps; linking checks template
    intersection; caps events negotiate concrete per-stream configs before
    data flows (GstBaseTransform transform_caps/fixate/set_caps pattern used
    by tensor_filter, tensor_filter.c:1151,1274,1309)
  - buffers and serialized events travel downstream on the pusher's thread;
    ``queue`` elements introduce thread boundaries (stage parallelism,
    SURVEY.md §2.6 item 1)
  - chain returns a FlowReturn: OK / DROPPED (QoS, tensor_filter.c:512) /
    EOS / ERROR
"""

from __future__ import annotations

import enum
import itertools
import time
from typing import Dict, List, Optional, Type

from nnstreamer_tpu_torch import meta as meta_mod
from nnstreamer_tpu_torch.analysis import lockwitness, sanitizer
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import (
    Buffer,
    Event,
    is_backend_tensor,
    materialize_tensors,
    nbytes_of,
)
from nnstreamer_tpu_torch.caps import FEATURE_MEMORY_HBM, Caps
from nnstreamer_tpu_torch.log import ElementError, get_logger

log = get_logger("pipeline")


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class FlowReturn(enum.Enum):
    OK = 0
    DROPPED = 1  # buffer consumed but intentionally not forwarded (QoS/if)
    EOS = 2
    ERROR = -1
    NOT_NEGOTIATED = -2


def parse_error_policy(value) -> "tuple[str, int]":
    """Parse an ``on-error`` property value into (kind, retries).

    Grammar: ``abort`` (default) | ``drop`` | ``retry`` | ``retry:<N>`` |
    ``restart``. Unknown values raise at parse time — a typo'd policy
    must fail loudly, not silently mean abort."""
    v = str(value or "abort").strip().lower()
    if v in ("abort", "drop", "restart"):
        return v, 0
    if v == "retry" or v.startswith("retry:"):
        _, _, n = v.partition(":")
        return "retry", max(1, int(n)) if n else 3
    raise ValueError(
        f"bad on-error policy {value!r} (abort|drop|retry:<N>|restart)")


def _valid_on_error(value) -> "Optional[str]":
    """Prop validator for the ``on-error`` grammar (NNST103)."""
    try:
        parse_error_policy(value)
        return None
    except (ValueError, TypeError) as e:
        return str(e)


class State(enum.Enum):
    NULL = 0
    READY = 1
    PAUSED = 2
    PLAYING = 3
    # pipeline-level only (elements never enter it): a fatal error was
    # dispatched and healthy branches were drained; leave via stop()
    ERROR = 4


class Pad:
    """One connection point. Src pads push to their linked peer's element."""

    def __init__(
        self,
        element: "Element",
        name: str,
        direction: PadDirection,
        template: Optional[Caps] = None,
    ):
        self.element = element
        self.name = name
        self.direction = direction
        self.template = template if template is not None else Caps.any_()
        self.peer: Optional[Pad] = None
        self.caps: Optional[Caps] = None  # negotiated
        self.eos = False
        self.reserved = False  # claimed by a deferred link (parse forward ref)
        # residency negotiation (set by pipeline.planner at PLAYING):
        #   device_ok — src pads: everything downstream of this pad (looking
        #     through residency-transparent elements) accepts the backend's
        #     tensors as they are. None = unplanned (device buffers flow,
        #     host consumers fetch for themselves); False = this element
        #     is the materialization boundary.
        #   device_resident — this src pad will actually carry device
        #     buffers (producer produces AND downstream accepts); its caps
        #     events get stamped with the memory:HBM feature.
        self.device_ok: Optional[bool] = None
        self.device_resident: bool = False

    # -- linking -----------------------------------------------------------
    def link(self, sink_pad: "Pad") -> None:
        if self.direction != PadDirection.SRC or sink_pad.direction != PadDirection.SINK:
            raise ElementError(self.element.name, f"bad link direction {self} -> {sink_pad}")
        if self.peer is not None or sink_pad.peer is not None:
            raise ElementError(self.element.name, f"pad already linked: {self} or {sink_pad}")
        if not self.template.can_intersect(sink_pad.template):
            raise ElementError(
                self.element.name,
                f"cannot link {self}: caps {self.template} !∩ {sink_pad.template}",
            )
        self.peer = sink_pad
        sink_pad.peer = self

    def unlink(self) -> None:
        if self.peer is not None:
            self.peer.peer = None
            self.peer = None

    # -- data flow (src->downstream) ---------------------------------------
    def push(self, buf: Buffer) -> FlowReturn:
        """Push a buffer downstream (src pads only)."""
        if sanitizer.active():
            # NNST602: backend tensors in, host out, no billed d2h → an
            # un-billed materialization (checked at the push boundary,
            # where the conversion is observable)
            sanitizer.check_push(self.element, buf)
        peer = self.peer
        if peer is None:
            return FlowReturn.OK  # unlinked src: drop (gst would error; be lenient for taps)
        if peer.caps is None and self.caps is not None:
            # late caps delivery (link established after negotiation)
            peer.receive_event(Event("caps", {"caps": self.caps}))
        return peer.element._chain_guard(peer, buf)

    def push_event(self, event: Event) -> None:
        if event.type == "caps":
            caps = event.data["caps"]
            if self.device_resident and not caps.has_feature(
                    FEATURE_MEMORY_HBM):
                # this edge was negotiated device-resident: downstream
                # introspection reads residency off the caps (the JAX
                # package's token, so its caps strings parse unchanged)
                caps = caps.with_feature(FEATURE_MEMORY_HBM)
                event = Event("caps", {"caps": caps})
            self.caps = caps
        if event.type == "eos":
            self.eos = True
        if self.peer is not None:
            self.peer.receive_event(event)

    # -- sink side ---------------------------------------------------------
    def receive_event(self, event: Event) -> None:
        assert self.direction == PadDirection.SINK
        if event.type == "caps":
            caps: Caps = event.data["caps"]
            inter = caps.intersect(self.template)
            if inter.is_empty():
                raise ElementError(
                    self.element.name,
                    f"caps not accepted on {self.name}: {caps} !∩ template {self.template}",
                )
            self.caps = inter.fixate() if not inter.is_fixed() else inter
            self.element._on_sink_caps(self, self.caps)
            return
        if event.type == "eos":
            self.eos = True
        self.element._on_sink_event(self, event)

    def __repr__(self) -> str:
        return f"<{self.element.name}:{self.name} {self.direction.value}>"


class Element:
    """Base element. Subclasses implement chain()/negotiation hooks.

    Properties arrive as keyword dict (set_property parity); each subclass
    declares what it understands.
    """

    # subclass overrides
    ELEMENT_NAME: str = "element"
    SINK_TEMPLATE: Optional[str] = None  # caps string or None=ANY
    SRC_TEMPLATE: Optional[str] = None
    #: residency-transparent: forwards buffers without touching tensor
    #: payloads (queue/tee/identity/…) — the residency planner looks
    #: THROUGH these when locating the materialization boundary
    DEVICE_TRANSPARENT: bool = False
    #: declared capability: this element's src pads may legitimately stay
    #: unlinked (tee taps). The dangling-pad lint (NNST002) honors the
    #: declaration instead of hard-coding class names, so subclasses and
    #: renames keep the exemption.
    MAY_DANGLE_SRC: bool = False
    #: property schema (nnlint NNST1xx): what this element understands.
    #: Merged over the MRO by analysis.schema.schema_for — subclasses add
    #: their own entries on top of these base ones.
    PROPERTY_SCHEMA = {
        "name": Prop("str", doc="element name"),
        "on_error": Prop("str", validate=_valid_on_error,
                         doc="abort|drop|retry:<N>|restart"),
        "retry_backoff_ms": Prop("number", doc="first retry backoff"),
        "config_file": Prop("str", doc="'key = value' property file"),
        "fusion": Prop("enum", enum=("auto", "off"),
                       doc="per-element fusion opt-out"),
    }

    _name_counters: Dict[str, "itertools.count"] = {}

    def __init__(self, name: Optional[str] = None, **props):
        cls_name = self.ELEMENT_NAME
        if name is None:
            ctr = Element._name_counters.setdefault(cls_name, itertools.count())
            name = f"{cls_name}{next(ctr)}"
        self.name = name
        self.state = State.NULL
        self.sink_pads: List[Pad] = []
        self.src_pads: List[Pad] = []
        self.pipeline = None  # set by Pipeline.add
        self.properties: Dict[str, object] = {}
        # error-policy runtime counters (read via get_property('error-stats'))
        self.error_stats: Dict[str, int] = {
            "dropped": 0, "retries": 0, "restarts": 0, "aborts": 0}
        # blocking_ok/invoke_ok: the element state lock is deliberately
        # held across start()/stop() work, which may open sockets or
        # compile programs — NNST611/613 police the narrower locks
        self._lock = lockwitness.make_rlock("element.state",
                                            blocking_ok=True,
                                            invoke_ok=True)
        self._setup_pads()
        self.set_properties(**props)

    # -- pads --------------------------------------------------------------
    def _setup_pads(self) -> None:
        """Default: one always-sink + one always-src pad. Sources/sinks and
        request-pad elements override."""
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def add_sink_pad(self, name: str, template: Optional[str] = None) -> Pad:
        t = template if template is not None else self.SINK_TEMPLATE
        pad = Pad(self, name, PadDirection.SINK, Caps(t) if t else Caps.any_())
        self.sink_pads.append(pad)
        return pad

    def add_src_pad(self, name: str, template: Optional[str] = None) -> Pad:
        t = template if template is not None else self.SRC_TEMPLATE
        pad = Pad(self, name, PadDirection.SRC, Caps(t) if t else Caps.any_())
        self.src_pads.append(pad)
        return pad

    @property
    def sink_pad(self) -> Pad:
        return self.sink_pads[0]

    @property
    def src_pad(self) -> Pad:
        return self.src_pads[0]

    def get_pad(self, name: str) -> Optional[Pad]:
        for p in self.sink_pads + self.src_pads:
            if p.name == name:
                return p
        return None

    def request_pad(self, name: str) -> Pad:
        """Request-pad elements (mux/demux/tee) override.
        Parity: GstElement request pads (sink_%u templates)."""
        raise ElementError(self.name, f"element has no request pad {name!r}")

    def _request_indexed_pad(self, name: str, prefix: str, add_fn) -> Pad:
        """Shared request-pad logic honoring explicit indices: requesting
        ``sink_3`` creates pads up through index 3 (list order == index
        order, which combiners rely on); ``sink_%u`` or a bare ref takes
        the next free index."""
        pads = self.sink_pads if prefix == "sink" else self.src_pads
        if name.startswith(f"{prefix}_") and name[len(prefix) + 1:].isdigit():
            want = int(name[len(prefix) + 1:])
            while len(pads) <= want:
                add_fn(f"{prefix}_{len(pads)}")
            return pads[want]
        return add_fn(f"{prefix}_{len(pads)}")

    # -- properties --------------------------------------------------------
    def set_properties(self, **props) -> None:
        for k, v in props.items():
            self.set_property(k, v)

    def set_property(self, key: str, value) -> None:
        # normalize like get_property does — set_property('on-error', …)
        # and set_property('on_error', …) must hit the same slot
        key = key.replace("-", "_")
        if key == "on_error":
            # a typo'd policy must fail at construction, not silently mean
            # abort at the first error months later
            parse_error_policy(value)
        self.properties[key] = value
        # an explicit set wins over a config-file value on later state cycles
        cfg_keys = getattr(self, "_config_file_keys", None)
        if cfg_keys:
            cfg_keys.discard(key)

    def get_property(self, key: str):
        key = key.replace("-", "_")
        if key == "error_stats":
            return dict(self.error_stats)
        return self.properties.get(key)

    # -- lifecycle ---------------------------------------------------------
    def change_state(self, target: State) -> None:
        order = [State.NULL, State.READY, State.PAUSED, State.PLAYING]
        cur, tgt = order.index(self.state), order.index(target)
        step = 1 if tgt > cur else -1
        for i in range(cur + step, tgt + step, step):
            self._transition(self.state, order[i])
            self.state = order[i]

    def _transition(self, old: State, new: State) -> None:
        if (old, new) == (State.NULL, State.READY):
            self._apply_config_file()
            self.start()
        elif (old, new) == (State.READY, State.NULL):
            self.stop()
        elif (old, new) == (State.PAUSED, State.PLAYING):
            self.play()
        elif (old, new) == (State.PLAYING, State.PAUSED):
            self.pause()

    def _apply_config_file(self) -> None:
        """``config-file`` prop: 'key = value' lines applied as element
        properties (gst_tensor_parse_config_file,
        nnstreamer_plugin_api_impl.c:1902-1937; wired on tensor_filter and
        tensor_decoder in the reference, any element here). Explicitly-set
        launch-line properties win over file values."""
        path = self.properties.get("config_file")
        if not path:
            return
        try:
            with open(str(path), "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError as e:
            from nnstreamer_tpu_torch.log import ElementError

            raise ElementError(self.name, f"cannot read config-file {path!r}: {e}")
        from nnstreamer_tpu_torch.pipeline.parse import _coerce

        # keys loaded from a config file on an earlier NULL->READY cycle are
        # re-appliable: only launch-line/user-set properties win over the file
        file_keys: set = getattr(self, "_config_file_keys", set())
        new_file_keys: set = set()
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, value = line.split("=", 1)
            key = key.strip().replace("-", "_")
            if key and (key not in self.properties or key in file_keys):
                # same coercion as launch-line properties: 'sync = false'
                # must store False, not the truthy string "false"
                self.properties[key] = _coerce(value.strip())
                new_file_keys.add(key)
        self._config_file_keys = new_file_keys

    def start(self) -> None:  # NULL->READY: open resources (model open, fw load)
        pass

    def stop(self) -> None:  # READY->NULL: release resources
        pass

    def play(self) -> None:  # PAUSED->PLAYING: begin streaming
        pass

    def pause(self) -> None:
        pass

    # -- dataflow hooks ----------------------------------------------------
    def _chain_guard(self, pad: Pad, buf: Buffer) -> FlowReturn:
        """Chain wrapper: tracing plus the error-policy dispatcher. Any
        exception escaping chain() is routed through the element's
        ``on-error`` policy instead of unwinding the pusher's stack."""
        if sanitizer.active():
            return self._chain_sanitized(pad, buf)
        try:
            return self._chain_traced(pad, buf)
        except Exception as e:  # noqa: BLE001 — policy decides, not the stack
            return self._dispatch_error(pad, buf, e)

    def _chain_sanitized(self, pad: Pad, buf: Buffer) -> FlowReturn:
        """:meth:`_chain_guard` under the sanitizer: the chain runs inside
        a frame, and a tee-shared torch tensor whose version counter this
        chain moved is an NNST600 of this element, raised into its own
        ``on-error`` policy."""
        sanitizer.enter_chain(self, buf)
        try:
            try:
                ret = self._chain_traced(pad, buf)
            finally:
                moved = sanitizer.exit_chain(self)
            if moved is not None:
                raise moved
            return ret
        except Exception as e:  # noqa: BLE001 — policy decides, not the stack
            return self._dispatch_error(pad, buf, e)

    def _spans(self):
        """The pipeline tracer's span flight-recorder, or None (spans off
        or untraced) — the single cheap gate every span site checks (two
        attribute reads when tracing is off)."""
        p = self.pipeline
        if p is None:
            return None
        t = p.tracer
        return t.spans if t is not None else None

    def _chain_traced(self, pad: Pad, buf: Buffer) -> FlowReturn:
        tracer = getattr(self.pipeline, "tracer", None) if self.pipeline else None
        if tracer is None:
            return self.chain(pad, buf)
        t0 = time.perf_counter()
        # GstShark-interlatency role: stamp the buffer at its first
        # traced chain; downstream chains record their age relative
        # to it (rewrapping elements restart the clock — documented
        # on Tracer.record_interlatency)
        born = getattr(buf, "_nns_born_t", None)
        if born is None:
            try:
                buf._nns_born_t = t0
            except AttributeError:
                pass  # slotted/foreign buffer: skip interlatency
        else:
            tracer.record_interlatency(self.name, t0 - born)
        spans = tracer.spans
        if spans is None:
            ret = self.chain(pad, buf)
            tracer.record_chain(self.name, t0, time.perf_counter())
            return ret
        # span mode: a per-buffer context (buffer id + open-span stack)
        # rides the meta dict, and the chain itself becomes a span on
        # this streaming thread's track — downstream chains that run
        # inline on the same thread nest inside it
        ctx = meta_mod.ensure_trace_ctx(buf)
        entry = ctx.push(self.name, t0)
        try:
            ret = self.chain(pad, buf)
        finally:
            t1 = time.perf_counter()
            # depth BEFORE discarding this entry: how many chains held
            # the buffer while this one ran (queue hand-offs overlap) —
            # the span-stack readout that rides into the trace args
            depth = ctx.depth
            ctx.discard(entry)
            # emitted even when chain raises: a flight recorder that
            # loses the crashing span is useless for the crash
            spans.emit(self.name, "chain", t0, t1,
                       args={"buf": ctx.buffer_id, "depth": depth})
        tracer.record_chain(self.name, t0, t1)
        return ret


    # -- error-policy runtime ---------------------------------------------
    #: first retry backoff; doubles per attempt (`retry-backoff-ms` prop)
    DEFAULT_RETRY_BACKOFF_MS = 10.0

    def error_policy(self) -> "tuple[str, int]":
        """(kind, retries) from the ``on-error`` property; default abort —
        the reference's behavior (GST_ELEMENT_ERROR is fatal unless the
        app intervenes)."""
        return parse_error_policy(self.properties.get("on_error"))

    def _note_fault(self, action: str, err: Exception, **detail) -> None:
        """Attribute a fault to this element on the bus record and tracer
        (degradation is visible, never silent)."""
        if self.pipeline is None:
            return
        tracer = getattr(self.pipeline, "tracer", None)
        if tracer is not None:
            tracer.record_fault(self.name, action)
        self.pipeline.bus.record_fault(self.name, action=action,
                                       error=err, **detail)

    def _dispatch_error(self, pad: Optional[Pad], buf: Optional[Buffer],
                        err: Exception) -> FlowReturn:
        """Apply this element's ``on-error`` policy to a chain failure.

        drop       count + skip the frame, stream continues
        retry:<N>  re-chain the same buffer with exponential backoff,
                   escalate to abort after N failures
        restart    serialized close→open of the element, then one re-chain
        abort      fatal bus message with backtrace, pipeline → ERROR with
                   EOS-style draining of healthy branches
        """
        if sanitizer.active():
            # a write into a tee-frozen array surfaces here as numpy's
            # read-only ValueError: convert it to an attributed NNST600
            # violation before the policy decides what to do with it
            conv = sanitizer.intercept_chain_error(self, err)
            if conv is not None:
                err = conv
        kind, retries = self.error_policy()
        log.warning("[%s] chain error (policy=%s): %s", self.name, kind, err)
        if kind == "drop":
            self.error_stats["dropped"] += 1
            self._note_fault("drop", err, policy=kind,
                            count=self.error_stats["dropped"])
            self.post_message("error-dropped", {
                "error": str(err), "count": self.error_stats["dropped"]})
            return FlowReturn.DROPPED
        if kind == "retry" and pad is not None:
            base = float(self.properties.get(
                "retry_backoff_ms", self.DEFAULT_RETRY_BACKOFF_MS)) / 1e3
            for attempt in range(retries):
                delay = base * (2 ** attempt)
                self.error_stats["retries"] += 1
                self._note_fault("retry", err, policy=kind,
                                 attempt=attempt + 1, backoff_s=delay)
                time.sleep(delay)
                try:
                    return self.chain(pad, buf)
                except Exception as e2:  # noqa: BLE001 — next attempt/abort
                    err = e2
            return self._abort_with(err, policy=kind)
        if kind == "restart":
            try:
                self._restart_for_error()
            except Exception as e2:  # noqa: BLE001 — restart itself failed
                return self._abort_with(e2, policy=kind)
            self.error_stats["restarts"] += 1
            self._note_fault("restart", err, policy=kind)
            self.post_message("element-restarted", {"error": str(err)})
            if pad is None:
                return FlowReturn.OK
            try:
                return self.chain(pad, buf)
            except Exception as e2:  # noqa: BLE001 — restart didn't cure it
                return self._abort_with(e2, policy=kind)
        return self._abort_with(err, policy=kind)

    def _restart_for_error(self) -> None:
        """on-error=restart: serialized close→open of this element against
        its hot loop. The base cycles stop()/start() under the element
        lock; elements with their own hot-loop serialization take it in
        stop()/start() (tensor_filter's ``_window_lock``, which also
        serializes model reloads)."""
        with self._lock:
            self.stop()
            self.start()

    def _abort_with(self, err: Exception, policy: str = "abort") -> FlowReturn:
        """Fatal path: backtrace-augmented bus error + pipeline ERROR
        transition (GST_ELEMENT_ERROR_BTRACE discipline)."""
        from nnstreamer_tpu_torch.log import format_backtrace

        bt = format_backtrace(err)
        self.error_stats["aborts"] += 1
        self._note_fault("abort", err, policy=policy)
        if self.pipeline is not None:
            self.pipeline.post_fatal(self.name, err, backtrace=bt)
        else:
            log.error("[%s] fatal: %s\n%s", self.name, err, bt)
        return FlowReturn.ERROR

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        """Process one buffer arriving on a sink pad. Default: passthrough."""
        return self.push(buf)

    def push(self, buf: Buffer, pad_index: int = 0) -> FlowReturn:
        """Push downstream on the nth src pad."""
        if not self.src_pads:
            return FlowReturn.OK
        return self.src_pads[pad_index].push(buf)

    # -- residency negotiation (memory:HBM lane) ---------------------------
    def accepts_device(self, pad: "Pad") -> bool:
        """Sink-side advertisement: True when this element consumes the
        backend's tensors untouched (no fetch to the host inside
        chain()). Default: host-only."""
        return False

    def produces_device(self, pad: "Pad") -> bool:
        """Src-side advertisement: True when this element's outputs on
        ``pad`` can be the backend's tensors."""
        return False

    def _record_crossing(self, direction: str, n: int = 1,
                         nbytes: int = 0, devices: int = 1) -> None:
        """Attribute ``n`` link crossings ('h2d' | 'd2h') to this element
        on the pipeline tracer. One pipelined multi-array transfer = one
        crossing (the link bills round trips, not arrays); ``nbytes`` is
        the payload it moved (buffer.nbytes_of over the transferred
        arrays). ``devices`` > 1 marks a mesh-sharded transfer: the payload
        splits evenly across that many shards, and the tracer banks the
        per-device bytes alongside the total."""
        tracer = getattr(self.pipeline, "tracer", None) if self.pipeline else None
        if tracer is not None:
            tracer.record_crossing(self.name, direction, n, nbytes=nbytes,
                                   devices=devices)
        if sanitizer.active():
            sanitizer.note_crossing(self, direction)

    def _fetch_to_host(self, buf: Buffer) -> Buffer:
        """``buf`` with the backend's tensors (``is_backend_tensor``)
        brought to the host in one batched transfer, billed as one ``d2h``
        crossing of this element; ``buf`` itself when it holds none. The
        host elements call it before they read values, and pass the host
        copy on, so a frame crosses once. On a planned pipeline the
        boundary upstream has fetched already and this is a no-op; it
        serves unplanned graphs and elements driven by hand."""
        dev = [t for t in buf.tensors if is_backend_tensor(t)]
        if not dev:
            return buf
        self._record_crossing("d2h", nbytes=nbytes_of(dev))
        return buf.with_tensors(materialize_tensors(buf.tensors))

    # -- negotiation hooks -------------------------------------------------
    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        """Sink caps fixed → compute and send src caps. Default: same caps
        (passthrough transform)."""
        out = self.transform_caps(pad, caps)
        if out is not None:
            for sp in self.src_pads:
                sp.push_event(Event("caps", {"caps": out}))

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        """Map fixed sink caps → fixed src caps (GstBaseTransform
        transform_caps + fixate collapsed, since sink caps arrive fixed)."""
        return caps

    def _on_sink_event(self, pad: Pad, event: Event) -> None:
        """Non-caps event on a sink pad. Default: forward when all sink pads
        agree (EOS waits for every sink pad — collectpads semantics)."""
        if event.type == "eos":
            if all(p.eos for p in self.sink_pads):
                self.on_eos()
                for sp in self.src_pads:
                    sp.push_event(event)
                if not self.src_pads and self.pipeline is not None:
                    # terminal sink: EOS has traversed the whole graph
                    # (including queue threads) — report for bus EOS
                    self.pipeline._sink_got_eos(self)
            return
        for sp in self.src_pads:
            sp.push_event(event)

    def on_eos(self) -> None:
        """Flush any aggregated state before EOS propagates."""

    def query_latency(self) -> int:
        """Estimated processing latency this element adds, in ns (the
        GST_QUERY_LATENCY analogue; tensor_filter reports its measured
        invoke window here, tensor_filter.c:1369-1431). Default: 0."""
        return 0

    def send_upstream_event(self, event: Event) -> None:
        """Send an event upstream from this element (QoS throttling — the
        tensor_rate → tensor_filter path, gsttensor_rate.c:452 /
        tensor_filter.c:512)."""
        for sp in self.sink_pads:
            if sp.peer is not None:
                sp.peer.element.on_upstream_event(sp.peer, event)

    def on_upstream_event(self, pad: "Pad", event: Event) -> None:
        """An upstream-travelling event arrived on a src pad. Default:
        keep forwarding upstream."""
        self.send_upstream_event(event)

    # -- messages ----------------------------------------------------------
    def post_error(self, err: Exception) -> None:
        if self.pipeline is not None:
            self.pipeline.bus.post("error", {"element": self.name, "error": err})
        else:
            log.error("[%s] %s", self.name, err)

    def post_message(self, mtype: str, data: dict) -> None:
        if self.pipeline is not None:
            self.pipeline.bus.post(mtype, {"element": self.name, **data})

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class SourceElement(Element):
    """Push-source base: the pipeline runs ``create()`` in a streaming thread
    while PLAYING (GstBaseSrc/GstPushSrc analogue)."""

    def _setup_pads(self) -> None:
        self.add_src_pad("src")

    def create(self) -> Optional[Buffer]:
        """Produce the next buffer, or None for EOS."""
        raise NotImplementedError

    def negotiate(self) -> Optional[Caps]:
        """Fixed caps for this source's stream, sent before first buffer."""
        return None

    # The streaming loop lives in Pipeline; it calls create() repeatedly.


# --- element factory ------------------------------------------------------
_element_classes: Dict[str, Type[Element]] = {}


def element_register(cls: Type[Element]) -> Type[Element]:
    """Class decorator: register under cls.ELEMENT_NAME (plus aliases in
    cls.ALIASES). Parity: the plugin registerer
    (gst/nnstreamer/registerer/nnstreamer.c:53-75)."""
    _element_classes[cls.ELEMENT_NAME] = cls
    for alias in getattr(cls, "ALIASES", ()):
        _element_classes[alias] = cls
    return cls


def element_class(type_name: str) -> Optional[Type[Element]]:
    """Registered class for an element type name (None when unknown).
    Used by parse/nnlint to check property schemas before construction."""
    cls = _element_classes.get(type_name)
    if cls is None:
        # lazily pull in the built-in element modules
        import nnstreamer_tpu_torch.elements  # noqa: F401

        cls = _element_classes.get(type_name)
    return cls


def element_factory_make(type_name: str, name: Optional[str] = None, **props) -> Element:
    cls = element_class(type_name)
    if cls is None:
        raise ValueError(
            f"no such element type {type_name!r}; known: {sorted(_element_classes)}"
        )
    _check_element_allowed(type_name)
    return cls(name=name, **props)


def _check_element_allowed(type_name: str) -> None:
    """Element allow-list for security-sensitive deployments
    (meson_options.txt enable-element-restriction parity): ini section
    [element-restriction] enable_element_restriction=true +
    restricted_elements=comma,separated,allow,list."""
    from nnstreamer_tpu_torch.config import conf

    c = conf()
    if not c.get_bool("element-restriction", "enable_element_restriction",
                      False):
        return
    allowed = c.get("element-restriction", "restricted_elements", "") or ""
    allow_set = {a.strip() for a in allowed.split(",") if a.strip()}
    # capsfilter is synthesized by parse_launch for inline caps segments —
    # restricting it would reject pipelines built purely from allowed
    # elements the user actually named
    allow_set.add("capsfilter")
    if type_name not in allow_set:
        raise PermissionError(
            f"element {type_name!r} is not in the configured allow-list"
        )


def element_types() -> List[str]:
    import nnstreamer_tpu_torch.elements  # noqa: F401

    return sorted(_element_classes)
