"""tensor_query elements: offload inference to a remote pipeline.

Parity: gst/nnstreamer/tensor_query/ —
  tensor_query_client     (tensor_query_client.c): acts like a remote
      tensor_filter; per-buffer send + blocking wait on the async receive
      queue (:674-760), caps handshake via CAPABILITY (:447-498).
  tensor_query_serversrc  (tensor_query_serversrc.c:68,233-300): server
      entry; pops received frames, attaches client_id meta
      (GstMetaQuery parity, tensor_meta.h:30-40).
  tensor_query_serversink (tensor_query_serversink.c:287-320): reads
      client_id meta and routes the answer back to that client.
Server handles are shared through a table keyed by ``id``
(tensor_query_server.c:24-67) so src and sink of one server pipeline use
one listener.

A copy of the JAX package's elements over this package's transport and
serving tier; the two packages' clients and servers talk to each other.
The serversink brings a batch's outputs to the host once (one d2h per
batch) before it slices them per client. Not part of this package yet:
``connect-type=HYBRID`` (MQTT discovery), the replica pool
(``replicas=N|auto``) — both raise — and sharded serve-batch placement
into a ``shard=dp`` filter.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import (
    Buffer,
    is_backend_tensor,
    materialize_tensors,
    nbytes_of,
)
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.edge import protocol as proto
from nnstreamer_tpu_torch.edge import tracex
from nnstreamer_tpu_torch.edge.handle import EdgeClient, EdgeServer
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)
from nnstreamer_tpu_torch.types import TensorInfo, TensorsConfig, TensorsInfo


def _valid_weights(value) -> Optional[str]:
    """Prop validator for the ``serve-weights`` grammar (NNST103)."""
    from nnstreamer_tpu_torch.serving.admission import parse_weights

    try:
        parse_weights(value)
        return None
    except (ValueError, TypeError) as e:
        return str(e)


def _valid_ctl_bounds(value) -> Optional[str]:
    """Prop validator for the ``ctl-bounds`` grammar (NNST103)."""
    from nnstreamer_tpu_torch.serving.controller import parse_ctl_bounds

    try:
        parse_ctl_bounds(value)
        return None
    except (ValueError, TypeError) as e:
        return str(e)

log = get_logger("query")

QUERY_DEFAULT_TIMEOUT_SEC = 10.0  # tensor_query_common.h:28

# shared server-handle table (tensor_query_server.c:24-67)
_server_table: Dict[str, EdgeServer] = {}
_server_refs: Dict[str, int] = {}
_server_lock = lockwitness.make_lock("query.server_table")

# serving-scheduler table keyed the same way: the serversink acks each
# demuxed batch back to the serversrc's scheduler (nnctl drain feedback
# + per-launch device window measurement) without holding an element ref
_sched_table: Dict[str, object] = {}


def get_scheduler(key: str):
    """The ServingScheduler registered under query-server id ``key``
    (None when that server is not in serving mode)."""
    with _server_lock:
        return _sched_table.get(key)


def _acquire_server(key: str, host: str, port: int, caps: str) -> EdgeServer:
    with _server_lock:
        srv = _server_table.get(key)
        if srv is None:
            srv = EdgeServer(host=host, port=port, caps=caps)
            srv.start()
            _server_table[key] = srv
            _server_refs[key] = 0
        elif caps and not srv.caps:
            srv.caps = caps
        _server_refs[key] += 1
        return srv


def _release_server(key: str) -> None:
    with _server_lock:
        if key not in _server_table:
            return
        _server_refs[key] -= 1
        if _server_refs[key] <= 0:
            _server_table.pop(key).close()
            _server_refs.pop(key, None)


def _hybrid_unported(element: str) -> ElementError:
    """``connect-type=HYBRID`` discovers the server over MQTT
    (``edge/discovery.py`` and ``edge/mqtt.py`` in the JAX package),
    which this package does not have yet. Fail loudly; never fall back
    to plain TCP."""
    return ElementError(
        element, "connect-type=HYBRID needs MQTT discovery "
                 "(edge/discovery.py, edge/mqtt.py), which "
                 "nnstreamer_tpu_torch does not have yet; use TCP")


def _replicas_unported(element: str, value: str) -> ElementError:
    """``replicas=N|auto`` clones the served program onto N devices
    (the JAX package's ``analysis/pool.py`` and the planner's
    ``install_pool``), which this package does not have yet (ROADMAP
    queue 1 item 8). Fail loudly; never serve one replica in silence."""
    return ElementError(
        element, f"replicas={value} needs the replica pool "
                 "(analysis/pool.py, install_pool; ROADMAP queue 1 item 8), "
                 "which nnstreamer_tpu_torch does not have yet; use "
                 "replicas=off")


def get_server(key: str) -> Optional[EdgeServer]:
    with _server_lock:
        return _server_table.get(key)


@element_register
class TensorQueryClient(Element):
    """Async offload client, the reference's concurrency model
    (tensor_query_client.c: chain sends; the nns-edge event callback
    pushes replies from its own thread). ``chain`` returns as soon as the
    frame is on the wire — up to ``max-in-flight`` (default 32) frames
    pipeline through the server, which is what lets a micro-batching
    server actually fill its batches across clients. A receiver thread
    pushes replies downstream in arrival order; ``timeout=`` still bounds
    reply waiting (QUERY_DEFAULT_TIMEOUT_SEC semantics) — expiry or a
    dead server posts a pipeline error instead of hanging."""

    ELEMENT_NAME = "tensor_query_client"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "connect_type": Prop("enum", enum=("TCP", "HYBRID")),
        "topic": Prop("str"),
        "timeout": Prop("number"),
        "max_in_flight": Prop("int"),
        "reconnect": Prop("bool"),
        "reconnect_retries": Prop("int"),
        "strict": Prop("bool"),
        "out_caps": Prop("caps", doc="downstream caps for server answers"),
        "trace_sample": Prop(
            "int", doc="nntrace-x head sampling: 1 in N requests carries "
                       "a trace context over the wire (0 = off, the "
                       "default — zero added wire bytes)"),
        "endpoints": Prop(
            "str", doc="nnfleet-r failover/hedging: comma list of "
                       "host:port endpoints. One entry behaves exactly "
                       "like host=/port= (fleet machinery off); two or "
                       "more engage headroom routing + failover"),
        "hedge_after_ms": Prop(
            "number", doc="resend an unanswered request to a second "
                          "endpoint after this long (0 = off; NNST980: "
                          "needs endpoints= — hedges carry the _rid "
                          "idempotence key the server dedups by)"),
        "blacklist_ms": Prop(
            "number", doc="how long a dead endpoint stays out of the "
                          "routing set while its redial runs (default "
                          "1000)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[EdgeClient] = None
        self._rx_thread = None
        self._rx_stop = threading.Event()
        self._inflight = 0
        # blocking_ok: append+send are ONE critical section by contract
        # (see chain()) — the reconnect path must never snapshot _sent
        # between the bookkeeping and the wire send, so the send itself
        # lives under this lock
        self._inflight_lock = lockwitness.make_lock(
            "query.client.inflight", blocking_ok=True)
        self._sem: Optional[threading.BoundedSemaphore] = None
        self._last_activity = 0.0
        self._failed = False
        # wire copies of unanswered frames (send order == reply order):
        # after a reconnect they are resent or dropped per the element's
        # on-error policy
        from collections import deque

        self._sent: "deque" = deque()
        # per-frame correlation: every DATA frame carries a ``_seq`` the
        # server echoes in its reply. A serving server sheds some frames
        # with SERVER_BUSY *immediately* while admitted neighbors are
        # still in flight, so replies are no longer guaranteed to arrive
        # in send order — pairing is by seq, FIFO only for servers that
        # don't echo it
        self._seq = itertools.count(1)
        self._busy_retries: Dict[int, int] = {}
        # nntrace-x head sampling state (trace-sample=N → 1 in N)
        self._trace_n = 0
        self._trace_count = 0
        # nnfleet-r state: None = legacy single-endpoint mode (the
        # byte-identical default). With >= 2 endpoints, _fleet holds the
        # endpoint records, _routes maps _seq -> routing bookkeeping
        # (endpoint, send time, hedged flag, resend budget), and every
        # request carries a _rid idempotence key for server-side dedup
        self._fleet = None
        self._fleet_q = None
        self._fleet_threads = []
        self._routes: Dict[int, dict] = {}
        self._rid_prefix = ""
        self._hedge_s = 0.0
        self._blacklist_s = 1.0
        self._ep_rr = 0
        self.fleet_stats = {"hedges": 0, "failovers": 0, "reroutes": 0,
                            "late_replies": 0, "hedge_dup_acks": 0}

    def start(self) -> None:
        host = str(self.properties.get("host", "localhost"))
        port = int(self.properties.get("port", 0))
        eps_spec = str(self.properties.get("endpoints", "") or "").strip()
        if eps_spec:
            from nnstreamer_tpu_torch.edge import fleet

            try:
                eps = fleet.parse_endpoints(eps_spec)
            except ValueError as e:
                raise ElementError(self.name, f"bad endpoints=: {e}")
            if not eps:
                raise ElementError(self.name, "endpoints= named no endpoint")
            if len(eps) >= 2:
                self._start_fleet(eps)
                return
            # single entry: exactly host=/port= — the legacy path below,
            # no _rid, no fleet threads, byte-identical wire frames
            host, port = eps[0]
        ctype = str(self.properties.get("connect_type", "TCP")).upper()
        if ctype == "HYBRID":
            raise _hybrid_unported(self.name)
        if ctype != "TCP":
            raise ElementError(
                self.name,
                f"unknown connect-type {ctype!r} (TCP or HYBRID)",
            )
        if not port:
            raise ElementError(self.name, "tensor_query_client needs port=")
        timeout = float(self.properties.get("timeout", QUERY_DEFAULT_TIMEOUT_SEC))
        self._client = EdgeClient(
            host, port, timeout=timeout,
            # reconnect=1: survive a server bounce with bounded
            # backoff+jitter redial; in-flight frames are then resent or
            # dropped per this element's on-error policy (_on_reconnect)
            reconnect=bool(int(self.properties.get("reconnect", 0) or 0)),
            max_retries=int(self.properties.get("reconnect_retries", 5)),
        )
        try:
            self._client.connect()
        except Exception as e:
            raise ElementError(self.name, f"cannot connect to {host}:{port}: {e}")
        self._sem = threading.BoundedSemaphore(
            max(1, int(self.properties.get("max_in_flight", 32))))
        self._failed = False
        self._inflight = 0
        self._sent.clear()
        self._busy_retries.clear()
        self._trace_n = max(0, int(self.properties.get("trace_sample", 0)
                                   or 0))
        self._trace_count = 0
        self._last_activity = time.monotonic()
        self._rx_stop.clear()
        self._rx_thread = threading.Thread(
            target=self._recv_loop, name=f"query-rx-{self.name}", daemon=True)
        self._rx_thread.start()

    def stop(self) -> None:
        self._rx_stop.set()
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._rx_thread is not None:
            self._rx_thread.join(timeout=2.0)
            self._rx_thread = None
        if self._fleet is not None:
            for ep in self._fleet:
                c = ep.get("client")
                if c is not None:
                    c.close()
            for t in self._fleet_threads:
                t.join(timeout=2.0)
            self._fleet = None
            self._fleet_threads = []
            self._routes.clear()

    # -- nnfleet-r: failover + hedging across N endpoints ------------------
    def _start_fleet(self, eps) -> None:
        """Engage fleet mode: one transport per endpoint, headroom
        routing, failover re-route, bounded hedged resends. Every frame
        carries ``_rid`` (client-unique) so a server that sees the same
        request twice — hedge race, failover resend — invokes it ONCE
        and sheds the copy as ``hedge-duplicate``."""
        import queue as _q
        import uuid

        timeout = float(self.properties.get("timeout",
                                            QUERY_DEFAULT_TIMEOUT_SEC))
        self._timeout = timeout
        self._client = None
        self._failed = False
        self._inflight = 0
        self._sent.clear()
        self._busy_retries.clear()
        self._routes.clear()
        self._trace_n = 0  # fleet frames stay untraced (rid is the key)
        self._rid_prefix = uuid.uuid4().hex[:12]
        self._hedge_s = max(0.0, float(
            self.properties.get("hedge_after_ms", 0) or 0)) / 1e3
        self._blacklist_s = max(0.05, float(
            self.properties.get("blacklist_ms", 1000) or 1000)) / 1e3
        self._max_retries = max(1, int(
            self.properties.get("reconnect_retries", 5)))
        self._sem = threading.BoundedSemaphore(
            max(1, int(self.properties.get("max_in_flight", 32))))
        for k in self.fleet_stats:
            self.fleet_stats[k] = 0
        self._fleet = [{"host": h, "port": p, "client": None,
                        "down_until": 0.0, "dialing": False}
                       for h, p in eps]
        connected = 0
        errs = []
        for ep in self._fleet:
            try:
                ep["client"] = self._dial(ep["host"], ep["port"])
                connected += 1
            except Exception as e:  # noqa: BLE001 — a down endpoint at start
                errs.append(f"{ep['host']}:{ep['port']}: {e}")
                ep["down_until"] = time.monotonic() + self._blacklist_s
        if not connected:
            self._fleet = None
            raise ElementError(
                self.name, "no fleet endpoint reachable: " + "; ".join(errs))
        if errs:
            log.warning("[%s] fleet started degraded (%d/%d up): %s",
                        self.name, connected, len(self._fleet),
                        "; ".join(errs))
        self._last_activity = time.monotonic()
        self._rx_stop.clear()
        self._fleet_q = _q.Queue()
        self._fleet_threads = []
        for i in range(len(self._fleet)):
            t = threading.Thread(target=self._fleet_forward, args=(i,),
                                 name=f"fleet-fwd-{self.name}-{i}",
                                 daemon=True)
            t.start()
            self._fleet_threads.append(t)
        t = threading.Thread(target=self._fleet_recv_loop,
                             name=f"fleet-rx-{self.name}", daemon=True)
        t.start()
        self._fleet_threads.append(t)

    def _dial(self, host: str, port: int) -> EdgeClient:
        """One fleet transport. The EdgeClient's own redial is OFF — the
        fleet layer handles outages itself (re-route NOW, redial in the
        background) because waiting out a per-connection backoff is
        exactly the stall failover exists to avoid."""
        c = EdgeClient(host, port, timeout=self._timeout)
        c.connect()
        return c

    def _alive_locked(self):
        """Indices of routable endpoints (connected, not blacklisted)."""
        now = time.monotonic()
        return [i for i, ep in enumerate(self._fleet)
                if ep["client"] is not None
                and not ep["client"].closed.is_set()
                and ep["down_until"] <= now]

    def _pick_ep_locked(self, exclude: Optional[int] = None) -> Optional[int]:
        """Route by real headroom: the endpoint with the best (lowest)
        advertised-health score wins; round-robin breaks ties so equal
        servers share load. ``exclude`` skips the original's endpoint
        when placing a hedge."""
        from nnstreamer_tpu_torch.edge.fleet import headroom_score

        alive = [i for i in self._alive_locked() if i != exclude]
        if not alive:
            return None
        n = len(self._fleet)
        best = min(alive, key=lambda i: (
            headroom_score(self._fleet[i]["client"].server_health),
            (i - self._ep_rr) % n))
        self._ep_rr = (best + 1) % n
        return best

    def _mark_down_locked(self, idx: int):
        """Blacklist a dead endpoint and collect its orphaned in-flight
        frames for re-route. Returns (dead_client, orphan_seqs); the
        caller closes/resends OUTSIDE the lock."""
        ep = self._fleet[idx]
        dead = ep["client"]
        ep["client"] = None
        ep["down_until"] = time.monotonic() + self._blacklist_s
        orphans = [m.meta["_seq"] for m in self._sent
                   if self._routes.get(m.meta["_seq"], {}).get("ep") == idx]
        if not ep["dialing"]:
            ep["dialing"] = True
            threading.Thread(target=self._redial_ep, args=(idx,),
                             name=f"fleet-redial-{self.name}-{idx}",
                             daemon=True).start()
        return dead, orphans

    def _fleet_failover(self, idx: int, client) -> None:
        """Endpoint ``idx`` died (its transport closed): blacklist it,
        re-route every un-answered frame it owned to a surviving
        endpoint, with each frame's resend budget bounding the loop —
        no lost-ack wedge, no unbounded retry storm."""
        with self._inflight_lock:
            ep = self._fleet[idx]
            if ep["client"] is not client or client is None:
                return  # someone already handled it
            dead, orphans = self._mark_down_locked(idx)
        if dead is not None:
            dead.close()
        self.fleet_stats["failovers"] += 1
        self._note_fault("failover",
                         ConnectionError(
                             f"endpoint {ep['host']}:{ep['port']} lost"),
                         endpoint=f"{ep['host']}:{ep['port']}",
                         orphans=len(orphans))
        self.post_message("endpoint-down", {
            "endpoint": f"{ep['host']}:{ep['port']}",
            "orphans": len(orphans)})
        for seq in orphans:
            self._reroute(seq)

    def _reroute(self, seq: int) -> None:
        """Resend one orphaned in-flight frame to the best surviving
        endpoint (bounded by its resend budget). Dropping is the
        LAST resort — and it releases the window slot so the stream
        never wedges on a lost ack."""
        with self._inflight_lock:
            entry = None
            for m in self._sent:
                if m.meta.get("_seq") == seq:
                    entry = m
                    break
            r = self._routes.get(seq)
            if entry is None or r is None:
                return  # answered (or dropped) while we raced here
            if r["resends"] >= self._max_retries:
                self._drop_inflight_locked(seq)
                self.error_stats["dropped"] += 1
                drop = True
                target = None
            else:
                drop = False
                target = self._pick_ep_locked(exclude=r["ep"])
                if target is None and self._alive_locked():
                    target = self._pick_ep_locked()  # only the same ep left
                if target is not None:
                    r["ep"] = target
                    r["t"] = time.monotonic()
                    r["resends"] += 1
                    client = self._fleet[target]["client"]
        if drop:
            self._sem.release()
            self._note_fault("reroute-drop",
                             ConnectionError("resend budget exhausted"),
                             seq=seq)
            return
        if target is None:
            # nothing alive right now: the frame stays in _sent; either a
            # redial restores an endpoint (and the rx loop's timeout
            # logic re-routes again) or the reply timeout fails loudly
            return
        self.fleet_stats["reroutes"] += 1
        try:
            client.send(entry)
        except (ConnectionError, OSError):
            self._fleet_failover(target, client)

    def _drop_inflight_locked(self, seq: int) -> None:
        """Remove one in-flight frame's accounting (lock held; the
        caller releases the semaphore outside)."""
        for i, m in enumerate(self._sent):
            if m.meta.get("_seq") == seq:
                del self._sent[i]
                break
        self._routes.pop(seq, None)
        self._busy_retries.pop(seq, None)
        self._inflight -= 1

    def _redial_ep(self, idx: int) -> None:
        """Background redial of a blacklisted endpoint: the same bounded
        backoff+jitter policy as EdgeClient's reconnect, applied by the
        fleet layer (traffic keeps flowing on the survivors meanwhile)."""
        import random

        ep = self._fleet[idx]
        backoff = 0.05
        for _attempt in range(self._max_retries):
            if self._rx_stop.wait(min(backoff, 2.0)
                                  * (0.5 + random.random())):
                break
            backoff = min(backoff * 2, 2.0)
            try:
                c = self._dial(ep["host"], ep["port"])
            except Exception:  # noqa: BLE001 — still down, keep backing off
                continue
            with self._inflight_lock:
                ep["client"] = c
                ep["down_until"] = 0.0
                ep["dialing"] = False
            log.info("[%s] fleet endpoint %s:%d restored", self.name,
                     ep["host"], ep["port"])
            self.post_message("endpoint-restored", {
                "endpoint": f"{ep['host']}:{ep['port']}"})
            return
        with self._inflight_lock:
            ep["dialing"] = False
        log.warning("[%s] fleet endpoint %s:%d stays blacklisted (%d "
                    "redial attempts failed)", self.name, ep["host"],
                    ep["port"], self._max_retries)

    def _fleet_forward(self, idx: int) -> None:
        """Per-endpoint pump: replies into the shared rx queue, death
        into the failover path. Health refreshes (CAPABILITY frames) are
        absorbed by the transport itself — server_health just updates."""
        while not self._rx_stop.is_set():
            ep = self._fleet[idx]
            client = ep["client"]
            if client is None:
                if self._rx_stop.wait(0.05):
                    return
                continue
            msg = client.recv(timeout=0.2)
            if msg is not None:
                self._fleet_q.put((idx, msg))
                continue
            if client.closed.is_set():
                self._fleet_failover(idx, client)

    def _fleet_hedge_tick(self) -> None:
        """Place due hedges: any un-answered frame older than
        hedge-after-ms gets ONE copy sent to a different live endpoint.
        The copy shares the original's ``_rid``, so whichever server
        sees the pair second sheds it un-invoked; whichever reply comes
        back first wins the pairing and the loser is discarded."""
        if not self._hedge_s:
            return
        now = time.monotonic()
        sends = []
        with self._inflight_lock:
            for m in self._sent:
                seq = m.meta.get("_seq")
                r = self._routes.get(seq)
                if r is None or r["hedged"] or now - r["t"] < self._hedge_s:
                    continue
                target = self._pick_ep_locked(exclude=r["ep"])
                if target is None:
                    continue  # nowhere else to hedge to right now
                r["hedged"] = True
                sends.append((m, target, self._fleet[target]["client"]))
        for m, target, client in sends:
            self.fleet_stats["hedges"] += 1
            try:
                client.send(m)
            except (ConnectionError, OSError):
                self._fleet_failover(target, client)

    def _fleet_recv_loop(self) -> None:
        """The fleet's single reply dispatcher: pairs replies (first
        copy wins), applies BUSY policy, drives hedging and the reply
        timeout. One consumer — downstream pushes stay ordered."""
        import queue as _q

        while not self._rx_stop.is_set():
            try:
                idx, msg = self._fleet_q.get(timeout=0.1)
            except _q.Empty:
                idx, msg = None, None
            self._fleet_hedge_tick()
            if msg is None:
                with self._inflight_lock:
                    waiting = self._inflight
                    alive = self._alive_locked()
                    dialing = any(ep["dialing"] for ep in self._fleet)
                if not waiting:
                    continue
                if not alive and not dialing:
                    self._fail(f"all {len(self._fleet)} fleet endpoints "
                               f"lost with {waiting} frame(s) in flight")
                    return
                if time.monotonic() - self._last_activity > self._timeout:
                    self._fail(f"no response within {self._timeout}s "
                               f"({waiting} frame(s) in flight)")
                    return
                continue
            self._last_activity = time.monotonic()
            if msg.type == proto.MSG_BUSY:
                if str(msg.meta.get("detail", "")) == "hedge-duplicate":
                    # the benign ack of a deduped hedge copy: the
                    # original is still being served — nothing to do
                    self.fleet_stats["hedge_dup_acks"] += 1
                    continue
                if self._fleet_handle_busy(msg):
                    continue
                return
            seq = msg.meta.get("_seq")
            with self._inflight_lock:
                entry = self._pop_sent(seq)
                self._routes.pop(seq, None)
                self._busy_retries.pop(seq, None)
            if entry is None:
                # the losing copy of a hedged pair (or a re-routed
                # frame's first answer already won) — expected, counted,
                # never a warning storm
                self.fleet_stats["late_replies"] += 1
                continue
            if proto.corrupt_payloads(msg):
                with self._inflight_lock:
                    self._inflight -= 1
                self._sem.release()
                self.error_stats["dropped"] += 1
                self._note_fault(
                    "byzantine-reply",
                    RuntimeError("corrupt tensor payload in reply"),
                    seq=seq, count=self.error_stats["dropped"])
                continue
            out = proto.message_to_buffer(msg)
            for k in ("client_id", "_seq", "_rid"):
                out.meta.pop(k, None)
            try:
                ret = self.push(out)
            except Exception as e:  # noqa: BLE001 — downstream raised
                with self._inflight_lock:
                    self._inflight -= 1
                self._sem.release()
                self._fail(f"downstream failed on reply: {e}")
                return
            with self._inflight_lock:
                self._inflight -= 1
            self._sem.release()
            if ret == FlowReturn.ERROR:
                self._failed = True
                return

    def _fleet_handle_busy(self, msg: proto.Message) -> bool:
        """A real SERVER_BUSY shed in fleet mode: the on-error policy
        decides, with retries going to the best-headroom endpoint (often
        NOT the one that shed — that's the point of the fleet)."""
        seq = msg.meta.get("_seq")
        reason = str(msg.meta.get("detail", "overload"))
        kind, retries = self.error_policy()
        if kind == "retry":
            n = self._busy_retries.get(seq, 0)
            if n < retries:
                with self._inflight_lock:
                    r = self._routes.get(seq)
                if r is None:
                    return True  # answered elsewhere meanwhile
                self._busy_retries[seq] = n + 1
                self.error_stats["retries"] += 1
                self._note_fault("busy-retry",
                                 RuntimeError(f"SERVER_BUSY ({reason})"),
                                 attempt=n + 1, seq=seq)
                base = float(self.properties.get(
                    "retry_backoff_ms", self.DEFAULT_RETRY_BACKOFF_MS)) / 1e3
                self._last_activity = time.monotonic()
                time.sleep(base * (2 ** n))
                with self._inflight_lock:
                    entry = None
                    for m in self._sent:
                        if m.meta.get("_seq") == seq:
                            entry = m
                            break
                    target = self._pick_ep_locked()
                    if entry is None or target is None:
                        entry = None
                    else:
                        r["ep"] = target
                        r["t"] = time.monotonic()
                        client = self._fleet[target]["client"]
                        self._last_activity = time.monotonic()
                if entry is not None:
                    try:
                        client.send(entry)
                    except (ConnectionError, OSError):
                        self._fleet_failover(target, client)
                return True
            with self._inflight_lock:
                self._drop_inflight_locked(seq)
            self._sem.release()
            self._fail(f"server busy after {n} retr"
                       f"{'y' if n == 1 else 'ies'} ({reason})")
            return False
        if kind == "drop":
            with self._inflight_lock:
                self._drop_inflight_locked(seq)
            self._sem.release()
            self.error_stats["dropped"] += 1
            self._note_fault("busy-drop",
                             RuntimeError(f"SERVER_BUSY ({reason})"),
                             seq=seq, count=self.error_stats["dropped"])
            self.post_message("server-busy", {
                "reason": reason, "dropped": self.error_stats["dropped"]})
            return True
        with self._inflight_lock:
            self._drop_inflight_locked(seq)
        self._sem.release()
        self._fail(f"server rejected request: SERVER_BUSY ({reason}) "
                   f"under on-error={kind}")
        return False

    def _chain_fleet(self, buf: Buffer) -> FlowReturn:
        """chain() in fleet mode: pick the best-headroom endpoint, stamp
        ``_seq`` (pairing) + ``_rid`` (server-side idempotence), send
        with inline failover — a dead first choice costs one blacklist
        and a resend, never an error."""
        msg = proto.buffer_to_message(buf, proto.MSG_DATA)
        seq = next(self._seq)
        msg.meta["_seq"] = seq
        msg.meta["_rid"] = f"{self._rid_prefix}-{seq}"
        if not self._sem.acquire(timeout=self._timeout):
            raise ElementError(
                self.name,
                f"no response within {self._timeout}s "
                "(in-flight window full)")
        for _attempt in range(len(self._fleet) + 1):
            with self._inflight_lock:
                if self._failed:
                    self._sem.release()
                    return FlowReturn.ERROR
                target = self._pick_ep_locked()
                if target is None:
                    dialing = any(ep["dialing"] for ep in self._fleet)
                    client = None
                else:
                    client = self._fleet[target]["client"]
                    self._last_activity = time.monotonic()
                    self._inflight += 1
                    self._sent.append(msg)
                    self._routes[seq] = {"ep": target,
                                         "t": time.monotonic(),
                                         "hedged": False, "resends": 0}
            if client is None:
                if dialing and self._rx_stop.wait(0.05) is False:
                    continue  # a redial is in flight: brief grace, retry
                self._sem.release()
                raise ElementError(self.name,
                                   "no live fleet endpoint to send to")
            try:
                client.send(msg)
                return FlowReturn.OK
            except (ConnectionError, OSError):
                with self._inflight_lock:
                    self._drop_inflight_locked(seq)
                self._fleet_failover(target, client)
        self._sem.release()
        raise ElementError(self.name, "send failed on every fleet endpoint")

    def _fail(self, why: str) -> None:
        self._failed = True
        self.post_message("error", {"element": self.name, "error": why})

    def _maybe_handle_reconnect(self) -> None:
        """Claim and handle a pending reconnect pulse. Called under
        ``_inflight_lock`` from BOTH the rx loop and chain() — whichever
        runs first wins; crucially chain() claims it BEFORE sending a new
        frame, so no post-reconnect send can overtake the resent backlog
        (a reply arriving for a new frame before the resend would pair
        with the wrong ``_sent`` entry and over-release the semaphore)."""
        if not self._client.reconnected.is_set():
            return
        self._client.reconnected.clear()
        self._handle_reconnect_locked()

    def _handle_reconnect_locked(self) -> None:
        """The transport re-handshook after an outage: decide the fate of
        the unanswered frames per this element's on-error policy —
        ``retry:*`` resends them (send order preserved), anything else
        drops them (counts surfaced) so the stream keeps moving.
        ``_inflight_lock`` is held by the caller."""
        kind, _ = self.error_policy()
        # replies queued by the OLD session are stale: every reply the dead
        # connection produced was enqueued before `reconnected` was set
        # (the transport's recv loop is single-threaded), and pairing them
        # against resent/dropped frames would double-account the window
        stale = 0
        while not self._client.recv_queue.empty():
            try:
                self._client.recv_queue.get_nowait()
                stale += 1
            except Exception:  # noqa: BLE001 — raced empty
                break
        if stale:
            log.warning("[%s] discarded %d stale reply(ies) from the dead "
                        "session", self.name, stale)
        pending = list(self._sent)
        resend = kind == "retry" and bool(pending)
        if resend:
            try:
                for m in pending:
                    if m.trace is not None:
                        # fresh send stamp: the reply's RTT must measure
                        # THIS transmission, not the dead session's
                        m.trace.t_send_ns = time.perf_counter_ns()
                    self._client.send(m)
            except (ConnectionError, OSError) as e:
                self._fail(f"resend after reconnect failed: {e}")
                return
        elif pending:
            self._inflight -= len(pending)
            self._sent.clear()
            for _ in pending:
                self._sem.release()
            self.error_stats["dropped"] += len(pending)
        self._last_activity = time.monotonic()
        if self.pipeline is not None:
            self.pipeline.bus.record_fault(
                self.name, action="reconnect",
                resent=len(pending) if resend else 0,
                dropped=0 if resend else len(pending))
        self.post_message("reconnected", {
            "resent": len(pending) if resend else 0,
            "dropped": 0 if resend else len(pending)})

    def _recv_loop(self) -> None:
        client = self._client
        while not self._rx_stop.is_set() and client is not None:
            msg = client.recv(timeout=0.2)
            if client.reconnected.is_set():
                # the pulse landed while we were (de)queuing: anything in
                # hand predates the reconnect (no post-redial frame can
                # have been sent before the pulse is claimed) — stale
                with self._inflight_lock:
                    self._maybe_handle_reconnect()
                if self._failed:
                    return
                continue
            if msg is None:
                with self._inflight_lock:
                    waiting = self._inflight
                if not waiting:
                    continue
                if client.closed.is_set():
                    self._fail(f"recv failed: server connection lost with "
                               f"{waiting} frame(s) in flight")
                    return
                if time.monotonic() - self._last_activity > client.timeout:
                    self._fail(f"no response within {client.timeout}s "
                               f"({waiting} frame(s) in flight)")
                    return
                continue
            self._last_activity = time.monotonic()
            if msg.type == proto.MSG_BUSY:
                # serving-tier admission reject: apply this element's
                # on-error policy to the shed frame (retry resends it,
                # drop counts + continues, abort fails the pipeline)
                if self._handle_busy(msg):
                    continue
                return
            seq = msg.meta.get("_seq")
            with self._inflight_lock:
                entry = self._pop_sent(seq)
                if entry is None:
                    # no in-flight frame to pair with: a stale reply that
                    # slipped every reconnect drain — accounting it would
                    # drive _inflight negative and over-release the
                    # semaphore; drop it instead
                    log.warning("[%s] discarding unpaired reply", self.name)
                    continue
            if proto.corrupt_payloads(msg):
                # byzantine reply: the frame parsed but its tensor
                # payload is provably corrupt — drop the FRAME (the
                # request is written off like a busy-drop), keep the
                # connection, record it on the fault ledger
                with self._inflight_lock:
                    self._inflight -= 1
                self._sem.release()
                self._busy_retries.pop(seq, None)
                self.error_stats["dropped"] += 1
                self._note_fault(
                    "byzantine-reply",
                    RuntimeError("corrupt tensor payload in reply"),
                    seq=seq, count=self.error_stats["dropped"])
                continue
            if msg.trace is not None and entry.trace is not None:
                # the reply context is the SERVER's object — carry the
                # request-side client legs (serialize stamp) over so the
                # waterfall covers both ends of the exchange
                msg.trace.client_spans = (entry.trace.client_spans
                                          + msg.trace.client_spans)
            self._busy_retries.pop(seq, None)
            tctx = msg.trace
            t_d0 = time.perf_counter_ns() if tctx is not None else 0
            out = proto.message_to_buffer(msg)
            out.meta.pop("client_id", None)
            out.meta.pop("_seq", None)
            if tctx is not None:
                # traced RESULT: close the waterfall with the client
                # deserialize leg, decompose the RTT into its SLO
                # components, bank the clock sample for trace stitching
                tctx.client_spans.append(
                    ("client-deserialize", t_d0, time.perf_counter_ns()))
                self._note_traced_reply(tctx)
            try:
                ret = self.push(out)
            except Exception as e:  # noqa: BLE001 — downstream raised
                # (chain errors dispatch policies and return ERROR now,
                # but pad/caps-level failures still unwind to the
                # pusher): surface it on the bus instead of silently
                # killing this daemon thread with the accounting wedged
                with self._inflight_lock:
                    self._inflight -= 1
                self._sem.release()
                self._fail(f"downstream failed on reply: {e}")
                return
            # decrement only AFTER the push: on_eos polls _inflight to
            # decide when EOS may propagate — releasing first would let
            # EOS overtake this very buffer
            with self._inflight_lock:
                self._inflight -= 1
            self._sem.release()
            if ret == FlowReturn.ERROR:
                # downstream refused the buffer without raising: stop
                # feeding the server (chain() checks _failed)
                self._failed = True
                return

    def _pop_sent(self, seq):
        """Remove and return the in-flight entry a reply pairs with:
        by ``_seq`` echo when present (serving servers reply out of send
        order — a shed frame's BUSY overtakes earlier admitted results),
        FIFO otherwise. ``_inflight_lock`` is held by the caller."""
        if seq is None:
            return self._sent.popleft() if self._sent else None
        for i, m in enumerate(self._sent):
            if m.meta.get("_seq") == seq:
                del self._sent[i]
                return m
        return None

    def _handle_busy(self, msg: proto.Message) -> bool:
        """A SERVER_BUSY shed arrived for one of our in-flight frames:
        dispatch this element's on-error policy. Returns True when the
        receive loop should keep running (retry resent / drop counted),
        False on the fatal path (the loop exits; chain() sees _failed)."""
        seq = msg.meta.get("_seq")
        reason = str(msg.meta.get("detail", "overload"))
        kind, retries = self.error_policy()
        with self._inflight_lock:
            entry = self._pop_sent(seq)
        if entry is None:
            log.warning("[%s] unpaired SERVER_BUSY (seq=%r)", self.name, seq)
            return True
        # tail retention: every observed shed of a traced request is an
        # exemplar (terminated span + shed reason), even if a retry later
        # gets it admitted
        if msg.trace is not None:
            if entry.trace is not None:
                msg.trace.client_spans = (entry.trace.client_spans
                                          + msg.trace.client_spans)
            self._note_traced_reply(msg.trace, shed_reason=reason)
        if kind == "retry":
            # seq None (a server that strips request meta): the counter
            # still keys on None so the retry budget BOUNDS the loop —
            # an uncounted path would resend forever
            n = self._busy_retries.get(seq, 0)
            if n < retries:
                self._busy_retries[seq] = n + 1
                self.error_stats["retries"] += 1
                self._note_fault("busy-retry",
                                 RuntimeError(f"SERVER_BUSY ({reason})"),
                                 attempt=n + 1, seq=seq)
                base = float(self.properties.get(
                    "retry_backoff_ms", self.DEFAULT_RETRY_BACKOFF_MS)) / 1e3
                # bounded backoff before the resend: hammering a shedding
                # server back-to-back just earns the next shed. The rx
                # loop stalls for the wait — stamp activity so the reply
                # timeout doesn't count the deliberate pause
                self._last_activity = time.monotonic()
                time.sleep(base * (2 ** n))
                with self._inflight_lock:
                    self._maybe_handle_reconnect()
                    if self._failed:
                        return False
                    self._last_activity = time.monotonic()
                    self._sent.append(entry)
                    try:
                        if entry.trace is not None:
                            entry.trace.t_send_ns = time.perf_counter_ns()
                        self._client.send(entry)
                    except (ConnectionError, OSError) as e:
                        self._sent.pop()
                        self._inflight -= 1
                        self._sem.release()
                        self._fail(f"busy-retry send failed: {e}")
                        return False
                return True
            with self._inflight_lock:
                self._inflight -= 1
            self._sem.release()
            self._fail(f"server busy after {n} retr"
                       f"{'y' if n == 1 else 'ies'} ({reason})")
            return False
        if kind == "drop":
            with self._inflight_lock:
                self._inflight -= 1
            self._sem.release()
            self.error_stats["dropped"] += 1
            self._busy_retries.pop(seq, None)
            self._note_fault("busy-drop",
                             RuntimeError(f"SERVER_BUSY ({reason})"),
                             seq=seq, count=self.error_stats["dropped"])
            self.post_message("server-busy", {
                "reason": reason, "dropped": self.error_stats["dropped"]})
            return True
        # abort / restart: a shed under these policies is fatal — the
        # stream's frames must not silently vanish
        with self._inflight_lock:
            self._inflight -= 1
        self._sem.release()
        self._fail(f"server rejected request: SERVER_BUSY ({reason}) "
                   f"under on-error={kind}")
        return False

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        """Validate our stream against the server-advertised caps
        (CAPABILITY handshake, tensor_query_client.c:447-498), then let the
        server's answer decide downstream caps (flexible unless the server
        advertised a fixed result stream)."""
        srv_caps = self._client.server_caps if self._client else ""
        if not srv_caps and self._fleet is not None:
            for ep in self._fleet:
                c = ep.get("client")
                if c is not None and c.server_caps:
                    srv_caps = c.server_caps
                    break
        if srv_caps:
            advertised = Caps.from_string(srv_caps)
            if not caps.can_intersect(advertised) and str(
                self.properties.get("strict", "")
            ) in ("1", "true", "True"):
                raise ElementError(
                    self.name,
                    f"server caps {srv_caps!r} reject our stream {caps}",
                )
        out = self.properties.get("out-caps") or self.properties.get("out_caps")
        if out:
            return Caps.from_string(str(out))
        return Caps.from_string("other/tensors,format=flexible")

    def _trace_ctx_for_send(self):
        """Head sampling (``trace-sample=1/N``): every Nth request gets a
        fresh trace context — and ONLY after the server's CAPABILITY
        advertised nntrace-x support, so an old server always sees
        byte-identical frames regardless of this element's config."""
        if not self._trace_n or self._client is None \
                or not self._client.server_trace:
            return None
        self._trace_count += 1
        if (self._trace_count - 1) % self._trace_n:
            return None
        return tracex.TraceContext(trace_id=tracex.new_id(),
                                   span_id=tracex.new_id())

    def _note_traced_reply(self, ctx, shed_reason: Optional[str] = None,
                           ) -> None:
        """A traced reply (RESULT or BUSY) came back: decompose the RTT
        into its SLO components, bank the clock sample for stitching,
        and (span mode) emit the rebased cross-process waterfall."""
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        if tracer is None or ctx is None:
            return
        if shed_reason:
            ctx.shed = True
            ctx.shed_reason = shed_reason
        rec = tracex.decompose(ctx)
        if rec is None:
            if not ctx.shed:
                return  # reply carried no usable timing
            rtt = ((ctx.t_wire_recv_ns - ctx.t_send_ns) / 1e6
                   if ctx.t_send_ns and ctx.t_wire_recv_ns else 0.0)
            rec = {"trace_id": ctx.trace_hex, "rtt_ms": max(0.0, rtt),
                   "shed": ctx.shed_reason or "overload"}
        peer = f"{self._client.host}:{self._client.port}"
        tracer.record_request_trace(peer, rec,
                                    sample=tracex.clock_sample(ctx))
        if tracer.spans is not None:
            tracex.emit_request_spans(tracer.spans, ctx)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._failed:
            return FlowReturn.ERROR
        if self._fleet is not None:
            return self._chain_fleet(buf)
        t_ser0 = time.perf_counter_ns()
        msg = proto.buffer_to_message(buf, proto.MSG_DATA)
        msg.meta["_seq"] = next(self._seq)  # reply/busy correlation
        msg.trace = self._trace_ctx_for_send()
        if msg.trace is not None:
            # the serialize leg of the request waterfall (client-local)
            msg.trace.client_spans.append(
                ("client-serialize", t_ser0, time.perf_counter_ns()))
        # backpressure: max-in-flight unanswered frames, then block (with
        # the reply timeout as the bound so a dead server can't wedge us)
        if not self._sem.acquire(timeout=self._client.timeout):
            raise ElementError(
                self.name,
                f"no response within {self._client.timeout}s "
                "(in-flight window full)",
            )
        # append+send are ONE critical section: _on_reconnect (rx thread)
        # must never snapshot _sent between them — it would either resend
        # a frame whose send is about to fail (double-release on the
        # semaphore) or let a new frame overtake the resent backlog
        send_err = None
        with self._inflight_lock:
            # a pending reconnect is handled HERE, before this frame hits
            # the wire — the resent backlog must precede any new send
            self._maybe_handle_reconnect()
            if self._failed:
                self._sem.release()
                return FlowReturn.ERROR
            # stamp BEFORE the rx loop can observe the increment — a
            # stale timestamp would read as an instant timeout
            self._last_activity = time.monotonic()
            self._inflight += 1
            self._sent.append(msg)
            try:
                if msg.trace is not None:
                    # t1 of the NTP-style exchange, stamped as late as
                    # the client gets before the frame hits the wire
                    msg.trace.t_send_ns = time.perf_counter_ns()
                self._client.send(msg)
            except (ConnectionError, OSError) as e:
                self._inflight -= 1
                self._sent.pop()
                send_err = e
        if send_err is not None:
            self._sem.release()
            raise ElementError(self.name, f"send failed: {send_err}")
        return FlowReturn.OK

    def on_eos(self) -> None:
        """Drain in-flight replies before EOS propagates downstream (the
        receiver thread is still pushing them). The deadline extends from
        the last reply, like the rx-loop's timeout — a slow-but-alive
        server draining a deep window must not lose its tail."""
        timeout = (self._client.timeout if self._client is not None
                   else getattr(self, "_timeout", 5.0)) + 1.0
        while not self._failed:
            with self._inflight_lock:
                if self._inflight == 0:
                    return
            if time.monotonic() - self._last_activity > timeout:
                return  # rx loop will post the timeout error
            time.sleep(0.005)


@element_register
class TensorQueryServerSrc(SourceElement):
    """Server entry. ``serve=1`` stacks the nnserve tier between the
    socket and the pipeline: instead of popping one request at a time,
    ``create()`` asks the :class:`~nnstreamer_tpu_torch.serving.ServingScheduler`
    for the next micro-batch — assembled from ALL waiting clients, padded
    to ``serve-batch`` rows (one jit signature downstream), admission-
    controlled per tenant, overload shed with SERVER_BUSY. Off by
    default: the un-configured element behaves exactly as before."""

    ELEMENT_NAME = "tensor_query_serversrc"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "connect_type": Prop("enum", enum=("TCP", "HYBRID")),
        "topic": Prop("str"),
        "id": Prop("str"),
        "caps": Prop("caps"),
        "dest_host": Prop("str", doc="HYBRID broker host"),
        "dest_port": Prop("int", doc="HYBRID broker port"),
        "announce_host": Prop("str", doc="HYBRID announce address override"),
        "serve": Prop("bool", doc="enable the continuous-batching serving "
                                  "tier (default off)"),
        "serve_batch": Prop("int", doc="micro-batch rows per pipeline "
                                       "buffer (pads partial fills)"),
        "serve_queue_depth": Prop(
            "int", doc="per-tenant admission bound; 0=unbounded (lint "
                       "NNST901)"),
        "serve_rate": Prop("number", doc="per-tenant token-bucket rate, "
                                         "requests/s (0=unlimited)"),
        "serve_burst": Prop("number", doc="token-bucket burst (default "
                                          "= serve-rate)"),
        "serve_weights": Prop("str", validate=_valid_weights,
                              doc="weighted-fair shares: tenant:weight,..."),
        "serve_tenant_key": Prop("str", doc="request meta key naming the "
                                            "tenant (default 'tenant')"),
        "serve_linger_ms": Prop("number", doc="hold an under-filled batch "
                                              "open this long (default 0)"),
        "replicas": Prop(
            "str",
            validate=lambda v: (
                None if str(v).strip().lower() in ("", "auto", "off")
                or str(v).strip().lstrip("-").isdigit()
                else f"expected an integer, 'auto' or 'off', got {v!r}"),
            doc="nnpool replica serving; only off (or 1) here — any other "
                "value raises at start (the replica pool is not ported)"),
        "slo_ms": Prop("number", doc="declared per-request latency SLO "
                                     "(admitted p99 target, ms) — the "
                                     "nnctl feedback target and the "
                                     "predictive-shed price bound"),
        "ctl": Prop("bool", doc="enable the nnctl closed-loop controller "
                                "(hot-sets serve-batch/linger/rates "
                                "while serving; default off)"),
        "ctl_interval_ms": Prop("number", doc="controller tick interval "
                                              "(default 100 ms)"),
        "ctl_bounds": Prop("str", validate=_valid_ctl_bounds,
                           doc="controller actuation bounds: "
                               "batch:lo:hi,linger:lo:hi,rate:lo:hi "
                               "(defaults batch:1:64 linger:0:50)"),
        "advertise_health": Prop(
            "bool", doc="nnfleet-r: ride live headroom (queue depth, "
                        "shed rate, serve-batch) on MSG_CAPABILITY as a "
                        "compat-safe TLV payload fleet clients route by "
                        "(default off — capability frames stay "
                        "byte-identical)"),
        "health_interval_ms": Prop(
            "number", doc="health-TLV refresh broadcast period "
                          "(default 500 ms; needs advertise-health=1)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._server: Optional[EdgeServer] = None
        self._key = ""
        self._sched = None
        self._ctl = None
        # nnfleet-r: health broadcast thread state + the non-serving
        # hedge-dedup filter (the serving path dedups in the scheduler)
        self._health_stop = None
        self._health_thread = None
        self._rid_filter = None

    def _serving_enabled(self) -> bool:
        return bool(self.properties.get("serve"))

    def _serve_batch(self) -> int:
        return max(1, int(self.properties.get("serve_batch", 1) or 1))

    def start(self) -> None:
        if str(self.properties.get("connect_type", "TCP")).upper() == \
                "HYBRID":
            raise _hybrid_unported(self.name)
        replicas = str(self.properties.get("replicas", "off")).strip().lower()
        if replicas not in ("", "off", "1"):
            raise _replicas_unported(self.name, replicas)
        host = str(self.properties.get("host", "localhost"))
        port = int(self.properties.get("port", 0))
        self._key = str(self.properties.get("id", "0"))
        caps = str(self.properties.get("caps", ""))
        self._server = _acquire_server(self._key, host, port, caps)
        if self._serving_enabled():
            self._sched = self._make_scheduler(caps)
            with _server_lock:
                _sched_table[self._key] = self._sched
            if bool(self.properties.get("ctl")):
                self._ctl = self._make_controller()
                self._ctl.start()
        elif bool(self.properties.get("ctl")):
            # statically NNST952; at runtime fail loudly rather than run
            # a controller with nothing to steer
            raise ElementError(
                self.name, "ctl=1 needs serve=1 (the controller steers "
                           "the serving scheduler's knobs)")
        from nnstreamer_tpu_torch.edge.fleet import RidFilter

        self._rid_filter = RidFilter()
        if bool(self.properties.get("advertise_health")):
            self._start_health_broadcast()
        self.post_message("server-started", {"port": self._server.port})

    def _health_snapshot(self) -> dict:
        """The health dict the capability TLV advertises: the live
        scheduler's non-draining snapshot when serving, else the raw
        socket queue depth (a non-serving server still has headroom)."""
        if self._sched is not None:
            return self._sched.health_snapshot()
        srv = self._server
        return {"depth": srv.recv_queue.qsize() if srv is not None else 0,
                "inflight": 0, "shed_permille": 0, "serve_batch": 1,
                "slo_ms": 0}

    def _start_health_broadcast(self) -> None:
        """advertise-health=1: install the capability-TLV provider (new
        connections get health in their handshake) and refresh every
        connected client on a period — the gossip fleet clients route
        by. Old clients byte-identically ignore the payload."""
        self._server.health_provider = self._health_snapshot
        interval = max(0.05, float(
            self.properties.get("health_interval_ms", 500) or 500) / 1e3)
        self._health_stop = threading.Event()

        def loop():
            while not self._health_stop.wait(interval):
                srv = self._server
                if srv is None:
                    return
                try:
                    srv.broadcast_health()
                except Exception:  # noqa: BLE001 — advisory, never fatal
                    log.exception("health broadcast failed")

        self._health_thread = threading.Thread(
            target=loop, name=f"health-{self.name}", daemon=True)
        self._health_thread.start()

    def _make_scheduler(self, caps: str):
        """Build the nnserve scheduler; serving needs FIXED caps (the
        batch's one compiled signature comes from them)."""
        from nnstreamer_tpu_torch.serving import ServingScheduler
        from nnstreamer_tpu_torch.serving.admission import parse_weights

        cfg = Caps.from_string(caps).to_config() if caps else None
        if cfg is None or cfg.info.num_tensors == 0 or not cfg.is_fixed():
            raise ElementError(
                self.name,
                "serve=1 needs fixed caps= (the serving batch is padded "
                "to ONE compiled signature, which flexible caps can't "
                "name)")
        return ServingScheduler(
            self._server,
            batch=self._serve_batch(),
            stats_key=self._key,
            element=self,
            queue_depth=int(self.properties.get("serve_queue_depth", 64)
                            or 0),
            rate=float(self.properties.get("serve_rate", 0) or 0),
            burst=float(self.properties.get("serve_burst", 0) or 0) or None,
            weights=parse_weights(self.properties.get("serve_weights", "")),
            tenant_key=str(self.properties.get("serve_tenant_key", "tenant")
                           or "tenant"),
            linger_ms=float(self.properties.get("serve_linger_ms", 0) or 0),
        )

    def _make_controller(self):
        """Build the nnctl controller against the live scheduler; the
        tracer is resolved lazily at publish time (it may attach after
        PLAYING)."""
        from nnstreamer_tpu_torch.serving.controller import (
            ServingController,
            parse_ctl_bounds,
        )

        return ServingController(
            self._sched,
            slo_ms=float(self.properties.get("slo_ms", 0) or 0),
            interval_ms=float(self.properties.get("ctl_interval_ms", 0)
                              or 0) or 100.0,
            bounds=parse_ctl_bounds(self.properties.get("ctl_bounds", "")),
            stats_key=self._key,
            tracer_fn=lambda: (getattr(self.pipeline, "tracer", None)
                               if self.pipeline is not None else None),
        )

    def stop(self) -> None:
        if self._health_stop is not None:
            self._health_stop.set()
            if self._health_thread is not None:
                self._health_thread.join(timeout=2.0)
            self._health_thread = None
            self._health_stop = None
        if self._server is not None:
            self._server.health_provider = None
        if self._ctl is not None:
            self._ctl.stop()
            self._ctl = None
        with _server_lock:
            if _sched_table.get(self._key) is self._sched:
                _sched_table.pop(self._key, None)
        if self._sched is not None:
            # clean drain: requests still queued when the server goes down
            # are shed with SERVER_BUSY (observable both ends), before the
            # listener closes under them
            self._sched.shutdown()
            self._sched = None
        if self._server is not None:
            _release_server(self._key)
            self._server = None

    @property
    def port(self) -> int:
        """Bound port (port=0 picks a free one — loopback test pattern,
        tests/get_available_port.py parity)."""
        return self._server.port if self._server else 0

    def negotiate(self) -> Optional[Caps]:
        caps = str(self.properties.get("caps", ""))
        if caps and self._serving_enabled():
            return self._batched_caps(caps)
        if caps:
            return Caps.from_string(caps)
        return Caps.from_string("other/tensors,format=flexible")

    def _batched_caps(self, caps: str) -> Caps:
        """Per-request caps → the batched stream the pipeline actually
        sees: every tensor gains a leading serve-batch dimension (the one
        compiled signature padding guarantees)."""
        cfg = Caps.from_string(caps).to_config()
        n = self._serve_batch()
        info = TensorsInfo(
            tensors=[
                TensorInfo.from_np_shape((n,) + t.np_shape(), t.dtype,
                                         t.name)
                for t in cfg.info
            ],
            format=cfg.info.format)
        return Caps.from_config(TensorsConfig(info, cfg.rate_n, cfg.rate_d))

    def create(self) -> Optional[Buffer]:
        while True:
            if self.pipeline is not None and not self.pipeline._running.is_set():
                return None  # teardown
            if self._sched is not None:
                buf = self._sched.next_batch(timeout=0.2)
                if buf is not None:
                    return buf
                continue
            item = self._server.pop(timeout=0.2)
            if item is None:
                continue
            cid, msg = item
            if self._rid_filter is not None and \
                    self._rid_filter.seen(msg.meta.get("_rid")):
                # nnfleet-r hedge dedup, non-serving path: the original
                # copy is already in (or through) the pipeline — this
                # duplicate is acked un-invoked
                reply = {"reason": "SERVER_BUSY",
                         "detail": "hedge-duplicate"}
                if "_seq" in msg.meta:
                    reply["_seq"] = msg.meta["_seq"]
                self._server.send_to(cid, proto.Message(proto.MSG_BUSY,
                                                        reply))
                continue
            buf = proto.message_to_buffer(msg)
            buf.meta["client_id"] = cid  # GstMetaQuery routing
            if msg.trace is not None:
                # non-serving traced request: the context rides the
                # buffer to the serversink (an object value, so it can
                # never leak onto wire meta — buffer_to_message drops
                # non-JSON values)
                msg.trace.add_stage(tracex.STAGE_INGEST,
                                    msg.trace.t_wire_recv_ns,
                                    time.perf_counter_ns())
                buf.meta["_tracex"] = msg.trace
            return buf


@element_register
class TensorQueryServerSink(Element):
    """Routes answers back by ``client_id`` meta; a serving batch
    (``serve_routes`` meta from the nnserve scheduler) demultiplexes row
    by row — every valid row to ITS client, padded tail rows dropped."""

    ELEMENT_NAME = "tensor_query_serversink"
    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "id": Prop("str"),
        "timeout": Prop("number", doc="bound one reply send, seconds "
                                      "(0/unset = block)"),
    }

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")  # terminal: answers leave via the socket

    def start(self) -> None:
        self._key = str(self.properties.get("id", "0"))

    def _reply_timeout(self) -> Optional[float]:
        t = float(self.properties.get("timeout", 0) or 0)
        return t if t > 0 else None

    def _note_reply_drop(self, cid) -> None:
        """A reply could not be delivered (client gone / send timed out):
        drop and keep streaming, but make it observable — the fault
        record and a tracer drop counter, never a silent DROPPED."""
        err = RuntimeError(f"client {cid} gone: reply dropped")
        self.error_stats["dropped"] += 1
        self._note_fault("reply-drop", err, client_id=cid,
                         count=self.error_stats["dropped"])
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        if tracer is not None:
            tracer.record_serving_reply_drop(self._key)
        self.post_message("reply-dropped", {"client_id": cid})

    def _note_d2h(self, tensors) -> None:
        """Bill the device-to-host copy of the outputs the filter left on
        its device: this package has no residency planner, so the
        serversink is where the reply's bytes leave the device."""
        dev = [t for t in tensors if is_backend_tensor(t)]
        if dev:
            self._record_crossing("d2h", nbytes=nbytes_of(dev))

    def _reply_trace(self, req_ctx, invoke_win):
        """Build the reply-direction trace context: the request's server
        stages so far (ingest/admission) extended with the invoke window
        the filter stamped (batch → device → reply), every stage tiling
        wire-receive → reply-build so the client-side decomposition has
        no unattributed gap. ``invoke_win`` is the ``serve_invoke`` meta
        ({t0_ns, t1_ns, disp_ns?, done_ns?}) or None."""
        rctx = tracex.reply_context(req_ctx)
        rctx.stages = list(req_ctx.stages)
        prev_end = (rctx.stages[-1][2] if rctx.stages
                    else req_ctx.t_wire_recv_ns)
        dev_end = prev_end
        if invoke_win:
            t0 = invoke_win.get("t0_ns")
            t1 = invoke_win.get("t1_ns")
            disp = invoke_win.get("disp_ns")
            done = invoke_win.get("done_ns")
            if t0:
                # pool assembly → invoke entry (the batch-fill leg)
                rctx.add_stage(tracex.STAGE_BATCH, prev_end, t0)
                if disp:
                    rctx.add_stage(tracex.STAGE_DISPATCH, t0, disp)
                    if done:
                        rctx.add_stage(tracex.STAGE_COMPUTE, disp, done)
                        if t1:
                            rctx.add_stage(tracex.STAGE_D2H, done, t1)
                    elif t1:
                        rctx.add_stage(tracex.STAGE_D2H, disp, t1)
                elif t1:
                    rctx.add_stage(tracex.STAGE_DEVICE, t0, t1)
                dev_end = t1 or t0
        now = time.perf_counter_ns()
        # invoke done → this reply built (demux + serialize; for later
        # rows of a batch it honestly includes the earlier rows' sends)
        rctx.add_stage(tracex.STAGE_REPLY, dev_end or now, now)
        rctx.t_reply_ns = now
        return rctx

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        srv = get_server(self._key)
        if srv is None:
            raise ElementError(self.name, f"no query server with id={self._key}")
        routes = buf.meta.get("serve_routes")
        if routes is not None:
            return self._chain_serving(srv, buf, routes)
        cid = buf.meta.get("client_id")
        if cid is None:
            raise ElementError(self.name, "buffer lost its client_id meta")
        req_ctx = buf.meta.get("_tracex")
        self._note_d2h(buf.tensors)
        msg = proto.buffer_to_message(buf, proto.MSG_RESULT)
        msg.meta.pop("client_id", None)
        msg.meta.pop("serve_invoke", None)  # server-local timing detail
        if req_ctx is not None:
            msg.trace = self._reply_trace(req_ctx,
                                          buf.meta.get("serve_invoke"))
        spans = self._spans()
        t_r = time.perf_counter() if spans is not None else 0.0
        ok = srv.send_to(int(cid), msg, timeout=self._reply_timeout())
        if spans is not None:
            args = {"client": int(cid), "delivered": bool(ok)}
            if req_ctx is not None:
                args["trace_id"] = req_ctx.trace_hex
            spans.emit("serve-reply", "serving", t_r, time.perf_counter(),
                       args=args)
        if not ok:
            # client went away: drop, stream continues (reference
            # logs+skips) — but recorded, never silent
            self._note_reply_drop(cid)
            return FlowReturn.DROPPED
        return FlowReturn.OK

    def _chain_serving(self, srv: EdgeServer, buf: Buffer,
                       routes) -> FlowReturn:
        """Demultiplex one batched reply: row k of every output tensor
        goes to routes[k]'s client (padded rows have no route and fall
        off the end). Goodput lands on the tracer per tenant."""
        timeout = self._reply_timeout()
        tracer = (getattr(self.pipeline, "tracer", None)
                  if self.pipeline else None)
        spans = self._spans()
        # ONE device-to-host copy for the whole batch (the filter's
        # outputs may still be on the card), then per-row numpy slices
        self._note_d2h(buf.tensors)
        outs = [np.asarray(t) for t in materialize_tensors(buf.tensors)]
        # an output is batched iff its leading dim IS the serve-batch size
        # (exact match — comparing against the fill count would slice a
        # non-batched summary output differently per load level)
        n_batch = int(buf.meta.get("serve_batch", len(routes)))
        delivered = 0
        for k, route in enumerate(routes):
            tensors = [
                t[k] if t.ndim > 0 and t.shape[0] == n_batch else t
                for t in outs
            ]
            reply = Buffer(
                tensors=tensors,
                pts=int(route.get("pts", -1)),
                duration=int(route.get("duration", -1)),
                meta=dict(route.get("meta") or {}),
            )
            msg = proto.buffer_to_message(reply, proto.MSG_RESULT)
            msg.meta.pop("client_id", None)
            req_ctx = route.get("trace")
            if req_ctx is not None:
                msg.trace = self._reply_trace(req_ctx,
                                              buf.meta.get("serve_invoke"))
            t_r = time.perf_counter() if spans is not None else 0.0
            ok = srv.send_to(int(route["client_id"]), msg, timeout=timeout)
            if spans is not None:
                # the reply leg of the serving timeline (enqueue→batch→
                # reply): send cost per demuxed row, on the sink's thread
                args = {"client": int(route["client_id"]),
                        "tenant": str(route.get("tenant", "_default")),
                        "delivered": bool(ok)}
                if req_ctx is not None:
                    args["trace_id"] = req_ctx.trace_hex
                spans.emit("serve-reply", "serving", t_r,
                           time.perf_counter(), args=args)
            if ok:
                delivered += 1
                if tracer is not None:
                    tracer.record_serving_reply(
                        self._key, str(route.get("tenant", "_default")))
            else:
                self._note_reply_drop(route["client_id"])
        sched = get_scheduler(self._key)
        if sched is not None:
            # batch fully demuxed: ack the scheduler (nnctl drain
            # feedback for pended serve-batch changes, and the per-launch
            # device window measurement from the filter's stamps)
            sched.note_reply_batch(buf.meta.get("serve_invoke"))
        return FlowReturn.OK if delivered else FlowReturn.DROPPED
