"""Edge connection handles: server + client over the NTEQ protocol.

API parity with the nns_edge_* handle model used throughout
tensor_query_*.c / edge_*.c: create → set event callback → start/connect →
send → close. Events mirror NNS_EDGE_EVENT_*: ``capability`` (server
advertises caps on connect, tensor_query_client.c:447-498),
``new_data_received`` (:502), ``connection_closed``.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Callable, Dict, Optional, Tuple

from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.edge import protocol as proto
from nnstreamer_tpu_torch.log import get_logger

log = get_logger("edge")


_hard_close = proto.hard_close  # one shutdown+close helper, see protocol.py

EventCallback = Callable[[str, dict], None]


def _set_sndtimeo(sock: socket.socket, seconds: float) -> None:
    """Kernel-level send deadline (SO_SNDTIMEO): bounds sendall() without
    touching the socket's recv behavior. 0 restores blocking sends."""
    import struct

    sec = int(seconds)
    usec = int((seconds - sec) * 1e6)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                    struct.pack("ll", sec, usec))


class EdgeServer:
    """Accepts connections, hands each client a unique id, advertises caps,
    queues received DATA frames, and routes RESULT frames back by id
    (the query-server handle table contract, tensor_query_server.c:24-67)."""

    def __init__(self, host: str = "localhost", port: int = 0, caps: str = ""):
        self.host = host
        self.caps = caps
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.port = self._listener.getsockname()[1]
        self._conns: Dict[int, socket.socket] = {}
        # per-connection send mutex: a serving server has TWO writers per
        # client socket (the serversink's RESULT replies from a queue
        # thread and the scheduler's BUSY sheds from the src streaming
        # thread) — unsynchronized sendalls would interleave bytes
        # mid-frame and corrupt the client's stream (EdgeClient.send
        # carries the same lock for the mirror-image reason)
        # blocking_ok: these mutexes exist to serialize the blocking
        # sendall itself — NNST611 polices everything else held there
        self._send_locks: Dict[int, threading.Lock] = {}
        self._lock = lockwitness.make_lock("edge.server.registry")
        self._next_id = 0
        self._stop = threading.Event()
        self.recv_queue: "queue.Queue[Tuple[int, proto.Message]]" = queue.Queue()
        #: optional health/headroom source (nnfleet-r): a callable
        #: returning the live health dict (edge/fleet.py keys). None
        #: (default) means capability frames carry ZERO payloads —
        #: byte-identical to a server that predates the TLV.
        self.health_provider = None

    def start(self) -> None:
        self._listener.listen(16)
        threading.Thread(target=self._accept_loop, name="edge-accept", daemon=True).start()

    def _capability_msg(self, cid: int) -> proto.Message:
        """The per-client CAPABILITY frame. Legacy meta fields are fixed
        (wire-compat contract, tests/test_edge_compat.py); the health
        TLV rides as a *payload* only when a provider is installed."""
        payloads = []
        if self.health_provider is not None:
            from nnstreamer_tpu_torch.edge import fleet

            try:
                payloads.append(fleet.pack_health(self.health_provider()))
            except Exception:  # noqa: BLE001 — health is advisory, never fatal
                log.exception("health provider failed; advertising none")
        return proto.Message(
            proto.MSG_CAPABILITY,
            # "trace": nntrace-x capability advertisement — a
            # client only ever attaches a trace header after
            # seeing this, so an old server (no key) gets
            # byte-identical data frames from every client
            {"caps": self.caps, "client_id": cid, "trace": 1},
            payloads=payloads,
        )

    def _accept_loop(self) -> None:
        from nnstreamer_tpu_torch.testing import faults

        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # accept-hang chaos point: the handshake stalls (client sees
            # a connect that never completes its CAPABILITY wait) while
            # ALREADY-connected clients keep streaming untouched
            f = faults.check("accept-hang", f"server:{self.host}:{self.port}")
            if f is not None:
                self._stop.wait(f.delay_s)
            with self._lock:
                self._next_id += 1
                cid = self._next_id
                self._conns[cid] = conn
                self._send_locks[cid] = lockwitness.make_lock(
                    "edge.server.send", blocking_ok=True)
            try:
                proto.send_message(conn, self._capability_msg(cid))
            except OSError:
                self._drop(cid)
                continue
            threading.Thread(
                target=self._recv_loop, args=(cid, conn),
                name=f"edge-recv-{cid}", daemon=True,
            ).start()

    def _recv_loop(self, cid: int, conn: socket.socket) -> None:
        import time as _time

        try:
            while not self._stop.is_set():
                msg = proto.recv_message(conn)
                if msg.type == proto.MSG_BYE:
                    break
                if msg.trace is not None:
                    # t2 of the NTP-style exchange: stamped as close to
                    # the wire as the transport gets
                    msg.trace.t_wire_recv_ns = _time.perf_counter_ns()
                msg.meta["client_id"] = cid
                self.recv_queue.put((cid, msg))
        except (ConnectionError, OSError):
            pass
        finally:
            self._drop(cid)

    def _drop(self, cid: int) -> None:
        with self._lock:
            conn = self._conns.pop(cid, None)
            self._send_locks.pop(cid, None)
        if conn is not None:
            _hard_close(conn)

    def send_to(self, cid: int, msg: proto.Message,
                timeout: Optional[float] = None) -> bool:
        """Route a frame back to the client it came from (serversink render,
        tensor_query_serversink.c:287-320). ``timeout`` bounds the send
        (serversink ``timeout=`` property): a client that stopped reading
        — full TCP window — must not wedge the server's reply path, so
        past the deadline the connection is dropped and False returned
        (the caller records the lost reply)."""
        with self._lock:
            conn = self._conns.get(cid)
            send_lock = self._send_locks.get(cid)
        if conn is None or send_lock is None:
            return False
        with send_lock:
            try:
                if timeout is not None and timeout > 0:
                    # SO_SNDTIMEO, NOT settimeout(): the per-client recv
                    # loop blocks on this same socket from its own thread,
                    # and a full settimeout() would make a racing recv
                    # raise spuriously and drop a healthy client
                    _set_sndtimeo(conn, timeout)
                proto.send_message(conn, msg, tag=f"server:{cid}")
                return True
            except (socket.timeout, OSError):
                self._drop(cid)
                return False
            finally:
                if timeout is not None and timeout > 0:
                    try:
                        _set_sndtimeo(conn, 0.0)  # back to blocking sends
                    except OSError:
                        pass

    def broadcast(self, msg: proto.Message) -> int:
        """Send to every connected client (edgesink fan-out); returns the
        number of clients reached."""
        with self._lock:
            cids = list(self._conns)
        return sum(1 for cid in cids if self.send_to(cid, msg))

    def broadcast_health(self) -> int:
        """Refresh every client's view of this server's headroom: one
        CAPABILITY frame per client with the live health TLV payload.
        Old clients re-apply the (identical) legacy meta fields and
        ignore the payload — mid-stream capability refreshes were always
        tolerated, which is what makes this channel compat-safe. No-op
        (returns 0) without a health provider."""
        if self.health_provider is None:
            return 0
        with self._lock:
            cids = list(self._conns)
        return sum(1 for cid in cids
                   if self.send_to(cid, self._capability_msg(cid)))

    def pop(self, timeout: float = 0.2) -> Optional[Tuple[int, proto.Message]]:
        try:
            return self.recv_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.items())
            self._conns.clear()
            self._send_locks.clear()
        for _cid, c in conns:
            _hard_close(c)


class EdgeClient:
    """Connects to an EdgeServer; the caps handshake result and an async
    receive queue mirror the query client's edge handle
    (tensor_query_client.c:541-566, event cb :435-520).

    ``reconnect=True``: a dropped connection triggers a BOUNDED redial —
    exponential backoff capped at ``max_backoff`` with full jitter (a
    fleet of edge clients must not re-dial a recovering server in
    lockstep), at most ``max_retries`` attempts per outage. Each
    successful redial re-runs the CAPABILITY handshake (the server hands
    out a fresh ``client_id``), bumps ``reconnects``, and pulses the
    ``reconnected`` event so the owning element can resend or drop its
    in-flight frames per its error policy. ``closed`` is then only set by
    :meth:`close` or when the retry budget is exhausted."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 reconnect: bool = False, max_retries: int = 5,
                 max_backoff: float = 2.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.reconnect = reconnect
        self.max_retries = max_retries
        self.max_backoff = max_backoff
        self.client_id: Optional[int] = None
        self.server_caps: Optional[str] = None
        #: True once the server's CAPABILITY advertised nntrace-x support
        #: — the gate for ever attaching a trace header to a frame (an
        #: old server must see byte-identical frames)
        self.server_trace = False
        #: latest health/headroom advertisement from the server's
        #: capability TLV (edge/fleet.py keys), None until one arrives —
        #: old servers never send one and this simply stays None
        self.server_health = None
        self.health_updated = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        # multi-writer sends (streaming thread + the rx thread's
        # reconnect resend) must not interleave bytes mid-frame — the
        # same per-connection send mutex mqtt.py uses (blocking_ok: the
        # lock's whole job is serializing the blocking sendall)
        self._send_lock = lockwitness.make_lock("edge.client.send",
                                                blocking_ok=True)
        self.recv_queue: "queue.Queue[proto.Message]" = queue.Queue()
        self._caps_ready = threading.Event()
        self._got_capability = False
        #: set once the connection is gone for good (recv loop exited and
        #: no redial will be attempted) — sources use this to turn a dead
        #: peer into EOS instead of spinning
        self.closed = threading.Event()
        #: completed re-handshakes; ``reconnected`` pulses on each
        self.reconnects = 0
        self.reconnected = threading.Event()

    def connect(self) -> None:
        self._sock = socket.create_connection((self.host, self.port), self.timeout)
        t = threading.Thread(target=self._recv_loop, name="edge-client-recv", daemon=True)
        t.start()
        if not self._caps_ready.wait(self.timeout):
            raise TimeoutError("no CAPABILITY handshake from server")
        if not self._got_capability:
            raise ConnectionError("server closed before CAPABILITY handshake")

    def _recv_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = proto.recv_message(self._sock)
                except (ConnectionError, OSError, proto.ProtocolError):
                    if self._stop.is_set() or not self.reconnect:
                        break
                    if not self._redial():
                        break
                    continue
                if msg.type == proto.MSG_CAPABILITY:
                    self.server_caps = str(msg.meta.get("caps", ""))
                    self.client_id = msg.meta.get("client_id")
                    self.server_trace = bool(msg.meta.get("trace"))
                    self._apply_health(msg)
                    self._got_capability = True
                    self._caps_ready.set()
                elif msg.type == proto.MSG_BYE:
                    break
                else:
                    if msg.trace is not None:
                        # t4 of the NTP-style exchange: the client-side
                        # receive stamp, as close to the wire as we get
                        import time as _time

                        msg.trace.t_wire_recv_ns = _time.perf_counter_ns()
                    self.recv_queue.put(msg)
        finally:
            self.closed.set()
            self._caps_ready.set()  # unblock connect() on early close

    def _apply_health(self, msg: proto.Message) -> None:
        """Pick the health TLV out of a CAPABILITY frame's payloads (if
        any). Non-health payloads are ignored — a FUTURE server may ride
        other payloads here and an old client must keep working."""
        for p in msg.payloads:
            from nnstreamer_tpu_torch.edge import fleet

            health = fleet.parse_health(p)
            if health is not None:
                self.server_health = health
                self.health_updated.set()
                return

    def _redial(self) -> bool:
        """Bounded backoff+jitter redial with a fresh CAPABILITY handshake.
        Returns False when stopping or out of retries."""
        import random

        _hard_close(self._sock)
        backoff = 0.05
        for _attempt in range(max(1, self.max_retries)):
            # full jitter (0.5–1.5x) so a herd of clients spreads out
            if self._stop.wait(min(backoff, self.max_backoff)
                               * (0.5 + random.random())):
                return False
            backoff = min(backoff * 2, self.max_backoff)
            try:
                sock = socket.create_connection((self.host, self.port),
                                                self.timeout)
                msg = proto.recv_message(sock)
            except (OSError, proto.ProtocolError):
                continue
            if msg.type != proto.MSG_CAPABILITY:
                _hard_close(sock)
                continue
            self._sock = sock
            self.server_caps = str(msg.meta.get("caps", ""))
            self.client_id = msg.meta.get("client_id")
            self.server_trace = bool(msg.meta.get("trace"))
            self._apply_health(msg)
            self.reconnects += 1
            self.reconnected.set()
            log.info("edge client reconnected to %s:%d (attempt %d, "
                     "client_id %s)", self.host, self.port, _attempt + 1,
                     self.client_id)
            return True
        log.warning("edge client gave up on %s:%d after %d redial attempts",
                    self.host, self.port, self.max_retries)
        return False

    def send(self, msg: proto.Message) -> None:
        sock = self._sock
        if sock is None:
            raise ConnectionError("not connected")
        with self._send_lock:
            proto.send_message(sock, msg,
                               tag=f"client:{self.host}:{self.port}")

    def recv(self, timeout: Optional[float] = None) -> Optional[proto.Message]:
        try:
            return self.recv_queue.get(timeout=timeout if timeout is not None else self.timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                proto.send_message(self._sock, proto.Message(proto.MSG_BYE))
            except OSError:
                pass
            _hard_close(self._sock)
            self._sock = None
